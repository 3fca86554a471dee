"""The port's binary remote-write codec (`foremast_tpu_torch/ingest/wire.py`)
and its receiver path against the JAX package's: `encode_frame` writes the
same bytes, frames and snappy streams written by either package decode in
the other to the same keys and columns, every malformed input raises the
same `WireError` text in both, and the port's receiver answers each push
(binary or JSON, snappy or not, malformed, oversized, at shutdown) with
the status and body the JAX receiver gives it.

Inputs are made from numpy seeds. The JAX receiver runs without its
`dirty` set and router, which the port leaves to later items."""

from __future__ import annotations

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from foremast_tpu.ingest import receiver as jrecv
from foremast_tpu.ingest import shards as jshards
from foremast_tpu.ingest import wire as jwire
from foremast_tpu_torch.ingest import receiver as trecv
from foremast_tpu_torch.ingest import shards as tshards
from foremast_tpu_torch.ingest import wire as twire

PKGS = {"jax": (jwire, jshards, jrecv), "port": (twire, tshards, trecv)}


def _entries(n_series=3, n_samples=4, base_ts=60, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_series):
        ts = np.cumsum(rng.integers(1, 90, n_samples)).astype(np.int64) + base_ts + i
        vs = rng.normal(1.0, 0.5, n_samples).astype(np.float32)
        out.append((f'm{{app="a{i}"}}', ts, vs, 10.0 * i if i else None))
    return out


def _push(port, body, ctype="application/json", enc=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/api/v1/write", data=body, method="POST")
    req.add_header("Content-Type", ctype)
    if enc:
        req.add_header("Content-Encoding", enc)
    try:
        resp = urllib.request.urlopen(req, timeout=10)
        return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _same_error(fn_name: str, *args, **kw) -> str:
    """Both packages raise their WireError with the same text."""
    got = {}
    for name, (wire, _, _) in PKGS.items():
        with pytest.raises(wire.WireError) as ei:
            getattr(wire, fn_name)(*args, **kw)
        got[name] = str(ei.value)
    assert got["port"] == got["jax"]
    return got["port"]


# ---------------------------------------------------------------- frame codec


@pytest.mark.parametrize("seed,n_series,n_samples", [(0, 3, 4), (1, 1, 10_080), (2, 17, 33), (3, 0, 0)])
def test_encode_frame_bytes_equal_jax(seed, n_series, n_samples):
    entries = _entries(n_series, n_samples, seed=seed)
    frame = twire.encode_frame(entries)
    assert frame == jwire.encode_frame(entries)
    for decode in (twire.decode_frame, jwire.decode_frame):
        out = decode(frame)
        assert len(out) == len(entries)
        for (k0, t0, v0, s0), (k1, t1, v1, s1) in zip(entries, out):
            assert (k1, s1) == (k0, s0)
            assert np.array_equal(t1, t0) and np.array_equal(v1.view(np.uint32), v0.view(np.uint32))
    if n_series:
        # zero-copy contract: the port's decoded arrays are views over the frame
        out = twire.decode_frame(frame)
        assert out[0][1].base is not None and out[0][2].base is not None


def test_frame_interning_and_canonicalization():
    entries = [('m{ b="2", a="1" }', np.array([60], np.int64), np.array([1.0], np.float32), None)]
    cache: dict = {}
    out1 = twire.decode_frame(twire.encode_frame(entries), cache, canonicalize=True)
    out2 = twire.decode_frame(twire.encode_frame(entries), cache, canonicalize=True)
    assert out1[0][0] == 'm{a="1",b="2"}' == jwire.decode_frame(jwire.encode_frame(entries), {}, True)[0][0]
    assert out2[0][0] is out1[0][0]  # the same interned str
    assert len(cache) == 1


@pytest.mark.parametrize(
    "mangle",
    [
        lambda b: b[:20],
        lambda b: b"XXXX" + b[4:],
        lambda b: b[:4] + b"\x09" + b[5:],
        lambda b: b[:5] + b"\x01" + b[6:],
        lambda b: b[:-3],
        lambda b: b + b"\x00\x00",
    ],
    ids=["short_header", "magic", "version", "reserved", "truncated", "trailing"],
)
def test_frame_damage_raises_the_same_error(mangle):
    _same_error("decode_frame", mangle(twire.encode_frame(_entries())))


def test_frame_internal_inconsistencies_raise_the_same_error():
    buf = bytearray(twire.encode_frame(_entries(n_series=2, n_samples=3)))
    bad = bytearray(buf)
    bad[12:20] = (7).to_bytes(8, "little")
    _same_error("decode_frame", bytes(bad))
    n_samples = int.from_bytes(buf[12:20], "little")
    off = 32 + 8 * n_samples + 8 * 2 + 4 * n_samples  # the counts section
    bad = bytearray(buf)
    bad[off : off + 4] = (99).to_bytes(4, "little")
    assert "counts do not sum" in _same_error("decode_frame", bytes(bad))


@pytest.mark.parametrize("poison", [np.nan, np.inf, -np.inf])
def test_frame_rejects_nonfinite_values(poison):
    entries = [("m", np.array([60, 90], np.int64), np.array([1.0, poison], np.float32), None)]
    assert "non-finite" in _same_error("decode_frame", twire.encode_frame(entries))


def test_frame_timestamp_order_and_utf8():
    bad = [("m", np.array([120, 60], np.int64), np.array([1.0, 2.0], np.float32), None)]
    assert "out-of-order" in _same_error("decode_frame", twire.encode_frame(bad))
    # duplicates are not out of order, and time may reset between series
    ok = [
        ("a", np.array([60, 60, 90], np.int64), np.array([1, 2, 3], np.float32), None),
        ("b", np.array([30], np.int64), np.array([4], np.float32), None),
    ]
    assert len(twire.decode_frame(twire.encode_frame(ok))) == 2
    buf = bytearray(twire.encode_frame([("mm", np.array([60], np.int64), np.array([1.0], np.float32), None)]))
    buf[-2:] = b"\xff\xfe"  # the key blob is the last section
    assert "utf-8" in _same_error("decode_frame", bytes(buf))


def test_json_codec_contract_matches_binary():
    body = {"timeseries": [{"labels": {"__name__": "m"}, "samples": [[60, float("nan")]]}]}
    assert "non-finite" in _same_error("parse_push", body)
    # out-of-order samples stay legal JSON in both
    body = {"timeseries": [{"labels": {"__name__": "m"}, "samples": [[120, 2.0], [60, 1.0]]}]}
    got, want = twire.parse_push(body), jwire.parse_push(body)
    assert got[0][0] == want[0][0] and np.array_equal(got[0][1], want[0][1])


# -------------------------------------------------------------------- snappy


@pytest.mark.parametrize("seed,size", [(0, 0), (1, 1), (2, 120_000), (3, 1_792)])
def test_snappy_round_trips_across_packages(seed, size):
    payload = np.random.default_rng(seed).integers(0, 4, size, dtype=np.uint8).tobytes()
    comp = twire.snappy_compress(payload)
    assert comp == jwire.snappy_compress(payload)
    assert jwire.snappy_decompress(comp) == payload == twire.snappy_decompress(jwire.snappy_compress(payload))
    assert twire.snappy_uncompressed_len(comp) == size


def test_snappy_overlapping_copy():
    # literal "ab", then a copy-1 of length 6 at offset 2: "abababab"
    stream = bytes([8]) + bytes([(2 - 1) << 2]) + b"ab" + bytes([0b01 | ((6 - 4) << 2), 2])
    assert twire.snappy_decompress(stream) == jwire.snappy_decompress(stream) == b"abababab"


@pytest.mark.parametrize(
    "stream",
    [
        b"",
        b"\xff" * 11,
        bytes([5]) + bytes([(10 - 1) << 2]) + b"ab",
        bytes([4]) + bytes([0b01, 9]),
        bytes([9]) + bytes([(2 - 1) << 2]) + b"ab",
    ],
    ids=["no_preamble", "varint", "literal_overrun", "copy_before_start", "declared_len"],
)
def test_snappy_malformed_streams_raise_the_same_error(stream):
    _same_error("snappy_decompress", stream)


def test_snappy_max_len_guard():
    comp = twire.snappy_compress(b"z" * 4096)
    assert "cap" in _same_error("snappy_decompress", comp, max_len=1024)


# ----------------------------------------------------- striped batch appends


def test_push_batch_matches_sequential_push_and_jax():
    entries = _entries(n_series=8, n_samples=16, seed=5)
    seq, bat, jbat = tshards.RingStore(shards=4), tshards.RingStore(shards=4), jshards.RingStore(shards=4)
    for key, ts, vs, start in entries:
        seq.push(key, ts, vs, start=start)
    assert bat.push_batch(entries) == [16] * 8 == jbat.push_batch(entries)
    assert seq.stats()["samples"] == bat.stats()["samples"] == jbat.stats()["samples"]
    for key, ts, _vs, _start in entries:
        got = [s.query(key, int(ts[0]), int(ts[-1]), now=float(ts[-1])) for s in (seq, bat, jbat)]
        assert {g[0] for g in got} == {"hit"}
        for g in got[1:]:
            assert np.array_equal(g[1], got[0][1]) and np.array_equal(g[2], got[0][2])


def test_push_many_journal_fires_in_apply_order():
    shard = tshards.RingStore(shards=1)._shards[0]
    items = [(k, t, v, s, None) for k, t, v, s in _entries(n_series=4)]
    journaled = []
    assert shard.push_many(items, journal=lambda key, *rest: journaled.append(key)) == [4] * 4
    assert journaled == [k for k, *_ in items]
    assert shard.push_many([]) == []


# --------------------------------------------------------- HTTP negotiation


def _servers(**kw):
    """A JAX and a port receiver over fresh stores: {name: (srv, store)}."""
    out = {}
    for name, (_, shards, recv) in PKGS.items():
        store = shards.RingStore(shards=2)
        srv, _ = recv.start_ingest_server(0, store, host="127.0.0.1", **kw)
        out[name] = (srv, store)
    return out


def _stop(servers):
    for name, (srv, _) in servers.items():
        PKGS[name][2].stop_ingest_server(srv)


def _json_body(entries):
    return json.dumps(
        {
            "timeseries": [
                {
                    "labels": {"__name__": "m", "app": f"a{i}"},
                    "samples": [[int(t), float(v)] for t, v in zip(ts, vs)],
                    **({"start": start} if start is not None else {}),
                }
                for i, (_k, ts, vs, start) in enumerate(entries)
            ]
        }
    ).encode()


def test_receiver_codec_negotiation_answers_as_jax():
    entries = _entries(n_series=2, n_samples=3)
    frame = twire.encode_frame(entries)
    js = _json_body(entries)
    servers = _servers()
    try:
        answers = {}
        for name, (srv, _) in servers.items():
            port = srv.server_address[1]
            answers[name] = [
                _push(port, frame, ctype=twire.BINARY_CONTENT_TYPE),
                _push(port, twire.snappy_compress(frame), ctype=twire.BINARY_CONTENT_TYPE, enc="snappy"),
                _push(port, twire.snappy_compress(js), enc="snappy"),
                _push(port, js),
                _push(port, frame, ctype=twire.BINARY_CONTENT_TYPE, enc="gzip"),
            ]
        assert answers["port"] == answers["jax"]
        assert answers["port"][0] == (200, {"accepted_samples": 6, "series": 2})
        assert answers["port"][-1][0] == 400 and "Content-Encoding" in answers["port"][-1][1]["reason"]
        for key, ts, _vs, _start in entries:
            got = servers["port"][1].query(key, int(ts[0]), int(ts[-1]), now=float(ts[-1]))
            want = servers["jax"][1].query(key, int(ts[0]), int(ts[-1]), now=float(ts[-1]))
            assert got[0] == want[0] == "hit" and np.array_equal(got[2], want[2])
        state = json.loads(
            urllib.request.urlopen(f"http://127.0.0.1:{servers['port'][0].server_address[1]}/debug/state").read()
        )
        for codec in ("json", "binary"):
            w = state["wire"][codec]
            assert w["requests"] >= 2 and w["samples"] >= 6
            assert set(w["stage_seconds"]) == {"read", "decompress", "decode", "apply"}
    finally:
        _stop(servers)


@pytest.mark.parametrize(
    "body_fn,enc",
    [
        (lambda f: f[:20], None),
        (lambda f: f[:-5], None),
        (lambda f: b"XXXX" + f[4:], None),
        (lambda f: bytes([200]) + b"\x00garbage", "snappy"),
        (lambda f: twire.snappy_compress(f)[:-3], "snappy"),
    ],
    ids=["short_header", "truncated", "magic", "bad_snappy", "truncated_snappy"],
)
def test_receiver_binary_negatives_are_the_same_400(body_fn, enc):
    frame = twire.encode_frame(_entries())
    bad_order = twire.encode_frame([("m", np.array([120, 60], np.int64), np.array([1, 2], np.float32), None)])
    nan_json = b'{"timeseries": [{"labels": {"__name__": "m"}, "samples": [[60, NaN]]}]}'
    good = twire.encode_frame(_entries(n_series=1, n_samples=2))
    servers = _servers()
    try:
        answers = {}
        for name, (srv, store) in servers.items():
            port = srv.server_address[1]
            answers[name] = [
                _push(port, body_fn(frame), ctype=twire.BINARY_CONTENT_TYPE, enc=enc),
                _push(port, bad_order, ctype=twire.BINARY_CONTENT_TYPE),
                _push(port, nan_json),
                store.stats()["samples"],
                _push(port, good, ctype=twire.BINARY_CONTENT_TYPE),
            ]
        assert answers["port"] == answers["jax"]
        first, order, nan, samples, healthy = answers["port"]
        assert first[0] == 400 and first[1]["reason"]
        assert order[0] == 400 and "out-of-order" in order[1]["reason"]
        assert nan[0] == 400 and samples == 0
        assert healthy == (200, {"accepted_samples": 2, "series": 1})
    finally:
        _stop(servers)


def _raw_post_status(port, headers: dict, payload: bytes) -> int:
    """POST with a Content-Length larger than what is sent: a status can
    only come back if the receiver answered before reading the body."""
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        head = "POST /api/v1/write HTTP/1.1\r\nHost: x\r\n" + "".join(f"{k}: {v}\r\n" for k, v in headers.items())
        s.sendall((head + "\r\n").encode() + payload)
        s.settimeout(10)
        return int(s.recv(4096).split(b"\r\n", 1)[0].split()[1])


def test_binary_413_from_the_declared_size_before_read():
    servers = _servers(max_decoded_bytes=4096, max_body_bytes=8 << 20)
    declared = 1 << 20
    header = (
        b"FMW1" + bytes((1, 0, 0, 0)) + (1).to_bytes(4, "little") + (100).to_bytes(8, "little")
        + (10).to_bytes(4, "little") + declared.to_bytes(8, "little")
    )
    bomb = bytes([0x80, 0x80, 0x80, 0x80, 0x01]) + b"\x00\x00"  # declares 2**28 bytes
    try:
        answers = {}
        for name, (srv, store) in servers.items():
            port = srv.server_address[1]
            answers[name] = [
                _raw_post_status(port, {"Content-Type": twire.BINARY_CONTENT_TYPE,
                                        "Content-Length": str(declared)}, header),
                _push(port, bomb, enc="snappy"),
                store.stats()["samples"],
                _push(port, twire.encode_frame(_entries(1, 2)), ctype=twire.BINARY_CONTENT_TYPE),
            ]
        assert answers["port"] == answers["jax"]
        code, bomb_answer, samples, ok = answers["port"]
        assert code == 413 and bomb_answer[0] == 413 and "declared decoded size" in bomb_answer[1]["reason"]
        assert samples == 0 and ok[0] == 200
    finally:
        _stop(servers)


# ------------------------------------------------------ shutdown drain


class _SlowApplyStore(tshards.RingStore):
    """A store whose batch apply stalls, so a shutdown lands mid-decode."""

    def __init__(self, *a, delay=0.4, **kw):
        super().__init__(*a, **kw)
        self._delay = delay
        self.apply_started = threading.Event()

    def push_batch(self, entries, **kw):
        self.apply_started.set()
        time.sleep(self._delay)
        return super().push_batch(entries, **kw)


def test_shutdown_drains_pooled_decode_never_half_applies():
    store = _SlowApplyStore(shards=2, delay=0.4)
    srv, _ = trecv.start_ingest_server(0, store, host="127.0.0.1", decode_workers=2)
    port = srv.server_address[1]
    result: dict = {}
    t = threading.Thread(
        target=lambda: result.update(
            resp=_push(port, twire.encode_frame(_entries(3, 5)), ctype=twire.BINARY_CONTENT_TYPE)
        )
    )
    t.start()
    assert store.apply_started.wait(5.0)  # a decode worker is mid-apply
    clean = trecv.stop_ingest_server(srv, drain_seconds=5.0)
    t.join(timeout=10)
    assert not t.is_alive() and clean is True
    code, out = result["resp"]
    if code == 200:
        assert out["accepted_samples"] == 15 == store.stats()["samples"]
    else:  # shed cleanly: nothing half-appended
        assert code == 503 and store.stats()["samples"] == 0


def test_closed_pool_sheds_503_with_nothing_applied():
    servers = _servers()
    try:
        answers = {}
        for name, (srv, store) in servers.items():
            srv._foremast_decode_pool.close(time.monotonic())  # the drain window
            answers[name] = (
                _push(srv.server_address[1], twire.encode_frame(_entries()), ctype=twire.BINARY_CONTENT_TYPE),
                store.stats()["samples"],
            )
        assert answers["port"] == answers["jax"]
        (code, out), samples = answers["port"]
        assert code == 503 and "draining" in out["reason"] and samples == 0
    finally:
        _stop(servers)


def test_decode_pool_close_refuses_then_drains():
    pool = trecv._DecodePool(workers=2)
    release, started = threading.Event(), threading.Event()

    def job():
        started.set()
        release.wait(5.0)
        return "done"

    results = []
    t = threading.Thread(target=lambda: results.append(pool.run(job)))
    t.start()
    assert started.wait(5.0)
    closer = threading.Thread(target=lambda: results.append(("clean", pool.close(time.monotonic() + 5.0))))
    closer.start()
    with pytest.raises(trecv._PoolClosed):
        # admission is refused the moment close begins
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            pool.run(lambda: "late")
            time.sleep(0.01)
    release.set()
    t.join(timeout=5)
    closer.join(timeout=5)
    assert not t.is_alive() and not closer.is_alive()
    assert "done" in results and ("clean", True) in results
