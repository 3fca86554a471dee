"""Ingest wire format: push payloads and query_range key resolution.

The port's copy of the JAX package's `foremast_tpu/ingest/wire.py`, with
the same codecs byte for byte: a frame or JSON body encoded by either
package decodes in the other to the same keys and columns.

The ingest plane inverts the reference's scrape direction (SURVEY §3.2:
the brain HTTP-GETs every document's `query_range` URL from Prometheus
each tick). Pushers — a vmagent-style forwarder, a recording-rule
evaluator, or the tests' direct `RingStore.push` — send samples keyed
by the SAME series identity the documents' query strings carry, so a
warm fetch is a dictionary gather instead of an HTTP round trip.

Three codecs live here, all pure functions with no locking or I/O:

  * ``parse_push`` — the receiver's remote-write-style JSON body:
    ``{"timeseries": [...]}`` where each entry carries either Prometheus
    remote-write shaped ``labels`` + ``samples`` pairs, or the direct
    ``alias``/``times``/``values`` arrays. Timestamps are unix SECONDS
    (the judgment plane's resolution; the 60 s recording-rule step makes
    sub-second precision meaningless here).
  * ``encode_frame``/``decode_frame`` — the BINARY wire codec: a
    length-prefixed columnar frame in the remote-write wire
    family's shape (one framed write request, optionally
    snappy-compressed) whose decode is ``np.frombuffer`` VIEWS over the
    frame — the (int64 times, float32 values) columns land in the ring
    with zero intermediate dict/list/object materialization. Layout and
    negotiation are specified in docs/wire-protocol.md.
  * ``resolve_query_range`` — a document's datasource URL → the ring
    key plus the requested (start, end, step) window. Handles both URL
    shapes the brain fetches (Prometheus ``query_range?query=...`` per
    `prometheushelper.go:12-27` and the wavefront ``&&`` encoding per
    `wavefronthelper.go:20-29`).

A pure-python snappy block-format codec rides along
(``snappy_compress``/``snappy_decompress``): the container bakes no
snappy wheel, and gating ``Content-Encoding: snappy`` on an optional
import would make wire compatibility an install-time accident. The
decoder handles the FULL block format (literals + all three copy
element shapes — what a real remote-write pusher emits); the encoder
emits well-formed literal-only streams (framing compatibility, not
ratio — the wire-speed path is the uncompressed frame).

Series identity: ``canonical_series`` normalizes a bare PromQL selector
(`name{a="1",b="2"}`) by sorting its label matchers, so a push built
from a labels map and a query string written in any label order land on
the same ring slot. Non-selector expressions (wrapped in functions)
pass through verbatim — pushers for those use the alias form with the
exact expression text.
"""

from __future__ import annotations

import re
import urllib.parse

import numpy as np

from foremast_tpu_torch.metrics.source import Series  # noqa: F401 - shared alias

_SELECTOR_RE = re.compile(
    r"^\s*([a-zA-Z_:][a-zA-Z0-9_:]*)\s*(?:\{(.*)\})?\s*$", re.DOTALL
)
_MATCHER_RE = re.compile(
    r'\s*([a-zA-Z_][a-zA-Z0-9_]*)\s*(=~|!=|!~|=)\s*"((?:[^"\\]|\\.)*)"\s*(?:,|$)'
)


def canonical_series(expr: str) -> str:
    """Label-order-independent form of a bare PromQL selector; any
    expression that is not a plain ``name{matchers}`` selector is
    returned stripped-but-verbatim (pushers then use the exact text)."""
    m = _SELECTOR_RE.match(expr or "")
    if m is None:
        return (expr or "").strip()
    name, body = m.group(1), m.group(2)
    if body is None or not body.strip():
        return name
    matchers = []
    pos = 0
    for mm in _MATCHER_RE.finditer(body):
        if mm.start() != pos:
            return expr.strip()  # unparsed residue: not a bare selector
        matchers.append((mm.group(1), mm.group(2), mm.group(3)))
        pos = mm.end()
    if pos != len(body):
        return expr.strip()
    matchers.sort()
    inner = ",".join(f'{k}{op}"{v}"' for k, op, v in matchers)
    return f"{name}{{{inner}}}"


def series_key(labels: dict) -> str:
    """Ring key for a labels map (`__name__` + sorted matchers) — the
    push-side mirror of `canonical_series` on the query side. Label
    values are rendered in PromQL's escaped form (backslash and quote),
    matching the escaped text a query selector carries — an unescaped
    render would let a value containing `","` inject fake matchers and
    collide with a different series' key."""
    name = str(labels.get("__name__", ""))
    rest = sorted(
        (str(k), str(v)) for k, v in labels.items() if k != "__name__"
    )
    if not rest:
        return name
    inner = ",".join(
        '{}="{}"'.format(k, v.replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in rest
    )
    return f"{name}{{{inner}}}"


class WireError(ValueError):
    """Malformed push payload (the receiver answers 400 with the text)."""


def _entry_series(entry: dict) -> tuple[np.ndarray, np.ndarray]:
    if "samples" in entry:
        samples = entry["samples"]
        ts = np.asarray([s[0] for s in samples], np.int64)
        vs = np.asarray([s[1] for s in samples], np.float32)
    elif "times" in entry and "values" in entry:
        ts = np.asarray(entry["times"], np.int64)
        vs = np.asarray(entry["values"], np.float32)
    else:
        raise WireError(
            "timeseries entry needs `samples` or `times`+`values`"
        )
    if ts.ndim != 1 or vs.ndim != 1 or len(ts) != len(vs):
        raise WireError("times/values must be equal-length 1-d arrays")
    if len(vs) and not bool(np.isfinite(vs).all()):
        # same contract as the binary codec: a non-finite value is a
        # malformed push, not a storable sample (parity keeps statuses
        # byte-identical across codecs)
        raise WireError("non-finite sample value (NaN/Inf)")
    return ts, vs


def parse_push(body) -> list[tuple[str, np.ndarray, np.ndarray, float | None]]:
    """Decode one push payload into ``(key, times, values, start)``
    tuples. `start` is the entry's optional coverage watermark: a
    backfill-style push may assert "there is no data before start" so
    queries reaching back to it count as covered."""
    if not isinstance(body, dict):
        raise WireError("push body must be a JSON object")
    series = body.get("timeseries")
    if not isinstance(series, list):
        raise WireError("push body needs a `timeseries` list")
    out = []
    for entry in series:
        if not isinstance(entry, dict):
            raise WireError("timeseries entries must be objects")
        labels = entry.get("labels")
        if labels is not None:
            if isinstance(labels, list):  # proto-JSON [{name,value}] shape
                if not all(
                    isinstance(lb, dict) and "name" in lb and "value" in lb
                    for lb in labels
                ):
                    raise WireError(
                        "label list entries must be {name, value} objects"
                    )
                labels = {
                    str(lb["name"]): str(lb["value"]) for lb in labels
                }
            if not isinstance(labels, dict) or not labels.get("__name__"):
                raise WireError("labels need a `__name__`")
            key = series_key(labels)
        else:
            alias = entry.get("alias") or entry.get("series")
            if not alias:
                raise WireError(
                    "timeseries entry needs `labels` or `alias`"
                )
            key = canonical_series(str(alias))
        try:
            ts, vs = _entry_series(entry)
        except WireError:
            raise
        except (TypeError, ValueError, IndexError, KeyError) as e:
            raise WireError(f"bad samples for {key!r}: {e}") from None
        start = entry.get("start")
        if start is not None:
            try:
                start = float(start)
            except (TypeError, ValueError):
                raise WireError(
                    f"bad `start` for {key!r}: {start!r}"
                ) from None
        out.append((key, ts, vs, start))
    return out


# --------------------------------------------------------------------------
# Binary wire codec: length-prefixed columnar frame, decoded as
# np.frombuffer views — no per-sample Python objects anywhere on the path.
#
#   header (32 bytes, little-endian):
#     [0:4)   magic  b"FMW1"
#     [4]     u8  version (1)
#     [5]     u8  flags (reserved, must be 0)
#     [6:8)   u16 reserved (must be 0)
#     [8:12)  u32 n_series
#     [12:20) u64 n_samples
#     [20:24) u32 key_blob_len
#     [24:32) u64 frame_len (header + all sections; truncation/garbage check)
#   sections, contiguous from byte 32, widest-alignment-first so every
#   np.frombuffer view is naturally aligned:
#     times    int64[n_samples]      sample timestamps, concatenated per series
#     starts   float64[n_series]     coverage watermark; NaN = none
#     values   float32[n_samples]
#     counts   uint32[n_series]      samples per series (prefix-sums slice times/values)
#     key_offs uint32[n_series + 1]  byte offsets into key_blob (offs[0] == 0)
#     key_blob utf-8 bytes           canonical series keys, concatenated
#
# Contract (docs/wire-protocol.md): per-series timestamps must be
# non-decreasing — an out-of-order frame is a 400, unlike the JSON compat
# codec which merge-sorts. Values must be finite in BOTH codecs.

BINARY_CONTENT_TYPE = "application/x-foremast-remote-write"
JSON_CONTENT_TYPE = "application/json"
FRAME_MAGIC = b"FMW1"
FRAME_VERSION = 1
_HEADER = 32
# Sanity ceilings: a header declaring more than this is malformed, not big
# (the receiver's byte caps bound real frames far below these).
_MAX_SERIES = 1 << 24
_MAX_SAMPLES = 1 << 33


def encode_frame(
    entries: list[tuple[str, np.ndarray, np.ndarray, float | None]],
) -> bytes:
    """Encode ``(key, times, values, start)`` tuples (the exact shape
    ``parse_push`` returns) into one binary frame. Keys are written as
    given — callers wanting cross-codec key identity pass canonical keys."""
    n_series = len(entries)
    keys = [str(k).encode("utf-8") for k, _, _, _ in entries]
    counts = np.asarray([len(t) for _, t, _, _ in entries], np.uint32)
    n_samples = int(counts.sum())
    times = (
        np.concatenate([np.asarray(t, np.int64) for _, t, _, _ in entries])
        if n_series
        else np.empty(0, np.int64)
    )
    values = (
        np.concatenate([np.asarray(v, np.float32) for _, _, v, _ in entries])
        if n_series
        else np.empty(0, np.float32)
    )
    starts = np.asarray(
        [np.nan if s is None else float(s) for _, _, _, s in entries],
        np.float64,
    )
    key_offs = np.zeros(n_series + 1, np.uint32)
    np.cumsum([len(k) for k in keys], out=key_offs[1:])
    blob = b"".join(keys)
    frame_len = (
        _HEADER
        + times.nbytes
        + starts.nbytes
        + values.nbytes
        + counts.nbytes
        + key_offs.nbytes
        + len(blob)
    )
    header = (
        FRAME_MAGIC
        + bytes((FRAME_VERSION, 0, 0, 0))
        + n_series.to_bytes(4, "little")
        + n_samples.to_bytes(8, "little")
        + len(blob).to_bytes(4, "little")
        + frame_len.to_bytes(8, "little")
    )
    return b"".join(
        (
            header,
            times.tobytes(),
            starts.tobytes(),
            values.tobytes(),
            counts.tobytes(),
            key_offs.tobytes(),
            blob,
        )
    )


def frame_decoded_len(buf: bytes) -> int:
    """Declared total frame length from the first 32 header bytes — the
    no-buffering 413 guard reads THIS (or Content-Length) before touching
    section bytes. Raises WireError when the header itself is malformed."""
    if len(buf) < _HEADER:
        raise WireError("binary frame shorter than its 32-byte header")
    if buf[:4] != FRAME_MAGIC:
        raise WireError("bad frame magic (want FMW1)")
    if buf[4] != FRAME_VERSION:
        raise WireError(f"unsupported frame version {buf[4]}")
    if buf[5] != 0 or buf[6] != 0 or buf[7] != 0:
        raise WireError("reserved frame header bytes must be zero")
    return int.from_bytes(buf[24:32], "little")


def decode_frame(
    buf: bytes, intern: dict | None = None, canonicalize: bool = False
) -> list[tuple[str, np.ndarray, np.ndarray, float | None]]:
    """Decode one binary frame into ``(key, times, values, start)`` tuples
    whose arrays are zero-copy views over ``buf`` (the frame must outlive
    them — the receiver applies within the request, so it always does).

    ``intern`` is an optional ``bytes -> str`` cache: repeat pushers resend
    the same key set every frame, so decode amortizes utf-8 decoding (and,
    with ``canonicalize``, the `canonical_series` regex) to one dict hit
    per series. Validation is vectorized: finiteness over the whole values
    column, per-series timestamp order via one diff masked at series
    boundaries — no per-sample Python loop anywhere."""
    frame_len = frame_decoded_len(buf)
    if frame_len != len(buf):
        raise WireError(
            f"frame length mismatch: header declares {frame_len} bytes, "
            f"got {len(buf)} (truncated or trailing garbage)"
        )
    n_series = int.from_bytes(buf[8:12], "little")
    n_samples = int.from_bytes(buf[12:20], "little")
    blob_len = int.from_bytes(buf[20:24], "little")
    if n_series > _MAX_SERIES or n_samples > _MAX_SAMPLES:
        raise WireError("frame header counts out of range")
    want = (
        _HEADER
        + 8 * n_samples  # times
        + 8 * n_series  # starts
        + 4 * n_samples  # values
        + 4 * n_series  # counts
        + 4 * (n_series + 1)  # key_offs
        + blob_len
    )
    if want != frame_len:
        raise WireError(
            f"frame sections need {want} bytes but header declares {frame_len}"
        )
    off = _HEADER
    times = np.frombuffer(buf, np.int64, n_samples, off)
    off += times.nbytes
    starts = np.frombuffer(buf, np.float64, n_series, off)
    off += starts.nbytes
    values = np.frombuffer(buf, np.float32, n_samples, off)
    off += values.nbytes
    counts = np.frombuffer(buf, np.uint32, n_series, off)
    off += counts.nbytes
    key_offs = np.frombuffer(buf, np.uint32, n_series + 1, off)
    off += key_offs.nbytes
    blob = buf[off : off + blob_len]
    if int(counts.sum()) != n_samples:
        raise WireError("per-series counts do not sum to n_samples")
    if key_offs[0] != 0 or int(key_offs[-1]) != blob_len:
        raise WireError("key offsets do not span the key blob")
    if n_series and bool(np.any(np.diff(key_offs.astype(np.int64)) < 0)):
        raise WireError("key offsets must be non-decreasing")
    if n_samples and not bool(np.isfinite(values).all()):
        raise WireError("non-finite sample value (NaN/Inf) in frame")
    bounds = np.cumsum(counts.astype(np.int64))
    if n_samples > 1:
        order_ok = np.diff(times) >= 0
        # series boundaries: time may legitimately reset between series
        order_ok[bounds[:-1][bounds[:-1] < n_samples] - 1] = True
        if not bool(order_ok.all()):
            raise WireError(
                "out-of-order timestamps within a series (binary frames "
                "must be time-sorted; use the JSON codec for unsorted pushes)"
            )
    out = []
    lo = 0
    for i in range(n_series):
        hi = int(bounds[i])
        raw = blob[int(key_offs[i]) : int(key_offs[i + 1])]
        key = intern.get(raw) if intern is not None else None
        if key is None:
            try:
                key = raw.decode("utf-8")
            except UnicodeDecodeError:
                raise WireError("series key is not valid utf-8") from None
            if canonicalize:
                key = canonical_series(key)
            if intern is not None and len(intern) < 65536:
                intern[raw] = key
        s = float(starts[i])
        out.append((key, times[lo:hi], values[lo:hi], None if s != s else s))
        lo = hi
    return out


# --------------------------------------------------------------------------
# Pure-python snappy block format (https://github.com/google/snappy —
# format_description.txt). Enough for wire compatibility with real
# remote-write pushers; the uncompressed binary frame is the fast path.


def _uvarint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise WireError("truncated snappy length varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 35:
            raise WireError("snappy length varint too long")


def snappy_uncompressed_len(buf: bytes) -> int:
    """Declared uncompressed size from the stream preamble — the snappy
    bomb guard checks THIS against the decoded-bytes cap before any
    decompression work happens."""
    n, _ = _uvarint(buf, 0)
    return n


def snappy_decompress(buf: bytes, max_len: int | None = None) -> bytes:
    """Decode a snappy block-format stream. Raises WireError on any
    malformed input (bad preamble, copy before start, overrun, short
    stream) and when the declared length exceeds ``max_len``."""
    declared, pos = _uvarint(buf, 0)
    if max_len is not None and declared > max_len:
        raise WireError(
            f"snappy stream declares {declared} bytes > cap {max_len}"
        )
    out = bytearray()
    n = len(buf)
    while pos < n:
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                nbytes = length - 60
                if pos + nbytes > n:
                    raise WireError("truncated snappy literal length")
                length = (
                    int.from_bytes(buf[pos : pos + nbytes], "little") + 1
                )
                pos += nbytes
            if pos + length > n:
                raise WireError("truncated snappy literal")
            out += buf[pos : pos + length]
            pos += length
        else:  # copy
            if kind == 1:
                if pos >= n:
                    raise WireError("truncated snappy copy-1")
                length = ((tag >> 2) & 0x7) + 4
                offset = ((tag >> 5) << 8) | buf[pos]
                pos += 1
            elif kind == 2:
                if pos + 2 > n:
                    raise WireError("truncated snappy copy-2")
                length = (tag >> 2) + 1
                offset = int.from_bytes(buf[pos : pos + 2], "little")
                pos += 2
            else:
                if pos + 4 > n:
                    raise WireError("truncated snappy copy-4")
                length = (tag >> 2) + 1
                offset = int.from_bytes(buf[pos : pos + 4], "little")
                pos += 4
            if offset == 0 or offset > len(out):
                raise WireError("snappy copy reaches before stream start")
            if len(out) + length > declared:
                raise WireError("snappy output overruns declared length")
            if offset >= length:
                start = len(out) - offset
                out += out[start : start + length]
            else:  # overlapping copy: byte-wise RLE semantics
                start = len(out) - offset
                for i in range(length):
                    out.append(out[start + i])
        if len(out) > declared:
            raise WireError("snappy output overruns declared length")
    if len(out) != declared:
        raise WireError(
            f"snappy stream declares {declared} bytes, decoded {len(out)}"
        )
    return bytes(out)


def snappy_compress(data: bytes) -> bytes:
    """Encode ``data`` as a valid snappy block-format stream of literals.
    No match search — the uncompressed binary frame is the wire-speed
    path; this exists so `Content-Encoding: snappy` round-trips without a
    native wheel. Any conformant decoder (including real snappy) reads it."""
    out = bytearray()
    n = len(data)
    shift = n
    while True:
        b = shift & 0x7F
        shift >>= 7
        if shift:
            out.append(b | 0x80)
        else:
            out.append(b)
            break
    pos = 0
    while pos < n:
        chunk = min(n - pos, 1 << 16)
        if chunk <= 60:
            out.append((chunk - 1) << 2)
        else:
            enc = (chunk - 1).to_bytes(4, "little").rstrip(b"\x00") or b"\x00"
            out.append((59 + len(enc)) << 2)
            out += enc
        out += data[pos : pos + chunk]
        pos += chunk
    return bytes(out)


def _qs_float(qs: dict, name: str) -> float | None:
    raw = qs.get(name, [None])[0]
    if raw in (None, ""):
        return None
    try:
        return float(raw)
    except ValueError:
        from foremast_tpu_torch.jobs.store import parse_time

        t = parse_time(raw)  # Prometheus accepts RFC3339 too
        return t if t > 0 else None


def resolve_query_range(
    url: str,
) -> tuple[str | None, float | None, float | None, float]:
    """Document URL → ``(key, start, end, step)``; key None when the URL
    carries no recognizable query (the source then bypasses the ring).
    Both the Prometheus `query_range?query=...&start=&end=&step=` shape
    and the wavefront `<query>&&<start>&&<unit>&&<end>` shape resolve."""
    if "&&" in url and "query_range" not in url:
        parts = url.split("&&")
        if len(parts) >= 4:
            key = canonical_series(urllib.parse.unquote(parts[0]))

            def _f(raw):
                try:
                    return float(raw)
                except ValueError:
                    return None

            # the inverse of promql.wavefront_url's granularity map
            step = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}.get(
                parts[2], 60.0
            )
            return key or None, _f(parts[1]), _f(parts[3]), step
        return None, None, None, 60.0
    try:
        qs = urllib.parse.parse_qs(urllib.parse.urlparse(url).query)
    except ValueError:
        return None, None, None, 60.0
    raw_q = qs.get("query", [None])[0] or qs.get("q", [None])[0]
    if not raw_q:
        return None, None, None, 60.0
    step = _qs_float(qs, "step") or 60.0
    return (
        canonical_series(raw_q),
        _qs_float(qs, "start"),
        _qs_float(qs, "end"),
        step,
    )
