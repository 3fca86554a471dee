"""The port's device-mesh worker against the JAX package's (CPU), held to
tests/test_device_mesh_parity.py.

The same seeded 13-service mixed fleet (not a multiple of 8, so every
sharded dispatch pads; bivariate, LSTM-hybrid and single-alias docs under
`auto`) runs through:

  * the JAX worker over its 8-device virtual CPU mesh (conftest), with the
    data-axis-sharded arena;
  * the port's worker over `["cpu"] * 8`, sharded (the default) and
    replicated (`FOREMAST_ARENA_SHARDED=0`), and the port's single-device
    worker.

Every worker runs a cold tick (object path), then a warm tick with a
joint doc and a univariate doc spiked (columnar paths), then a quiet warm
tick. The three port workers must write byte-identical statuses, anomaly
payloads, hook bands and fit-key sets (pad keys aside: the sharded arena
pins one pad row per shard). Against the JAX worker: statuses exact,
hook verdicts and pairs exact and bands within the port's tolerance, the
same fit-key sets, and the sharded univariate arena's row maps,
migrations and evictions equal to JAX's. The LSTM-AE entries the JAX
worker trains are carried into each port worker's joint cache, as in
tests/test_torch_joint_worker.py.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from benchmarks.worker_bench import build_mixed_fleet
from foremast_tpu.config import BrainConfig as JaxConfig
from foremast_tpu.jobs import BrainWorker as JaxWorker
from foremast_tpu.models.cache import is_pad_fit_key as jax_is_pad
from foremast_tpu.parallel.mesh import make_mesh as jax_make_mesh
from foremast_tpu_torch.config import BrainConfig
from foremast_tpu_torch.interop import joint_entry_from_numpy
from foremast_tpu_torch.jobs import BrainWorker
from foremast_tpu_torch.models.cache import is_pad_fit_key
from foremast_tpu_torch.parallel import Blocks, make_mesh
from tests.torch_workers import PortArraySource, assert_same_hook_records, hook_recorder, port_store, statuses

NOW = 1_760_000_000.0
SERVICES = 13  # not a multiple of 8: every sharded dispatch pads
HIST_LEN = 256
CUR_LEN = 30
STEPS = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _monolithic(monkeypatch):
    monkeypatch.setenv("FOREMAST_SWEEP_SLICE_DOCS", "0")


def _cfg(cls, **kw):
    cfg = cls(algorithm="auto", season_steps=24, max_cache_size=4 * SERVICES + 64, **kw)
    return dataclasses.replace(cfg, anomaly=dataclasses.replace(cfg.anomaly, threshold=4.0))


def _spike(source) -> None:
    """A joint service's every metric +0.6 on its last 3 points, and one
    univariate series to 40 there."""
    joint = next(d for d in source.docs if d.current_config.count("==") >= 2)
    sid, f = joint.app_name.replace("app", ""), joint.current_config.count("==")
    for m in range(f):
        url = f"http://prom/cur?q=m{m}:app{sid}&step=60"
        ct, cv = source.data[url]
        s = cv.copy()
        s[-3:] += 0.6
        source.data[url] = (ct, s)
    url = next(u for u in source.data if "cur" in u and ":app0&" in u)
    ct, cv = source.data[url]
    s = cv.copy()
    s[-3:] = 40.0
    source.data[url] = (ct, s)


class _Fleet:
    """The seeded fleet: the JAX store/source and the docs to spike by."""

    def __init__(self):
        self.store, self.source, _ = build_mixed_fleet(SERVICES, HIST_LEN, CUR_LEN, NOW, joint_frac=0.17)
        self.source.docs = list(self.store._docs.values())


def _carry_lstm(jw, pw) -> None:
    for key, entry in jw._mvj.cache.snapshot().items():
        if key[0] == "lstm":
            pw._mvj.cache.put(key, joint_entry_from_numpy(jax.tree.map(np.asarray, entry)))


def _fit_keys(worker, pad) -> tuple:
    return (
        sorted(repr(k) for k in worker._fit_cache._d if not pad(k)),
        sorted(repr(k) for k in worker.judge.cache._d if not pad(k)),
    )


def _hex_records(records) -> list:
    return sorted(
        (r[0], r[1], r[2], r[3], r[4].tobytes().hex(), r[5].tobytes().hex(), r[6], r[7]) for r in records
    )


@pytest.fixture(scope="module")
def runs():
    """Every worker through the three ticks: name -> (statuses per tick,
    hook records, fit keys, worker)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("FOREMAST_SWEEP_SLICE_DOCS", "0")
    out = {}
    try:
        mp.setenv("FOREMAST_ARENA_SHARDED", "1")
        jfleet = _Fleet()
        jrec: list = []
        jw = JaxWorker(
            jfleet.store, jfleet.source, config=_cfg(JaxConfig), claim_limit=2 * SERVICES, worker_id="w",
            on_verdict=hook_recorder(jrec), device_mesh=jax_make_mesh(n_data=8),
        )
        jw.judge.lstm_steps = STEPS
        port = {}
        for name, mesh, sharded in (
            ("sharded", make_mesh(n_data=8, devices=["cpu"] * 8), "1"),
            ("replicated", make_mesh(n_data=8, devices=["cpu"] * 8), "0"),
            ("single", None, "1"),
        ):
            mp.setenv("FOREMAST_ARENA_SHARDED", sharded)
            fleet = _Fleet()
            store, source = port_store(fleet.store), PortArraySource(fleet.source.data)
            source.docs = fleet.source.docs
            rec: list = []
            w = BrainWorker(
                store, source, config=_cfg(BrainConfig), device="cpu", claim_limit=2 * SERVICES,
                worker_id="w", on_verdict=hook_recorder(rec), device_mesh=mesh,
            )
            w.judge.lstm_steps = STEPS
            port[name] = (w, store, source, rec)
        ticks = {name: [] for name in (*port, "jax")}
        for t, spike in ((NOW + 150, False), (NOW + 210, True), (NOW + 270, False)):
            if spike:
                _spike(jfleet.source)
                for w, _, source, _ in port.values():
                    _spike(source)
            # an unhealthy doc is done after the spike: later ticks claim fewer
            n = jw.tick(now=t)
            assert n > 0
            ticks["jax"].append(statuses(jfleet.store))
            for name, (w, store, _, _) in port.items():
                if t == NOW + 150:
                    _carry_lstm(jw, w)
                assert w.tick(now=t) == n
                ticks[name].append(statuses(store))
        out["jax"] = (ticks["jax"], jrec, _fit_keys(jw, jax_is_pad), jw)
        for name, (w, _, _, rec) in port.items():
            out[name] = (ticks[name], rec, _fit_keys(w, is_pad_fit_key), w)
    finally:
        mp.undo()
    return out


def test_port_mesh_workers_write_identical_bytes(runs):
    """Sharded, replicated and single-device port workers: byte-identical
    statuses, anomaly payloads, hook verdicts and bands, fit-key sets."""
    s_ticks, s_rec, s_keys, _ = runs["sharded"]
    for name in ("replicated", "single"):
        ticks, rec, keys, _ = runs[name]
        assert ticks == s_ticks, name
        assert _hex_records(rec) == _hex_records(s_rec), name
        assert keys == s_keys, name
    assert any(st[0] == "completed_unhealth" for st in s_ticks[1].values())


def test_port_mesh_worker_matches_jax_mesh_worker(runs):
    """The port's sharded worker over ["cpu"] * 8 against the JAX worker
    over its 8-device mesh: statuses exact, hook records (bands within
    tolerance), fit-key sets, and the fast-path doc counts."""
    p_ticks, p_rec, p_keys, pw = runs["sharded"]
    j_ticks, j_rec, j_keys, jw = runs["jax"]
    assert p_ticks == j_ticks
    assert_same_hook_records(p_rec, j_rec)
    assert p_keys == j_keys
    assert pw._fast_kinds == jw._fast_kinds
    assert pw._fast_kinds["univariate"] > 0 and pw._fast_kinds["bivariate"] + pw._fast_kinds["lstm"] > 0


def test_sharded_arena_row_maps_equal_jax(runs):
    """The sharded univariate arena's row maps, migrations, evictions and
    counters equal the JAX sharded arena's after the same ticks."""
    pw, jw = runs["sharded"][3], runs["jax"][3]
    assert pw._uni._arenas.keys() == jw._uni._arenas.keys()
    for key, arena in pw._uni._arenas.items():
        ref = jw._uni._arenas[key]
        assert (arena.shards, arena.cap, arena.cap_s) == (ref.shards, ref.cap, ref.cap_s)
        assert arena.rows == ref.rows
        assert arena.row_key == ref.row_key
        assert arena.counters() == ref.counters()
    assert pw._uni.device_state_counters() == jw._uni.device_state_counters()
    assert pw._mvj.joint_state_counters() == jw._mvj.joint_state_counters()


def test_mesh_worker_partitions_and_reports(runs):
    """The sharded worker placed and partitioned (the in-run assert of
    every placement ran), padded, and reports the mesh; every arena leaf
    is 8 blocks of capacity/8 rows; the replicated arm holds a whole
    replica per device; the single worker has no mesh section. The eight
    blocks all lie on the CPU here, so each leaf is one buffer of the
    eight [capacity/8] shard blocks, shared by the eight blocks."""
    sw, rw, pw = runs["sharded"][3], runs["replicated"][3], runs["single"][3]
    dm = sw.debug_state()["device_mesh"]
    assert dm["devices"] == 8 and dm["shape"] == {"data": 8, "model": 1}
    assert dm["place_calls"] > 0 and dm["pad_rows_total"] > 0 and dm["fetch_bytes"] > 0
    assert dm["arena_layout"] == "sharded" and dm["arena_capacity_rows"] > 0
    assert dm["arena_total_device_bytes"] == 8 * dm["arena_replica_bytes"]
    rdm = rw.debug_state()["device_mesh"]
    assert rdm["arena_layout"] == "replicated"
    # the eight blocks lie on one device, which holds one replica
    assert rdm["arena_total_device_bytes"] == rdm["arena_replica_bytes"] > 0
    assert pw.debug_state()["device_mesh"] is None
    arenas = list(sw._uni._arenas.values()) + list(sw._mvj._joint_arenas.values())
    assert len(arenas) >= 2
    from foremast_tpu_torch.parallel.mesh import tree_leaves

    for a in arenas:
        assert a.shards == 8 and a.cap == 8 * a.cap_s
        for leaf in tree_leaves(a.state):
            assert isinstance(leaf, Blocks) and not leaf.replicated and len(leaf.parts) == 8
            assert all(p is leaf.parts[0] for p in leaf.parts) and leaf.parts[0].shape[0] == 8 * a.cap_s
    for a in list(rw._uni._arenas.values()) + list(rw._mvj._joint_arenas.values()):
        assert a.shards == 1
        for leaf in tree_leaves(a.state):
            assert leaf.replicated and all(p is leaf.parts[0] for p in leaf.parts) and leaf.parts[0].shape[0] == a.cap
