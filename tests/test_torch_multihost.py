"""Pod mode across real process boundaries, on the CPU over gloo: the
port's counterparts of `tests/test_multihost.py` and
`tests/test_multihost_worker.py`'s pod case.

Two processes join one process group through the JAX_* rendezvous
(`init_distributed`), build the global mesh (4 CPU blocks each, 8 in
all) and reduce across it; then two processes run full PodWorker ticks
(cold, a spike, warm) over a seeded fleet, each rank judging its own
blocks, and the leader's statuses and `anomaly_info` must equal the JAX
single-process worker's, on both cold routes. In the f32 case only the
leader's environment sets FOREMAST_BF16_DELTA=0: the follower takes the
route from the leader's knob broadcast."""

from __future__ import annotations

import json

import pytest

from benchmarks.worker_bench import build_fleet
from tests.torch_pod import LOAD_FLEET, ROOT, launch, tagged, write_fleet

NOW = 1_760_000_000.0
SERVICES = 8
HIST_LEN = 256
CUR_LEN = 30

_MESH_CHILD = """
import sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
from foremast_tpu_torch.parallel import init_distributed, make_global_mesh, per_block, process_count, shard_leading

addr, rank = sys.argv[1], int(sys.argv[2])
assert init_distributed() is True
assert init_distributed() is True  # idempotent over the group it made
assert process_count() == 2
mesh = make_global_mesh(devices=["cpu"] * 4)
assert mesh.shape == {{"data": 8, "model": 1}}, mesh.shape
assert mesh.size == 8 and len(mesh.data_devices) == 4
pod = mesh.pod
assert pod.owners == (0, 0, 0, 0, 1, 1, 1, 1) and pod.first == 4 * rank and pod.n_local == 4
assert [pod.owner(b) for b in (0, 3, 4, 7)] == [0, 0, 1, 1]
assert pod.backend == "gloo", pod.backend
# every rank holds the same global [8] array; each places and sums only
# its own blocks, and the gather brings every block's partial sum back
x = np.repeat(np.array([1.0, 2.0], np.float32), 4)
blocks = shard_leading(x, mesh)
assert len(blocks) == 4 and all(p.shape == (1,) for p in blocks.parts)
assert float(blocks.parts[0][0]) == 1.0 + rank
partial = per_block(lambda a: a.sum().reshape(1), blocks)
mine = torch.cat(list(partial.parts))
every = pod.gather_host(mine)
assert every.tolist() == [1.0] * 4 + [2.0] * 4, every
assert float(every.sum()) == 12.0  # 4 x 1 (rank 0) + 4 x 2 (rank 1)
assert make_global_mesh(n_model=2, devices=["cpu"] * 4).shape == {{"data": 4, "model": 2}}
print(f"rank {{rank}} ok", flush=True)
"""

_POD_CHILD = (
    """
import json, sys, threading
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
"""
    + LOAD_FLEET
    + """
from foremast_tpu_torch.config import BrainConfig
from foremast_tpu_torch.engine import scoring
from foremast_tpu_torch.parallel import (
    LeaderSource, LeaderStore, PodWorker, broadcast_obj, init_distributed, is_leader, make_global_mesh,
)
from foremast_tpu_torch.parallel.mesh import Blocks

addr, rank, fleet_path, f32 = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4] == "f32"
assert init_distributed() is True
leader = is_leader()
assert leader == (rank == 0)
fetch_threads = set()
if leader:
    store_in, source_in, fleet = load_fleet(fleet_path)
    fetch = source_in.fetch
    # every fetch is a collective: only the tick thread may make one (no
    # fetch pool, prefetch or pipeline thread in pod mode)
    source_in.fetch = lambda url: fetch_threads.add(threading.current_thread().name) or fetch(url)
else:
    store_in = source_in = None
cfg = BrainConfig(algorithm="moving_average_all")
bands = {{}}


def on_verdict(doc, verdicts):
    for v in verdicts:
        bands[doc.id + "|" + v.alias] = [float(v.upper[-1]), float(v.lower[-1])]


# the leader alone has a verdict hook (as the CLI's gauges are): the
# follower takes the leader's choice, so both bring bands back
worker = PodWorker(
    LeaderStore(store_in), LeaderSource(source_in), config=cfg, device="cpu",
    device_mesh=make_global_mesh(devices=["cpu"] * 4), claim_limit={services}, worker_id=f"pod-{{rank}}",
    on_verdict=on_verdict if leader else None,
)
assert worker.on_verdict is not None
# the follower's environment leaves FOREMAST_BF16_DELTA unset: its cold
# route is the leader's, by the knob broadcast
assert scoring.bf16_delta_enabled() is (not f32), scoring.bf16_delta_enabled()
assert worker.sweep_slice_docs == 0 and worker._degrade.tick_budget_seconds == 0.0
print("CLOCK " + repr(broadcast_obj(12345.5 if leader else None)), flush=True)
assert worker.tick(now={now!r} + 150) == {services}
if leader:
    # the spike on the leader's source alone: followers see it through
    # the broadcast fetch
    url = next(u for u in source_in.data if "cur" in u and "latency:app3" in u)
    t, v = source_in.data[url]
    v = v.copy()
    v[-3:] = 40.0
    source_in.data[url] = (t, v)
assert worker.tick(now={now!r} + 200) == {services}
uni = worker.judge.univariate
counters = uni.device_state_counters()
assert counters["hits"] > 0, counters  # the warm tick took the columnar path
(arena,) = uni._arenas.values()
state = arena.state[0]
assert isinstance(state, Blocks) and state.replicated and len(state.parts) == 4, state
dm = uni.mesh_debug()
assert dm["pod"] == {{"rank": rank, "processes": 2, "blocks": [4 * rank, 4 * rank + 3], "gather_backend": "gloo"}}
assert dm["gathers"] > 0 and dm["gather_bytes"] > 0 and dm["shape"] == {{"data": 8, "model": 1}}
fits = sorted(str(k) for k in worker._fit_cache.snapshot())
print("FITS " + json.dumps(fits), flush=True)
if leader:
    statuses = {{d.id: [d.status, json.dumps(d.anomaly_info, sort_keys=True)] for d in store_in._docs.values()}}
    print("STATUSES " + json.dumps(statuses, sort_keys=True), flush=True)
    assert len(bands) == 4 * {services}, len(bands)
    assert fetch_threads == {{"MainThread"}}, fetch_threads
print(f"rank {{rank}} ok", flush=True)
"""
)


def _spike(source) -> None:
    url = next(u for u in source.data if "cur" in u and "latency:app3" in u)
    t, v = source.data[url]
    v = v.copy()
    v[-3:] = 40.0
    source.data[url] = (t, v)


def _reference_statuses(f32: bool) -> dict:
    """The JAX single-process worker on the same seeded fleet, the same
    clock and the same cold route."""
    from foremast_tpu.config import BrainConfig
    from foremast_tpu.engine import scoring
    from foremast_tpu.jobs.worker import BrainWorker

    store, source = build_fleet(SERVICES, HIST_LEN, CUR_LEN, NOW)
    scoring.set_bf16_delta(not f32)
    try:
        w = BrainWorker(store, source, config=BrainConfig(algorithm="moving_average_all"), claim_limit=SERVICES,
                        worker_id="ref", device_mesh=None)
        assert w.tick(now=NOW + 150) == SERVICES
        _spike(source)
        assert w.tick(now=NOW + 200) == SERVICES
    finally:
        scoring.set_bf16_delta(None)
    return {d.id: [d.status, json.dumps(d.anomaly_info, sort_keys=True)] for d in store._docs.values()}


def test_two_process_global_mesh(tmp_path):
    child = tmp_path / "mesh_child.py"
    child.write_text(_MESH_CHILD.format(root=str(ROOT)))
    procs, outs = launch(child, [], timeout=120)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"rank {rank} ok" in out


@pytest.mark.parametrize("route", ["bf16", "f32"])
def test_pod_worker_ticks_equal_the_jax_worker(tmp_path, route):
    """Two ranks run full ticks: the leader claims and fetches, the claim
    set, series and clock are broadcast, each rank judges its 4 blocks and
    gathers all 8, and only the leader writes. Its statuses equal the JAX
    worker's; both ranks end with the same fit-cache keys."""
    f32 = route == "f32"
    store, source = build_fleet(SERVICES, HIST_LEN, CUR_LEN, NOW)
    fleet = tmp_path / "fleet.pkl"
    write_fleet(fleet, store, source)
    child = tmp_path / "pod_child.py"
    child.write_text(_POD_CHILD.format(root=str(ROOT), now=NOW, services=SERVICES))
    procs, outs = launch(child, [fleet, route], timeout=180,
                         env_of=lambda rank: {"FOREMAST_BF16_DELTA": "0"} if f32 and rank == 0 else {})
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"rank {rank} ok" in out
    assert tagged(outs[0], "CLOCK") == tagged(outs[1], "CLOCK") == "12345.5"
    assert tagged(outs[0], "FITS") == tagged(outs[1], "FITS")
    assert len(json.loads(tagged(outs[0], "FITS"))) >= 4 * SERVICES
    got = json.loads(tagged(outs[0], "STATUSES"))
    assert "STATUSES" not in outs[1]  # the follower persists nothing
    assert got == _reference_statuses(f32)
    assert got["job-3"][0] == "completed_unhealth"
