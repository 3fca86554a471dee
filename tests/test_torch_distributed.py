"""Pod mode's pieces in one process (`foremast_tpu_torch/parallel/
distributed.py`, `parallel/mesh.py`'s pod half): what needs no peer.

With one process `broadcast_obj` makes no collective and `is_leader` is
true; `init_distributed` is a no-op without the JAX_* rendezvous (the
counterpart of `tests/test_parallel.py::test_init_distributed_single_host_noop`);
the leader adapters forward the mesh-of-pods claim filter
(`tests/test_parallel.py::test_leader_store_claim_filter_passthrough`),
carry a claim failure's transience and a fetch failure across the
broadcast as markers, and answer `count_open` without a collective; the
watchdog raises `PodCollectiveTimeout` on a collective that never
returns. A pod's block ownership and row slicing are checked on a
layout built by hand; the multi-process behaviour is in
`tests/test_torch_multihost.py` and `tests/test_torch_pod_failure.py`."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from foremast_tpu_torch.jobs.models import Document
from foremast_tpu_torch.jobs.store import InMemoryStore
from foremast_tpu_torch.parallel import distributed as D
from foremast_tpu_torch.parallel import mesh as meshlib


def _docs(store, n=4):
    for i in range(n):
        store.create(
            Document(
                id=f"j{i}", app_name=f"app{i}", end_time="2999-01-01T00:00:00Z",
                current_config="m== http://x", historical_config="", strategy="continuous",
            )
        )


def test_single_process_broadcast_is_the_object_and_makes_no_collective():
    before = dict(D.BROADCASTS)
    obj = {"a": np.arange(3)}
    assert D.is_leader() is True
    assert D.broadcast_obj(obj) is obj
    assert D.broadcast_obj() is None
    assert D.BROADCASTS == before


def test_init_distributed_single_host_noop(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert meshlib.init_distributed() is False
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    assert meshlib.init_distributed() is False
    assert meshlib.process_count() == 1 and meshlib.process_index() == 0
    assert not torch.distributed.is_initialized()


def test_init_distributed_needs_the_whole_rendezvous(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="JAX_PROCESS_ID"):
        meshlib.init_distributed()
    assert not torch.distributed.is_initialized()


def test_leader_store_claim_filter_passthrough():
    """The mesh-of-pods seam: LeaderStore.claim forwards the leader's
    worker-mesh claim filter to the real store, so the filtered claim set
    is what broadcasts to followers."""
    inner = InMemoryStore()
    _docs(inner)
    store = D.LeaderStore(inner)
    got = store.claim("w0", 90.0, limit=16, claim_filter=lambda d: d.app_name in ("app1", "app3"))
    assert sorted(d.id for d in got) == ["j1", "j3"]
    rest = store.claim("w0", 90.0, limit=16)
    assert sorted(d.id for d in rest) == ["j0", "j2"]


class _FailingStore(InMemoryStore):
    def __init__(self, exc):
        super().__init__()
        self.exc = exc

    def claim(self, *a, **kw):
        raise self.exc


@pytest.mark.parametrize(
    "exc,raised",
    [(ConnectionError("store down"), ConnectionError), (ValueError("bad query"), RuntimeError)],
    ids=["transient", "permanent"],
)
def test_claim_error_crosses_with_its_transience(exc, raised):
    """A leader's claim failure travels as a `_ClaimError` marker and is
    raised again after the broadcast: a transient one as ConnectionError
    (the worker degrades it to an empty tick), any other as RuntimeError."""
    store = D.LeaderStore(_FailingStore(exc))
    with pytest.raises(raised, match=type(exc).__name__):
        store.claim("w0", 90.0, limit=4)
    marker = D._ClaimError("x", True)
    assert marker.transient and marker.msg == "x"


def test_fetch_error_crosses_as_a_marker():
    class Broken:
        def fetch(self, url):
            raise KeyError(url)

    src = D.LeaderSource(Broken())
    assert D.LeaderSource.concurrent_fetch is False
    with pytest.raises(RuntimeError, match="KeyError"):
        src.fetch("http://prom/cur?q=a")
    assert D._FetchError("m").msg == "m"


def test_leader_adapters_need_the_real_store_and_answer_count_open_locally(monkeypatch):
    with pytest.raises(ValueError, match="process 0"):
        D.LeaderStore(None)
    with pytest.raises(ValueError, match="process 0"):
        D.LeaderSource(None)
    inner = InMemoryStore()
    _docs(inner, 3)
    store = D.LeaderStore(inner)

    def no_collective(*a, **kw):
        raise AssertionError("count_open entered a collective")

    monkeypatch.setattr(D, "broadcast_obj", no_collective)
    assert store.count_open() == 3
    # a follower holds no queue and answers 0, again without a collective
    monkeypatch.setattr(D, "is_leader", lambda: False)
    assert D.LeaderStore(None).count_open() == 0


def test_pod_timeout_knob(monkeypatch):
    monkeypatch.delenv("FOREMAST_POD_TIMEOUT_SECONDS", raising=False)
    assert D._pod_timeout_seconds() == 300.0
    assert D.collective_timeout().total_seconds() == 600.0
    monkeypatch.setenv("FOREMAST_POD_TIMEOUT_SECONDS", "0")
    assert D._pod_timeout_seconds() is None
    assert D.collective_timeout().total_seconds() == 1800.0
    monkeypatch.setenv("FOREMAST_POD_TIMEOUT_SECONDS", "10")
    assert D._pod_timeout_seconds() == 10.0
    assert D.collective_timeout().total_seconds() == 60.0
    monkeypatch.setenv("FOREMAST_POD_TIMEOUT_SECONDS", "soon")
    assert D._pod_timeout_seconds() == 300.0


def test_watchdog_raises_on_a_collective_that_never_returns(monkeypatch):
    """A broadcast stuck in its collective (a dead peer) makes the caller
    raise PodCollectiveTimeout after the budget, from the one persistent
    broadcast thread; the next call still queues behind it."""
    gate = threading.Event()
    calls = []

    def stuck(obj=None):
        calls.append(obj)
        gate.wait(30)
        return obj

    monkeypatch.setattr(D, "_broadcast_raw", stuck)
    monkeypatch.setattr(D, "process_count", lambda: 2)
    monkeypatch.setenv("FOREMAST_POD_TIMEOUT_SECONDS", "0.3")
    monkeypatch.setattr(D, "_broadcast_worker", None)
    t0 = time.monotonic()
    with pytest.raises(D.PodCollectiveTimeout, match="dead or wedged"):
        D.broadcast_obj("clock")
    assert 0.25 <= time.monotonic() - t0 < 5
    worker = D._broadcast_worker
    assert worker is not None and worker._thread.daemon and worker._thread.name == "foremast-pod-broadcast"
    gate.set()  # the wedged collective returns; the thread serves the next call
    assert D.broadcast_obj("next") == "next"
    assert calls == ["clock", "next"]


def test_watchdog_reraises_the_collective_s_error(monkeypatch):
    def broken(obj=None):
        raise RuntimeError("Connection closed by peer")

    monkeypatch.setattr(D, "_broadcast_raw", broken)
    monkeypatch.setattr(D, "process_count", lambda: 2)
    monkeypatch.setenv("FOREMAST_POD_TIMEOUT_SECONDS", "5")
    monkeypatch.setattr(D, "_broadcast_worker", None)
    # a dead peer's collective error is not a document's failure: it
    # escapes every `except Exception` of the worker
    with pytest.raises(meshlib.PodCollectiveError, match="closed by peer") as caught:
        D.broadcast_obj(1)
    assert not isinstance(caught.value, Exception)
    assert issubclass(D.PodCollectiveTimeout, meshlib.PodCollectiveError)


def _pod(rank: int, owners) -> meshlib.Pod:
    return meshlib.Pod(rank, max(owners) + 1, owners, "gloo", None, "the devices are on the CPU")


def test_pod_owners_and_local_rows():
    pod = _pod(1, [0, 0, 1, 1])
    assert (pod.first, pod.n_local, pod.n_data) == (2, 2, 4)
    assert [pod.owner(b) for b in range(4)] == [0, 0, 1, 1]
    assert pod.local_rows(np.arange(8)).tolist() == [4, 5, 6, 7]
    assert pod.local_rows(torch.arange(4)).tolist() == [2, 3]
    fill = pod.local_rows(meshlib.Fill((8, 3), 0.0, torch.float32))
    assert isinstance(fill, meshlib.Fill) and fill.shape == (4, 3)
    with pytest.raises(ValueError, match="pod's data axis"):
        pod.local_rows(np.arange(6))


def test_a_pod_mesh_places_and_judges_only_its_own_blocks():
    """shard_leading over a pod's mesh keeps this rank's rows; a
    ShardedJudge over it pads batches to the whole pod's data axis,
    asserts its own blocks, and keeps replicated arenas."""
    from foremast_tpu_torch.parallel.batch import ShardedJudge

    mesh = meshlib.Mesh([["cpu"], ["cpu"]], pod=_pod(1, [0, 0, 1, 1]))
    assert mesh.shape == {"data": 4, "model": 1} and mesh.size == 4 and len(mesh.data_devices) == 2
    placed = meshlib.shard_leading(np.arange(8, dtype=np.float32), mesh)
    assert [p.tolist() for p in placed.parts] == [[4.0, 5.0], [6.0, 7.0]]
    judge = ShardedJudge(mesh=mesh)
    assert (judge.n_data, judge.n_local) == (4, 2)
    assert judge._batch_multiple() == 4 and judge._arena_shards() == 1
    judge._place_cols(np.zeros(8, np.float32))
    assert judge.mesh_stats["place_calls"] == 1
    assert judge.mesh_debug()["pod"] == {"rank": 1, "processes": 2, "blocks": [2, 3], "gather_backend": "gloo"}


def test_pod_worker_in_one_process_is_a_brain_worker():
    """A PodWorker of one process (every broadcast the object itself)
    judges like a BrainWorker, runs unbudgeted and unsliced, and its run
    loop stops on the leader's stop()."""
    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.jobs import BrainWorker
    from tests.torch_workers import port_store, PortArraySource, statuses
    from benchmarks.worker_bench import build_fleet

    jstore, jsource = build_fleet(4, 128, 16, 1_760_000_000.0)
    cfg = BrainConfig(algorithm="moving_average_all")
    pod = D.PodWorker(D.LeaderStore(port_store(jstore)), D.LeaderSource(PortArraySource(jsource.data)), config=cfg,
                      device="cpu", claim_limit=4)
    assert pod.sweep_slice_docs == 0 and pod._degrade.tick_budget_seconds == 0.0
    assert pod.judge.univariate.mesh.shape == {"data": 1, "model": 1}
    ref_store = port_store(jstore)
    ref = BrainWorker(ref_store, PortArraySource(jsource.data), config=cfg, device="cpu", claim_limit=4,
                      device_mesh=None)
    assert pod.tick(now=1_760_000_150.0) == ref.tick(now=1_760_000_150.0) == 4
    assert statuses(pod.store.inner) == statuses(ref_store)
    stops = iter([False, True])
    ticks = []
    pod.tick = lambda now=None: ticks.append(now) or 0
    pod.run(poll_seconds=0.0, stop=lambda: next(stops))
    assert ticks == [None]
