"""Pod mode when the LEADER dies mid-tick: the port's counterpart of
`tests/test_pod_failure.py::test_leader_death_mid_tick_fails_fast_and_recovers`.

Two ranks tick over a fleet whose documents live in a fake
Elasticsearch behind a real HTTP socket (`tests/torch_fake_services.py`),
so the store outlives the pod. The leader claims (the documents are
parked `preprocess_inprogress` on the store) and then calls `os._exit`
on its 3rd fetch, before any verdict. The follower must fail fast: its
next collective errors out or the watchdog (`FOREMAST_POD_TIMEOUT_SECONDS`)
fires, and it exits nonzero well inside the test's budget. Then a
single-process takeover worker, past `MAX_STUCK_IN_SECONDS`, re-claims
every parked document and judges each exactly once, to the JAX
worker's statuses."""

from __future__ import annotations

import json
import time

from benchmarks.worker_bench import build_fleet
from tests.torch_fake_services import serve_fake_es
from tests.torch_pod import LOAD_FLEET, ROOT, launch, write_fleet

NOW = 1_760_000_000.0
SERVICES = 4
HIST_LEN = 64
CUR_LEN = 16
POD_TIMEOUT = 20

_CHILD = (
    """
import os, sys
sys.path.insert(0, {root!r})
"""
    + LOAD_FLEET
    + """
from foremast_tpu_torch.config import BrainConfig
from foremast_tpu_torch.jobs.store import ElasticsearchStore
from foremast_tpu_torch.parallel import LeaderSource, LeaderStore, PodWorker, init_distributed

addr, rank, fleet_path, es_url = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
assert init_distributed() is True
leader = rank == 0
if leader:
    _, source_in, _ = load_fleet(fleet_path)

    class DyingSource(FleetSource):
        # the LEADER PROCESS DIES on the 3rd fetch of the tick: after the
        # claim was persisted, before any verdict. os._exit: a crash, not
        # an exception (no cleanup, no error marker broadcast)
        calls = 0

        def fetch(self, url):
            DyingSource.calls += 1
            if DyingSource.calls >= 3:
                os._exit(17)
            return super().fetch(url)

    store_in = ElasticsearchStore(es_url)
    source = LeaderSource(DyingSource(source_in.data))
else:
    store_in = None
    source = LeaderSource(None)
cfg = BrainConfig(algorithm="moving_average_all", max_stuck_seconds=90.0)
worker = PodWorker(LeaderStore(store_in), source, config=cfg, device="cpu", claim_limit={services},
                   worker_id=f"pod-{{rank}}")
print(f"rank {{rank}} ticking", flush=True)
worker.tick(now={now!r} + 150)  # the leader dies inside; the follower must raise
print(f"rank {{rank}} SURVIVED", flush=True)  # reachable only on a bug
"""
)


def _reference() -> dict:
    from foremast_tpu.config import BrainConfig
    from foremast_tpu.jobs.worker import BrainWorker

    store, source = build_fleet(SERVICES, HIST_LEN, CUR_LEN, NOW)
    ref = BrainWorker(store, source, config=BrainConfig(algorithm="moving_average_all"), claim_limit=SERVICES,
                      worker_id="ref", device_mesh=None)
    assert ref.tick(now=NOW + 7200) == SERVICES
    return {d.id: (d.status, json.dumps(d.anomaly_info, sort_keys=True)) for d in store._docs.values()}


def test_leader_death_mid_tick_fails_fast_and_recovers(tmp_path):
    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.jobs import BrainWorker
    from foremast_tpu_torch.jobs.models import STATUS_PREPROCESS_INPROGRESS, TERMINAL_STATUSES
    from foremast_tpu_torch.jobs.store import ElasticsearchStore
    from tests.torch_workers import PortArraySource

    srv, es, url = serve_fake_es()
    try:
        ElasticsearchStore(url).ensure_index()
        store, source = build_fleet(SERVICES, HIST_LEN, CUR_LEN, NOW)
        es.load([d.to_json() for d in store._docs.values()])
        fleet = tmp_path / "fleet.pkl"
        write_fleet(fleet, store, source)
        child = tmp_path / "pod_child.py"
        child.write_text(_CHILD.format(root=str(ROOT), now=NOW, services=SERVICES))
        t0 = time.monotonic()
        procs, outs = launch(child, [fleet, url], timeout=150,
                             env_of=lambda rank: {"FOREMAST_POD_TIMEOUT_SECONDS": str(POD_TIMEOUT)})
        elapsed = time.monotonic() - t0

        # the leader crashed with its marker code; the follower FAILED
        # FAST: nonzero, never past the tick, and no hang (the 150 s
        # communicate timeout is the hang detector)
        assert procs[0].returncode == 17, outs[0]
        assert procs[1].returncode not in (0, None), outs[1]
        assert "rank 1 ticking" in outs[1] and "SURVIVED" not in outs[1], outs[1]
        assert elapsed < POD_TIMEOUT + 60, f"the follower took {elapsed:.0f} s"

        # the claim is parked on the store, owned by the dead pod
        parked = [d for d in es.sources().values() if d["status"] == STATUS_PREPROCESS_INPROGRESS]
        assert parked, "the leader died before persisting any claim"

        # a restarted worker (one process: the store contract is the
        # same) takes the parked claims over once they are stale, and
        # judges every document exactly once; `now` past endTime, so every
        # document finalizes on that judgment
        takeover = BrainWorker(
            ElasticsearchStore(url), PortArraySource(source.data),
            config=BrainConfig(algorithm="moving_average_all", max_stuck_seconds=2.0),
            device="cpu", claim_limit=SERVICES, worker_id="takeover",
        )
        writes_before = dict(es.writes)
        total = 0
        deadline = time.monotonic() + 60
        while total < SERVICES and time.monotonic() < deadline:
            time.sleep(1.0)
            total += takeover.tick(now=NOW + 7200)
        assert total == SERVICES, f"the takeover judged {total} of {SERVICES}"
        got = es.sources()
        assert len(got) == SERVICES
        for doc_id, (status, anomaly) in _reference().items():
            rec = got[doc_id]
            assert rec["status"] == status and rec["status"] in TERMINAL_STATUSES, (doc_id, rec["status"], status)
            assert json.dumps(rec.get("anomalyInfo"), sort_keys=True) == anomaly, doc_id
            assert rec["processingContent"] == "takeover"
            # one claim write and one verdict write by the takeover
            assert es.writes[doc_id] - writes_before.get(doc_id, 0) == 2, (doc_id, es.writes[doc_id])
        # a second tick finds nothing claimable: no verdict written twice
        assert takeover.tick(now=NOW + 7300) == 0
    finally:
        srv.shutdown()
        srv.server_close()
