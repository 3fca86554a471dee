#!/usr/bin/env python3
"""Restart the port's ingest CLI worker several times under one snapshot
root, and report how warm each restart's first judging tick was.

    JAX_PLATFORMS=cpu python3 tools/ingest_restart_repro.py [--rounds 3]

Each round is the flow of `tests/test_torch_cli_worker.py::
test_ingest_worker_judges_pushed_samples_with_no_prometheus_get` on the
CPU: a `FOREMAST_INGEST=1` worker takes the fleet's samples as one FMW1
push and judges the fleet, stops on SIGTERM, and restarts on the same
`FOREMAST_SNAPSHOT_DIR` to judge the reset fleet. Every round uses the
same fleet (one fake Prometheus for all rounds, so the documents and
their fit keys are the same) and the same directory. For each start it
prints whether the writes equal the JAX worker's, the requests that
reached Prometheus, the first judging tick's docs and warm (fast-path)
docs, and the restore lines (the journal's restored fit counts). A cold
doc after a restart is then either a fit key missing from the restored
journal (fewer fits restored than the fleet has) or a failed admission
(the fits restored, the doc judged cold all the same)."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _records(err: str) -> list[dict]:
    out = []
    for ln in err.splitlines():
        if ln.startswith("{"):
            try:
                out.append(json.loads(ln))
            except ValueError:
                pass
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--root", default=None, help="the snapshot root (default: a new temporary directory)")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from tests.test_torch_cli_worker import _free_port, _judged, _push_frame, _pushed_fleet, _start, _stop
    from tests.torch_fake_services import FakeElasticsearch, FakePrometheus, serve_fake_es, serve_fake_prometheus

    root = args.root or tempfile.mkdtemp(prefix="foremast-restart-")
    prom = FakePrometheus()
    prom_srv, prom_url = serve_fake_prometheus(prom)
    docs, entries, keyed, want = _pushed_fleet(prom_url)
    prom.data = keyed
    cold_after_restart = 0
    try:
        for rnd in range(1, args.rounds + 1):
            es_srv, es, es_url = serve_fake_es(FakeElasticsearch())
            port = _free_port()
            cli = ["--device", "cpu", "--elastic-url", es_url, "--gauge-port", "0", "--poll", "0.2"]
            env = {"FOREMAST_SNAPSHOT_DIR": os.path.join(root, "snap"), "FOREMAST_INGEST": "1",
                   "FOREMAST_INGEST_PORT": str(port),
                   "FOREMAST_SNAPSHOT_MAX_AGE_SECONDS": str(10 * 365 * 86_400)}
            try:
                for start in ("first", "restart"):
                    proc = _start(cli, env)
                    if start == "first":
                        _push_frame(port, entries, time.monotonic() + 60)
                        es.load(docs)
                    else:
                        es.set_status("preprocess_completed")
                    got = _judged(es, time.monotonic() + 60, proc)
                    rc, _, err = _stop(proc)
                    tick = next((r for r in _records(err) if r.get("msg") == "tick complete" and r.get("docs")), {})
                    restored = [ln for ln in err.splitlines() if ln.startswith("restored")]
                    if start == "restart":
                        cold_after_restart += tick.get("docs", 0) - tick.get("fast_path", 0)
                    print(f"round {rnd} {start}: exit {rc}; writes equal the JAX worker's: {got == want}; "
                          f"Prometheus requests {sum(prom.requests.values())}; first judging tick: "
                          f"{tick.get('docs')} docs, {tick.get('fast_path')} warm; {restored}")
            finally:
                es_srv.shutdown()
                es_srv.server_close()
    finally:
        prom_srv.shutdown()
        prom_srv.server_close()
    print(f"cold docs in the restarts' first ticks: {cold_after_restart}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
