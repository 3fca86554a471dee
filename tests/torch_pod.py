"""Shared launcher of the port's pod-mode tests: N processes of one child
script joined into a gloo process group on the CPU through the JAX_*
rendezvous (`foremast_tpu_torch.parallel.mesh.init_distributed`), each on
a free loopback port, each with its own `communicate(timeout=...)`.

The children import only the port. Fleets go to them as a pickle the
parent writes (documents as JSON, series as numpy arrays)."""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# gloo's TCP transport occasionally corrupts a frame header on a loaded
# host and dies with this invariant: an environment flake inside the
# collective library, retried once on a fresh port
GLOO_FLAKE = "op.preamble.length"

# the knobs a child takes from its parent only when a test sets them
POD_ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "FOREMAST_POD_TIMEOUT_SECONDS",
           "FOREMAST_BF16_DELTA")

# the port's side of a fleet pickle: documents and an exact-URL source
LOAD_FLEET = """
import pickle
from foremast_tpu_torch.jobs import Document, InMemoryStore
from foremast_tpu_torch.metrics.source import MetricSource


class FleetSource(MetricSource):
    concurrent_fetch = False

    def __init__(self, data):
        self.data = data

    def fetch(self, url):
        return self.data[url]


def load_fleet(path):
    with open(path, "rb") as fh:
        fleet = pickle.load(fh)
    store = InMemoryStore()
    for doc in fleet["docs"]:
        store.create(Document.from_json(doc))
    return store, FleetSource(fleet["data"]), fleet
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_fleet(path, store, source, **extra) -> None:
    """Pickle a JAX-package fleet (`benchmarks.worker_bench`) for the
    children: documents as JSON, series as numpy arrays."""
    fleet = {
        "docs": [d.to_json() for d in store._docs.values()],
        "data": {u: (t.copy(), v.copy()) for u, (t, v) in source.data.items()},
        **extra,
    }
    with open(path, "wb") as fh:
        pickle.dump(fleet, fh)


def child_env(addr: str, rank: int, world: int, extra: dict | None = None) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in POD_ENV}
    env.update(
        JAX_COORDINATOR_ADDRESS=addr,
        JAX_NUM_PROCESSES=str(world),
        JAX_PROCESS_ID=str(rank),
        PYTHONPATH=str(ROOT),
        OMP_NUM_THREADS="2",
    )
    env.update(extra or {})
    return env


def launch(script, args, world: int = 2, timeout: float = 150, env_of=None) -> tuple[list, list]:
    """Run `world` ranks of `script` (argv: address, rank, *args); returns
    (processes, combined outputs). `env_of(rank)` adds env to a rank.
    Retries once on the gloo flake."""
    for attempt in range(2):
        addr = f"127.0.0.1:{free_port()}"
        procs = [
            subprocess.Popen(
                [sys.executable, str(script), addr, str(rank), *[str(a) for a in args]],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
                cwd=str(ROOT),
                env=child_env(addr, rank, world, env_of(rank) if env_of else None),
            )
            for rank in range(world)
        ]
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=timeout)
                outs.append(out)
        finally:
            # a child hung at the rendezvous (its peer crashed) must not leak
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        flaked = any(p.returncode != 0 for p in procs) and any(GLOO_FLAKE in o for o in outs)
        if not flaked or attempt:
            return procs, outs
    return procs, outs


def tagged(out: str, tag: str) -> str:
    """The rest of the first line of `out` that starts with `tag `."""
    return next(line for line in out.splitlines() if line.startswith(tag + " "))[len(tag) + 1 :]
