"""Fixtures of the harness's own tests. Whether a card is present is
decided inside the `card` fixture, never while a module is imported."""

import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
TINY = 24  # services of a rehearsal: 96 windows a sweep

if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card and never falls back to the CPU")
    return torch.device("cuda")


def run_cmd(args, cwd=ROOT, env=None, timeout=600):
    """The harness's command; returns (rc, stdout lines, stderr)."""
    full = dict(os.environ)
    full.pop("PYTHONPATH", None)
    full.update(env or {})
    proc = subprocess.run([sys.executable, os.path.join(cwd, "portbench", "run.py"), *args], cwd=cwd,
                          env=full, capture_output=True, text=True, timeout=timeout)
    return proc.returncode, proc.stdout.strip().splitlines(), proc.stderr


def rehearse(workload, seed, trace=0, seconds=1.0, cwd=ROOT, env=None, extra=()):
    """A tiny run on the CPU through the command; (rc, result or None, stderr)."""
    rc, out, err = run_cmd(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                            "--trace", str(trace), "--device", "cpu", "--services", str(TINY), *extra],
                           cwd=cwd, env=env)
    result = json.loads(out[-1]) if rc == 0 and out else None
    return rc, result, err
