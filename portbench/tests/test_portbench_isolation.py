"""Nothing the harness or its reference loads is JAX, the JAX package or
its benchmarks (top-level module names compared whole: the port's name
begins with the JAX package's), and the reference loads nothing of the
program."""

import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT, TINY

BANNED = {"jax", "jaxlib", "flax", "foremast_tpu", "benchmarks"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_source_imports_a_banned_module():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                assert not set(_imports(os.path.join(d, f))) & BANNED, f


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            assert "foremast_tpu_torch" not in set(_imports(os.path.join(ref, f))), f


def test_loaded_modules_of_a_run_and_of_the_reference():
    code = f"""
import sys, os
sys.path.insert(0, {ROOT!r})
os.environ.pop("PYTHONPATH", None)
from portbench.reference import ma_judge
import numpy as np
rng = np.random.default_rng(0)
h = rng.normal(5, 1, (4, 200)).astype(np.float32)
m, s, n = ma_judge.fit(h)
ma_judge.judge(m, s, n, rng.normal(5, 1, (4, 30)), rng.normal(5, 1, (4, 30)), [2] * 4, [1] * 4, [0] * 4,
               dict(p_threshold=0.05, min_mw=20, min_wx=20, min_kw=5, min_fr=20), 10)
top = {{k.split(".")[0] for k in sys.modules}}
assert "foremast_tpu_torch" not in top, "the reference loaded the program"
from portbench import cli
rc = cli.main(["--workload", "ma.rollout", "--seed", "4", "--seconds", "1", "--device", "cpu",
               "--services", "{TINY}"], {ROOT!r}, 0.0)
top = {{k.split(".")[0] for k in sys.modules}}
assert rc == 0 and "foremast_tpu_torch" in top
print(sorted(top & set({sorted(BANNED)!r})))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
