"""The port's rule runner (`foremast_tpu_torch/analysis/core.py`,
`__main__.py`) after the runner cases of `tests/test_analysis.py`: scan
scope, suppressions, the baseline, exit codes and the metrics-lint fold,
and the gate itself: the port's tree is clean against the committed,
empty `analysis_baseline_torch.json`.

Bad code appears only as source strings (written to `tmp_path` where a
case needs a file), so the JAX package's own gate, which scans `tests/`,
never sees it."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

from foremast_tpu.analysis import analyze_source as jax_analyze_source
from foremast_tpu.analysis.async_blocking import AsyncBlockingChecker as JaxAsyncBlockingChecker
from foremast_tpu.analysis.core import Finding as JaxFinding
from foremast_tpu_torch.analysis import all_checkers, analyze_source, repo_root
from foremast_tpu_torch.analysis.async_blocking import AsyncBlockingChecker
from foremast_tpu_torch.analysis.core import (
    PACKAGE,
    PARSE_RULE,
    Baseline,
    Finding,
    Module,
    analyze_modules,
    collect_modules,
    default_paths,
)
from foremast_tpu_torch.analysis.lock_discipline import LockDisciplineChecker

ROOT = repo_root()
ASYNC_PATH = "foremast_tpu_torch/service/fixture.py"


def src(text: str) -> str:
    return textwrap.dedent(text)


ASYNC_BAD = src(
    """
    import time
    import requests

    async def handler(request, store):
        time.sleep(1)
        requests.get("http://upstream")
        store.update(request)
        return open("/etc/hostname").read()
    """
)

ASYNC_CLEAN = src(
    """
    import asyncio
    import time

    async def handler(request, store):
        await asyncio.sleep(1)
        doc = await asyncio.to_thread(store.get, "id")

        def executor_target():
            time.sleep(1)

        return doc
    """
)

LOCK_BAD = src(
    """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._items = {}

        def put(self, key, value):
            with self._lock:
                self._items[key] = value

        def racy_get(self, key):
            return self._items.get(key)
    """
)


def _async(source: str, relpath: str = ASYNC_PATH) -> list[Finding]:
    return analyze_source(source, relpath, [AsyncBlockingChecker()])


# ---------------------------------------------------------------------------
# scan scope
# ---------------------------------------------------------------------------


def test_scope_repo_rules_cover_the_port_tests_and_smoke():
    assert AsyncBlockingChecker().applies_to("tests/test_torch_x.py")
    assert AsyncBlockingChecker().applies_to("chip_smoke.py")
    assert not LockDisciplineChecker().applies_to("tests/test_torch_x.py")
    assert not LockDisciplineChecker().applies_to("chip_smoke.py")
    assert LockDisciplineChecker().applies_to(f"{PACKAGE}/jobs/worker.py")
    assert [c.rule for c in all_checkers()] == ["async-blocking", "lock-discipline", "metrics-contract"]


def test_default_scan_includes_the_port_tests_and_smoke():
    relpaths = {m.relpath for m in collect_modules(ROOT, default_paths(ROOT))}
    assert "chip_smoke.py" in relpaths
    assert "tests/test_torch_analysis.py" in relpaths and "tests/torch_fake_services.py" in relpaths
    assert any(p.startswith(f"{PACKAGE}/analysis/") for p in relpaths)
    # the JAX package's tests and tree are its own rules' business
    assert not any(p.startswith(("foremast_tpu/", "benchmarks/")) for p in relpaths)
    assert "tests/test_analysis.py" not in relpaths
    # the lock graph and the env contract keep reading the package alone
    assert {m.relpath.split("/")[0] for m in collect_modules(ROOT)} == {PACKAGE}


def test_a_file_that_does_not_parse_is_a_finding(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def f(:\n    pass\n")
    findings = analyze_modules(collect_modules(str(tmp_path), [str(bad)]), all_checkers())
    assert [(f.rule, f.path, f.line) for f in findings] == [(PARSE_RULE, "broken.py", 1)]
    assert analyze_source("x = (\n", ASYNC_PATH, all_checkers())[0].rule == PARSE_RULE


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

_SLEEP = """
    import time

    async def handler(request):
        {line}
    """

SUPPRESSION_CASES = {
    # name: (source, findings left)
    "same_line_by_rule": (src(_SLEEP.format(line="time.sleep(1)  # foremast: ignore[async-blocking]")), 0),
    "bare_on_the_line_above": (src(_SLEEP.format(line="# foremast: ignore\n        time.sleep(1)")), 0),
    "wrong_rule": (src(_SLEEP.format(line="time.sleep(1)  # foremast: ignore[jit-hygiene]")), 1),
    "other_statement_does_not_leak_down": (
        src(_SLEEP.format(line="x = 1  # foremast: ignore[async-blocking]\n        time.sleep(1)")), 1),
    "multi_rule_listing_it": (
        src(_SLEEP.format(line="time.sleep(1)  # foremast: ignore[async-blocking, jit-hygiene]")), 0),
    "multi_rule_not_listing_it": (
        src(_SLEEP.format(line="time.sleep(1)  # foremast: ignore[jit-hygiene,lock-discipline]")), 1),
    "spaced_bracket_is_rule_scoped": (src(_SLEEP.format(line="time.sleep(1)  # foremast: ignore [jit-hygiene]")), 1),
    "spaced_bracket_listing_it": (src(_SLEEP.format(line="time.sleep(1)  # foremast: ignore [async-blocking]")), 0),
    "dash_reason_after_the_list": (
        src(_SLEEP.format(line="time.sleep(1)  # foremast: ignore[async-blocking] — a test's own loop")), 0),
}


@pytest.mark.parametrize("name", sorted(SUPPRESSION_CASES))
def test_suppression_forms(name):
    """Each form as `tests/test_analysis.py` pins it on the JAX runner,
    with the same answer there."""
    source, left = SUPPRESSION_CASES[name]
    assert len(_async(source)) == left
    jax = jax_analyze_source(source, "foremast_tpu/service/fixture.py", [JaxAsyncBlockingChecker()])
    assert len(jax) == left


def test_markers_follow_the_placement_rules_of_suppressions():
    module = Module(ASYNC_PATH, src(
        """
        # foremast: device-boundary
        def gather(x):
            return x

        y = 1
        def other(x):  # foremast: sharded-arena
            return x
        """
    ))
    gather, other = (n for n in module.tree.body if hasattr(n, "name"))
    assert module.marked_def(gather, "device-boundary") and not module.marked_def(gather, "sharded-arena")
    assert module.marked_def(other, "sharded-arena") and not module.marked_def(other, "device-boundary")
    # the line above counts only when it is a pure comment
    assert module.marked(7, "sharded-arena") and not module.marked(8, "sharded-arena")


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------


def test_baseline_round_trip_and_staleness(tmp_path):
    findings = _async(ASYNC_BAD)
    assert len(findings) == 4
    path = str(tmp_path / "baseline.json")
    Baseline.from_findings(findings).save(path)
    loaded = Baseline.load(path)
    new, grandfathered = loaded.split(findings)
    assert new == [] and len(grandfathered) == len(findings)
    assert loaded.stale(findings) == []
    # a paid-off finding shows as stale; a brand-new one is not masked
    assert len(loaded.stale(findings[1:])) == 1
    extra = Finding(rule="async-blocking", path=ASYNC_PATH, line=99, message="novel")
    new, _ = loaded.split([*findings, extra])
    assert new == [extra]


def test_baseline_fingerprint_is_line_independent_and_jax_compatible():
    a = Finding(rule="r", path="p.py", line=10, message="m")
    b = Finding(rule="r", path="p.py", line=99, message="m")
    assert a.fingerprint() == b.fingerprint()
    assert a.fingerprint() != Finding(rule="r", path="p.py", line=10, message="other").fingerprint()
    assert a.fingerprint() == JaxFinding(rule="r", path="p.py", line=10, message="m").fingerprint()
    assert a.to_json() == JaxFinding(rule="r", path="p.py", line=10, message="m").to_json()


def test_missing_baseline_means_empty(tmp_path):
    assert Baseline.load(str(tmp_path / "absent.json")).entries == []


# ---------------------------------------------------------------------------
# the runner and the gate
# ---------------------------------------------------------------------------


def test_tree_clean_against_committed_baseline():
    """`python -m foremast_tpu_torch.analysis` exits 0 on this tree: the
    per-module rules over the package, the port's tests and the smoke
    script, the env contract, the whole-program rules (concurrency,
    device-flow, sharding-contract, status-machine), the README's knob
    table and family index, the metric registry's coverage and the
    metrics lint, against the committed baseline, which is empty and
    stays so."""
    from foremast_tpu_torch.analysis.__main__ import BASELINE_NAME, tree_findings

    path = os.path.join(ROOT, BASELINE_NAME)
    assert json.load(open(path, encoding="utf-8"))["findings"] == []
    new, _ = Baseline.load(path).split(tree_findings(ROOT))
    assert new == [], "\n" + "\n".join(f.render() for f in new)


def test_runner_exit_codes(tmp_path, capsys):
    from foremast_tpu_torch.analysis.__main__ import main

    bad = tmp_path / "fixture_bad.py"
    bad.write_text(ASYNC_BAD)
    assert main([str(bad)]) == 1
    out = capsys.readouterr().out
    assert "async-blocking" in out and "4 finding(s)" in out

    clean = tmp_path / "fixture_clean.py"
    clean.write_text(ASYNC_CLEAN)
    assert main([str(clean)]) == 0
    assert "clean" in capsys.readouterr().out

    # a fixture tree with an unlocked guarded access
    tree = tmp_path / "tree"
    tree.mkdir()
    (tree / "box.py").write_text(LOCK_BAD)
    assert main([str(tree)]) == 1
    assert "unlocked read of `self._items` in `Box.racy_get`" in capsys.readouterr().out

    # bad usage
    assert main([str(tmp_path / "absent.py")]) == 2
    with pytest.raises(SystemExit) as e:
        main(["--no-such-flag"])
    assert e.value.code == 2


def test_runner_baseline_json_and_sarif(tmp_path, capsys):
    from foremast_tpu_torch.analysis.__main__ import main

    bad = tmp_path / "fixture_bad.py"
    bad.write_text(ASYNC_BAD)
    baseline = str(tmp_path / "baseline.json")
    assert main([str(bad), "--baseline", baseline, "--write-baseline"]) == 0
    capsys.readouterr()
    assert main([str(bad), "--baseline", baseline]) == 0
    assert "4 grandfathered finding(s)" in capsys.readouterr().out

    assert main([str(bad), "--json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in out["findings"]} == {"async-blocking"} and len(out["findings"]) == 4
    assert out["grandfathered"] == [] and out["stale_baseline"] == []

    assert main([str(bad), "--sarif", "--baseline", baseline]) == 0
    sarif = json.loads(capsys.readouterr().out)
    results = sarif["runs"][0]["results"]
    assert sarif["version"] == "2.1.0" and len(results) == 4
    assert all(r["suppressions"][0]["status"] == "accepted" for r in results)


def test_runner_folds_in_metrics_lint():
    from foremast_tpu_torch.analysis.__main__ import metrics_lint_findings

    assert metrics_lint_findings() == []


@pytest.mark.slow
def test_runner_cli_subprocess_gate():
    """The command the README gives, end to end."""
    proc = subprocess.run(
        [sys.executable, "-m", "foremast_tpu_torch.analysis"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s), clean" in proc.stdout
