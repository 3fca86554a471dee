"""The port's metric naming lint (`foremast_tpu_torch/observe/metrics_lint.py`)
against the JAX package's (`foremast_tpu/observe/metrics_lint.py`).

The port's default set lints clean, its rules are JAX's (the same
regexes and label table; a rogue family and an extra label are flagged
as in `tests/test_observe.py`), and the families its default set exports
equal the JAX default set's, name for name and label set for label set.
The port exports no family the JAX set lacks: `PORT_EXTRA` is empty."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from prometheus_client import CollectorRegistry, Counter, Gauge

import foremast_tpu.observe.metrics_lint as J
import foremast_tpu_torch.observe.metrics_lint as P

ROOT = Path(__file__).resolve().parent.parent
# families the port's default set exports beyond the JAX set's
PORT_EXTRA: dict[str, frozenset[str]] = {}


def _families(registry) -> dict[str, tuple[str, frozenset[str]]]:
    out = {}
    for family in registry.collect():
        labels: set[str] = set()
        for sample in family.samples:
            labels.update(sample.labels)
        out[family.name] = (family.type, frozenset(labels - {"le", "quantile"}))
    return out


def test_metrics_lint_default_registry_clean():
    assert P.lint_registry(P.default_registry_families()) == []


def test_metrics_lint_flags_violations():
    reg = CollectorRegistry()
    Gauge("acme_rogue_metric", "wrong prefix", registry=reg)
    Counter("foremast_worker_jobs", "undocumented extra label", ["status", "shard"],
            registry=reg).labels(status="done", shard="0").inc()
    Gauge("foremast_free_form", "unlisted family, bad label", ["Bad-Label"], registry=reg).labels(
        **{"Bad-Label": "x"}).set(1)
    problems = P.lint_registry(reg)
    assert any("acme_rogue_metric" in p for p in problems)
    assert any("shard" in p for p in problems)
    assert any("Bad-Label" in p for p in problems)
    assert problems == J.lint_registry(reg)


def test_rules_and_tables_are_jax():
    assert P.NAME_RE.pattern == J.NAME_RE.pattern and P.LABEL_RE.pattern == J.LABEL_RE.pattern
    assert P.ALLOWED_LABELS == J.ALLOWED_LABELS
    assert set(P.FAMILY_DOCS) == set(J.FAMILY_DOCS) == set(P.ALLOWED_LABELS)


def test_exported_families_equal_jax():
    port = _families(P.default_registry_families())
    jax = _families(J.default_registry_families())
    assert {k: v[1] for k, v in port.items() if k not in jax} == PORT_EXTRA
    assert set(jax) <= set(port)
    for name, want in jax.items():
        assert port[name] == want, name
    # every family with a label table is exported by both sets
    for name in PORT_EXTRA:
        assert name in P.ALLOWED_LABELS


def test_module_main_exits_zero():
    out = subprocess.run([sys.executable, "-m", "foremast_tpu_torch.observe.metrics_lint"], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "all exported families conform" in out.stdout
