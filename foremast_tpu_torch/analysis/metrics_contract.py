"""metrics-contract: the constructed families, the lint registry and the
README's family index cannot drift apart.

The port's own copy of the rules of
`foremast_tpu/analysis/metrics_contract.py`. A metric family lives in
three places: the constructor call in code, the registry of
`foremast_tpu_torch/observe/metrics_lint.py` (``ALLOWED_LABELS``, which
pins label sets, and ``FAMILY_DOCS``, one line of meaning each), and the
family index in the README's port section. The contract:

  1. every literal ``foremast*`` family name passed to a metric
     constructor (`Counter` / `Gauge` / `Histogram` / `*MetricFamily` /
     the `observe.spans.counter()` helper) anywhere in the package is in
     `ALLOWED_LABELS` (as collected: a counter's ``_total`` suffix is
     stripped) and has a line in `FAMILY_DOCS`;
  2. every registry entry is constructed somewhere, or is declared in
     `DYNAMIC_FAMILIES` (a name built with an f-string), and the two
     dicts cover the same names;
  3. the family index between the ``METRIC FAMILIES (TORCH)`` markers of
     the README is rendered from the registry (``--update-metrics-docs``);
     a stale index is a finding.

The per-series model-output gauges (``foremastbrain_<series>_upper`` and
the like) are templated per job and stay outside the registry: the
gauges build them with f-strings, so rule 1 never sees them.
"""

from __future__ import annotations

import ast
import os
import re

from foremast_tpu_torch.analysis.core import PACKAGE, Checker, Finding, Module, in_package, repo_root

RULE = "metrics-contract"
LINT_PATH = f"{PACKAGE}/observe/metrics_lint.py"

DOCS_RELPATH = "README.md"
DOCS_BEGIN = "<!-- BEGIN METRIC FAMILIES (TORCH) (generated: python -m foremast_tpu_torch.analysis --update-metrics-docs) -->"
DOCS_END = "<!-- END METRIC FAMILIES (TORCH) -->"

_CONSTRUCTORS = frozenset({
    "Counter", "Gauge", "Histogram", "Summary", "Info", "Enum",
    "CounterMetricFamily", "GaugeMetricFamily", "HistogramMetricFamily", "SummaryMetricFamily",
    "counter",  # observe.spans.counter, the shared-family helper
})

_FAMILY_RE = re.compile(r"^foremast(brain)?_[a-z0-9_]+$")

# families whose names are built dynamically (f-strings), invisible to
# the literal scan: rule 2's exemptions
DYNAMIC_FAMILIES = frozenset({"foremastbrain_gauge_families_dropped"})

_REGEN = "`python -m foremast_tpu_torch.analysis --update-metrics-docs`"
_HINT = f"run {_REGEN}"


def collected_name(name: str) -> str:
    """prometheus_client collects counters without the `_total` suffix."""
    return name[:-6] if name.endswith("_total") else name


def _registry():
    from foremast_tpu_torch.observe.metrics_lint import ALLOWED_LABELS, FAMILY_DOCS

    return ALLOWED_LABELS, FAMILY_DOCS


def scan_constructions(module: Module) -> list[tuple[str, int]]:
    """(literal family name, line) of every metric-constructor call: the
    first positional argument or the `name=` keyword."""
    out: list[tuple[str, int]] = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        name = func.attr if isinstance(func, ast.Attribute) else (func.id if isinstance(func, ast.Name) else None)
        if name not in _CONSTRUCTORS:
            continue
        first = node.args[0] if node.args else next((kw.value for kw in node.keywords if kw.arg == "name"), None)
        if isinstance(first, ast.Constant) and isinstance(first.value, str) and _FAMILY_RE.match(first.value):
            out.append((first.value, node.lineno))
    return out


class MetricsContractChecker(Checker):
    rule = RULE
    description = "every constructed foremast_* family is registered in metrics_lint (ALLOWED_LABELS + FAMILY_DOCS)"

    def __init__(self, registry=None, docs=None):
        self._reg = registry
        self._docs = docs

    def _load(self):
        if self._reg is None:
            self._reg, self._docs = _registry()
        return self._reg, self._docs

    def check(self, module: Module) -> list[Finding]:
        allowed, docs = self._load()
        findings: list[Finding] = []
        for name, line in scan_constructions(module):
            coll = collected_name(name)
            if coll not in allowed:
                findings.append(module.finding(
                    self.rule, line,
                    f"metric family {name!r} is constructed here but not registered in "
                    "metrics_lint.ALLOWED_LABELS — its label set is unchecked and the family index "
                    "cannot list it",
                    hint="add it to ALLOWED_LABELS (exact label set) and FAMILY_DOCS (one-line meaning) "
                    f"in observe/metrics_lint.py, then {_REGEN}",
                ))
            elif coll not in docs:
                findings.append(module.finding(
                    self.rule, line,
                    f"metric family {name!r} has no FAMILY_DOCS entry — the generated family index "
                    "cannot describe it",
                    hint=f"add a one-line meaning to FAMILY_DOCS in observe/metrics_lint.py, then {_REGEN}",
                ))
        return findings


# ---------------------------------------------------------------------------
# over the package: registry coverage and the generated family index
# ---------------------------------------------------------------------------


def check_registry_coverage(modules) -> list[Finding]:
    """Rule 2: every registry entry is constructed in the package (or
    declared dynamic), and FAMILY_DOCS covers ALLOWED_LABELS exactly."""
    allowed, docs = _registry()
    constructed = {collected_name(name) for m in modules if in_package(m.relpath)
                   for name, _ in scan_constructions(m)}
    findings = [
        Finding(RULE, LINT_PATH, 1,
                f"registry entry {name!r} is never constructed in the package — dead registry weight "
                "(or a construction the literal scan cannot see)",
                "remove the entry, or add the family name to metrics_contract.DYNAMIC_FAMILIES if it "
                "is built dynamically")
        for name in sorted(set(allowed) - constructed - DYNAMIC_FAMILIES)
    ]
    for name in sorted(set(allowed) ^ set(docs)):
        where = "ALLOWED_LABELS" if name in allowed else "FAMILY_DOCS"
        findings.append(Finding(
            RULE, LINT_PATH, 1,
            f"family {name!r} appears in {where} only — ALLOWED_LABELS and FAMILY_DOCS must cover the same set",
            "keep the two dicts in observe/metrics_lint.py key for key identical"))
    return findings


def render_family_table() -> str:
    """The README's family-index block, rendered from the registry."""
    allowed, docs = _registry()
    lines = [DOCS_BEGIN, "", "| Family (as collected) | Labels | Meaning |", "|---|---|---|"]
    for name in sorted(allowed):
        labels = ", ".join(f"`{lb}`" for lb in sorted(allowed[name])) or "—"
        doc = docs.get(name, "").replace("|", "\\|")
        lines.append(f"| `{name}` | {labels} | {doc} |")
    lines.append("")
    lines.append(
        "Counters are listed as collected (without their `_total` suffix). This table is generated "
        "from `foremast_tpu_torch/observe/metrics_lint.py`'s registry: edit `ALLOWED_LABELS` / "
        "`FAMILY_DOCS`, then run `python -m foremast_tpu_torch.analysis --update-metrics-docs`. The "
        "gate fails when the table, the registry and the constructor calls drift apart "
        "(rule `metrics-contract`)."
    )
    lines.append(DOCS_END)
    return "\n".join(lines)


def _split_docs(text: str) -> tuple[str, str, str] | None:
    try:
        head, rest = text.split(DOCS_BEGIN, 1)
        _, tail = rest.split(DOCS_END, 1)
    except ValueError:
        return None
    return head, text[len(head): len(text) - len(tail)], tail


def check_metrics_docs(root: str | None = None) -> list[Finding]:
    """A finding when the README's family index is missing or stale."""
    root = root or repo_root()
    with open(os.path.join(root, DOCS_RELPATH), encoding="utf-8") as f:
        text = f.read()
    parts = _split_docs(text)
    if parts is None:
        return [Finding(RULE, DOCS_RELPATH, 1, "METRIC FAMILIES (TORCH) markers missing from the README", _HINT)]
    if parts[1] != render_family_table():
        line = text[: text.index(DOCS_BEGIN)].count("\n") + 1
        return [Finding(RULE, DOCS_RELPATH, line,
                        "generated metric-family table is stale vs the metrics_lint registry", _HINT)]
    return []


def update_metrics_docs(root: str | None = None) -> bool:
    """Rewrite the README's family index in place; True if it changed."""
    root = root or repo_root()
    path = os.path.join(root, DOCS_RELPATH)
    with open(path, encoding="utf-8") as f:
        text = f.read()
    parts = _split_docs(text)
    if parts is None:
        raise SystemExit(f"{DOCS_RELPATH}: markers not found; add\n{DOCS_BEGIN}\n{DOCS_END}\nwhere the table belongs")
    head, old, tail = parts
    new = render_family_table()
    if old == new:
        return False
    with open(path, "w", encoding="utf-8") as f:
        f.write(head + new + tail)
    return True
