"""The port's metrics-contract, sharding-contract and status-machine rules
(`foremast_tpu_torch/analysis/metrics_contract.py`, `sharding_contract.py`,
`status_machine.py`) after their cases in `tests/test_analysis.py`.

The fixtures are JAX's, with paths and imports mapped from
`foremast_tpu/` to `foremast_tpu_torch/`; each case asserts what the JAX
case asserts on the port's rule, and a parity test runs every shared
fixture through both packages' rules: the same (rule, line) pairs come
out. The torch form of the placement check has fixtures of its own
(JAX's flags `jnp.asarray`, the port's flags torch's uploads). The tree
cases hold the committed status graph to the code and to the JAX
package's graph, check that a direct upload put into a real `jobs/`
module is found, and that the runner's regenerate flags change nothing
on this tree.

Bad code appears only as source strings, so neither package's gate,
both of which scan `tests/`, sees it."""

from __future__ import annotations

import json
import os
import shutil
import textwrap

import pytest

from foremast_tpu.analysis.blocking_under_lock import apply_suppressions as jax_apply_suppressions
from foremast_tpu.analysis.core import Module as JaxModule
from foremast_tpu.analysis.core import analyze_source as jax_analyze_source
from foremast_tpu.analysis.interproc import Program as JaxProgram
from foremast_tpu.analysis.metrics_contract import MetricsContractChecker as JaxMetricsContract
from foremast_tpu.analysis.sharding_contract import check_sharding_contract as jax_check_sharding
from foremast_tpu.analysis.status_machine import GRAPH_NAME as JAX_GRAPH_NAME
from foremast_tpu.analysis.status_machine import build_graph as jax_build_status_graph
from foremast_tpu.analysis.status_machine import check_status_machine as jax_check_status
from foremast_tpu.analysis.status_machine import write_graph as jax_write_status_graph
from foremast_tpu_torch.analysis import all_checkers, analyze_source
from foremast_tpu_torch.analysis.blocking_under_lock import apply_suppressions
from foremast_tpu_torch.analysis.core import Module, collect_modules, in_package, repo_root
from foremast_tpu_torch.analysis.interproc import Program
from foremast_tpu_torch.analysis.metrics_contract import (
    DOCS_BEGIN,
    DOCS_END,
    DYNAMIC_FAMILIES,
    MetricsContractChecker,
    check_metrics_docs,
    check_registry_coverage,
    render_family_table,
    update_metrics_docs,
)
from foremast_tpu_torch.analysis.sharding_contract import check_sharding_contract
from foremast_tpu_torch.analysis.status_machine import (
    GRAPH_NAME,
    _normalize,
    build_graph,
    check_status_machine,
    load_graph,
    write_graph,
)

ROOT = repo_root()


def src(text: str) -> str:
    return textwrap.dedent(text)


def _to_jax(text: str) -> str:
    return text.replace("foremast_tpu_torch/", "foremast_tpu/").replace("foremast_tpu_torch.", "foremast_tpu.")


def _program(sources: dict) -> Program:
    return Program([Module(p, src(s)) for p, s in sources.items()])


@pytest.fixture(scope="module")
def tree():
    """The port's package, parsed once, and its `Program` (one build for
    the module's tree cases)."""
    modules = [m for m in collect_modules(ROOT) if in_package(m.relpath)]
    return modules, Program(modules)


# ---------------------------------------------------------------------------
# metrics-contract
# ---------------------------------------------------------------------------

METRICS_PATH = "foremast_tpu_torch/observe/fixture.py"
_REGISTRY = {"foremast_known": frozenset()}
_DOCS = {"foremast_known": "a known family"}

METRICS_UNREGISTERED = """
    from prometheus_client import Counter

    def build(reg):
        Counter("foremast_known_total", "fine", registry=reg)
        Counter("foremast_rogue_total", "not registered", registry=reg)
"""

METRICS_FAMILY = """
    from prometheus_client.core import GaugeMetricFamily

    def collect():
        yield GaugeMetricFamily("foremast_mystery", "nope")
"""

METRICS_NAME_KEYWORD = """
    from prometheus_client import Counter

    def build(reg):
        Counter(name="foremast_rogue_total", documentation="d", registry=reg)
"""

METRICS_DYNAMIC = """
    from prometheus_client import Counter

    def build(reg, ns):
        Counter(f"{ns}_dynamic_total", "f-string: not checked", registry=reg)
        print("foremast_not_a_constructor")
"""

METRICS_UNDOCUMENTED = """
    from foremast_tpu_torch.observe.spans import counter

    def build(reg):
        counter("foremast_known_total", "registered", registry=reg)
        counter("foremast_half_total", "registered, undocumented", registry=reg)
"""


def _metrics(source: str, registry=None, docs=None) -> list:
    checker = MetricsContractChecker(registry=registry or _REGISTRY, docs=docs or _DOCS)
    return analyze_source(src(source), METRICS_PATH, [checker])


def test_metrics_contract_flags_unregistered_and_undocumented():
    findings = _metrics(METRICS_UNREGISTERED)
    assert len(findings) == 1
    assert "foremast_rogue_total" in findings[0].message and "ALLOWED_LABELS" in findings[0].message
    # registered but without a FAMILY_DOCS line: the other message
    half = _metrics(METRICS_UNDOCUMENTED, registry={**_REGISTRY, "foremast_half": frozenset()})
    assert [f.line for f in half] == [6] and "no FAMILY_DOCS entry" in half[0].message


def test_metrics_contract_counts_metric_family_constructors():
    findings = _metrics(METRICS_FAMILY)
    assert len(findings) == 1 and "foremast_mystery" in findings[0].message


def test_metrics_contract_checks_name_keyword_form():
    findings = _metrics(METRICS_NAME_KEYWORD)
    assert len(findings) == 1 and "foremast_rogue_total" in findings[0].message


def test_metrics_contract_ignores_dynamic_and_nonmetric_strings():
    assert _metrics(METRICS_DYNAMIC) == []


def test_metrics_contract_is_a_package_rule_in_all_checkers():
    checker = next(c for c in all_checkers() if c.rule == "metrics-contract")
    assert checker.applies_to("foremast_tpu_torch/observe/gauges.py")
    assert not checker.applies_to("tests/test_torch_x.py") and not checker.applies_to("chip_smoke.py")


def test_metrics_registry_docs_and_table_in_sync():
    """ALLOWED_LABELS == FAMILY_DOCS keys, every registry entry is
    constructed in the package (or declared dynamic: JAX's one entry),
    and the README's family index is the renderer's."""
    assert check_metrics_docs(ROOT) == []
    assert check_registry_coverage(collect_modules(ROOT)) == []
    assert DYNAMIC_FAMILIES == frozenset({"foremastbrain_gauge_families_dropped"})
    with open(os.path.join(ROOT, "README.md"), encoding="utf-8") as f:
        assert render_family_table() in f.read()


def test_metrics_docs_stale_and_missing_markers(tmp_path):
    readme = tmp_path / "README.md"
    readme.write_text("# no markers\n")
    assert [f.message for f in check_metrics_docs(str(tmp_path))] == [
        "METRIC FAMILIES (TORCH) markers missing from the README"]
    readme.write_text(f"head\n\n{DOCS_BEGIN}\nold table\n{DOCS_END}\ntail\n")
    stale = check_metrics_docs(str(tmp_path))
    assert len(stale) == 1 and stale[0].line == 3 and "stale" in stale[0].message
    assert update_metrics_docs(str(tmp_path)) is True
    assert check_metrics_docs(str(tmp_path)) == []
    assert update_metrics_docs(str(tmp_path)) is False
    text = readme.read_text()
    assert text.startswith("head\n\n") and text.endswith("\ntail\n")


def test_registry_coverage_flags_dead_and_one_sided_entries(monkeypatch):
    from foremast_tpu_torch.observe import metrics_lint

    monkeypatch.setitem(metrics_lint.ALLOWED_LABELS, "foremast_unbuilt", frozenset())
    monkeypatch.setitem(metrics_lint.FAMILY_DOCS, "foremast_docs_only", "x")
    messages = [f.message for f in check_registry_coverage(collect_modules(ROOT))]
    assert any("'foremast_unbuilt' is never constructed" in m for m in messages)
    assert any("'foremast_unbuilt' appears in ALLOWED_LABELS only" in m for m in messages)
    assert any("'foremast_docs_only' appears in FAMILY_DOCS only" in m for m in messages)


# ---------------------------------------------------------------------------
# sharding-contract
# ---------------------------------------------------------------------------

PLACEMENT_TORCH = """
    import numpy as np
    import torch

    def build(values, dev):
        return torch.as_tensor(values).cuda()

    def build_to(values, dev):
        return torch.from_numpy(values).to(dev)

    def build_factory(values, dev):
        return torch.tensor(values, device=dev)

    def beside(a):
        return torch.zeros((4, a.shape[1]), dtype=a.dtype, device=a.device)

    def on_host(values):
        return torch.zeros(4, device="cpu") + torch.as_tensor(values)

    def host_cast(values):
        return torch.from_numpy(values).to(torch.float32)

    def _place(values, dev):
        return torch.as_tensor(values).cuda()

    def build_suppressed(values, dev):
        # bench-only constructor (fixture)
        # foremast: ignore[sharding-contract]
        return torch.zeros(8, device=dev)
"""

ARENA_FIX = """
    class Router:
        def spread(self):
            return self._arena_budget + 1

        # Reads the shard-agnostic budget only (fixture).
        # foremast: sharded-arena
        def budget(self):
            return self._arena_budget

        def line_marked(self):
            return self._arena_budget  # foremast: sharded-arena
"""


def _sharding(sources: dict) -> list:
    prog = _program(sources)
    return apply_suppressions(check_sharding_contract(prog), prog.modules)


def test_sharding_contract_placement_outside_hooks():
    findings = _sharding({"foremast_tpu_torch/jobs/shardfix.py": PLACEMENT_TORCH})
    assert [(f.line, f.message.split(" in warm-path code")[0]) for f in findings] == [
        (6, "direct upload `.cuda()`"),
        (9, "direct upload `torch.from_numpy(...).to(...)`"),
        (12, "direct upload `torch.tensor(..., device=...)`"),
    ]
    assert all(f.rule == "sharding-contract" for f in findings)
    assert "(`build`)" in findings[0].message


def test_sharding_contract_placement_scope():
    """parallel/batch.py is in scope, the placement library and the rest
    of parallel/ are not."""
    text = {"foremast_tpu_torch/parallel/batch.py": PLACEMENT_TORCH}
    assert len(_sharding(text)) == 3
    for path in ("foremast_tpu_torch/parallel/mesh.py", "foremast_tpu_torch/ops/windows.py",
                 "foremast_tpu_torch/engine/judge.py"):
        assert _sharding({path: PLACEMENT_TORCH}) == []


def test_sharding_contract_arena_needs_sharded_annotation():
    findings = _sharding({"foremast_tpu_torch/parallel/arenafix.py": ARENA_FIX})
    assert len(findings) == 1
    assert "arena reference `_arena_budget` in sharded code (`spread`)" in findings[0].message


def test_sharding_contract_finds_an_upload_put_into_a_real_jobs_module(tree):
    """A direct `torch.as_tensor(...).cuda()` in the worker's real source
    is found, at its line."""
    modules, _ = tree
    worker = next(m for m in modules if m.relpath == "foremast_tpu_torch/jobs/worker.py")
    anchor = "    def _decode_uni(self, packed: _UniPacked, res, now: float) -> list:\n"
    assert anchor in worker.source
    bad = "        staged = torch.as_tensor(packed.nidx).cuda()\n"
    source = worker.source.replace(anchor, anchor + bad, 1)
    line = source[: source.index(bad)].count("\n") + 1
    mutated = [Module(m.relpath, source) if m is worker else m for m in modules]
    findings = apply_suppressions(check_sharding_contract(Program(mutated)), mutated)
    assert [(f.path, f.line) for f in findings] == [("foremast_tpu_torch/jobs/worker.py", line)]
    assert "`.cuda()`" in findings[0].message and "(`_decode_uni`)" in findings[0].message


def test_sharding_contract_tree_markers_on_jax_counterparts(tree):
    """The tree is clean, and the sharded-arena markers sit on the port's
    counterparts of JAX's six sites."""
    modules, program = tree
    assert apply_suppressions(check_sharding_contract(program), modules) == []
    by_path = {m.relpath: m for m in modules}
    batch = by_path["foremast_tpu_torch/parallel/batch.py"]
    marked = {fn.qualname for fn in program.functions
              if fn.module in (batch, by_path["foremast_tpu_torch/parallel/distributed.py"])
              and fn.module.marked_def(fn.node, "sharded-arena")}
    assert marked == {"ShardedJudge._resolve_arena_shards", "ShardedJudge._arena_shards",
                      "ShardedJudge._arena_sharding", "PodWorker.__init__"}
    lines = [i for i, text in enumerate(batch.lines, 1) if "foremast: sharded-arena" in text]
    assert any("self._arena_shards_n = self._resolve_arena_shards()" in batch.lines[i - 1] for i in lines)
    assert any("shards = self._arena_shards()" in batch.lines[i] for i in lines)


# ---------------------------------------------------------------------------
# status-machine
# ---------------------------------------------------------------------------

STATUS_MODELS_FIX = """
    STATUS_INITIAL = "initial"
    STATUS_INPROGRESS = "preprocess_inprogress"
    STATUS_COMPLETED = "preprocess_completed"
    STATUS_HEALTHY = "completed_health"
    STATUS_FAILED = "failed"

    TERMINAL_STATUSES = frozenset({STATUS_HEALTHY, STATUS_FAILED})
    INPROGRESS_STATUSES = frozenset({STATUS_INPROGRESS})
    CLAIMABLE_STATUSES = frozenset({STATUS_INITIAL, STATUS_COMPLETED})
"""

STATUS_WORKER_FIX = """
    from foremast_tpu_torch.jobs.modelsfix import (
        STATUS_HEALTHY,
        STATUS_INPROGRESS,
    )

    class Worker:
        def judge(self, doc):
            if doc.status == STATUS_INPROGRESS:
                doc.status = STATUS_HEALTHY

        def rewind(self, doc):
            if doc.status == STATUS_HEALTHY:
                doc.status = STATUS_INPROGRESS

        def dynamic(self, doc, value):
            doc.status = value

        def alien(self, doc):
            doc.status = "totally_new"
"""

STATUS_CLAIM_FIX = """
    from foremast_tpu_torch.jobs.modelsfix import (
        STATUS_COMPLETED,
        STATUS_HEALTHY,
    )

    class Safe:
        def cycle(self):
            docs = self.store.claim("w", 600, 8)
            try:
                for d in docs:
                    d.status = STATUS_HEALTHY
            finally:
                self.release(docs)

        def release(self, docs):
            for d in docs:
                d.status = STATUS_COMPLETED

    class Leaky:
        def cycle(self):
            docs = self.store.claim("w", 600, 8)
            for d in docs:
                d.status = STATUS_HEALTHY

        def outer(self):
            self.cycle()
"""

# the pod form: the worker calls its base-typed store, and only the
# wrapper's override claims (the pod's `LeaderStore` over its inner store)
STATUS_POD_FIX = """
    from foremast_tpu_torch.jobs.modelsfix import STATUS_HEALTHY

    class JobStore:
        def take(self, n):
            return []

    class LeaderStore(JobStore):
        def take(self, n):
            return self.inner.claim("w", 600, n)

    class Worker:
        def __init__(self, store: JobStore):
            self.store = store

        def _cycle(self):
            return self.store.take(1)

        def tick(self):
            docs = self._cycle()
            for d in docs:
                d.status = STATUS_HEALTHY
"""

STATUS_SHARED = {
    "status_writes": {"foremast_tpu_torch/jobs/modelsfix.py": STATUS_MODELS_FIX,
                      "foremast_tpu_torch/jobs/workerfix.py": STATUS_WORKER_FIX},
    "status_claims": {"foremast_tpu_torch/jobs/modelsfix.py": STATUS_MODELS_FIX,
                      "foremast_tpu_torch/jobs/claimfix.py": STATUS_CLAIM_FIX},
}


def _status(sources: dict, tmp_path) -> list:
    prog = _program(sources)
    write_graph(str(tmp_path), build_graph(prog))
    return check_status_machine(str(tmp_path), prog)


def test_status_machine_write_legality_and_dynamic_writes(tmp_path):
    findings = _status(STATUS_SHARED["status_writes"], tmp_path)
    msgs = "\n".join(f.message for f in findings)
    # `judge` (in-progress -> terminal) is legal and not flagged
    assert "`Worker.judge`" not in msgs
    assert "illegal status transition" in msgs and "`Worker.rewind`" in msgs
    assert "dynamic status write in `Worker.dynamic`" in msgs
    assert "unknown status `totally_new`" in msgs
    assert len(findings) == 3


def test_status_machine_claim_path_protection(tmp_path):
    """A claim whose span settles through a try/finally release edge is
    compliant; a bare claim with no protected exception edge is the
    stranded-docs finding, at the span owner, once."""
    findings = _status(STATUS_SHARED["status_claims"], tmp_path)
    claim = [f for f in findings if "claim path" in f.message]
    assert len(claim) == 1 and "`Leaky.cycle`" in claim[0].message


def test_status_machine_claim_reaches_subclass_overrides(tmp_path):
    """A call on a base-typed store reaches the subclass's override (the
    pod's `LeaderStore` claiming from its inner store): the worker owns
    the span and is reported once, where JAX's resolver, which follows no
    overrides, sees no claim; a suppression with its reason silences
    it."""
    sources = {"foremast_tpu_torch/jobs/modelsfix.py": STATUS_MODELS_FIX,
               "foremast_tpu_torch/jobs/podfix.py": STATUS_POD_FIX}
    findings = _status(sources, tmp_path)
    assert [f.message.split(" has ")[0] for f in findings] == ["claim path `Worker.tick`"]
    assert jax_pairs("status", sources, tmp_path) == set()
    # without the claiming override there is no claim to protect
    plain = STATUS_POD_FIX.replace('return self.inner.claim("w", 600, n)', "return []")
    assert _status({**sources, "foremast_tpu_torch/jobs/podfix.py": plain}, tmp_path) == []
    suppressed = sources["foremast_tpu_torch/jobs/podfix.py"].replace(
        "        def tick(self):", "        # the takeover ends a dead leader's claims (fixture)\n"
        "        # foremast: ignore[status-machine]\n        def tick(self):")
    prog = _program({**sources, "foremast_tpu_torch/jobs/podfix.py": suppressed})
    write_graph(str(tmp_path), build_graph(prog))
    assert apply_suppressions(check_status_machine(str(tmp_path), prog), prog.modules) == []


def test_statusgraph_artifact_roundtrip_and_staleness(tmp_path):
    prog = _program({
        "foremast_tpu_torch/jobs/modelsfix.py": STATUS_MODELS_FIX,
        "foremast_tpu_torch/jobs/workerfix.py": """
            from foremast_tpu_torch.jobs.modelsfix import (
                STATUS_HEALTHY,
                STATUS_INPROGRESS,
            )

            class Worker:
                def judge(self, doc):
                    if doc.status == STATUS_INPROGRESS:
                        doc.status = STATUS_HEALTHY
        """,
    })
    g = build_graph(prog)
    root = str(tmp_path)
    assert any("missing" in f.message for f in check_status_machine(root, prog))
    write_graph(root, g)
    assert load_graph(root) == g
    assert check_status_machine(root, prog) == []
    stale = dict(g)
    stale["transitions"] = g["transitions"][1:]
    with open(tmp_path / GRAPH_NAME, "w") as f:
        json.dump(stale, f)
    assert any("stale" in f.message for f in check_status_machine(root, prog))


def test_status_machine_scope_leaves_the_gateway_and_mesh_out(tmp_path):
    """`.status =` outside jobs/ and chaos/degrade.py is not a document's
    (the gateway's job records, mesh membership, the chaos plan)."""
    bad = "class Rec:\n    def set(self, v):\n        self.status = v\n"
    for path in ("foremast_tpu_torch/service/app.py", "foremast_tpu_torch/mesh/membership.py",
                 "foremast_tpu_torch/chaos/plan.py"):
        assert _status({"foremast_tpu_torch/jobs/modelsfix.py": STATUS_MODELS_FIX, path: bad}, tmp_path) == []
    inside = _status({"foremast_tpu_torch/jobs/modelsfix.py": STATUS_MODELS_FIX,
                      "foremast_tpu_torch/chaos/degrade.py": bad}, tmp_path)
    assert [f.message.split(" — ")[0] for f in inside] == ["dynamic status write in `Rec.set`"]


def test_tree_statusgraph_committed_in_sync(tree):
    """analysis_statusgraph_torch.json is committed and matches the graph
    computed from jobs/models.py and the write sites; the tree's one
    claim-span finding (`BrainWorker._tick`, JAX's too) carries its
    suppression."""
    modules, program = tree
    committed = load_graph(ROOT)
    assert committed is not None, "run python -m foremast_tpu_torch.analysis --write-statusgraph"
    assert _normalize(committed) == _normalize(build_graph(program))
    pairs = {(e["from"], e["to"], e["via"]) for e in committed["transitions"]}
    assert ("preprocess_inprogress", "preprocess_completed", "release") in pairs
    assert any(s["terminal"] for s in committed["statuses"])
    found = check_status_machine(ROOT, program)
    assert [(f.path, f.message.split(" has ")[0]) for f in found] == [
        ("foremast_tpu_torch/jobs/worker.py", "claim path `BrainWorker._tick`")]
    assert apply_suppressions(found, modules) == []


def test_statusgraph_equals_the_jax_graph():
    """The port's committed graph equals JAX's in its statuses and
    transitions, and in its writes compared by (function, status,
    from-set): the same machine, written at the same sites."""
    ours = load_graph(ROOT)
    with open(os.path.join(ROOT, JAX_GRAPH_NAME), encoding="utf-8") as f:
        jax = json.load(f)
    assert ours["statuses"] == jax["statuses"]
    assert ours["transitions"] == jax["transitions"]

    def writes(g):
        return sorted((w["fn"], w["status"], tuple(w["from"])) for w in g["writes"])

    assert writes(ours) == writes(jax) and len(writes(ours)) == 9


# ---------------------------------------------------------------------------
# parity with the JAX rules
# ---------------------------------------------------------------------------

SHARED = {
    "metrics_unregistered": ("metrics", METRICS_UNREGISTERED),
    "metrics_family": ("metrics", METRICS_FAMILY),
    "metrics_name_keyword": ("metrics", METRICS_NAME_KEYWORD),
    "metrics_dynamic": ("metrics", METRICS_DYNAMIC),
    "metrics_undocumented": ("metrics", METRICS_UNDOCUMENTED),
    "sharding_arena": ("sharding", {"foremast_tpu_torch/parallel/arenafix.py": ARENA_FIX}),
    "status_writes": ("status", STATUS_SHARED["status_writes"]),
    "status_claims": ("status", STATUS_SHARED["status_claims"]),
}


def port_pairs(kind: str, fixture, tmp_path) -> set:
    if kind == "metrics":
        registry = {**_REGISTRY, "foremast_half": frozenset()}
        found = analyze_source(src(fixture), METRICS_PATH,
                               [MetricsContractChecker(registry=registry, docs=_DOCS)])
    elif kind == "sharding":
        found = _sharding(fixture)
    else:
        found = _status(fixture, tmp_path)
    return {(f.rule, f.path, f.line) for f in found}


def jax_pairs(kind: str, fixture, tmp_path) -> set:
    """The same through the JAX package's rules, paths mapped back."""
    if kind == "metrics":
        registry = {**_REGISTRY, "foremast_half": frozenset()}
        found = jax_analyze_source(_to_jax(src(fixture)), _to_jax(METRICS_PATH),
                                   [JaxMetricsContract(registry=registry, docs=_DOCS)])
    else:
        modules = [JaxModule(_to_jax(p), _to_jax(src(s))) for p, s in fixture.items()]
        prog = JaxProgram(modules)
        if kind == "sharding":
            found = jax_apply_suppressions(jax_check_sharding(prog), modules)
        else:
            jax_write_status_graph(str(tmp_path), jax_build_status_graph(prog))
            found = jax_check_status(str(tmp_path), prog)
    return {(f.rule, f.path.replace("foremast_tpu/", "foremast_tpu_torch/"), f.line) for f in found}


@pytest.mark.parametrize("name", sorted(SHARED))
def test_parity_with_the_jax_rules(name, tmp_path):
    kind, fixture = SHARED[name]
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    ours.mkdir()
    theirs.mkdir()
    assert port_pairs(kind, fixture, ours) == jax_pairs(kind, fixture, theirs)


# ---------------------------------------------------------------------------
# the runner: the regenerate flags change nothing on this tree
# ---------------------------------------------------------------------------


def test_regenerate_flags_are_no_ops_on_the_tree(tmp_path, capsys, monkeypatch):
    """`--write-statusgraph` and `--update-metrics-docs` on a copy of the
    tree's artifacts rewrite them byte for byte."""
    from foremast_tpu_torch.analysis import __main__ as runner

    for name in (GRAPH_NAME, "README.md"):
        shutil.copy(os.path.join(ROOT, name), tmp_path / name)
    os.symlink(os.path.join(ROOT, "foremast_tpu_torch"), tmp_path / "foremast_tpu_torch")
    monkeypatch.setattr(runner, "repo_root", lambda: str(tmp_path))
    assert runner.main(["--update-metrics-docs"]) == 0
    assert "already current" in capsys.readouterr().out
    assert runner.main(["--write-statusgraph"]) == 0
    assert "9 statuses, 16 transitions, 9 write sites" in capsys.readouterr().out
    for name in (GRAPH_NAME, "README.md"):
        with open(os.path.join(ROOT, name), "rb") as a, open(tmp_path / name, "rb") as b:
            assert a.read() == b.read(), name
