"""The port's device-flow rule (`foremast_tpu_torch/analysis/device_flow.py`),
its direct call resolver (`interproc.Program.resolve_call_direct`) and the
premise of the three rules it records as "none", after the cases in
`tests/test_analysis.py`.

JAX's fixture is mapped from `foremast_tpu/` to `foremast_tpu_torch/`;
each case asserts what the JAX case asserts on the port's rule, and a
parity test runs every shared fixture through both packages' rules: the
same (rule, line) pairs come out. The torch forms have fixtures of their
own: each sink `tools/sync_probe.py` measured as a sync on the card, the
idioms it measured as none (Python iteration, per-element indexing,
which JAX's rule flags), uploads, tensor-annotated parameters, an `ops/`
helper reached from a dispatch root, the `per_block` applier, return
summaries, isinstance branches. The tree cases: the port's tree is
clean with the boundary markers on the counterparts of JAX's stages, and
an `.item()` put into the real `engine/scoring.py` `score_from_arena` is
found.

Bad code appears only as source strings, so neither package's gate,
both of which scan `tests/`, sees it."""

from __future__ import annotations

import ast
import pathlib
import textwrap

import pytest

from foremast_tpu.analysis.blocking_under_lock import apply_suppressions as jax_apply_suppressions
from foremast_tpu.analysis.core import Module as JaxModule
from foremast_tpu.analysis.device_flow import check_device_flow as jax_check_device_flow
from foremast_tpu.analysis.interproc import Program as JaxProgram
from foremast_tpu_torch.analysis.blocking_under_lock import apply_suppressions
from foremast_tpu_torch.analysis.core import Module, collect_modules, in_package, repo_root
from foremast_tpu_torch.analysis.device_flow import check_device_flow
from foremast_tpu_torch.analysis.interproc import Program

ROOT = repo_root()


def src(text: str) -> str:
    return textwrap.dedent(text)


def _to_jax(text: str) -> str:
    return text.replace("foremast_tpu_torch/", "foremast_tpu/").replace("foremast_tpu_torch.", "foremast_tpu.")


def _program(sources: dict) -> Program:
    return Program([Module(p, src(s)) for p, s in sources.items()])


def _device_flow(sources: dict) -> list:
    prog = _program(sources)
    return apply_suppressions(check_device_flow(prog), prog.modules)


def _lines(findings) -> list:
    return sorted((f.path.rsplit("/", 1)[-1], f.line) for f in findings)


@pytest.fixture(scope="module")
def tree():
    """The port's package, parsed once, and its `Program`."""
    modules = [m for m in collect_modules(ROOT) if in_package(m.relpath)]
    return modules, Program(modules)


# ---------------------------------------------------------------------------
# JAX's cases
# ---------------------------------------------------------------------------

DEVICE_FLOW_SRC = {
    "foremast_tpu_torch/engine/devfix.py": """
        import numpy as np

        def sweep(judge, tasks):
            res = judge.judge_columnar(tasks)
            total = float(res[0])
            rows = np.asarray(res[1])
            width = res[0].shape[0]
            return total, rows, width

        def drain(buf):
            return buf.item()

        def helper_sink(judge, tasks):
            res = judge.judge_columnar(tasks)
            return drain(res[0])

        # The fixture's designated decode stage: gathers the columnar
        # result once; everything it hands on is host.
        # foremast: device-boundary
        def decode(res):
            return [float(v) for v in res[0]]

        def caller(judge, tasks):
            res = judge.judge_columnar(tasks)
            out = decode(res)
            return sum(out)
    """,
}


def test_device_flow_flags_sinks_interprocedurally():
    """Sinks fire on dispatch-root taint in the same function and in a
    helper the tainted value is passed to; `.shape` reads stay clean."""
    findings = _device_flow(DEVICE_FLOW_SRC)
    assert findings and all(f.rule == "device-flow" for f in findings)
    msgs = "\n".join(f.message for f in findings)
    assert "`float()`" in msgs and "in `sweep`" in msgs
    assert "`np.asarray()`" in msgs
    assert "`.item()`" in msgs and "in `drain`" in msgs
    assert len(findings) == 3


def test_device_flow_boundary_neither_flags_nor_pushes_taint():
    msgs = "\n".join(f.message for f in _device_flow(DEVICE_FLOW_SRC))
    assert "in `decode`" not in msgs
    assert "in `caller`" not in msgs


def test_device_flow_sink_scope_excludes_host_only_modules():
    text = DEVICE_FLOW_SRC["foremast_tpu_torch/engine/devfix.py"]
    assert _device_flow({"foremast_tpu_torch/ingest/devfix.py": text}) == []


# ---------------------------------------------------------------------------
# the torch forms
# ---------------------------------------------------------------------------

ENGINE = "foremast_tpu_torch/engine/devfix.py"

# each idiom `tools/sync_probe.py` measured as a sync (or a failure) on
# an H100, applied to a pending's result
SYNC_SINKS = """
    import numpy as np
    import torch

    def sinks(judge, x):
        t = judge.judge_columnar_async(x).wait()
        a = t.item()
        b = t.tolist()
        c = t.cpu()
        d = t.numpy()
        e = t.to("cpu")
        f = float(t)
        g = int(t)
        h = bool(t)
        if t:
            pass
        i = np.asarray(t)
        j = sorted(t)
        k = t[t > 0]
        m = t[~t.isnan()]
        mask = t > 1
        n = t[mask]
        o = torch.where(t > 0)
        p = t.nonzero()
        q = torch.argwhere(t)
        r = torch.masked_select(t, mask)
        s = torch.unique(t)
        u = torch.bincount(t)
        v = torch.repeat_interleave(x, t)
        w = torch.allclose(t, t)
        y = torch.equal(t, t)
        z = torch.linalg.cholesky(t)
        zz = torch.linalg.inv(t) if not t.any() else None
        assert t.all()
"""

# each idiom it measured as none
NO_SYNC = """
    import torch

    def none(judge, x, k):
        t = judge.judge_columnar_async(x).wait()
        for row in t:
            row.add_(1)
        a = list(t)
        b = sum(t)
        c = t[3]
        d = t[k]
        e = [v * 2 for v in t]
        f = t.to("cpu", non_blocking=True)
        g = torch.where(t > 0, t, 0.0)
        h = torch.repeat_interleave(x, 2)
        i = torch.linalg.cholesky_ex(t)
        j = t.shape[0] + t.numel() + len(t)
        if t is None or t.ndim > 1 or t.dtype == torch.bool:
            pass
        t[t > 0] = 0.0
        return a, b, c, d, e, f, g, h, i, j
"""


def test_device_flow_torch_sinks_measured_as_syncs():
    findings = _device_flow({ENGINE: SYNC_SINKS})
    lines = [f.line for f in findings]
    # every idiom line from `a = t.item()` to `assert t.all()`, but the
    # `if` body's `pass` and `mask = t > 1` (a comparison stays on the card)
    want = [n for n in range(7, 35) if n not in (16, 21)]
    assert sorted(set(lines)) == want, [(f.line, f.message[:50]) for f in findings]
    msgs = "\n".join(f.message for f in findings)
    for what in ("`.item()`", "`.tolist()`", "`.cpu()`", "`.numpy()`", '`.to("cpu")` (blocking)', "`float()`",
                 "`int()`", "`bool()`", "a truth test", "`np.asarray()`", "`sorted()`", "boolean-mask indexing",
                 "one-argument `torch.where()`", "`.nonzero()`", "`torch.argwhere()`", "`torch.masked_select()`",
                 "`torch.unique()`", "`torch.bincount()`", "`repeat_interleave` with tensor repeats",
                 "`torch.allclose()`", "`torch.equal()`", "`torch.linalg.cholesky()`", "`torch.linalg.inv()`"):
        assert what in msgs, what


def test_device_flow_no_sink_where_the_card_measured_none():
    """Python iteration, `list()` / `sum()`, per-element indexing, a
    non-blocking copy, the three-argument `where`, int repeats, the `_ex`
    linalg forms, static reads and a masked store run through the sync
    debug mode: none is a finding (JAX's rule flags the iterations)."""
    assert _device_flow({ENGINE: NO_SYNC}) == []
    jax = _jax_pairs({ENGINE: NO_SYNC})
    assert {line for _r, _p, line in jax} == {6, 8, 9, 12}


UPLOADS = """
    import numpy as np
    import torch

    def uploads(values, dev, a: torch.Tensor):
        x = torch.tensor(values, device=dev)
        y = torch.as_tensor(values, device="cuda")
        z = torch.from_numpy(values).to(dev)
        w = torch.from_numpy(values).cuda()
        fine = torch.from_numpy(values).pin_memory().to(dev, non_blocking=True)
        cast = torch.from_numpy(values).to(torch.float32)
        host = torch.tensor(values, device="cpu")
        moved = torch.as_tensor(a, device=dev)
        return x, y, z, w, fine, cast, host, moved
"""


def test_device_flow_blocking_uploads_of_host_data():
    findings = _device_flow({ENGINE: UPLOADS})
    assert [(f.line, f.message.split(" on ")[0]) for f in findings] == [
        (6, "`torch.tensor(..., device=...)` (blocking upload)"),
        (7, "`torch.as_tensor(..., device=...)` (blocking upload)"),
        (8, "`torch.from_numpy(...).to(...)` (blocking upload)"),
        (9, "`torch.from_numpy(...).cuda(...)` (blocking upload)"),
    ]
    assert all("on host data" in f.message for f in findings)


SOURCES = """
    import numpy as np
    import torch

    from foremast_tpu_torch.ops.windows import to_device

    def annotated(x: torch.Tensor, y: "torch.Tensor | None", z: np.ndarray | torch.Tensor):
        s = float(x)
        s += float(y)
        s += float(z)
        return s

    def placed(judge, host, dev):
        a = judge._place(host)
        b = to_device(host, dev)
        c = torch.zeros(4, device=dev)
        d = torch.zeros(4)
        e = torch.zeros_like(a)
        f = torch.ones(4, device=d.device)
        g = torch.ones(4, device=a.device)
        s = float(a)
        s += float(b)
        s += float(c)
        s += float(d)
        s += float(e)
        s += float(f)
        s += float(g)
        return s

    def attrs(self, dev):
        self.buf = torch.zeros(4, device=dev)
        self.count = 3
        s = bool(self.buf)
        s = bool(self.count)
        return s
"""


def test_device_flow_torch_sources():
    """A tensor-annotated parameter (not a union with a host array), the
    placement hooks and placers, a factory on a card or beside a card
    tensor, a torch op on a card tensor, an attribute path assigned one."""
    lines = src(SOURCES).splitlines()
    found = [lines[f.line - 1].strip() for f in _device_flow({ENGINE: SOURCES})]
    assert found == ["s = float(x)", "s += float(y)", "s = float(a)", "s += float(b)", "s += float(c)",
                     "s += float(e)", "s += float(g)", "s = bool(self.buf)"]


def test_device_flow_return_summaries_do_not_leak_through_helpers():
    """A helper handed a card value by one caller gives the others back
    host values: its summary names the parameter that reaches its
    result."""
    text = """
        import torch

        def ident(x):
            return x

        def made(n, dev):
            return torch.zeros(n, device=dev)

        def on_card(judge, t):
            v = ident(judge._place(t))
            return float(v)

        def on_host(n):
            v = ident(n)
            return float(v)

        def makes(n, dev):
            return int(made(n, dev).sum())
    """
    assert _lines(_device_flow({ENGINE: text})) == [("devfix.py", 12), ("devfix.py", 19)]


def test_device_flow_applier_and_isinstance_branches():
    """`per_block(fn, batch, ...)` hands its card arguments to fn's
    parameters in order; in the branch an isinstance test rules out a
    tensor, the value is host."""
    text = """
        import numpy as np
        import torch

        def score(batch, level, rows, *, algo="ma"):
            if algo == "ma":
                return batch.sum().item()
            return level

        def dispatch(judge, batch, level):
            placed = judge._place(batch)
            return per_block(score, placed, level, algo="hw")

        def per_row(cutoff, like: torch.Tensor):
            if isinstance(cutoff, torch.Tensor):
                return cutoff.to(like.dtype)
            return torch.full((), float(cutoff), device=like.device)

        def host_or_card(x):
            return x.contiguous() if isinstance(x, torch.Tensor) else np.ascontiguousarray(x)

        def placed(judge, x):
            return host_or_card(judge._place(x))
    """
    findings = _device_flow({ENGINE: text})
    assert [(f.line, f.message.split(" on ")[0]) for f in findings] == [(7, "`.item()`")]


OPS_HELPER = {
    "foremast_tpu_torch/engine/judgefix.py": """
        from foremast_tpu_torch.ops.helperfix import reached

        class Judge:
            def judge_columnar_async(self, values):
                return reached(self._place(values))
    """,
    "foremast_tpu_torch/ops/helperfix.py": """
        def reached(values):
            return values * values.max().item()

        def unreached(values):
            return values * values.max().item()

        def cold(x: "torch.Tensor"):
            return x.sum().item()
    """,
}


def test_device_flow_checks_ops_helpers_a_dispatch_root_reaches():
    """In `ops/` and `models/` a function is checked when a dispatch root
    reaches it before a boundary (JAX leaves them to jit-hygiene); one
    nothing reaches is not, whatever it holds."""
    findings = _device_flow(OPS_HELPER)
    assert [(f.path.rsplit("/", 1)[-1], f.line, f.message.split(" — ")[0]) for f in findings] == [
        ("helperfix.py", 3, "`.item()` on a device value in `reached`")]
    boundary = dict(OPS_HELPER)
    boundary["foremast_tpu_torch/engine/judgefix.py"] = boundary["foremast_tpu_torch/engine/judgefix.py"].replace(
        "            def judge_columnar_async", "            # foremast: device-boundary\n"
        "            def judge_columnar_async")
    assert _device_flow(boundary) == []


def test_device_flow_gather_names_and_host_copy():
    """A root every definition of which is a boundary is a gather
    (`judge.joint_columnar`, untyped receiver); `_fetch` is one by name."""
    text = """
        class Judge:
            # the fixture's gather
            # foremast: device-boundary
            def joint_columnar(self, x):
                return self.joint_columnar_async(x).wait()

        def use(judge, x):
            flags = judge.joint_columnar(x)
            rows = judge._fetch(judge.judge_columnar_async(x))
            return bool(flags.any()), int(rows[0])
    """
    assert _device_flow({ENGINE: text}) == []


# ---------------------------------------------------------------------------
# parity with the JAX rule
# ---------------------------------------------------------------------------

SHARED = {
    "device_flow": DEVICE_FLOW_SRC,
    "device_flow_host_only": {"foremast_tpu_torch/ingest/devfix.py": DEVICE_FLOW_SRC[ENGINE]},
    "device_flow_pending": {"foremast_tpu_torch/jobs/devfix.py": """
        def finish(pending, docs):
            res = pending.wait()
            verdict = res[0]
            docs.append(int(verdict[0]))
            return docs, verdict.tolist()
    """},
}


def _jax_pairs(sources: dict) -> set:
    modules = [JaxModule(_to_jax(p), _to_jax(src(s))) for p, s in sources.items()]
    found = jax_apply_suppressions(jax_check_device_flow(JaxProgram(modules)), modules)
    return {(f.rule, f.path.replace("foremast_tpu/", "foremast_tpu_torch/"), f.line) for f in found}


@pytest.mark.parametrize("name", sorted(SHARED))
def test_parity_with_the_jax_rule(name):
    ours = {(f.rule, f.path, f.line) for f in _device_flow(SHARED[name])}
    assert ours == _jax_pairs(SHARED[name])


# ---------------------------------------------------------------------------
# resolve_call_direct
# ---------------------------------------------------------------------------

RESOLVE = """
    class Store:
        def claim(self, n):
            return []

    class Leader(Store):
        def claim(self, n):
            return self.inner.claim(n)

    class Worker:
        def __init__(self, store: Store):
            self.store = store
            self.hook = self.on_done

        def on_done(self, x):
            return x

        def tick(self):
            self.store.claim(1)
            self.hook(2)
            box = Store()

            def inner():
                return helper()

            def helper():
                return 3

            return inner()
"""


def test_resolve_call_direct_names_callees_and_follows_overrides():
    prog = _program({"foremast_tpu_torch/jobs/resfix.py": RESOLVE})
    tick = next(f for f in prog.functions if f.qualname == "Worker.tick")
    inner = next(f for f in prog.functions if f.qualname == "Worker.tick.inner")
    calls = {ast.unparse(c.func): c for c in ast.walk(tick.node) if isinstance(c, ast.Call)}

    def direct(fn, call):
        return sorted(f.qualname for f in prog.resolve_call_direct(call, fn))

    assert direct(tick, calls["self.store.claim"]) == ["Leader.claim", "Store.claim"]
    # the callback table resolves `self.hook(...)` to `on_done`; the direct
    # resolver keeps only callees the call names
    assert [f.qualname for f in prog.resolve_call(calls["self.hook"], tick)] == ["Worker.on_done"]
    assert direct(tick, calls["self.hook"]) == []
    assert direct(tick, calls["Store"]) == []  # no __init__: nothing to call
    assert direct(tick, calls["inner"]) == ["Worker.tick.inner"]
    helper_call = next(c for c in ast.walk(inner.node) if isinstance(c, ast.Call))
    # a bare name a nested def calls: the closure its enclosing function defines
    assert direct(inner, helper_call) == ["Worker.tick.helper"]
    # memoized: the same list object a second time
    assert prog.resolve_call_direct(calls["self.store.claim"], tick) is prog.resolve_call_direct(
        calls["self.store.claim"], tick)


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------


def test_device_flow_tree_clean_with_boundaries_on_jax_counterparts(tree):
    modules, program = tree
    assert apply_suppressions(check_device_flow(program), modules) == []
    marked = sorted(fn.qualname for fn in program.functions if fn.module.marked_def(fn.node, "device-boundary"))
    assert marked == sorted([
        "BrainWorker._decode_uni", "HealthJudge._decode_bucket", "_HostCopy.unpack", "_HostCopy.wait",
        "engine.multivariate._coerce_entry", "MultivariateJudge._pairwise", "MultivariateJudge._judge_bivariate",
        "MultivariateJudge._judge_lstm_group", "MultivariateJudge._fit_mvn_batch",
        "MultivariateJudge.joint_columnar",
    ])


@pytest.mark.parametrize("sink", ["_ = level.sum().item()", "_ = int(rows.max())", "_ = bool(trend.any())"])
def test_device_flow_finds_a_sync_put_into_score_from_arena(tree, sink):
    """The warm dispatch's arena scoring with a sync put into it: found,
    at its line."""
    modules, _ = tree
    scoring = next(m for m in modules if m.relpath == "foremast_tpu_torch/engine/scoring.py")
    anchor = "    def take(a):\n        return a.index_select(0, rows)\n"
    assert anchor in scoring.source
    source = scoring.source.replace(anchor, anchor + f"\n    {sink}\n", 1)
    line = source[: source.index(sink)].count("\n") + 1
    mutated = [Module(m.relpath, source) if m is scoring else m for m in modules]
    findings = apply_suppressions(check_device_flow(Program(mutated)), mutated)
    assert [(f.path, f.line) for f in findings] == [("foremast_tpu_torch/engine/scoring.py", line)]
    assert "in `score_from_arena`" in findings[0].message


# ---------------------------------------------------------------------------
# the premise of the three recorded "none"
# ---------------------------------------------------------------------------

_COMPILERS = ("torch.compile", "torch.jit", "torch.cuda.graph", "torch.cuda.CUDAGraph", "CUDAGraph", "torch._dynamo")


def test_the_port_compiles_nothing_at_run_time():
    """jit-hygiene, recompile-hazard and recompile-witness have no
    counterpart in the port because nothing in it is traced or compiled
    per shape: no `torch.compile`, `torch.jit`, CUDA graph or dynamo, by
    name or by import."""
    found = []
    for path in sorted(pathlib.Path(ROOT, "foremast_tpu_torch").rglob("*.py")):
        if path.parts[-2] == "analysis":
            continue  # the rules name these in their documentation
        for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
            if isinstance(node, (ast.Attribute, ast.Name)):
                names = [ast.unparse(node)]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            for name in names:
                if any(name == c or name.startswith(c + ".") for c in _COMPILERS):
                    found.append(f"{path.relative_to(ROOT)}:{node.lineno}: {name}")
    assert found == [], (
        "the port now compiles at run time; port jit-hygiene, recompile-hazard and recompile-witness "
        "(foremast_tpu/analysis/) before this lands:\n" + "\n".join(found))


def test_the_recompile_witness_stays_refused(monkeypatch):
    import argparse

    from foremast_tpu_torch import cli

    monkeypatch.setenv("FOREMAST_RECOMPILE_WITNESS", "1")
    with pytest.raises(NotImplementedError, match="XLA recompiles"):
        cli._refuse_unported(argparse.Namespace())
