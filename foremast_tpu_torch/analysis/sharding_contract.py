"""sharding-contract: uploads stay behind the placement seam, and sharded
code declares its arena accesses.

The port's torch form of `foremast_tpu/analysis/sharding_contract.py`.
The device mesh works because placement is central: every buffer that
enters a dispatch goes through `HealthJudge._place` / `_place_cols`,
which `ShardedJudge` overrides to split it over the mesh. A direct upload
in warm-path code puts the buffer on the default card first, which makes
the mesh placement a second copy, or bypasses the partition and breaks
the parity between the sharded and the plain judge.

Two checks:

  * PLACEMENT, in ``foremast_tpu_torch/jobs/`` (the worker keeps its
    buffers as host numpy until the judge places them) and
    ``foremast_tpu_torch/parallel/batch.py`` (the sharded judge itself):
    an upload outside `_place` / `_place_cols` is a finding. An upload
    is a ``.cuda()`` call, a ``.to(...)`` on a tensor just made from host
    data (``torch.tensor`` / ``torch.as_tensor`` / ``torch.from_numpy``),
    or a tensor factory called with ``device=`` (``torch.tensor(x,
    device=d)``, ``torch.zeros(n, device=d)``). A factory whose device is
    an existing tensor's own (``device=a.device``) allocates beside that
    tensor and places nothing; a literal ``device="cpu"`` stays on the
    host. `ops/windows.py`'s `to_device` and `parallel/mesh.py` are the
    placement library the hooks call, and stay out of scope.
  * SHARDED ARENA, in ``foremast_tpu_torch/parallel/``: an arena
    reference must sit in a function marked ``# foremast: sharded-arena``
    (or on a marked line). An arena over a mesh keeps one buffer a device
    holding its shards' blocks, with position i of a B-row batch on block
    ``i // (B / shards)``, so the per-block programs gather device-local
    rows (`arena.device_rows`). A new arena access in parallel/ declares
    that it keeps that layout: global rows fed to a device-local gather,
    or a concatenation that re-blocks the row axis, would read the wrong
    rows or move them between cards.
"""

from __future__ import annotations

import ast

from foremast_tpu_torch.analysis.core import PACKAGE, Finding
from foremast_tpu_torch.analysis.interproc import FunctionInfo, Program, dotted, own_body_walk

RULE = "sharding-contract"
ARENA_MARKER = "sharded-arena"

PLACEMENT_HOOKS = frozenset({"_place", "_place_cols"})
PLACEMENT_SCOPE = (f"{PACKAGE}/jobs/", f"{PACKAGE}/parallel/batch.py")
ARENA_SCOPE = (f"{PACKAGE}/parallel/",)

# torch calls that turn host data into a tensor
FROM_HOST = frozenset({"torch.tensor", "torch.as_tensor", "torch.from_numpy", "torch.asarray"})
# torch calls that make a tensor where `device=` says
FACTORIES = FROM_HOST | frozenset({
    "torch.zeros", "torch.ones", "torch.empty", "torch.full", "torch.arange", "torch.linspace",
    "torch.eye", "torch.rand", "torch.randn", "torch.randint", "torch.randperm", "torch.zeros_like",
    "torch.ones_like", "torch.empty_like", "torch.full_like",
})


def check_sharding_contract(program: Program) -> list[Finding]:
    findings: list[Finding] = []
    for fn in program.functions:
        rel = fn.module.relpath
        if rel.startswith(PLACEMENT_SCOPE) and fn.name not in PLACEMENT_HOOKS:
            findings.extend(_placement_findings(fn))
        if rel.startswith(ARENA_SCOPE):
            findings.extend(_arena_findings(fn))
    return findings


def kwarg(call: ast.Call, name: str) -> ast.AST | None:
    return next((kw.value for kw in call.keywords if kw.arg == name), None)


def is_cpu(node: ast.AST | None) -> bool:
    """A literal host device: "cpu", or torch.device("cpu")."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and dotted(node.func) == "torch.device" and node.args:
        return is_cpu(node.args[0])
    return False


def to_target(call: ast.Call) -> ast.AST | None:
    """The device (or dtype) a `.to(...)` call names."""
    return kwarg(call, "device") or (call.args[0] if call.args else None)


def device_target(call: ast.Call) -> ast.AST | None:
    """The device a `.to(...)` call moves to, or None for a dtype cast: a
    string, a `.device`, `torch.device(...)`, or a name that says "dev"."""
    target = to_target(call)
    if target is None or (isinstance(target, ast.Attribute) and target.attr == "dtype"):
        return None
    if isinstance(target, ast.Constant) or (isinstance(target, ast.Attribute) and target.attr == "device"):
        return target
    if isinstance(target, ast.Call) and dotted(target.func) == "torch.device":
        return target
    return target if "dev" in (dotted(target) or "").rsplit(".", 1)[-1].lower() else None


def upload_form(call: ast.Call) -> str | None:
    """How `call` puts data on a card, as the finding names it, or None."""
    func = call.func
    d = dotted(func)
    if isinstance(func, ast.Attribute) and func.attr == "cuda":
        return ".cuda()"
    if isinstance(func, ast.Attribute) and func.attr == "to" and isinstance(func.value, ast.Call):
        inner = dotted(func.value.func)
        target = device_target(call)
        if inner in FROM_HOST and target is not None and not is_cpu(target):
            return f"{inner}(...).to(...)"
    if d in FACTORIES:
        device = kwarg(call, "device")
        if device is None or is_cpu(device):
            return None
        if isinstance(device, ast.Attribute) and device.attr == "device":
            return None  # beside an existing tensor
        return f"{d}(..., device=...)"
    return None


def _placement_findings(fn: FunctionInfo) -> list[Finding]:
    out: list[Finding] = []
    for node in own_body_walk(fn.node):
        if not isinstance(node, ast.Call):
            continue
        form = upload_form(node)
        if form is None:
            continue
        out.append(fn.module.finding(
            RULE, node,
            f"direct upload `{form}` in warm-path code (`{fn.name}`): buffers entering a sharded "
            "dispatch must go through `_place`/`_place_cols` — committing to the default card first "
            "makes the mesh placement a second copy (or bypasses the partition entirely)",
            hint="keep the buffer host-side (numpy) and let the judge's placement hook put it on the "
            "mesh; a bench-only constructor may carry `# foremast: ignore[sharding-contract]` with "
            "its reason",
        ))
    return out


def _arena_findings(fn: FunctionInfo) -> list[Finding]:
    if fn.module.marked_def(fn.node, ARENA_MARKER):
        return []
    for node in own_body_walk(fn.node):
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        else:
            continue
        if "arena" not in name.lower():
            continue
        # a marked line counts too (a single-expression access)
        if fn.module.marked(getattr(node, "lineno", fn.node.lineno), ARENA_MARKER):
            continue
        # one finding a function is enough signal
        return [fn.module.finding(
            RULE, node,
            f"arena reference `{name}` in sharded code (`{fn.name}`) without the sharded-arena "
            "annotation — arena rows block-shard over the data axis with position-tied placement "
            "(ShardedJudge._arena_sharding); code that touches them from parallel/ must declare it "
            "honors that layout",
            hint="annotate the enclosing def (or this line) with `# foremast: sharded-arena` after "
            "checking the access keeps row placement aligned with batch position (device-local rows "
            "into per-block gathers, no row-axis re-blocking)",
        )]
    return []
