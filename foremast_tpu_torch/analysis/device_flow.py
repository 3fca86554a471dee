"""device-flow: implicit device-to-host syncs outside the gather stages.

The port's torch form of `foremast_tpu/analysis/device_flow.py`. The warm
tick's contract is ONE blocking device-to-host copy a dispatch: the
gather at `HealthJudge._fetch` / `_host_copy` (`_HostCopy`, waited by
`ColumnarPending.wait`). Everything upstream is queued on the card;
everything downstream decodes host arrays. The regression this rule
catches is the quiet one: a `.item()`, a `float()`, an `if` on a tensor,
each a round trip the tick then pays on every dispatch. The card finds
them under `torch.cuda.set_sync_debug_mode("error")`; this rule finds
them on the CPU, before they run.

The model is an interprocedural taint over `interproc.Program`, kept as
sets of labels: DEV (a value on the card) and the names of the
enclosing function's parameters.

  * SOURCES (DEV): the dispatch roots (`judge_columnar`,
    `judge_columnar_async`, `joint_columnar`, `joint_columnar_async`;
    a root marked as a boundary is a gather instead), a ``.wait()`` on a
    pending, the placement hooks (`_place`, `_place_cols`) and placers
    (`ops.windows.to_device`, `parallel.mesh.place`), an upload
    (``.cuda()``, a ``.to()`` of a device, a factory with a card
    ``device=``; ``device=x.device`` puts the result where x is), and a
    parameter annotated ``torch.Tensor``: the port's programs run
    eagerly, so a tensor argument on the dispatch path is on the card
    where JAX's would be a traced value.
  * PROPAGATION: a torch op carries its inputs' labels (its result lies
    where they do); local assignments (a tuple unpacked element by
    element, a ``for`` target from what it iterates, ``zip`` and
    ``enumerate`` pairwise), attribute paths (``self.state = ...``);
    each function's return SUMMARY (DEV, or the parameters whose
    values reach its result), so a call's result is on the card when
    its callee makes a card value or hands an argument back; call
    arguments into the parameters of the callees (`resolve_call_direct`)
    and of a function passed beside them (``per_block(score_from_arena,
    batch, ...)``); to a fixpoint over a worklist.
  * SINKS, measured: `tools/sync_probe.py` ran each idiom on an H100
    under the sync debug mode. Those that synchronize: ``.item()``,
    ``.tolist()``, ``.cpu()``, a ``.to("cpu")`` that is not
    ``non_blocking=True``, ``float()`` / ``int()`` / ``bool()``, a truth
    test (``if`` / ``while`` / ``assert`` / a conditional expression /
    ``not``; ``x is None`` reads no value), ``sorted()``, boolean-mask
    indexing (an index that is a comparison, an ``~`` / ``&`` / ``|``
    of one, or a value named ``*mask*``), one-argument
    ``torch.where``, ``nonzero``, ``argwhere``, ``masked_select``,
    ``unique``, ``bincount``, ``repeat_interleave`` with tensor repeats
    and no ``output_size``, ``torch.allclose``, ``torch.equal`` (a
    Python bool of card data, which the debug mode does not report),
    ``torch.linalg.cholesky`` / ``inv`` / ``solve`` / ``eigh``, and a
    blocking upload of host data (``torch.tensor(host, device=d)``,
    ``torch.from_numpy(a).to(d)`` without ``non_blocking=True``). Those
    that fail on a card tensor: ``.numpy()``, ``np.asarray`` and
    friends. Python iteration over a tensor, ``list()`` / ``sum()`` of
    one and per-element indexing do NOT synchronize (the probe ran them
    through), so, unlike JAX's rule, they are no sinks.
  * BOUNDARY: a function marked ``# foremast: device-boundary`` (on or
    above its ``def``) is a sanctioned gather or decode stage: sinks in
    it are the design, its result is host, and what it hands on is
    host. The marker goes on a stage's entry point, not on every helper
    it feeds.

Static reads (``.shape`` / ``.ndim`` / ``.dtype`` / ``.device`` /
``.numel()`` / ``.size()`` and the like, ``len()``, ``isinstance()``)
carry no labels. In the branch an ``isinstance(x, torch.Tensor)`` test
rules out, x is host.

Sinks are checked in ``engine/``, ``jobs/`` and ``parallel/`` (JAX's
scope), and in every function of ``ops/`` and ``models/`` that a
dispatch root reaches before a boundary: in JAX those run traced under
jit, where jit-hygiene guards them; in the port they run eagerly, so a
``.item()`` there is a real sync on every warm dispatch. The host-only
packages (ingest/, metrics/, mesh/, the CLI, deploy, observe) hold no
card values by construction and are not checked; taint still flows
through them.
"""

from __future__ import annotations

import ast
import collections

from foremast_tpu_torch.analysis.core import PACKAGE, Finding
from foremast_tpu_torch.analysis.interproc import FunctionInfo, Program, dotted, own_body_walk
from foremast_tpu_torch.analysis.sharding_contract import (
    FACTORIES,
    FROM_HOST,
    device_target,
    is_cpu,
    kwarg,
    to_target,
)

RULE = "device-flow"
BOUNDARY_MARKER = "device-boundary"

DISPATCH_ROOTS = frozenset({"judge_columnar", "judge_columnar_async", "joint_columnar", "joint_columnar_async"})
PLACEMENT_HOOKS = frozenset({"_place", "_place_cols", "to_device"})
# placers called through their module (`meshlib.place(...)`)
PLACERS = frozenset({"parallel.mesh.place"})
SINK_SCOPE = (f"{PACKAGE}/engine/", f"{PACKAGE}/jobs/", f"{PACKAGE}/parallel/")
REACHED_SCOPE = (f"{PACKAGE}/ops/", f"{PACKAGE}/models/")

_NP_NAMES = frozenset({"np", "numpy"})
_NP_MATERIALIZERS = frozenset({"asarray", "array", "asanyarray", "ascontiguousarray"})
_SYNC_BUILTINS = frozenset({"float", "int", "bool"})
_STATIC_ATTRS = frozenset({
    "shape", "ndim", "dtype", "size", "nbytes", "device", "is_cuda", "numel", "dim", "stride",
    "element_size", "is_contiguous", "data_ptr", "requires_grad", "layout", "devices", "is_pinned",
    "storage_offset", "untyped_storage", "is_floating_point",
})
_STATIC_CALLS = frozenset({
    "len", "isinstance", "hasattr", "getattr", "id", "type", "callable", "dataclasses.is_dataclass",
    "dataclasses.fields", "torch.is_tensor",
})
_TENSOR_TYPES = frozenset({"torch.Tensor", "Tensor"})
_TO_HOST = frozenset({"item", "tolist", "cpu", "numpy"})
# tensor methods and torch functions whose output size depends on the
# data (the host reads a count first), and torch functions that read a
# result back (`tools/sync_probe.py` on the card; `torch.equal`'s Python
# bool is such a read, which the debug mode does not report)
_DATA_SIZED = frozenset({"nonzero", "argwhere", "masked_select", "unique", "unique_consecutive", "bincount"})
_SYNCING_TORCH = frozenset({f"torch.{n}" for n in _DATA_SIZED} | {
    "torch.allclose", "torch.equal", "torch.linalg.cholesky", "torch.linalg.inv", "torch.linalg.solve",
    "torch.linalg.eigh",
})


def _non_blocking(call: ast.Call) -> bool:
    v = kwarg(call, "non_blocking")
    return isinstance(v, ast.Constant) and v.value is True


def _is_pending_wait(call: ast.Call) -> bool:
    """`<something pending>.wait()`: the gather half of the async
    dispatch. The receiver must mention "pending", so an `event.wait()`
    never taints."""
    func = call.func
    if not (isinstance(func, ast.Attribute) and func.attr == "wait"):
        return False
    return "pending" in (dotted(func.value) or "").lower()


def _looks_boolean(index: ast.AST) -> bool:
    """An index that is a boolean mask by its form."""
    if isinstance(index, ast.Compare):
        return True
    if isinstance(index, ast.UnaryOp) and isinstance(index.op, ast.Invert):
        return True
    if isinstance(index, ast.BinOp) and isinstance(index.op, (ast.BitAnd, ast.BitOr)):
        return _looks_boolean(index.left) or _looks_boolean(index.right)
    name = dotted(index)
    return name is not None and "mask" in name.rsplit(".", 1)[-1].lower()


DEV = "<device>"  # the label of a value made on the card


def _iter_pairs(target: ast.AST, it: ast.AST) -> list[tuple[ast.AST, ast.AST | None]]:
    """(target, what it takes its labels from) of a loop over `it`:
    `for a, b in zip(x, y)` binds a to x and b to y, `for i, v in
    enumerate(x)` binds i to nothing (a host index) and v to x, any other
    loop binds the whole target to `it`."""
    if isinstance(it, ast.Call) and isinstance(target, ast.Tuple) and not it.keywords:
        name = dotted(it.func)
        if name == "zip" and len(it.args) == len(target.elts):
            return list(zip(target.elts, it.args))
        if name == "enumerate" and len(it.args) == 1 and len(target.elts) == 2:
            return [(target.elts[0], None)] + _iter_pairs(target.elts[1], it.args[0])
    return [(target, it)]


def _assign_pairs(node: ast.Assign) -> list[tuple[ast.AST, list[ast.AST]]]:
    """(value, targets) of an assignment, element by element where a tuple
    is unpacked from a tuple display (`d, rows = devs[i], a[j]`)."""
    value = node.value
    if (len(node.targets) == 1 and isinstance(node.targets[0], ast.Tuple) and isinstance(value, ast.Tuple)
            and len(value.elts) == len(node.targets[0].elts)
            and not any(isinstance(e, ast.Starred) for e in (*value.elts, *node.targets[0].elts))):
        return [(v, [t]) for t, v in zip(node.targets[0].elts, value.elts)]
    return [(value, node.targets)]


def _target_keys(target: ast.AST) -> list[str]:
    """The env keys an assignment target writes: a name, an attribute path
    (`self.state`), the container a subscript stores into, each element
    of a tuple target."""
    if isinstance(target, (ast.Tuple, ast.List)):
        return [k for elt in target.elts for k in _target_keys(elt)]
    if isinstance(target, ast.Starred):
        return _target_keys(target.value)
    while isinstance(target, ast.Subscript):
        target = target.value
    key = dotted(target)
    return [key] if key is not None else []


def _param_names(fn: FunctionInfo) -> list[str]:
    """Every parameter in binding order: positional, `*args`, keyword-only,
    `**kwargs` (`self` included)."""
    a = fn.node.args
    out = [p.arg for p in (*a.posonlyargs, *a.args)]
    if a.vararg is not None:
        out.append(a.vararg.arg)
    out += [p.arg for p in a.kwonlyargs]
    if a.kwarg is not None:
        out.append(a.kwarg.arg)
    return out


def _tensor_params(fn: FunctionInfo) -> set[str]:
    """Parameters annotated as tensors (`torch.Tensor`, `Tensor | None`):
    the eager counterparts of JAX's traced arguments, on the card on the
    port's dispatch path."""
    a = fn.node.args
    out = set()
    for p in (*a.posonlyargs, *a.args, *a.kwonlyargs):
        text = ast.unparse(p.annotation) if p.annotation is not None else ""
        parts = {part.strip().strip("'\"") for part in text.split("|")} - {"None"}
        if parts and parts <= _TENSOR_TYPES:
            out.add(p.arg)
    return out


def bind_args(callee: FunctionInfo, call: ast.Call) -> list[tuple[str, ast.AST]]:
    """(parameter, argument expression) pairs of a call: the receiver of a
    method call binds `self`, a `*spread` every positional parameter from
    its place on, a `**spread` every parameter."""
    a = callee.node.args
    positional = [p.arg for p in (*a.posonlyargs, *a.args)]
    keyword = positional + [p.arg for p in a.kwonlyargs]
    out: list[tuple[str, ast.AST]] = []
    if positional and positional[0] in ("self", "cls"):
        if isinstance(call.func, ast.Attribute) and callee.class_key is not None:
            out.append((positional[0], call.func.value))
        positional = positional[1:]
    for i, arg in enumerate(call.args):
        if isinstance(arg, ast.Starred):
            rest = positional[i:] + ([a.vararg.arg] if a.vararg is not None else [])
            out += [(p, arg.value) for p in rest]
            break
        if i < len(positional):
            out.append((positional[i], arg))
        elif a.vararg is not None:
            out.append((a.vararg.arg, arg))
    for kw in call.keywords:
        if kw.arg is None:
            out += [(p, kw.value) for p in keyword]
        elif kw.arg in keyword:
            out.append((kw.arg, kw.value))
        elif a.kwarg is not None:
            out.append((a.kwarg.arg, kw.value))
    return out


class _Flow:
    """The taint as sets of LABELS: `DEV` (made on the card) and the names
    of the enclosing function's parameters (whatever a caller hands in).
    A function's return SUMMARY is the labels its returns carry, so a
    call's result is on the card when the callee makes a card value
    itself or hands back an argument that is one; a helper that takes a
    card value from one caller does not taint what it returns to the
    others. The sink pass reads a function's labels against the
    parameters some caller hands a card value (`tainted_params`)."""

    def __init__(self, program: Program):
        self.program = program
        self.boundary: set[int] = set()
        # names every definition of which is a boundary: a call by that
        # name is a gather, whatever its receiver (`judge.joint_columnar`)
        self.boundary_names: set[str] = set()
        # grown to a fixpoint by check_device_flow:
        self.returns: dict[int, frozenset] = {}
        self.tainted_params: dict[int, set[str]] = {}
        self._envs: dict[int, dict] = {}
        self._assigns: dict[int, list] = {}

    def is_boundary(self, fn: FunctionInfo) -> bool:
        return id(fn) in self.boundary

    def _upload(self, call: ast.Call, env: dict, fn: FunctionInfo) -> frozenset | None:
        """The labels of an upload's result (`.cuda()`, a `.to()` of a card,
        a factory with a card's `device=`; a tensor's own `.device` puts
        the result where that tensor is), or None: not an upload."""
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr == "cuda":
            return frozenset({DEV})
        if isinstance(func, ast.Attribute) and func.attr == "to":
            device = device_target(call)
        elif dotted(func) in FACTORIES:
            device = kwarg(call, "device")
        else:
            return None
        if device is None or is_cpu(device):
            return None
        if isinstance(device, ast.Attribute) and device.attr == "device":
            return self.labels(device.value, env, fn)
        return frozenset({DEV})

    def _source(self, call: ast.Call, env: dict, fn: FunctionInfo) -> frozenset | None:
        """The labels of a call that makes a card value, or None."""
        up = self._upload(call, env, fn)
        if up is not None:
            return up
        name = call.func.attr if isinstance(call.func, ast.Attribute) else (
            call.func.id if isinstance(call.func, ast.Name) else None)
        if (name in DISPATCH_ROOTS and name not in self.boundary_names) or name in PLACEMENT_HOOKS \
                or _is_pending_wait(call):
            return frozenset({DEV})
        if any(c.qualname in PLACERS for c in self.program.resolve_call_direct(call, fn)):
            return frozenset({DEV})
        return None

    @staticmethod
    def _barrier(call: ast.Call) -> bool:
        """Calls whose result is host whatever their arguments: the
        designated gather `_fetch`, the explicit conversions (the sink
        pass flags those on their own; taint must not survive them and
        report twice downstream) and a `.to()` of the host."""
        d = dotted(call.func)
        if d is not None and "." in d and d.split(".", 1)[0] in _NP_NAMES and d.rsplit(".", 1)[1] in _NP_MATERIALIZERS:
            return True
        if d in _SYNC_BUILTINS or d in _STATIC_CALLS:
            return True
        if isinstance(call.func, ast.Name):
            return call.func.id == "_fetch"
        if isinstance(call.func, ast.Attribute):
            attr = call.func.attr
            return attr in _TO_HOST or attr == "_fetch" or (attr == "to" and is_cpu(to_target(call)))
        return False

    def _gather_name(self, call: ast.Call) -> bool:
        name = call.func.attr if isinstance(call.func, ast.Attribute) else (
            call.func.id if isinstance(call.func, ast.Name) else None)
        return name in self.boundary_names

    def _call_labels(self, call: ast.Call, env: dict, fn: FunctionInfo) -> frozenset | None:
        """The labels of a call's result, or None for an unresolved call
        (whose result the caller takes from the whole expression)."""
        if self._barrier(call):
            return frozenset()
        callees = self.program.resolve_call_direct(call, fn)
        if any(self.is_boundary(c) for c in callees) or self._gather_name(call):
            return frozenset()  # gathered and decoded: host
        src = self._source(call, env, fn)
        if src is not None:
            return src
        d = dotted(call.func)
        if d in FACTORIES:
            # no `device=`: a host tensor, but torch.tensor / as_tensor of a
            # card tensor and a `*_like` stay where their input is
            return None if d in FROM_HOST or d.endswith("_like") else frozenset()
        if not callees:
            return None
        out: set = set()
        for callee in callees:
            if callee.name == "__init__":
                # a constructed object holds what it was given
                out |= self.labels(ast.Tuple(elts=[*call.args, *(k.value for k in call.keywords)]), env, fn)
                continue
            summary = self.returns.get(id(callee), frozenset())
            if DEV in summary:
                out.add(DEV)
            for param, arg in bind_args(callee, call):
                if param in summary:
                    out |= self.labels(arg, env, fn)
        return frozenset(out)

    def labels(self, expr: ast.AST, env: dict, fn: FunctionInfo) -> frozenset:
        """The labels `expr` carries (outside static reads)."""
        out: set = set()
        stack = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
                continue  # x.shape and friends are host metadata
            if isinstance(node, ast.Compare) and all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                continue  # `x is None` is a host bool
            if isinstance(node, ast.Call):
                got = self._call_labels(node, env, fn)
                if got is not None:
                    out |= got
                    continue
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)):
                # the element, with each target bound to what it iterates
                inner = dict(env)
                for gen in node.generators:
                    for target, value in _iter_pairs(gen.target, gen.iter):
                        got = set(self.labels(value, inner, fn)) if value is not None else set()
                        for name in _target_keys(target):
                            inner[name] = got
                elts = [node.key, node.value] if isinstance(node, ast.DictComp) else [node.elt]
                for elt in elts:
                    out |= self.labels(elt, inner, fn)
                continue
            elif isinstance(node, ast.Name):
                out |= env.get(node.id, set())
            elif isinstance(node, ast.Attribute):
                # `self.state` assigned a card value in this function
                out |= env.get(dotted(node) or "", set())
            stack.extend(ast.iter_child_nodes(node))
        return frozenset(out)

    def env(self, fn: FunctionInfo) -> dict:
        """Local name -> labels: each parameter its own name (and DEV when
        annotated as a tensor), each assignment its value's, to a fixpoint."""
        env = {p: {p} for p in _param_names(fn)}
        for p in _tensor_params(fn):
            env[p].add(DEV)
        assigns = self._assigns.get(id(fn))
        if assigns is None:
            assigns = []
            for node in own_body_walk(fn.node):
                if isinstance(node, ast.Assign):
                    assigns += _assign_pairs(node)
                elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and node.value is not None:
                    assigns.append((node.value, [node.target]))
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    assigns += [(value, [target]) for target, value in _iter_pairs(node.target, node.iter)
                                if value is not None]
            self._assigns[id(fn)] = assigns
        changed = True
        while changed:
            changed = False
            for value, targets in assigns:
                got = self.labels(value, env, fn)
                if not got:
                    continue
                for t in targets:
                    for key in _target_keys(t):
                        if not got <= env.setdefault(key, set()):
                            env[key] |= got
                            changed = True
        return env

    def device_labels(self, fn: FunctionInfo) -> set:
        """The labels that mean a card value inside `fn`."""
        return {DEV} | self.tainted_params.get(id(fn), set())

    def taint_param(self, callee: FunctionInfo, param: str) -> bool:
        into = self.tainted_params.setdefault(id(callee), set())
        if param in into or param in ("self", "cls"):
            return False
        into.add(param)
        return True


def _ref_targets(program: Program, node: ast.AST, fn: FunctionInfo) -> list[FunctionInfo]:
    """The functions a reference expression (not a call) names:
    `scoring.score_from_arena`, `helper`, `self._method`."""
    if isinstance(node, ast.Name):
        found = program._local_function(node.id, fn)
        return [found] if found is not None else []
    if isinstance(node, ast.Attribute):
        named = program.resolve_call(ast.Call(func=node, args=[], keywords=[]), fn)
        return [c for c in named if c.name == node.attr]
    return []


def check_device_flow(program: Program) -> list[Finding]:
    flow = _Flow(program)
    for fn in program.functions:
        if fn.module.marked_def(fn.node, BOUNDARY_MARKER):
            flow.boundary.add(id(fn))
    names = {fn.name for fn in program.functions}
    flow.boundary_names = names - {fn.name for fn in program.functions if not flow.is_boundary(fn)}
    live = [fn for fn in program.functions if not flow.is_boundary(fn)]
    calls = {id(fn): [n for n in own_body_walk(fn.node) if isinstance(n, ast.Call)] for fn in live}
    rets = {id(fn): [n.value for n in own_body_walk(fn.node) if isinstance(n, ast.Return) and n.value is not None]
            for fn in live}

    # the interprocedural fixpoint, over a worklist: a function is looked
    # at again when a callee's return summary or its own parameter taint
    # grows. A boundary's body is the sanctioned decode: nothing it
    # returns or passes on is taint.
    callers: dict[int, set] = {}
    for fn in live:
        for call in calls[id(fn)]:
            for callee in program.resolve_call_direct(call, fn):
                callers.setdefault(id(callee), set()).add(fn)
    by_id = {id(fn): fn for fn in live}
    queue, queued = collections.deque(live), {id(fn) for fn in live}

    def again(fns) -> None:
        for g in fns:
            if id(g) in by_id and id(g) not in queued:
                queued.add(id(g))
                queue.append(g)

    while queue:
        fn = queue.popleft()
        queued.discard(id(fn))
        env = flow.env(fn)
        flow._envs[id(fn)] = env
        summary = frozenset().union(*(flow.labels(r, env, fn) for r in rets[id(fn)]))
        if summary != flow.returns.get(id(fn), frozenset()):
            flow.returns[id(fn)] = summary
            again(callers.get(id(fn), ()))
        hot = flow.device_labels(fn)
        for call in calls[id(fn)]:
            again(_flow_into_callees(program, flow, call, env, hot, fn))

    findings: list[Finding] = []
    reached = _reached_from_roots(program, flow, calls)
    for fn in live:
        rel = fn.module.relpath
        if rel.startswith(SINK_SCOPE) or (rel.startswith(REACHED_SCOPE) and id(fn) in reached):
            findings.extend(_sink_findings(flow, fn))
    return findings


def _flow_into_callees(program: Program, flow: _Flow, call: ast.Call, env: dict, hot: set, fn) -> list:
    """Taint the parameters of `call`'s callees that card values land on; a
    function passed as an argument beside card values gets them too, in
    order as far as the first `*spread` (an applier such as `per_block`
    calls it with them). Returns the functions whose taint grew."""
    changed = []

    def dev(expr) -> bool:
        return bool(flow.labels(expr, env, fn) & hot)

    for callee in program.resolve_call_direct(call, fn):
        for param, arg in bind_args(callee, call):
            if dev(arg) and flow.taint_param(callee, param):
                changed.append(callee)
    arg_dev = [not isinstance(a, ast.Starred) and dev(a) for a in call.args]
    kw_dev = {kw.arg: dev(kw.value) for kw in call.keywords if kw.arg is not None}
    if not (any(arg_dev) or any(kw_dev.values())):
        return changed
    for i, arg in enumerate(call.args):
        for target in _ref_targets(program, arg, fn):
            if target is fn:
                continue
            params = [p for p in _param_names(target) if p not in ("self", "cls")]
            for j, rest in enumerate(call.args[i + 1:]):
                if isinstance(rest, ast.Starred) or j >= len(params):
                    break
                if arg_dev[i + 1 + j] and flow.taint_param(target, params[j]):
                    changed.append(target)
            for name, is_dev in kw_dev.items():
                if is_dev and name in params and flow.taint_param(target, name):
                    changed.append(target)
    return changed


def _reached_from_roots(program: Program, flow: _Flow, calls: dict) -> set[int]:
    """Functions the dispatch roots reach through calls and applied
    function references, stopping at boundaries."""
    frontier = [fn for fn in program.functions if fn.name in DISPATCH_ROOTS and not flow.is_boundary(fn)]
    seen = {id(fn) for fn in frontier}
    while frontier:
        fn = frontier.pop()
        nxt = []
        for call in calls[id(fn)]:
            nxt += program.resolve_call_direct(call, fn)
            for arg in call.args:
                nxt += _ref_targets(program, arg, fn)
        for callee in nxt:
            if id(callee) not in seen and not flow.is_boundary(callee):
                seen.add(id(callee))
                frontier.append(callee)
    return seen


def _tensor_test(test: ast.AST) -> tuple[str, bool] | None:
    """(name, negated) of `isinstance(name, torch.Tensor)` (or a tuple of
    types holding it), optionally under `not`."""
    neg = False
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        test, neg = test.operand, True
    if not (isinstance(test, ast.Call) and dotted(test.func) == "isinstance" and len(test.args) == 2):
        return None
    name, types = dotted(test.args[0]), test.args[1]
    kinds = types.elts if isinstance(types, ast.Tuple) else [types]
    if name is None or not any(dotted(k) in _TENSOR_TYPES for k in kinds):
        return None
    return name, neg


def _host_by_isinstance(fn_node: ast.AST) -> dict[int, set[str]]:
    """Node id -> the names an enclosing `isinstance(x, torch.Tensor)` test
    proves hold no tensor there: the else branch of the test, the body of
    its negation (an `if`, or a conditional expression)."""
    out: dict[int, set[str]] = {}

    def mark(nodes, names):
        for top in nodes:
            for n in ast.walk(top):
                out.setdefault(id(n), set()).update(names)

    for node in own_body_walk(fn_node):
        if isinstance(node, (ast.If, ast.IfExp)):
            got = _tensor_test(node.test)
            if got is None:
                continue
            name, neg = got
            body = node.body if isinstance(node.body, list) else [node.body]
            orelse = node.orelse if isinstance(node.orelse, list) else [node.orelse]
            mark(body if neg else orelse, {name})
    return out


def _truth_syncs(test: ast.AST, dev) -> bool:
    """A truth test that reads a card value: `if t`, `not t`, `t and u`;
    `x is None` reads no value."""
    if isinstance(test, ast.BoolOp):
        return any(_truth_syncs(v, dev) for v in test.values)
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _truth_syncs(test.operand, dev)
    return dev(test)


def _sink_findings(flow: _Flow, fn: FunctionInfo) -> list[Finding]:
    env = flow._envs[id(fn)]
    hot = flow.device_labels(fn)
    out: list[Finding] = []

    def dev(expr: ast.AST) -> bool:
        return bool(flow.labels(expr, env, fn) & hot)

    def flag(node: ast.AST, what: str, host: bool = False) -> None:
        on = "host data" if host else "a device value"
        out.append(fn.module.finding(
            RULE, node,
            f"{what} on {on} in `{fn.name}` — an implicit device->host sync outside the "
            "gather/decode stages",
            hint="keep the value on the card until the designated gather (`ColumnarPending.wait` / "
            "`_fetch` / `_host_copy`), or, if this function IS a gather or decode stage, mark its def "
            "`# foremast: device-boundary` and say why",
        ))

    narrowed = _host_by_isinstance(fn.node)
    for node in own_body_walk(fn.node):
        if id(node) in narrowed:
            # a branch where an isinstance test says these names hold no tensor
            local = {**env, **{name: set() for name in narrowed[id(node)]}}

            def dev(expr: ast.AST, local=local) -> bool:
                return bool(flow.labels(expr, local, fn) & hot)
        else:
            def dev(expr: ast.AST) -> bool:
                return bool(flow.labels(expr, env, fn) & hot)
        if isinstance(node, ast.Call):
            _call_sinks(node, dev, flag)
        elif isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            if _truth_syncs(node.test, dev):
                flag(node, "a truth test")
        elif (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load)
              and _looks_boolean(node.slice) and dev(node.value) and dev(node.slice)):
            flag(node, "boolean-mask indexing")
    return out


def _call_sinks(node: ast.Call, dev, flag) -> None:
    d = dotted(node.func)
    attr = node.func.attr if isinstance(node.func, ast.Attribute) else None
    recv = node.func.value if attr is not None else None
    torch_fn = d is not None and d.startswith("torch.")
    if d is not None and "." in d and d.split(".", 1)[0] in _NP_NAMES and d.rsplit(".", 1)[1] in _NP_MATERIALIZERS:
        if any(dev(a) for a in node.args):
            flag(node, f"`{d}()`")
    elif d in _SYNC_BUILTINS or d == "sorted":
        if any(dev(a) for a in node.args):
            flag(node, f"`{d}()`")
    elif attr in _TO_HOST and not torch_fn:
        if dev(recv):
            flag(node, f"`.{attr}()`")
    elif attr == "to" and is_cpu(to_target(node)) and not _non_blocking(node):
        if dev(recv):
            flag(node, '`.to("cpu")` (blocking)')
    elif d == "torch.where" and len(node.args) == 1 and not node.keywords:
        if dev(node.args[0]):
            flag(node, "one-argument `torch.where()` (data-dependent size)")
    elif torch_fn and d in _SYNCING_TORCH:
        if any(dev(a) for a in node.args):
            flag(node, f"`{d}()`")
    elif attr in _DATA_SIZED and not torch_fn:
        if dev(recv):
            flag(node, f"`.{attr}()` (data-dependent size)")
    elif attr == "repeat_interleave" or d == "torch.repeat_interleave":
        # the repeats: the method's first argument, the function's second
        # (or its only one)
        args = node.args if d != "torch.repeat_interleave" else node.args[1:] or node.args
        repeats = kwarg(node, "repeats") or (args[0] if args else None)
        if repeats is not None and kwarg(node, "output_size") is None and dev(repeats):
            flag(node, "`repeat_interleave` with tensor repeats and no `output_size` (data-dependent size)")
    elif d in ("torch.tensor", "torch.as_tensor", "torch.asarray"):
        device = kwarg(node, "device")
        if device is not None and not is_cpu(device) and node.args and not dev(node.args[0]):
            flag(node, f"`{d}(..., device=...)` (blocking upload)", host=True)
    elif (isinstance(recv, ast.Call) and dotted(recv.func) in FROM_HOST and not _non_blocking(node)
          and (attr == "cuda" or (attr == "to" and device_target(node) is not None
                                  and not is_cpu(device_target(node))))
          and not any(dev(a) for a in recv.args)):
        flag(node, f"`{dotted(recv.func)}(...).{attr}(...)` (blocking upload)", host=True)
