"""Cross-module program model behind the port's concurrency rules.

The port's own copy of the resolver in `foremast_tpu/analysis/interproc.py`,
reading the port's tree (`foremast_tpu_torch/`) for the lock graph,
thread-escape and blocking-under-lock:

  * every class, its methods, and the ``threading.Lock``/``RLock``
    attributes it owns (with the creation site, so the runtime witness
    can map a live lock object back to its static identity);
  * attribute and local-variable TYPES where they are statically
    evident (``self.store = store`` with an annotation,
    ``self._shards = tuple(RingShard(...) ...)`` including
    container-element types, ``x = ClassName(...)`` locals);
  * a CALL RESOLVER: ``self.m()``, ``self.attr.m()``, typed locals,
    module functions, imported names, constructors, plus a CALLBACK
    TABLE for the hook pattern the package leans on
    (``store.journal = self._journal``,
    ``store.claim(claim_filter=self.mesh.claim_filter)``,
    ``ring.evict_unowned(self.router.owns_series)``): a function
    reference assigned to an attribute/dict slot or passed as an
    argument is recorded under that attribute/parameter NAME, and a
    later call of that bare name resolves to the recorded targets;
  * fixpoint summaries over the resolved call graph: which locks a
    function may eventually acquire, and which blocking operations it
    may eventually perform.

Resolution is deliberately OVER-approximate (a callback name with two
registered targets resolves to both): the static graph must be a
superset of every runtime acquisition order, and for
blocking-under-lock a may-block answer is the conservative one. All of it is pure AST:
nothing here imports the checked code.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable

from foremast_tpu_torch.analysis.core import PACKAGE, Module

_LOCK_FACTORIES = {
    "threading.Lock": "Lock",
    "threading.RLock": "RLock",
    "Lock": "Lock",
    "RLock": "RLock",
}
_MUTATORS = frozenset(
    {
        "append", "appendleft", "extend", "insert", "add", "remove",
        "discard", "pop", "popitem", "clear", "update", "setdefault",
        "move_to_end", "sort", "reverse",
    }
)


def dotted(node: ast.AST) -> str | None:
    """`a.b.c` as a string, or None for non-name-rooted expressions."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def annotation_name(node: ast.AST | None) -> str | None:
    """A (possibly string-quoted) annotation as a dotted name. PEP 604
    optionals (`X | None`, the codebase's idiom for optional typed
    params) unwrap to the class side — an optional dependency still
    types the attribute it is assigned to."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        left = annotation_name(node.left)
        if left and left != "None":
            return left
        return annotation_name(node.right)
    return dotted(node)


def module_stem(relpath: str) -> str:
    """`foremast_tpu_torch/observe/spans.py` -> `observe.spans`: the
    short module identity lock IDs and messages use (the JAX package's
    for the same module, so the two graphs compare by node id)."""
    stem = relpath
    if stem.startswith(f"{PACKAGE}/"):
        stem = stem[len(PACKAGE) + 1:]
    if stem.endswith(".py"):
        stem = stem[:-3]
    return stem.replace("/", ".").removesuffix(".__init__")


@dataclasses.dataclass(frozen=True)
class LockId:
    """One static lock identity. Per-instance locks of one class attr
    (the shard locks) share an identity on purpose: the ordering
    contract is per-SITE, not per-object."""

    name: str      # "RingShard._lock" or "native._lock"
    kind: str      # "Lock" | "RLock"
    site: str      # "foremast_tpu_torch/ingest/shards.py:119" (the factory call)

    def __str__(self) -> str:
        return self.name


@dataclasses.dataclass(eq=False)  # identity hash: one info per def site
class FunctionInfo:
    module: Module
    node: ast.AST                    # FunctionDef | AsyncFunctionDef
    qualname: str                    # "RingShard.push" / "observe.spans._run"
    class_key: str | None            # owning ClassInfo key, or None
    # filled by the summary fixpoint:
    acquires_all: set = dataclasses.field(default_factory=set)   # {LockId}
    blocks_all: dict = dataclasses.field(default_factory=dict)   # desc -> site

    @property
    def name(self) -> str:
        return self.node.name

    def site(self, node: ast.AST | None = None) -> str:
        line = getattr(node, "lineno", self.node.lineno)
        return f"{self.module.relpath}:{line}"


@dataclasses.dataclass
class ClassInfo:
    key: str                         # unique: "relpath::Qual.Name"
    name: str
    module: Module
    node: ast.ClassDef
    bases: list[str] = dataclasses.field(default_factory=list)
    methods: dict = dataclasses.field(default_factory=dict)      # name -> FunctionInfo
    lock_attrs: dict = dataclasses.field(default_factory=dict)   # attr -> LockId
    attr_types: dict = dataclasses.field(default_factory=dict)   # attr -> class key


class Program:
    """The whole-package index + call resolver."""

    def __init__(self, modules: Iterable[Module]):
        self.modules = list(modules)
        self.classes: dict[str, ClassInfo] = {}
        self.functions: list[FunctionInfo] = []
        # per module relpath: top-level def name -> FunctionInfo
        self.module_functions: dict[str, dict[str, FunctionInfo]] = {}
        # per module relpath: local name -> fully qualified import target
        self.imports: dict[str, dict[str, str]] = {}
        # per module relpath: module-level lock name -> LockId
        self.module_locks: dict[str, dict[str, LockId]] = {}
        # simple class name -> [class keys] (collision-aware lookup)
        self._by_name: dict[str, list[str]] = {}
        # method name -> [FunctionInfo] across all classes
        self._methods_by_name: dict[str, list[FunctionInfo]] = {}
        # callback name -> {FunctionInfo}: function refs stored in
        # attributes/dict slots or passed as call arguments
        self.callbacks: dict[str, set] = {}
        # (function, bare name) -> resolution: the index is complete
        # before the first lookup, so each answer is computed once
        self._local_fn_memo: dict[tuple[int, str], FunctionInfo | None] = {}
        self._local_type_memo: dict[tuple[int, str], str | None] = {}
        self._nested_memo: dict[int, dict[str, FunctionInfo]] = {}
        self._fn_by_node: dict[int, FunctionInfo] | None = None
        self._subclasses: dict[str, list[str]] | None = None
        self._index()
        self._collect_callbacks()
        self._summarize()

    # -- indexing --------------------------------------------------------

    def _index(self) -> None:
        for module in self.modules:
            self.imports[module.relpath] = self._module_imports(module)
            self.module_functions[module.relpath] = {}
            self.module_locks[module.relpath] = self._find_module_locks(module)
            self._index_scope(
                module, module.tree.body, prefix="", cls=None, direct=True
            )
        # attribute/parameter TYPE resolution needs the complete class
        # index (modules are indexed in path order, and `node.py` must
        # see `routing.py`'s classes) — second pass
        for cls in self.classes.values():
            for fn in cls.methods.values():
                self._scan_method_for_class_state(cls, fn)

    @staticmethod
    def _module_imports(module: Module) -> dict[str, str]:
        out: dict[str, str] = {}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    out[alias.asname or alias.name] = (
                        f"{node.module}.{alias.name}"
                    )
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    out[alias.asname or alias.name.split(".")[0]] = alias.name
        return out

    def _find_module_locks(self, module: Module) -> dict[str, LockId]:
        out: dict[str, LockId] = {}
        for stmt in module.tree.body:
            if isinstance(stmt, ast.Assign):
                kind = self._lock_kind(stmt.value)
                if kind is None:
                    continue
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = LockId(
                            name=f"{module_stem(module.relpath)}.{t.id}",
                            kind=kind,
                            site=f"{module.relpath}:{stmt.value.lineno}",
                        )
        return out

    @staticmethod
    def _lock_kind(node: ast.AST) -> str | None:
        if isinstance(node, ast.Call) and not node.args and not node.keywords:
            return _LOCK_FACTORIES.get(dotted(node.func))
        return None

    def _index_scope(
        self, module, body, prefix: str, cls: ClassInfo | None, direct: bool
    ):
        """`direct` is True only while iterating a module or class BODY
        — a def nested inside another def is its own FunctionInfo but
        neither a method of the class nor a module-level function."""
        for stmt in body:
            if isinstance(stmt, ast.ClassDef):
                qual = f"{prefix}{stmt.name}"
                key = f"{module.relpath}::{qual}"
                info = ClassInfo(
                    key=key,
                    name=stmt.name,
                    module=module,
                    node=stmt,
                    bases=[dotted(b) for b in stmt.bases if dotted(b)],
                )
                self.classes[key] = info
                self._by_name.setdefault(stmt.name, []).append(key)
                self._index_scope(module, stmt.body, f"{qual}.", info, True)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{stmt.name}"
                fn = FunctionInfo(
                    module=module,
                    node=stmt,
                    qualname=(
                        qual if prefix
                        else f"{module_stem(module.relpath)}.{qual}"
                    ),
                    class_key=cls.key if cls is not None else None,
                )
                self.functions.append(fn)
                if direct and cls is not None:
                    cls.methods[stmt.name] = fn
                    self._methods_by_name.setdefault(stmt.name, []).append(fn)
                elif direct and cls is None:
                    self.module_functions[module.relpath][stmt.name] = fn
                # nested defs (and defs inside defs) are their own
                # FunctionInfos, resolved by name from the enclosing
                # scope; `self` inside them still means the enclosing
                # class (a thread target defined in a method)
                self._index_scope(module, stmt.body, f"{qual}.", cls, False)
            else:
                # defs hide inside compound statements too (a thread
                # target defined under `with lock:`, a conditional
                # handler class) — walk every nested statement list
                for _f, value in ast.iter_fields(stmt):
                    if not (isinstance(value, list) and value):
                        continue
                    if isinstance(value[0], ast.stmt):
                        self._index_scope(module, value, prefix, cls, False)
                    elif isinstance(value[0], ast.excepthandler) or hasattr(
                        value[0], "body"
                    ):  # except handlers, match cases
                        for item in value:
                            self._index_scope(
                                module, item.body, prefix, cls, False
                            )

    def _scan_method_for_class_state(self, cls: ClassInfo, fn: FunctionInfo):
        """Lock attrs + attribute types assigned anywhere in a method."""
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Assign):
                continue
            for target in node.targets:
                attr = self_attr(target)
                if attr is None:
                    continue
                kind = self._lock_kind(node.value)
                if kind is not None:
                    cls.lock_attrs[attr] = LockId(
                        name=f"{cls.name}.{attr}",
                        kind=kind,
                        site=f"{cls.module.relpath}:{node.value.lineno}",
                    )
                    continue
                ckey = self._value_class(node.value, fn)
                if ckey is not None:
                    cls.attr_types.setdefault(attr, ckey)
        # parameter annotations: `def __init__(self, store: RingStore)`
        # + plain `self.x = param` aliasing
        params = {}
        args = fn.node.args
        for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
            ann = annotation_name(a.annotation)
            if ann:
                ckey = self.resolve_class_name(ann, fn.module)
                if ckey:
                    params[a.arg] = ckey
        if params:
            for node in ast.walk(fn.node):
                if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Name
                ):
                    ckey = params.get(node.value.id)
                    if ckey is None:
                        continue
                    for target in node.targets:
                        attr = self_attr(target)
                        if attr is not None:
                            cls.attr_types.setdefault(attr, ckey)

    def _value_class(self, value: ast.AST, fn: FunctionInfo) -> str | None:
        """Class key a value expression constructs, unwrapping the
        container shapes the codebase uses for lock-owning members:
        `X(...)`, `[X(...) for ...]`, `tuple(X(...) for ...)`,
        `X(...) if c else None`."""
        if isinstance(value, ast.IfExp):
            return (
                self._value_class(value.body, fn)
                or self._value_class(value.orelse, fn)
            )
        if isinstance(value, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self._value_class(value.elt, fn)
        if isinstance(value, ast.Call):
            callee = dotted(value.func)
            if callee in ("list", "tuple") and value.args:
                return self._value_class(value.args[0], fn)
            if callee is not None:
                return self.resolve_class_name(callee, fn.module)
        return None

    def resolve_class_name(self, name: str, module: Module) -> str | None:
        """A (possibly dotted / imported) name to a ClassInfo key."""
        # string annotations arrive quoted, possibly as `"X | None"`
        name = name.strip("'\"")
        if "|" in name:
            parts = [p.strip() for p in name.split("|")]
            name = next((p for p in parts if p and p != "None"), name)
        target = self.imports.get(module.relpath, {}).get(name, name)
        simple = target.rsplit(".", 1)[-1]
        keys = self._by_name.get(simple, [])
        if not keys:
            return None
        if len(keys) == 1:
            return keys[0]
        # prefer the class defined in this module, else give up
        for k in keys:
            if k.startswith(f"{module.relpath}::"):
                return k
        return None

    # -- callback table --------------------------------------------------

    def _collect_callbacks(self) -> None:
        for fn in self.functions:
            for node in ast.walk(fn.node):
                if isinstance(node, ast.Assign):
                    targets = self._ref_targets(node.value, fn)
                    if not targets:
                        continue
                    for t in node.targets:
                        name = None
                        if isinstance(t, ast.Attribute):
                            name = t.attr
                        elif isinstance(t, ast.Subscript) and isinstance(
                            t.slice, ast.Constant
                        ) and isinstance(t.slice.value, str):
                            name = t.slice.value
                        if name is not None:
                            self.callbacks.setdefault(name, set()).update(
                                targets
                            )
                elif isinstance(node, ast.Call):
                    self._collect_call_arg_callbacks(node, fn)

    def _collect_call_arg_callbacks(self, call: ast.Call, fn: FunctionInfo):
        """`f(cb)` / `f(x=cb)` where cb is a function reference: bind cb
        to the parameter NAME it lands on, for every resolution
        candidate of f."""
        arg_refs = [
            (i, None, self._ref_targets(a, fn))
            for i, a in enumerate(call.args)
        ] + [
            (None, kw.arg, self._ref_targets(kw.value, fn))
            for kw in call.keywords
            if kw.arg is not None
        ]
        arg_refs = [(i, k, t) for i, k, t in arg_refs if t]
        if not arg_refs:
            return
        callees = self.resolve_call(call, fn) or self._callees_by_attr_name(
            call
        )
        for i, kw, targets in arg_refs:
            if kw is not None:
                self.callbacks.setdefault(kw, set()).update(targets)
                continue
            for callee in callees:
                params = [
                    a.arg
                    for a in callee.node.args.args
                    if a.arg not in ("self", "cls")
                ]
                if i < len(params):
                    self.callbacks.setdefault(params[i], set()).update(
                        targets
                    )

    def _callees_by_attr_name(self, call: ast.Call) -> list[FunctionInfo]:
        if isinstance(call.func, ast.Attribute):
            return list(self._methods_by_name.get(call.func.attr, ()))
        return []

    def _ref_targets(self, value: ast.AST, fn: FunctionInfo) -> set:
        """FunctionInfos a *reference* expression denotes (not a call):
        `self._journal`, `self.mesh.claim_filter`, `helper`."""
        out: set = set()
        if isinstance(value, ast.Attribute):
            recv_cls = self.receiver_class(value.value, fn)
            if recv_cls is not None:
                m = self._lookup_method(recv_cls, value.attr)
                if m is not None:
                    out.add(m)
                    return out
            # unique-method-name fallback: `self.mesh.claim_filter`
            # with an untyped `mesh` still resolves when exactly one
            # class in the package defines the method
            candidates = self._methods_by_name.get(value.attr, ())
            if len(candidates) == 1:
                out.add(candidates[0])
        elif isinstance(value, ast.Name):
            local = self._local_function(value.id, fn)
            if local is not None:
                out.add(local)
        return out

    def _local_function(self, name: str, fn: FunctionInfo) -> FunctionInfo | None:
        key = (id(fn), name)
        if key not in self._local_fn_memo:
            self._local_fn_memo[key] = self._find_local_function(name, fn)
        return self._local_fn_memo[key]

    def _nested_defs(self, fn: FunctionInfo) -> dict[str, FunctionInfo]:
        """Name -> the first def of that name nested anywhere in `fn`
        (walk order)."""
        nested = self._nested_memo.get(id(fn))
        if nested is None:
            by_node = self._fn_by_node
            if by_node is None:
                by_node = self._fn_by_node = {id(f.node): f for f in self.functions}
            nested = {}
            for stmt in ast.walk(fn.node):
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) and stmt is not fn.node:
                    cand = by_node.get(id(stmt))
                    if cand is not None:
                        nested.setdefault(stmt.name, cand)
            self._nested_memo[id(fn)] = nested
        return nested

    def _find_local_function(self, name: str, fn: FunctionInfo) -> FunctionInfo | None:
        # nested def in the same function?
        nested = self._nested_defs(fn).get(name)
        if nested is not None:
            return nested
        mod_fns = self.module_functions.get(fn.module.relpath, {})
        if name in mod_fns:
            return mod_fns[name]
        target = self.imports.get(fn.module.relpath, {}).get(name)
        if target and "." in target:
            mod_target, simple = target.rsplit(".", 1)
            fns = self.module_functions.get(
                mod_target.replace(".", "/") + ".py", {}
            )
            if simple in fns:
                return fns[simple]
        return None

    # -- receivers and calls ---------------------------------------------

    def receiver_class(self, node: ast.AST, fn: FunctionInfo) -> str | None:
        """Class key of a receiver expression, or None. Handles `self`,
        `self.attr` (declared types), `x` locals constructed in this
        function or annotated parameters, and subscripts of typed
        containers (`self._shards[i]`)."""
        while isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Name):
            if node.id == "self":
                return fn.class_key
            return self._local_type(node.id, fn)
        if isinstance(node, ast.Attribute):
            attr = self_attr(node)
            if attr is not None and fn.class_key is not None:
                cls = self.classes.get(fn.class_key)
                if cls is not None:
                    return cls.attr_types.get(attr)
        return None

    def _local_type(self, name: str, fn: FunctionInfo) -> str | None:
        key = (id(fn), name)
        if key not in self._local_type_memo:
            self._local_type_memo[key] = self._find_local_type(name, fn)
        return self._local_type_memo[key]

    def _find_local_type(self, name: str, fn: FunctionInfo) -> str | None:
        args = fn.node.args
        for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
            if a.arg == name:
                ann = annotation_name(a.annotation)
                if ann:
                    return self.resolve_class_name(ann, fn.module)
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == name:
                        ckey = self._value_class(node.value, fn)
                        if ckey is not None:
                            return ckey
        return None

    def _lookup_method(self, class_key: str, name: str) -> FunctionInfo | None:
        cls = self.classes.get(class_key)
        seen = set()
        while cls is not None and cls.key not in seen:
            seen.add(cls.key)
            if name in cls.methods:
                return cls.methods[name]
            nxt = None
            for base in cls.bases:
                bkey = self.resolve_class_name(base, cls.module)
                if bkey is not None:
                    nxt = self.classes.get(bkey)
                    break
            cls = nxt
        return None

    def overrides(self, fn: FunctionInfo) -> list[FunctionInfo]:
        """The methods of `fn`'s name in the subclasses of its class,
        transitively: where a call through a base-typed receiver
        (`self.store.count_open()` on a `JobStore`) may land at run
        time. The call resolver answers the base's method only."""
        if fn.class_key is None or fn.name not in self._methods_by_name:
            return []
        if self._subclasses is None:
            self._subclasses = {}
            for cls in self.classes.values():
                for base in cls.bases:
                    bkey = self.resolve_class_name(base, cls.module)
                    if bkey is not None:
                        self._subclasses.setdefault(bkey, []).append(cls.key)
        out, stack, seen = [], list(self._subclasses.get(fn.class_key, [])), set()
        while stack:
            key = stack.pop()
            if key in seen:
                continue
            seen.add(key)
            m = self.classes[key].methods.get(fn.name)
            if m is not None:
                out.append(m)
            stack.extend(self._subclasses.get(key, []))
        return sorted(out, key=lambda f: f.qualname)

    def resolve_call(self, call: ast.Call, fn: FunctionInfo) -> list[FunctionInfo]:
        """Possible targets of a call expression (empty = unresolved).
        Unresolved calls of a NAME registered in the callback table
        resolve to the registered targets."""
        func = call.func
        out: list[FunctionInfo] = []
        if isinstance(func, ast.Name):
            local = self._local_function(func.id, fn)
            if local is not None:
                return [local]
            ckey = self.resolve_class_name(func.id, fn.module)
            if ckey is not None:
                init = self._lookup_method(ckey, "__init__")
                return [init] if init is not None else []
            if func.id in self.callbacks:
                return sorted(
                    self.callbacks[func.id], key=lambda f: f.qualname
                )
            return []
        if isinstance(func, ast.Attribute):
            recv_cls = self.receiver_class(func.value, fn)
            if recv_cls is not None:
                m = self._lookup_method(recv_cls, func.attr)
                if m is not None:
                    return [m]
            # `mod.fn()` through an `import pkg.mod [as mod]`
            d = dotted(func)
            if d is not None and "." in d:
                root, tail = d.split(".", 1)
                target = self.imports.get(fn.module.relpath, {}).get(root)
                if target is not None and "." not in tail:
                    fns = self.module_functions.get(
                        target.replace(".", "/") + ".py", {}
                    )
                    if tail in fns:
                        return [fns[tail]]
            if func.attr in self.callbacks:
                return sorted(
                    self.callbacks[func.attr], key=lambda f: f.qualname
                )
        return out

    # -- lock identification ---------------------------------------------

    def lock_for_with_item(
        self, expr: ast.AST, fn: FunctionInfo
    ) -> LockId | None:
        """The LockId a `with <expr>:` item acquires, or None."""
        attr = self_attr(expr)
        if attr is not None and fn.class_key is not None:
            cls = self.classes.get(fn.class_key)
            if cls is not None and attr in cls.lock_attrs:
                return cls.lock_attrs[attr]
        if isinstance(expr, ast.Name):
            return self.module_locks.get(fn.module.relpath, {}).get(expr.id)
        if isinstance(expr, ast.Attribute):
            recv_cls = self.receiver_class(expr.value, fn)
            if recv_cls is not None:
                cls = self.classes.get(recv_cls)
                if cls is not None:
                    return cls.lock_attrs.get(expr.attr)
        return None

    def all_locks(self) -> list[LockId]:
        out: dict[str, LockId] = {}
        for cls in self.classes.values():
            for lock in cls.lock_attrs.values():
                out[lock.name] = lock
        for locks in self.module_locks.values():
            for lock in locks.values():
                out[lock.name] = lock
        return sorted(out.values(), key=lambda lk: lk.name)

    # -- summaries (fixpoint) --------------------------------------------

    def _summarize(self) -> None:
        from foremast_tpu_torch.analysis.blocking_under_lock import classify_blocking

        calls: dict[int, list] = {}
        for fn in self.functions:
            acq: set = set()
            blk: dict = {}
            cl: list = []
            for node in own_body_walk(fn.node):
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        lock = self.lock_for_with_item(item.context_expr, fn)
                        if lock is not None:
                            acq.add(lock)
                elif isinstance(node, ast.Call):
                    cl.append(node)
                    desc = classify_blocking(node)
                    if desc is not None:
                        blk.setdefault(desc, fn.site(node))
            # the call graph is fixed once indexed: resolve each call once
            calls[id(fn)] = [callee for call in cl for callee in self.resolve_call(call, fn)]
            fn.acquires_all = acq
            fn.blocks_all = blk
        changed = True
        while changed:
            changed = False
            for fn in self.functions:
                for callee in calls[id(fn)]:
                    if not callee.acquires_all <= fn.acquires_all:
                        fn.acquires_all |= callee.acquires_all
                        changed = True
                    for desc, site in callee.blocks_all.items():
                        if desc not in fn.blocks_all:
                            fn.blocks_all[desc] = site
                            changed = True


def self_attr(node: ast.AST) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def walk_pruned(node: ast.AST):
    """`node` and its subtree, NEVER entering nested function
    definitions (neither the def node nor its children are yielded —
    a nested def runs when called, possibly on another thread, so
    nothing inside it belongs to the enclosing context). Lambdas ARE
    included: the codebase's lambdas are thin argument adapters
    executed by their consumer, and attributing their contents to the
    enclosing function is the harmless over-approximation."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.append(child)


def locked_walk(program, fn: FunctionInfo):
    """THE shared traversal for the concurrency rules: yields
    ``(node, held, acquired)`` triples over `fn`'s inline body, where
    `held` is the list of LockIds held at that node and `acquired` is
    the LockId a lock-taking `with` statement acquires (None for every
    other node; `held` then excludes it, so the caller sees the
    ordering event outer-held -> acquired).

    Guarantees the bespoke per-rule walkers used to get wrong in three
    places at once (code-review finding): nested function definitions
    are never entered (they run when called, not where defined, so
    their bodies must neither inherit the lock context nor pollute
    guard inference), and nested compound-statement bodies are visited
    exactly once, with the correct held set."""
    out: list = []

    def emit(node, held):
        for n in walk_pruned(node):
            out.append((n, held, None))

    def visit(body, held: list):
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                acquired: list = []
                for item in stmt.items:
                    lock = program.lock_for_with_item(item.context_expr, fn)
                    if lock is not None:
                        out.append((stmt, held + acquired, lock))
                        acquired.append(lock)
                    else:
                        emit(item.context_expr, held + acquired)
                visit(stmt.body, held + acquired)
                continue
            # the statement node itself (Assign/AugAssign/Delete are
            # what mutation detection matches on), then its expression
            # fields; nested statement bodies recurse with `held`
            out.append((stmt, held, None))
            for _field, value in ast.iter_fields(stmt):
                if isinstance(value, ast.AST):
                    emit(value, held)
                elif isinstance(value, list) and value:
                    if isinstance(value[0], ast.stmt):
                        visit(value, held)
                    else:
                        for v in value:
                            if isinstance(v, ast.excepthandler):
                                if v.type is not None:
                                    emit(v.type, held)
                                visit(v.body, held)
                            elif hasattr(v, "body") and isinstance(
                                getattr(v, "body"), list
                            ):  # match_case
                                guard = getattr(v, "guard", None)
                                if guard is not None:
                                    emit(guard, held)
                                visit(v.body, held)
                            elif isinstance(v, ast.AST):
                                emit(v, held)

    visit(fn.node.body, [])
    return out


def own_body_walk(fn_node: ast.AST):
    """Walk a function body WITHOUT descending into nested function
    definitions — a nested def runs when called (possibly on another
    thread), never at its definition site, so its acquisitions and
    blocking calls must not be attributed inline. Lambdas ARE included:
    the codebase's lambdas are thin argument adapters executed by their
    consumer, and attributing their calls to the enclosing function is
    the harmless over-approximation."""
    stack = [
        stmt
        for stmt in fn_node.body
        if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.append(child)


def mutated_attr(node: ast.AST) -> tuple[str | None, ast.AST | None]:
    """(attr, receiver) for an attribute mutation node: `recv.attr = v`,
    `recv.attr += v`, `recv.attr[k] = v`, `del recv.attr`, or a
    mutating method call `recv.attr.append(v)` / `recv.attr.update(d)`.
    Returns (None, None) for anything else."""
    if isinstance(node, (ast.Assign, ast.Delete)):
        for t in node.targets:
            a, r = _mut_target(t)
            if a is not None:
                return a, r
        return None, None
    if isinstance(node, ast.AugAssign):
        return _mut_target(node.target)
    if isinstance(node, ast.Call):
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in _MUTATORS:
            if isinstance(func.value, ast.Attribute):
                return func.value.attr, func.value.value
    return None, None


def _mut_target(t: ast.AST) -> tuple[str | None, ast.AST | None]:
    while isinstance(t, ast.Subscript):
        t = t.value
    if isinstance(t, ast.Attribute):
        return t.attr, t.value
    return None, None
