"""lock-discipline: unlocked access to lock-guarded state, env mutation.

The port's copy of `foremast_tpu/analysis/lock_discipline.py`. The
long-lived worker is a small thread swarm: the tick thread, the
ThreadingHTTPServer receiver, gauge and observe handlers, the trace
autoflush daemon, the snapshotter and the pod's broadcast thread. The
classes they share (jobs/store.py, models/cache.py, observe/spans.py,
ingest/shards.py, ...) each own a ``threading.Lock``; the contract, that
every access to the guarded state goes through the lock, lives only in
docstrings, where a refactor can silently break it.

This checker makes the contract structural. For every class that
assigns a ``threading.Lock``/``RLock`` to an attribute, the guarded set
is INFERRED: attributes *written or mutated* (assignment, augmented
assignment, ``self.x[k] = v``, ``del``, or a mutating method call like
``.append``/``.pop``/``.update``) inside a ``with self._lock:`` block.
Any read or write of a guarded attribute outside a locked region, in
any method but ``__init__`` (construction happens-before sharing), is a
finding. Deliberate lock-free fast paths (``ModelCache.peek``) carry a
``# foremast: ignore[lock-discipline]`` with their justification: the
suppression is the documentation.

Module-level locks get the same treatment for ``global``-declared names
(native.py's loader state), with nested function bodies treated as NOT
holding the lock of their definition site (they run when called, not
when defined).

Separately, ``os.environ`` WRITES anywhere in the package are flagged:
CPython's environ mutation is not thread-safe against concurrent
readers, and a knob changed after threads start reaches only code that
happens to re-read the env; plumb explicit setters instead.
"""

from __future__ import annotations

import ast
import dataclasses

from foremast_tpu_torch.analysis.core import Checker, Finding, Module, os_import_aliases

_LOCK_FACTORIES = frozenset(
    {"threading.Lock", "threading.RLock", "Lock", "RLock"}
)
_MUTATORS = frozenset(
    {
        "append",
        "appendleft",
        "extend",
        "insert",
        "add",
        "remove",
        "discard",
        "pop",
        "popitem",
        "clear",
        "update",
        "setdefault",
        "move_to_end",
        "sort",
        "reverse",
        "inc",
        "dec",
        "set",
        "observe",
    }
)
_ENV_WRITE_CALLS = frozenset({"update", "setdefault", "pop", "clear", "popitem"})


def _dotted(node: ast.AST) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_lock_factory(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and not node.args
        and _dotted(node.func) in _LOCK_FACTORIES
    )


def _self_attr(node: ast.AST) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _subscript_base_attr(node: ast.Subscript) -> str | None:
    base = node.value
    while isinstance(base, ast.Subscript):
        base = base.value
    return _self_attr(base)


@dataclasses.dataclass
class _Access:
    attr: str
    node: ast.AST
    write: bool
    locked: bool
    method: str


class _ClassScanner(ast.NodeVisitor):
    """Collect self-attribute accesses with their locked-ness for one
    class body."""

    def __init__(self, lock_attrs: set[str]):
        self.lock_attrs = lock_attrs
        self.accesses: list[_Access] = []
        self._locked = 0
        self._method = ""

    def scan_method(self, fn: ast.FunctionDef) -> None:
        self._method = fn.name
        for stmt in fn.body:
            self.visit(stmt)

    # -- lock regions ----------------------------------------------------

    def _with_holds_lock(self, node: ast.With | ast.AsyncWith) -> bool:
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr in self.lock_attrs:
                return True
        return False

    def _visit_with(self, node):
        holds = self._with_holds_lock(node)
        for item in node.items:
            self.visit(item.context_expr)
        if holds:
            self._locked += 1
        for stmt in node.body:
            self.visit(stmt)
        if holds:
            self._locked -= 1

    visit_With = _visit_with
    visit_AsyncWith = _visit_with

    def _visit_nested_fn(self, node):
        # a nested def runs when CALLED, not where defined: its body must
        # not inherit the definition site's lock state
        saved = self._locked
        self._locked = 0
        for stmt in node.body:
            self.visit(stmt)
        self._locked = saved

    visit_FunctionDef = _visit_nested_fn
    visit_AsyncFunctionDef = _visit_nested_fn

    # -- accesses --------------------------------------------------------

    def _record(self, attr: str | None, node: ast.AST, write: bool) -> None:
        if attr is None or attr in self.lock_attrs:
            return
        self.accesses.append(
            _Access(attr, node, write, self._locked > 0, self._method)
        )

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None:
            self._record(attr, node, isinstance(node.ctx, (ast.Store, ast.Del)))
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        attr = _self_attr(node.target)
        if attr is not None:
            self._record(attr, node, True)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            self._record(_subscript_base_attr(node), node, True)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in _MUTATORS:
            self._record(_self_attr(func.value), node, True)
        self.generic_visit(node)


class _ModuleLockScanner(ast.NodeVisitor):
    """Same idea for module-level locks guarding `global`-declared names."""

    def __init__(self, lock_names: set[str], module_names: set[str]):
        self.lock_names = lock_names
        self.module_names = module_names
        self.accesses: list[_Access] = []
        self._locked = 0
        self._fn = ""
        self._globals: set[str] = set()
        self._locals: set[str] = set()

    def scan_function(self, fn: ast.FunctionDef) -> None:
        self._fn = fn.name
        self._globals = set()
        self._locals = {a.arg for a in ast.walk(fn) if isinstance(a, ast.arg)}
        for node in ast.walk(fn):
            if isinstance(node, ast.Global):
                self._globals.update(node.names)
            elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
                self._locals.add(node.id)
        self._locals -= self._globals
        for stmt in fn.body:
            self.visit(stmt)

    def _visit_with(self, node):
        holds = any(
            isinstance(item.context_expr, ast.Name)
            and item.context_expr.id in self.lock_names
            for item in node.items
        )
        if holds:
            self._locked += 1
        for stmt in node.body:
            self.visit(stmt)
        if holds:
            self._locked -= 1

    visit_With = _visit_with
    visit_AsyncWith = _visit_with

    def _visit_nested_fn(self, node):
        saved = self._locked
        self._locked = 0
        for stmt in node.body:
            self.visit(stmt)
        self._locked = saved

    visit_FunctionDef = _visit_nested_fn
    visit_AsyncFunctionDef = _visit_nested_fn

    def visit_Name(self, node: ast.Name) -> None:
        name = node.id
        if (
            name in self.module_names
            and name not in self.lock_names
            and name not in self._locals
        ):
            write = isinstance(node.ctx, (ast.Store, ast.Del))
            if write and name not in self._globals:
                return  # a plain Store without `global` is a new local
            self.accesses.append(
                _Access(name, node, write, self._locked > 0, self._fn)
            )
        self.generic_visit(node)


class LockDisciplineChecker(Checker):
    rule = "lock-discipline"
    description = (
        "lock-guarded attributes accessed without the lock; runtime "
        "os.environ mutation"
    )

    def check(self, module: Module) -> list[Finding]:
        findings: list[Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(module, node))
        findings.extend(self._check_module_locks(module))
        findings.extend(self._check_env_writes(module))
        return findings

    # -- classes ---------------------------------------------------------

    def _check_class(self, module: Module, cls: ast.ClassDef) -> list[Finding]:
        methods = [
            n
            for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        lock_attrs: set[str] = set()
        for fn in methods:
            for node in ast.walk(fn):
                if (
                    isinstance(node, ast.Assign)
                    and _is_lock_factory(node.value)
                ):
                    for target in node.targets:
                        attr = _self_attr(target)
                        if attr is not None:
                            lock_attrs.add(attr)
        if not lock_attrs:
            return []
        scanner = _ClassScanner(lock_attrs)
        for fn in methods:
            if fn.name == "__init__":
                continue  # construction happens-before sharing
            scanner.scan_method(fn)
        guarded = {
            a.attr for a in scanner.accesses if a.locked and a.write
        }
        findings = []
        for a in scanner.accesses:
            if a.attr in guarded and not a.locked:
                kind = "write to" if a.write else "read of"
                findings.append(
                    module.finding(
                        self.rule,
                        a.node,
                        f"unlocked {kind} `self.{a.attr}` in "
                        f"`{cls.name}.{a.method}` (guarded by "
                        f"{'/'.join(sorted(lock_attrs))} elsewhere)",
                        hint="take the lock, or mark a deliberate "
                        "lock-free path with "
                        "`# foremast: ignore[lock-discipline]` and say why",
                    )
                )
        return findings

    # -- module-level locks ----------------------------------------------

    def _check_module_locks(self, module: Module) -> list[Finding]:
        lock_names: set[str] = set()
        module_names: set[str] = set()
        for stmt in module.tree.body:
            targets: list[ast.AST] = []
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
                if _is_lock_factory(stmt.value):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            lock_names.add(t.id)
            elif isinstance(stmt, ast.AnnAssign):
                targets = [stmt.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    module_names.add(t.id)
        if not lock_names:
            return []
        scanner = _ModuleLockScanner(lock_names, module_names)
        for stmt in module.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scanner.scan_function(stmt)
        guarded = {a.attr for a in scanner.accesses if a.locked and a.write}
        findings = []
        for a in scanner.accesses:
            if a.attr in guarded and not a.locked:
                kind = "write to" if a.write else "read of"
                findings.append(
                    module.finding(
                        self.rule,
                        a.node,
                        f"unlocked {kind} module global `{a.attr}` in "
                        f"`{a.method}` (guarded by "
                        f"{'/'.join(sorted(lock_names))} elsewhere)",
                        hint="take the module lock, or suppress a "
                        "deliberate racy read with "
                        "`# foremast: ignore[lock-discipline]`",
                    )
                )
        return findings

    # -- os.environ writes -----------------------------------------------

    def _check_env_writes(self, module: Module) -> list[Finding]:
        # bare `environ` only counts when imported from os (a WSGI
        # handler's `environ` dict is not the process environment)
        environ_names = {"os.environ"} | set(
            os_import_aliases(module.tree, "environ")
        )
        write_calls = {
            f"{base}.{m}" for base in environ_names for m in _ENV_WRITE_CALLS
        }
        findings = []
        for node in ast.walk(module.tree):
            msg = None
            if isinstance(node, ast.Subscript) and isinstance(
                node.ctx, (ast.Store, ast.Del)
            ):
                if _dotted(node.value) in environ_names:
                    msg = "os.environ item assignment"
            elif isinstance(node, ast.Call):
                dotted = _dotted(node.func)
                if dotted in ("os.putenv", "os.unsetenv"):
                    msg = f"`{dotted}` call"
                elif dotted in write_calls:
                    msg = f"`{dotted}` call"
            if msg is not None:
                findings.append(
                    module.finding(
                        self.rule,
                        node,
                        f"{msg} mutates process env at runtime — a "
                        "cross-thread race that only reaches code which "
                        "re-reads the env",
                        hint="plumb an explicit value (setter / argument) "
                        "instead; see engine.arena.set_arena_budget and "
                        "engine.scoring.set_bf16_delta",
                    )
                )
        return findings
