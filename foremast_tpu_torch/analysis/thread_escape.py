"""thread-escape: lock-guarded state mutated from code a thread can reach.

The port's copy of `foremast_tpu/analysis/thread_escape.py`.
lock-discipline is single-class: it infers a class's guarded attributes
and flags unlocked access WITHIN that class. The port's threaded data
plane breaks out of that box: state escapes through hook attributes
(``store.journal``), through callables handed to thread pools and
``threading.Thread(target=...)`` (the pod's `_BroadcastWorker` loop,
the snapshotter, the trace autoflush), through the `ThreadingHTTPServer`
handler classes of the gateway, dashboard, receiver and observe server,
and through collectors registered on a metrics registry that scrape
threads walk. This rule follows the state across modules:

  1. THREAD ROOTS are collected package-wide: ``Thread(target=f)``
     targets, ``pool.submit(f, ...)`` submissions, the ``do_*`` methods
     and ``handle`` of ``*RequestHandler`` subclasses, ``collect``
     methods of classes registered via ``.register(...)``, and every
     function reference recorded in the callback table (journal hooks,
     claim filters, the observe server's state callables: they run on
     whatever thread invokes the hook).
  2. Everything REACHABLE from those roots through the resolver is the
     escaped surface.
  3. For every lock-owning class, the GUARDED map records which lock
     each attribute is mutated under, program-wide (the owning class's
     methods plus typed cross-class writes).

Findings:

  * **escaped mutation**: a guarded attribute mutated through a typed
    receiver OUTSIDE its owning class without holding the guarding
    lock, when the mutation site (or any method of the owning class)
    is thread-reachable;
  * **mixed guard**: one attribute mutated under TWO different locks
    in different places: each critical section is atomic only against
    itself, so the two sides race as if unlocked.
"""

from __future__ import annotations

import ast

from foremast_tpu_torch.analysis.core import Finding
from foremast_tpu_torch.analysis.interproc import (
    FunctionInfo,
    Program,
    locked_walk,
    mutated_attr,
)

RULE = "thread-escape"

_HANDLER_METHODS = frozenset(
    {"do_GET", "do_POST", "do_PUT", "do_DELETE", "do_HEAD", "do_PATCH", "handle"}
)


# ---------------------------------------------------------------------------
# roots + reachability
# ---------------------------------------------------------------------------


def thread_roots(program: Program) -> set:
    roots: set = set()
    # callback-table targets: hooks run on the registering thread's
    # peers (receiver handlers calling the journal, claims calling the
    # mesh filter)
    for targets in program.callbacks.values():
        roots.update(targets)
    for fn in program.functions:
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            callee = node.func
            # Thread(target=f) / Thread(..., target=f)
            if (
                isinstance(callee, ast.Name)
                and callee.id == "Thread"
                or isinstance(callee, ast.Attribute)
                and callee.attr == "Thread"
            ):
                for kw in node.keywords:
                    if kw.arg == "target":
                        roots.update(program._ref_targets(kw.value, fn))
            # pool.submit(f, ...)
            elif isinstance(callee, ast.Attribute) and callee.attr == "submit":
                if node.args:
                    roots.update(program._ref_targets(node.args[0], fn))
            # registry.register(Collector(...)) — the collector's
            # collect() runs on scrape-handler threads
            elif isinstance(callee, ast.Attribute) and callee.attr == "register":
                for arg in node.args:
                    if isinstance(arg, ast.Call):
                        ckey = program._value_class(arg, fn)
                        if ckey is not None:
                            m = program._lookup_method(ckey, "collect")
                            if m is not None:
                                roots.add(m)
    # HTTP handler classes: request threads enter through do_*
    for cls in program.classes.values():
        if any(b and b.endswith("RequestHandler") for b in cls.bases):
            for name, m in cls.methods.items():
                if name in _HANDLER_METHODS:
                    roots.add(m)
    return roots


def reachable_functions(program: Program, roots: set) -> set:
    """Every function a root may run: the resolver's callees, the
    overrides of each reached method in its class's subclasses (a
    handler calling `self.store.count_open()` on a `JobStore` runs the
    store it was given), and the defs of enclosing functions that a
    nested handler class calls by bare name (the port's
    `ThreadingHTTPServer` handlers are classes inside the function that
    starts the server, calling its closures)."""
    enclosing = _enclosing_functions(program)
    seen = set(roots)
    frontier = list(roots)
    while frontier:
        fn = frontier.pop()
        found = list(program.overrides(fn))
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Call):
                callees = program.resolve_call(node, fn)
                if not callees and isinstance(node.func, ast.Name):
                    callees = _closure_targets(program, enclosing, fn, node.func.id)
                found += callees
        for callee in found:
            if callee not in seen:
                seen.add(callee)
                frontier.append(callee)
    return seen


def _enclosing_functions(program: Program) -> dict:
    """FunctionInfo -> the innermost function whose body defines it
    (directly or inside a class body), for nested definitions only."""
    by_node = {id(f.node): f for f in program.functions}
    out = {}
    for outer in program.functions:
        stack = list(ast.iter_child_nodes(outer.node))
        while stack:
            node = stack.pop()
            inner = by_node.get(id(node))
            if inner is not None:
                out[inner] = outer
                continue  # deeper defs belong to `inner`
            stack.extend(ast.iter_child_nodes(node))
    return out


def _closure_targets(program: Program, enclosing: dict, fn: FunctionInfo, name: str) -> list:
    outer = enclosing.get(fn)
    while outer is not None:
        nested = program._nested_defs(outer).get(name)
        if nested is not None:
            return [nested]
        outer = enclosing.get(outer)
    return []


# ---------------------------------------------------------------------------
# guarded map
# ---------------------------------------------------------------------------


def guarded_map(program: Program) -> dict:
    """class key -> attr -> list of (held-lock-name frozenset, site):
    one entry per LOCKED mutation site of the attribute, package-wide.
    An attribute is consistently guarded when some single lock is held
    at EVERY locked mutation site (`guard_locks` — the intersection);
    two sites with disjoint held sets are a mixed guard."""
    out: dict[str, dict[str, list]] = {}

    for fn in program.functions:
        if fn.name == "__init__":
            continue  # construction happens-before sharing

        def visit_mut(ckey, attr, held, node, fn=fn):
            cls = program.classes.get(ckey)
            if cls is None or attr in cls.lock_attrs:
                return
            # only the OWNER's locks are guard evidence: a foreign
            # class mutating b.attr under its own unrelated lock must
            # not teach us that attr is "guarded" by it
            names = frozenset(
                lk.name
                for lk in held
                if fn.class_key == ckey or lk.name.split(".")[0] == cls.name
            )
            if names:
                out.setdefault(ckey, {}).setdefault(attr, []).append(
                    (names, fn.site(node))
                )

        _walk_mutations(program, fn, visit_mut)
    return out


def guard_locks(sites: list) -> frozenset:
    """The lock(s) held at every locked mutation site (empty = mixed)."""
    locks = sites[0][0]
    for names, _ in sites[1:]:
        locks &= names
    return locks


def _walk_mutations(program: Program, fn: FunctionInfo, visit_mut) -> None:
    """Call visit_mut(owner_class_key, attr, held_locks, node) for every
    attribute mutation in `fn` whose receiver's class resolves — over
    the shared pruned traversal, so a mutation inside a nested def
    (a thread target defined in a locked region) is never credited
    with the definition site's locks."""
    for node, held, acquired in locked_walk(program, fn):
        if acquired is not None:
            continue
        attr, recv = mutated_attr(node)
        if attr is None or recv is None:
            continue
        ckey = program.receiver_class(recv, fn)
        if ckey is not None:
            visit_mut(ckey, attr, held, node)


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------


def check_thread_escape(program: Program) -> list[Finding]:
    roots = thread_roots(program)
    reachable = reachable_functions(program, roots)
    guards = guarded_map(program)
    findings: list[Finding] = []

    # mixed guard: no single lock common to every locked mutation site
    for ckey, attrs in sorted(guards.items()):
        cls = program.classes[ckey]
        for attr, sites in sorted(attrs.items()):
            if guard_locks(sites):
                continue
            uniq = sorted({(tuple(sorted(n)), s) for n, s in sites})[:4]
            detail = ", ".join(
                f"{'+'.join(names)} at {site}" for names, site in uniq
            )
            first_site = sorted(s for _, s in sites)[0]
            path, _, line = first_site.partition(":")
            findings.append(
                Finding(
                    rule=RULE,
                    path=path,
                    line=int(line or 1),
                    message=f"`{cls.name}.{attr}` is mutated under "
                    f"DIFFERENT locks ({detail}) — the critical sections "
                    "do not exclude each other, so the writes race as if "
                    "unlocked",
                    hint="pick ONE lock for the attribute and hold it at "
                    "every mutation site",
                )
            )

    # escaped mutation: guarded attr written cross-class without the lock
    reachable_classes = {
        fn.class_key for fn in reachable if fn.class_key is not None
    }
    for fn in program.functions:
        if fn.name == "__init__":
            continue

        def check_mut(ckey, attr, held, node, fn=fn):
            if ckey == fn.class_key:
                return  # same-class discipline is lock-discipline's rule
            sites = guards.get(ckey, {}).get(attr)
            if not sites:
                return  # unguarded attribute
            common = guard_locks(sites)
            if not common:
                return  # already a mixed-guard finding
            lock_name = sorted(common)[0]
            if any(lk.name in common for lk in held):
                return
            if fn not in reachable and ckey not in reachable_classes:
                return  # nothing threaded ever reaches this state
            cls = program.classes[ckey]
            findings.append(
                Finding(
                    rule=RULE,
                    path=fn.module.relpath,
                    line=getattr(node, "lineno", fn.node.lineno),
                    message=f"`{cls.name}.{attr}` is guarded by "
                    f"{lock_name} but mutated here (in `{fn.qualname}`) "
                    "without it — thread-reachable state escaped its "
                    "lock",
                    hint=f"mutate through a {cls.name} method that takes "
                    "the lock, or mark a deliberate exception with "
                    "`# foremast: ignore[thread-escape]` and say why",
                )
            )

        _walk_mutations(program, fn, check_mut)
    return sorted(set(findings), key=Finding.sort_key)
