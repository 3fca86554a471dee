"""status-machine: the document status transition graph, committed.

The port's own copy of `foremast_tpu/analysis/status_machine.py`. The
exactly-once ledger the worker tests assert at run time (no verdict lost,
none written twice) rests on a static invariant: every `.status` write in
the worker and store path is one of a few legal transitions, and every
claim path ends, through its exception edges too, in a terminal write or
a release back to claimable. This rule extracts that machine from the
code, as `lock_order.py` extracts the lock graph, and commits it:

  * the STATUS REGISTRY comes from `jobs/models.py` (the ``STATUS_*``
    constants and the ``TERMINAL_STATUSES`` / ``INPROGRESS_STATUSES`` /
    ``CLAIMABLE_STATUSES`` sets: the wire contract with the reference
    service);
  * the LEGAL TRANSITIONS derive from those sets: every claimable status
    may move to ``preprocess_inprogress`` (the claim, a stuck takeover
    included), and an in-progress status to any terminal status or to
    ``preprocess_completed`` (the release; `chaos/degrade.py`'s REASON_*
    sentinels say why, the status written is always that one);
  * every WRITE SITE (``<recv>.status = <expr>`` in `jobs/` and
    `chaos/degrade.py`) is recorded with the from-set its guard gives: a
    write under ``x.status in (A, B)`` adds the edges ``A -> to`` and
    ``B -> to``; an unguarded write must target a legal target;
  * the machine is committed as ``analysis_statusgraph_torch.json`` and
    drift-gated as the lock graph is (``--write-statusgraph``
    regenerates it; a stale artifact is a finding);
  * findings: a raw string a registry cannot see, a computed (dynamic)
    status, a write outside the legal set, and, the static form of
    exactly-once, a CLAIM PATH whose exception edges reach neither a
    terminal write nor a release: a function that (transitively) claims
    and settles must hold a ``try`` whose handler or ``finally`` settles
    (the `_sweep_sliced` shape) or hand the claim-to-settle span to a
    callee that does.

Mesh membership, the chaos plan and the gateway's job records
(`service/app.py`) have status fields of their own, outside the scope.
"""

from __future__ import annotations

import ast
import json
import os

from foremast_tpu_torch.analysis.core import PACKAGE, Finding
from foremast_tpu_torch.analysis.interproc import FunctionInfo, Program, own_body_walk

RULE = "status-machine"
GRAPH_NAME = "analysis_statusgraph_torch.json"
GRAPH_VERSION = 1

WRITE_SCOPE = (f"{PACKAGE}/jobs/", f"{PACKAGE}/chaos/degrade.py")
REGISTRY_SETS = ("TERMINAL_STATUSES", "INPROGRESS_STATUSES", "CLAIMABLE_STATUSES")
_INPROGRESS = "preprocess_inprogress"
_RELEASED = "preprocess_completed"
_REGEN = "`python -m foremast_tpu_torch.analysis --write-statusgraph`"


class StatusRegistry:
    """STATUS_* constants and the classification sets, parsed from the
    module that defines ``TERMINAL_STATUSES``."""

    def __init__(self, names: dict[str, str], sets: dict[str, set[str]]):
        self.names = names  # STATUS_X -> "value"
        self.values = set(names.values())
        self.terminal = sets.get("TERMINAL_STATUSES", set())
        self.inprogress = sets.get("INPROGRESS_STATUSES", set())
        self.claimable = sets.get("CLAIMABLE_STATUSES", set())

    @classmethod
    def from_program(cls, program: Program) -> "StatusRegistry | None":
        for module in program.modules:
            names: dict[str, str] = {}
            set_nodes: dict[str, ast.AST] = {}
            for stmt in module.tree.body:
                if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Name)):
                    continue
                name = stmt.targets[0].id
                if (name.startswith("STATUS_") and isinstance(stmt.value, ast.Constant)
                        and isinstance(stmt.value.value, str)):
                    names[name] = stmt.value.value
                elif name in REGISTRY_SETS:
                    set_nodes[name] = stmt.value
            if "TERMINAL_STATUSES" not in set_nodes:
                continue
            sets: dict = {}
            # twice: the second pass resolves the starred references
            # between sets (CLAIMABLE = (INITIAL, COMPLETED, *INPROGRESS))
            for _ in range(2):
                sets = {key: _resolve_status_set(node, names, sets) for key, node in set_nodes.items()}
            return cls(names, sets)
        return None

    def legal_transitions(self) -> list[dict]:
        """The claim edges, the judge edges (to every terminal status)
        and the release edges."""
        edges = [{"from": s, "to": _INPROGRESS, "via": "claim"} for s in sorted(self.claimable)]
        for s in sorted(self.inprogress):
            edges += [{"from": s, "to": t, "via": "judge"} for t in sorted(self.terminal)]
            edges.append({"from": s, "to": _RELEASED, "via": "release"})
        return edges

    def legal_pairs(self) -> set[tuple[str, str]]:
        return {(e["from"], e["to"]) for e in self.legal_transitions()}


def _resolve_status_set(node: ast.AST, names: dict[str, str], sets_so_far: dict) -> set[str]:
    """frozenset({...}) / tuple / set / list of STATUS_* names, string
    constants and `*OTHER_SET` splices."""
    if isinstance(node, ast.Call) and node.args:
        return _resolve_status_set(node.args[0], names, sets_so_far)
    out: set[str] = set()
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        for elt in node.elts:
            if isinstance(elt, ast.Starred) and isinstance(elt.value, ast.Name):
                out |= sets_so_far.get(elt.value.id, set())
            elif isinstance(elt, ast.Name) and elt.id in names:
                out.add(names[elt.id])
            elif isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                out.add(elt.value)
    return out


# ---------------------------------------------------------------------------
# write sites
# ---------------------------------------------------------------------------


def _status_value(expr: ast.AST, registry: StatusRegistry) -> list[str] | None:
    """The status value(s) an assignment's right side denotes: a STATUS_*
    name, a raw string, or a conditional over those. None: dynamic."""
    if isinstance(expr, ast.Name) and expr.id in registry.names:
        return [registry.names[expr.id]]
    if isinstance(expr, ast.Attribute) and expr.attr in registry.names:
        return [registry.names[expr.attr]]  # models.STATUS_X
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return [expr.value]
    if isinstance(expr, ast.IfExp):
        a = _status_value(expr.body, registry)
        b = _status_value(expr.orelse, registry)
        if a is not None and b is not None:
            return a + b
    return None


def _guard_statuses(test: ast.AST, registry: StatusRegistry) -> list[str] | None:
    """`x.status in (A, B)` -> [a, b]; `x.status == A` -> [a]."""
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
        return None
    left = test.left
    if not (isinstance(left, ast.Attribute) and left.attr == "status"):
        return None
    comp = test.comparators[0]
    if isinstance(test.ops[0], ast.In):
        vals = _resolve_status_set(comp, registry.names, {})
        return sorted(vals) if vals else None
    if isinstance(test.ops[0], ast.Eq):
        return _status_value(comp, registry)
    return None


def _status_writes(node: ast.AST, registry: StatusRegistry):
    """The values of a `<recv>.status = <expr>` statement's write ([]
    for any other node; ["?"] for a dynamic value)."""
    if not isinstance(node, ast.Assign):
        return []
    if not any(isinstance(t, ast.Attribute) and t.attr == "status" for t in node.targets):
        return []
    vals = _status_value(node.value, registry)
    return vals if vals is not None else ["?"]


def collect_writes(program: Program, registry: StatusRegistry) -> list[dict]:
    """Every `.status = <expr>` write in scope: its site, its value ("?"
    = dynamic) and the from-set its guard gives (["*"] = unguarded)."""
    writes: list[dict] = []
    for fn in program.functions:
        if fn.module.relpath.startswith(WRITE_SCOPE):
            _walk_writes(fn, fn.node.body, ["*"], registry, writes)
    writes.sort(key=lambda w: (w["site"], w["status"]))
    return writes


def _walk_writes(fn: FunctionInfo, body, fromset: list[str], registry, writes) -> None:
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Attribute) and t.attr == "status":
                    vals = _status_value(stmt.value, registry)
                    for v in vals if vals is not None else ["?"]:
                        writes.append({"site": fn.site(stmt), "fn": fn.qualname, "status": v,
                                       "from": list(fromset)})
        inner = fromset
        if isinstance(stmt, (ast.If, ast.While)):
            guard = _guard_statuses(stmt.test, registry)
            if guard is not None:
                inner = guard
        for field, value in ast.iter_fields(stmt):
            if not (isinstance(value, list) and value):
                continue
            if isinstance(value[0], ast.stmt):
                # the guard narrows the THEN branch only
                _walk_writes(fn, value, inner if field == "body" else fromset, registry, writes)
            elif isinstance(value[0], ast.excepthandler):
                for h in value:
                    _walk_writes(fn, h.body, fromset, registry, writes)
            elif isinstance(getattr(value[0], "body", None), list):  # match cases
                for case in value:
                    _walk_writes(fn, case.body, fromset, registry, writes)


# ---------------------------------------------------------------------------
# claim-path protection (the exactly-once exception edge)
# ---------------------------------------------------------------------------


class _ClaimAnalysis:
    """Fixpoint summaries: which functions (transitively) CLAIM and which
    (transitively) SETTLE (write a terminal status or release to
    preprocess_completed)."""

    def __init__(self, program: Program, registry: StatusRegistry):
        self.program = program
        self.registry = registry
        self.claims: set[int] = set()
        self.settles: set[int] = set()
        self._settle_values = registry.terminal | {_RELEASED}
        self._callee_map = {id(fn): [c for node in own_body_walk(fn.node) if isinstance(node, ast.Call)
                                     for c in program.resolve_call_direct(node, fn)]
                            for fn in program.functions}
        self._compute()

    def _settling_write(self, node: ast.AST) -> bool:
        return bool(set(_status_writes(node, self.registry)) & self._settle_values)

    def _writes_settle(self, fn: FunctionInfo) -> bool:
        return any(self._settling_write(node) for node in own_body_walk(fn.node))

    @staticmethod
    def _calls_claim(fn: FunctionInfo) -> bool:
        return any(isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                   and node.func.attr == "claim" for node in own_body_walk(fn.node))

    def _callees(self, fn: FunctionInfo) -> list[FunctionInfo]:
        return self._callee_map[id(fn)]

    def _compute(self) -> None:
        for fn in self.program.functions:
            if self._calls_claim(fn):
                self.claims.add(id(fn))
            if self._writes_settle(fn):
                self.settles.add(id(fn))
        changed = True
        while changed:
            changed = False
            for fn in self.program.functions:
                for callee in self._callees(fn):
                    for summary in (self.claims, self.settles):
                        if id(callee) in summary and id(fn) not in summary:
                            summary.add(id(fn))
                            changed = True

    def _try_protected(self, fn: FunctionInfo) -> bool:
        """A `try` in `fn` whose finally or handler (transitively) settles."""

        def body_settles(body) -> bool:
            for stmt in body:
                for node in ast.walk(stmt):
                    if self._settling_write(node):
                        return True
                    if isinstance(node, ast.Call) and any(
                            id(c) in self.settles for c in self.program.resolve_call_direct(node, fn)):
                        return True
            return False

        for node in own_body_walk(fn.node):
            if not isinstance(node, ast.Try):
                continue
            if node.finalbody and body_settles(node.finalbody):
                return True
            if any(body_settles(h.body) for h in node.handlers):
                return True
        return False

    def _owns_span(self, fn: FunctionInfo) -> bool:
        """True when `fn` is the frame where a bare claim meets the settle
        obligation: it settles (transitively) and calls `.claim` itself or
        a callee that claims without settling. A frame whose claiming
        callees all settle merely wraps a lower owner; reporting every
        frame of the call cone would turn one gap into many findings at
        frames that cannot fix it."""
        if id(fn) not in self.settles:
            return False
        if self._calls_claim(fn):
            return True
        return any(id(c) in self.claims and id(c) not in self.settles for c in self._callees(fn))

    def unprotected_owners(self) -> list[FunctionInfo]:
        """Span owners with no protected exception edge: no settling try
        of their own and no call into a compliant callee."""
        compliant = {id(fn) for fn in self.program.functions
                     if id(fn) in self.settles and self._try_protected(fn)}
        changed = True
        while changed:
            changed = False
            for fn in self.program.functions:
                if id(fn) not in compliant and any(id(c) in compliant for c in self._callees(fn)):
                    compliant.add(id(fn))
                    changed = True
        return [fn for fn in self.program.functions
                if self._owns_span(fn) and id(fn) not in compliant
                and fn.module.relpath.startswith(WRITE_SCOPE)]


# ---------------------------------------------------------------------------
# the artifact and the gate
# ---------------------------------------------------------------------------


def build_graph(program: Program) -> dict | None:
    registry = StatusRegistry.from_program(program)
    if registry is None:
        return None
    return {
        "version": GRAPH_VERSION,
        "comment": (
            "The port's document status transition graph (rule: status-machine). `statuses` is the "
            "jobs/models.py registry with its classification flags; `transitions` is the legal edge "
            "set derived from it (claim/judge/release); `writes` is every `.status =` site in "
            "jobs/ and chaos/degrade.py with its guard-derived from-set. Regenerate with "
            "`python -m foremast_tpu_torch.analysis --write-statusgraph`; the gate fails when this "
            "drifts from the computed graph."
        ),
        "statuses": [
            {"name": name, "value": value, "terminal": value in registry.terminal,
             "claimable": value in registry.claimable, "inprogress": value in registry.inprogress}
            for name, value in sorted(registry.names.items())
        ],
        "transitions": registry.legal_transitions(),
        "writes": collect_writes(program, registry),
    }


def graph_path(root: str) -> str:
    return os.path.join(root, GRAPH_NAME)


def write_graph(root: str, graph: dict) -> None:
    with open(graph_path(root), "w", encoding="utf-8") as f:
        json.dump(graph, f, indent=2, sort_keys=True)
        f.write("\n")


def load_graph(root: str) -> dict | None:
    path = graph_path(root)
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _normalize(graph: dict) -> tuple:
    return (
        graph.get("version"),
        tuple((s["name"], s["value"], s["terminal"], s["claimable"], s["inprogress"])
              for s in sorted(graph.get("statuses", ()), key=lambda s: s["name"])),
        tuple((e["from"], e["to"], e["via"])
              for e in sorted(graph.get("transitions", ()), key=lambda e: (e["from"], e["to"], e["via"]))),
        tuple((w["site"], w["fn"], w["status"], tuple(w["from"]))
              for w in sorted(graph.get("writes", ()), key=lambda w: (w["site"], w["status"]))),
    )


def check_status_machine(root: str, program: Program) -> list[Finding]:
    registry = StatusRegistry.from_program(program)
    if registry is None:
        return []  # no status registry in scope (a fixture run)
    findings: list[Finding] = []
    legal = registry.legal_pairs()
    legal_targets = {to for _f, to in legal}

    for w in collect_writes(program, registry):
        path, _, line = w["site"].partition(":")
        line = int(line or 1)
        if w["status"] == "?":
            findings.append(Finding(
                RULE, path, line,
                f"dynamic status write in `{w['fn']}` — a computed status value defeats the "
                "transition-graph analysis (and the exactly-once ledger it encodes)",
                "assign one of the STATUS_* constants (branch on the condition, not on the value)"))
        elif w["status"] not in registry.values:
            findings.append(Finding(
                RULE, path, line,
                f"unknown status `{w['status']}` written in `{w['fn']}` — not in the jobs/models.py "
                "registry (the wire contract with the reference service)",
                f"use a STATUS_* constant; a new status goes into models.py, then {_REGEN}"))
        else:
            findings.extend(_write_legality(w, legal, legal_targets, path, line))

    for fn in _ClaimAnalysis(program, registry).unprotected_owners():
        findings.append(Finding(
            RULE, fn.module.relpath, fn.node.lineno,
            f"claim path `{fn.qualname}` has an exception edge that reaches neither a terminal "
            "status write nor a release — a crash mid-path strands claimed docs until the "
            "stuck-takeover window",
            "wrap the claim-to-settle span in try/finally (or an except edge) that releases unjudged "
            "docs (`_release_docs` -> preprocess_completed), or delegate to a helper that does — "
            "the `_sweep_sliced` shape"))

    findings.extend(_artifact_findings(root, program))
    return findings


def _write_legality(w: dict, legal, legal_targets, path: str, line: int) -> list[Finding]:
    if w["status"] == "initial":
        # (re)creation: constructors set it, and nothing moves back to
        # fresh work through `.status =`
        froms = ["(any)"]
    elif w["from"] == ["*"]:
        froms = [] if w["status"] in legal_targets else ["(unguarded)"]
    else:
        froms = [s for s in w["from"] if (s, w["status"]) not in legal]
    if not froms:
        return []
    return [Finding(
        RULE, path, line,
        f"illegal status transition {froms} -> `{w['status']}` written in `{w['fn']}` — outside the "
        "legal set (claim -> in-progress -> judged/released/terminal)",
        f"see `transitions` in {GRAPH_NAME}; if the machine legitimately grew, change "
        f"jobs/models.py's classification sets, then {_REGEN}")]


def _artifact_findings(root: str, program: Program) -> list[Finding]:
    computed = build_graph(program)
    if computed is None:
        return []
    committed = load_graph(root)
    if committed is None:
        return [Finding(RULE, GRAPH_NAME, 1,
                        f"{GRAPH_NAME} missing — the status transition graph must be committed so "
                        "state-machine changes are reviewable diffs",
                        f"run {_REGEN} and commit the artifact")]
    if _normalize(committed) != _normalize(computed):
        return [Finding(RULE, GRAPH_NAME, 1,
                        f"committed {GRAPH_NAME} is stale vs the computed status graph (statuses, "
                        "transitions or write sites changed)",
                        f"run {_REGEN}, review the diff, and commit it")]
    return []
