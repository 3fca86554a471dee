"""lock-order: the port's static lock-acquisition graph, pinned as an
artifact.

The port's own copy of `foremast_tpu/analysis/lock_order.py`, over the
port's tree:

  * every ``threading.Lock``/``RLock`` the package creates is a NODE
    (per creation site: all shard locks share one identity, because
    the ordering contract is per-site, not per-object);
  * an EDGE ``A -> B`` means "B may be acquired while A is held",
    computed over the whole package with the interprocedural resolver
    (`analysis/interproc.py`): direct nesting, calls through typed
    attributes, and the callback table all contribute;
  * a CYCLE is a finding: two threads walking it from different ends
    deadlock;
  * the graph is COMMITTED as ``analysis_lockgraph_torch.json``, in the
    JAX artifact's format, and `check_lock_order` reports a drift from
    it (`python -m foremast_tpu_torch.analysis --write-lockgraph`
    regenerates it), so every ordering change is a reviewable diff.

The static graph is deliberately a SUPERSET of runtime behavior; the
runtime witness (`analysis/witness.py`) checks from the other side that
every OBSERVED acquisition edge exists here.

Self-edges on RLocks are reentrancy, not deadlock: they are recorded
(``reentrant``) but left out of cycle detection. A self-edge on a plain
Lock deadlocks a single thread and is always a finding.
"""

from __future__ import annotations

import ast
import json
import os

from foremast_tpu_torch.analysis.core import Finding
from foremast_tpu_torch.analysis.interproc import FunctionInfo, Program, locked_walk

RULE = "lock-order"
GRAPH_NAME = "analysis_lockgraph_torch.json"
GRAPH_VERSION = 1


def build_graph(program: Program) -> dict:
    """The lock graph as the JSON-shaped dict the artifact stores:
    ``nodes`` (id, kind, site) and ``edges`` (from, to, via = one
    example site of the inner acquisition/call), both sorted."""
    edges: dict[tuple[str, str], str] = {}
    reentrant: dict[str, str] = {}

    def record(outer, inner, site: str):
        if outer.name == inner.name:
            if inner.kind == "RLock":
                reentrant.setdefault(inner.name, site)
                return
        edges.setdefault((outer.name, inner.name), site)

    for fn in program.functions:
        _walk_function(program, fn, record)

    nodes = [
        {"id": lk.name, "kind": lk.kind, "site": lk.site}
        for lk in program.all_locks()
    ]
    return {
        "version": GRAPH_VERSION,
        "comment": (
            "Static lock-acquisition graph of foremast_tpu_torch (rule: "
            "lock-order). An edge A -> B means B may be acquired while A "
            "is held; `via` is one example site. Regenerate with `python "
            "-m foremast_tpu_torch.analysis --write-lockgraph`; the "
            "runtime witness (FOREMAST_LOCK_WITNESS) asserts observed "
            "orders stay inside this graph."
        ),
        "nodes": nodes,
        "edges": [
            {"from": a, "to": b, "via": site}
            for (a, b), site in sorted(edges.items())
        ],
        "reentrant": [
            {"id": name, "via": site}
            for name, site in sorted(reentrant.items())
        ],
    }


def _walk_function(program: Program, fn: FunctionInfo, record) -> None:
    for node, held, acquired in locked_walk(program, fn):
        if acquired is not None:
            for outer in held:
                record(outer, acquired, fn.site(node))
        elif held and isinstance(node, ast.Call):
            for callee in program.resolve_call(node, fn):
                for inner in sorted(
                    callee.acquires_all, key=lambda lk: lk.name
                ):
                    for outer in held:
                        record(outer, inner, fn.site(node))


def find_cycles(graph: dict) -> list[list[str]]:
    """Every elementary cycle reachable in the edge set (self-edges on
    plain Locks included — they deadlock a single thread). Returned as
    node-id paths, deterministic order."""
    adj: dict[str, list[str]] = {}
    for e in graph["edges"]:
        adj.setdefault(e["from"], []).append(e["to"])
    for targets in adj.values():
        targets.sort()
    cycles: list[list[str]] = []
    seen_cycles: set[tuple] = set()

    def dfs(start: str, node: str, path: list[str], on_path: set):
        for nxt in adj.get(node, ()):
            if nxt == start:
                canon = min(
                    tuple(path[i:] + path[:i]) for i in range(len(path))
                )
                if canon not in seen_cycles:
                    seen_cycles.add(canon)
                    cycles.append(path + [start])
            elif nxt not in on_path and nxt > start:
                # only explore nodes ordered after `start`: each cycle
                # is found exactly once, rooted at its smallest node
                dfs(start, nxt, path + [nxt], on_path | {nxt})

    for start in sorted(adj):
        dfs(start, start, [start], {start})
    return cycles


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


def _site_of(graph: dict, node_id: str) -> str:
    for n in graph["nodes"]:
        if n["id"] == node_id:
            return n["site"]
    return GRAPH_NAME


def check_lock_order(root: str, program: Program) -> list[Finding]:
    """Cycle findings + artifact-drift finding, for the default run."""
    graph = build_graph(program)
    findings: list[Finding] = []
    for cycle in find_cycles(graph):
        chain = " -> ".join(cycle)
        site = _site_of(graph, cycle[0])
        path, _, line = site.partition(":")
        findings.append(
            Finding(
                rule=RULE,
                path=path,
                line=int(line or 1),
                message=f"lock-order cycle: {chain} — two threads walking "
                "this cycle from different ends deadlock",
                hint="impose one global order (acquire the earlier lock "
                "first everywhere), or split the critical sections so "
                "the nesting disappears",
            )
        )
    committed = load_graph(root)
    if committed is None:
        findings.append(
            Finding(
                rule=RULE,
                path=GRAPH_NAME,
                line=1,
                message=f"{GRAPH_NAME} missing — the lock-acquisition "
                "graph must be committed so ordering changes are "
                "reviewable diffs",
                hint="run `python -m foremast_tpu_torch.analysis --write-lockgraph` and commit the artifact",
            )
        )
    elif _normalize(committed) != _normalize(graph):
        findings.append(
            Finding(
                rule=RULE,
                path=GRAPH_NAME,
                line=1,
                message=f"committed {GRAPH_NAME} is stale vs the computed "
                "lock graph (locks or acquisition edges changed)",
                hint="run `python -m foremast_tpu_torch.analysis --write-lockgraph`, review the diff, "
                "and commit it",
            )
        )
    return findings


def _normalize(graph: dict) -> tuple:
    return (
        graph.get("version"),
        tuple(
            (n["id"], n["kind"], n["site"])
            for n in sorted(graph.get("nodes", ()), key=lambda n: n["id"])
        ),
        tuple(
            (e["from"], e["to"], e["via"])
            for e in sorted(
                graph.get("edges", ()), key=lambda e: (e["from"], e["to"])
            )
        ),
        tuple(
            (r["id"], r["via"])
            for r in sorted(graph.get("reentrant", ()), key=lambda r: r["id"])
        ),
    )
