"""`python -m foremast_tpu_torch.analysis`: the port's env contract and
lock-order rule over its tree; exit 1 on any finding.

    --write-lockgraph   rewrite analysis_lockgraph_torch.json from the tree
    --update-env-docs   rewrite the README's generated knob table
"""

from __future__ import annotations

import argparse
import sys

from foremast_tpu_torch.analysis.core import collect_modules, repo_root
from foremast_tpu_torch.analysis.env_contract import check_env_docs, env_findings, update_env_docs
from foremast_tpu_torch.analysis.interproc import Program
from foremast_tpu_torch.analysis.lock_order import GRAPH_NAME, build_graph, check_lock_order, write_graph


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m foremast_tpu_torch.analysis")
    p.add_argument("--write-lockgraph", action="store_true", help=f"regenerate {GRAPH_NAME}")
    p.add_argument("--update-env-docs", action="store_true", help="regenerate the README's knob table")
    args = p.parse_args(argv)
    root = repo_root()
    program = Program(collect_modules(root))
    if args.write_lockgraph:
        graph = build_graph(program)
        write_graph(root, graph)
        print(f"{GRAPH_NAME}: {len(graph['nodes'])} locks, {len(graph['edges'])} edges")
    if args.update_env_docs:
        print("README.md env table " + ("updated" if update_env_docs(root) else "already current"))
    findings = env_findings(root=root) + check_env_docs(root) + check_lock_order(root, program)
    for f in findings:
        print(f.render())
    print(f"foremast_tpu_torch.analysis: {len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
