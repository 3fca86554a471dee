"""The gated runner: `python -m foremast_tpu_torch.analysis`.

Exit codes: 0 clean (modulo the committed baseline), 1 findings, 2 bad
usage. One command gates every machine-checked contract of the port:

  * the per-module rules (`all_checkers()`: async-blocking over the
    package, the port's tests and `chip_smoke.py`; lock-discipline over
    the package) and the env contract over the package;
  * on the default (no-paths) run only: the whole-program rules
    (lock-order with the committed graph's drift check, thread-escape,
    blocking-under-lock), the README's knob table and the metric naming
    lint (`observe/metrics_lint.py`).

    --json / --sarif     machine-readable output (SARIF 2.1.0)
    --baseline PATH      the grandfather list (default: analysis_baseline_torch.json)
    --write-baseline     snapshot today's findings as the baseline and exit 0
    --write-lockgraph    rewrite analysis_lockgraph_torch.json from the tree and exit
    --update-env-docs    rewrite the README's generated knob table and exit
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from foremast_tpu_torch.analysis import all_checkers
from foremast_tpu_torch.analysis.core import (
    Baseline,
    Finding,
    analyze_modules,
    collect_modules,
    default_paths,
    in_package,
    repo_root,
)
from foremast_tpu_torch.analysis.env_contract import check_env_docs, env_findings, update_env_docs

BASELINE_NAME = "analysis_baseline_torch.json"
LINT_PATH = "foremast_tpu_torch/observe/metrics_lint.py"


def metrics_lint_findings() -> list[Finding]:
    """The metric naming lint as findings under rule `metrics-lint`."""
    from foremast_tpu_torch.observe.metrics_lint import default_registry_families, lint_registry

    hint = "metric families must match the dashboard contract (observe/metrics_lint.py)"
    return [Finding("metrics-lint", LINT_PATH, 1, p, hint) for p in lint_registry(default_registry_families())]


def program_findings(root: str, modules) -> list[Finding]:
    """The whole-program concurrency rules over the package's modules
    (the static lock graph with its cycle and drift check,
    thread-escape, blocking-under-lock), per-line suppressions applied."""
    from foremast_tpu_torch.analysis.blocking_under_lock import apply_suppressions, check_blocking_under_lock
    from foremast_tpu_torch.analysis.interproc import Program
    from foremast_tpu_torch.analysis.lock_order import check_lock_order
    from foremast_tpu_torch.analysis.thread_escape import check_thread_escape

    pkg = [m for m in modules if in_package(m.relpath)]
    program = Program(pkg)
    findings = check_lock_order(root, program) + check_thread_escape(program) + check_blocking_under_lock(program)
    return apply_suppressions(findings, pkg)


def tree_findings(root: str, paths=None) -> list[Finding]:
    """Every finding of a run over `paths`, or of the full gate when
    `paths` is empty, sorted; the baseline is not applied."""
    modules = collect_modules(root, paths or default_paths(root))
    findings = analyze_modules(modules, all_checkers())
    findings += env_findings(paths or None, root=root)
    if not paths:
        findings += check_env_docs(root) + program_findings(root, modules) + metrics_lint_findings()
    return sorted(set(findings), key=Finding.sort_key)


def to_sarif(new: list[Finding], grandfathered: list[Finding]) -> dict:
    """SARIF 2.1.0: new findings as error-level results, grandfathered
    ones carried with an `accepted` suppression so viewers can show (but
    not gate on) the known debt."""
    rules = sorted({f.rule for f in [*new, *grandfathered]})

    def result(f: Finding, suppressed: bool) -> dict:
        out = {
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message + (f" — {f.hint}" if f.hint else "")},
            "locations": [{"physicalLocation": {
                "artifactLocation": {"uri": f.path, "uriBaseId": "SRCROOT"},
                "region": {"startLine": max(1, f.line)},
            }}],
            "fingerprints": {"foremastCheck/v1": f.fingerprint()},
        }
        if suppressed:
            out["suppressions"] = [{"kind": "external", "status": "accepted",
                                    "justification": f"grandfathered in {BASELINE_NAME}"}]
        return out

    return {
        "$schema": "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/Schemata/sarif-schema-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {"name": "foremast-check-torch", "rules": [{"id": r} for r in rules]}},
            "originalUriBaseIds": {"SRCROOT": {"uri": "file:///"}},
            "results": [result(f, False) for f in new] + [result(f, True) for f in grandfathered],
        }],
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m foremast_tpu_torch.analysis",
        description="the port's static rules: async-blocking, lock-discipline, env-contract, "
        "lock-order, thread-escape, blocking-under-lock, metrics-lint",
    )
    p.add_argument("paths", nargs="*", help="files/directories to scan (default: the package, the port's "
                   "tests and chip_smoke.py; the whole-program rules need the default scan)")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument("--sarif", action="store_true", help="emit SARIF 2.1.0 on stdout")
    p.add_argument("--baseline", default=None, help=f"baseline file (default: <repo>/{BASELINE_NAME})")
    p.add_argument("--write-baseline", action="store_true",
                   help="snapshot current findings as the new baseline and exit 0")
    p.add_argument("--write-lockgraph", action="store_true",
                   help="rewrite analysis_lockgraph_torch.json from the tree and exit")
    p.add_argument("--update-env-docs", action="store_true",
                   help="rewrite the README's generated knob table and exit")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    root = repo_root()
    if args.update_env_docs:
        print("README.md env table " + ("updated" if update_env_docs(root) else "already current"))
        return 0
    if args.write_lockgraph:
        from foremast_tpu_torch.analysis.interproc import Program
        from foremast_tpu_torch.analysis.lock_order import GRAPH_NAME, build_graph, write_graph

        graph = build_graph(Program(collect_modules(root)))
        write_graph(root, graph)
        print(f"{GRAPH_NAME}: {len(graph['nodes'])} locks, {len(graph['edges'])} edges")
        return 0
    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        print(f"no such file or directory: {', '.join(missing)}", file=sys.stderr)
        return 2

    findings = tree_findings(root, args.paths)
    baseline_path = args.baseline or os.path.join(root, BASELINE_NAME)
    if args.write_baseline:
        Baseline.from_findings(findings).save(baseline_path)
        print(f"wrote {len(findings)} grandfathered finding(s) to {baseline_path}")
        return 0
    baseline = Baseline.load(baseline_path)
    new, grandfathered = baseline.split(findings)
    stale = baseline.stale(findings)

    if args.sarif:
        json.dump(to_sarif(new, grandfathered), sys.stdout, indent=2)
        print()
    elif args.json:
        json.dump({"findings": [f.to_json() for f in new],
                   "grandfathered": [f.to_json() for f in grandfathered],
                   "stale_baseline": stale}, sys.stdout, indent=2)
        print()
    else:
        for f in new:
            print(f.render())
        if grandfathered:
            print(f"foremast_tpu_torch.analysis: {len(grandfathered)} grandfathered finding(s) "
                  f"suppressed by {BASELINE_NAME}")
        for e in stale:
            print("foremast_tpu_torch.analysis: stale baseline entry (debt paid, remove it): "
                  f"[{e['rule']}] {e['path']}: {e['message']}")
        print(f"foremast_tpu_torch.analysis: {len(new)} finding(s)"
              + ("; fix, or suppress with `# foremast: ignore[rule] — reason`" if new else ", clean"))
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
