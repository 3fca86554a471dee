"""The port's static rules and its runtime lock witness.

The port's own copy of `foremast_tpu/analysis/`, for the rules the port
needs. Each per-module checker is a pure function of a parsed ``Module``
(`core.py`: no import of the checked code, no device), emitting
``Finding``s with file:line, a stable rule ID and a fix hint:
async-blocking (`async_blocking.py`), lock-discipline
(`lock_discipline.py`) and the env contract (`env_contract.py`: every
env read names a knob of `config.ENV_KNOBS`, and the README's knob table
is rendered from it). The whole-program rules run over
`interproc.Program`'s cross-module call resolution: lock-order
(`lock_order.py`, the static lock graph committed as
`analysis_lockgraph_torch.json`), thread-escape (`thread_escape.py`) and
blocking-under-lock (`blocking_under_lock.py`). The runner folds in the
metric naming lint (`observe/metrics_lint.py`) and gates everything
against the committed `analysis_baseline_torch.json`. Per-line
``# foremast: ignore[rule] — reason`` comments mark deliberate
exceptions in place.

The witness (`witness.py`, `FOREMAST_LOCK_WITNESS=1`) checks real
acquisition orders against the static graph. Nothing here imports the
checked code or creates a lock, so the CLI can install the witness
before the package's first lock exists.

    python -m foremast_tpu_torch.analysis                    # the gate
    python -m foremast_tpu_torch.analysis --write-lockgraph  # regenerate
    python -m foremast_tpu_torch.analysis --update-env-docs  # README table
"""

from __future__ import annotations

from foremast_tpu_torch.analysis.core import (
    Baseline,
    Checker,
    Finding,
    Module,
    analyze_modules,
    analyze_source,
    collect_modules,
    repo_root,
)


def all_checkers() -> list[Checker]:
    """One instance of every per-module checker, in report order. The
    env contract runs from `env_contract.env_findings` over the package
    alone, and the whole-program rules need the complete package: both
    run from the full scan only (`__main__.program_findings`)."""
    from foremast_tpu_torch.analysis.async_blocking import AsyncBlockingChecker
    from foremast_tpu_torch.analysis.lock_discipline import LockDisciplineChecker

    return [AsyncBlockingChecker(), LockDisciplineChecker()]


__all__ = [
    "Baseline",
    "Checker",
    "Finding",
    "Module",
    "all_checkers",
    "analyze_modules",
    "analyze_source",
    "collect_modules",
    "repo_root",
]
