"""The port's static rules and its runtime lock witness.

The port's own copy of `foremast_tpu/analysis/`. Each per-module checker
is a pure function of a parsed ``Module`` (`core.py`: no import of the
checked code, no device), emitting ``Finding``s with file:line, a stable
rule ID and a fix hint. The whole-program rules run over one
`interproc.Program`'s cross-module call resolution. The runner folds in
the metric naming lint (`observe/metrics_lint.py`) and gates everything
against the committed `analysis_baseline_torch.json`. Per-line
``# foremast: ignore[rule] — reason`` comments mark deliberate
exceptions in place; ``# foremast: device-boundary`` and ``# foremast:
sharded-arena`` declare contracts that change what a rule checks.

Every rule of the JAX package and its counterpart here:

| JAX rule | the port | |
|---|---|---|
| async-blocking | `async_blocking.py` | also over the port's tests and `chip_smoke.py` |
| lock-discipline | `lock_discipline.py` | |
| env-contract | `env_contract.py` | the README's knob table rendered from `config.ENV_KNOBS` |
| metrics-contract | `metrics_contract.py` | the README's family index rendered from the lint registry |
| lock-order | `lock_order.py` | the graph committed as `analysis_lockgraph_torch.json` |
| thread-escape | `thread_escape.py` | |
| blocking-under-lock | `blocking_under_lock.py` | |
| device-flow | `device_flow.py` | torch's syncs, measured on the card; also `ops/` and `models/` where a dispatch root reaches them |
| sharding-contract | `sharding_contract.py` | torch's uploads |
| status-machine | `status_machine.py` | the graph committed as `analysis_statusgraph_torch.json` |
| jit-hygiene | none | guards code traced under `jax.jit`; the port traces nothing. Its sync half (`.item()`, `float()`, `bool()`, `np.asarray`, `if` on a device value) is device-flow's, which checks `ops/` and `models/` on the dispatch path |
| recompile-hazard | none | guards XLA's cache of programs compiled per shape and static value; the port has no `torch.compile`, no `torch.jit` and no CUDA graph, and its kernels build once per source hash (`ops/_build.py`), so nothing recompiles per shape |
| recompile-witness | none | counts XLA backend compiles at run time; nothing in the port compiles at run time but the kernels' one build (`FOREMAST_RECOMPILE_WITNESS` is refused by the CLI) |

`tests/test_torch_analysis_device.py` holds the premise of the three
"none": an AST scan of the package finds no `torch.compile`, `torch.jit`,
`torch.cuda.graph`, `CUDAGraph` or `torch._dynamo`. A port that adds one
must port the recompile rules first.

The witness (`witness.py`, `FOREMAST_LOCK_WITNESS=1`) checks real
acquisition orders against the static graph. Nothing here imports the
checked code or creates a lock, so the CLI can install the witness
before the package's first lock exists.

    python -m foremast_tpu_torch.analysis                        # the gate
    python -m foremast_tpu_torch.analysis --write-lockgraph      # regenerate
    python -m foremast_tpu_torch.analysis --write-statusgraph    # regenerate
    python -m foremast_tpu_torch.analysis --update-env-docs      # README table
    python -m foremast_tpu_torch.analysis --update-metrics-docs  # README index
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
    from foremast_tpu_torch.analysis.metrics_contract import MetricsContractChecker

    return [AsyncBlockingChecker(), LockDisciplineChecker(), MetricsContractChecker()]


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
