"""The port's static rules and its runtime lock witness.

The parts of `foremast_tpu/analysis/` the port needs, in its own copy:
the env contract (`env_contract.py`: every env read names a knob of
`config.ENV_KNOBS`, and the README's knob table is rendered from it),
the static lock-acquisition graph (`interproc.py`, `lock_order.py`,
committed as `analysis_lockgraph_torch.json`) and the witness that
checks real acquisition orders against it (`witness.py`,
`FOREMAST_LOCK_WITNESS=1`). Nothing here imports the checked code or
creates a lock, so the CLI can install the witness before the package's
first lock exists.

    python -m foremast_tpu_torch.analysis                    # check
    python -m foremast_tpu_torch.analysis --write-lockgraph  # regenerate
    python -m foremast_tpu_torch.analysis --update-env-docs  # README table
"""
