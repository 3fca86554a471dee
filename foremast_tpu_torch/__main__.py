"""`python -m foremast_tpu_torch worker ...`: the port's command line
(`foremast_tpu_torch/cli.py`)."""

from foremast_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
