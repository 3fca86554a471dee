"""foremast-tpu's scoring brain on PyTorch and CUDA.

A port of `foremast_tpu` (the JAX reference) for NVIDIA Hopper: the same
module names and `[B, T]` layouts, with every Pallas kernel of the
scoring path, and the Holt-Winters and Holt recurrences, rewritten as
hand-written CUDA kernels (`ops/csrc/`). The package imports torch and
numpy only — never JAX, scipy or anything of `foremast_tpu`. Entry
points run on the CUDA device unless the caller passes `device="cpu"`,
which runs each kernel's plain PyTorch version.

Layers:
  config.py   judgment config (env parity with the reference brain)
  ops/        masked windows, bounds, the univariate forecasters, rank
              tests, kernel wrappers + CUDA sources
  engine/     the scoring programs, the ragged-job judge (object and
              columnar paths) and the device state arena
  models/     the fit cache (fitted terminal state kept between ticks),
              the seasonal (Prophet-substitute) model
  parallel/   synthetic fixed-shape batches for throughput runs
  interop.py  JAX-side state (numpy leaves) -> the port's tensors
"""
