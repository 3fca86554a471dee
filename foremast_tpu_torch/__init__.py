"""foremast-tpu's scoring brain on PyTorch and CUDA.

A port of `foremast_tpu` (the JAX reference) for NVIDIA Hopper: the same
module names and `[B, T]` layouts, with every Pallas kernel of the
scoring path, the Holt-Winters and Holt recurrences, and the LSTM
autoencoder's forward and backward passes rewritten as hand-written CUDA
kernels (`ops/csrc/`). The package imports torch and
numpy only — never JAX, scipy or anything of `foremast_tpu`. Entry
points run on the CUDA device unless the caller passes `device="cpu"`,
which runs each kernel's plain PyTorch version.

Layers:
  config.py   judgment config (env parity with the reference brain)
  ops/        masked windows, bounds, the univariate forecasters, rank
              tests, kernel wrappers + CUDA sources
  engine/     the scoring programs, the ragged-job judge (object and
              columnar paths), the multivariate judge (bivariate and
              LSTM-AE joint detectors) and the device state arenas
  models/     the fit cache (fitted terminal state kept between ticks),
              the seasonal (Prophet-substitute) model, the joint models
  parallel/   synthetic fixed-shape batches for throughput runs
  jobs/       the job store (in memory or Elasticsearch over HTTP), the
              request converter, the chunk pipeline and the brain worker
  service/    the REST job gateway (standard-library HTTP server)
  watch/      the Kubernetes control loop: CRDs, the kube API (in memory
              or over HTTP), barrelman, the status poller and remediation
  metrics/    the config codec, Prometheus and in-memory metric sources
  ingest/     crc-framed record logs under the fit journals
  observe/    spans, JSON logs, Prometheus gauges and the /metrics server
  native.py   the host packing library (ops/csrc/windowpack.cpp, g++)
  cli.py      `python -m foremast_tpu_torch score | serve | worker | watch |
              unwatch | watch-plane`
  interop.py  JAX-side state (numpy leaves) -> the port's tensors
"""

__version__ = "0.1.0"
