"""Demo workload — the instrumented example app + fault injectors.

The port's copy of the JAX package's `foremast_tpu/demo/`. Python
equivalent of `examples/spring-boot-demo/` (SURVEY.md section 2.6): a
small WSGI app wired through the instrumentation starter, with an error
endpoint, a rate-based error generator, and a CSV-trace replayer — the
fault injectors that drive the end-to-end demo/runbook.
"""

from foremast_tpu_torch.demo.app import (
    DemoClient,
    ErrorGenerator,
    FileErrorGenerator,
    make_demo_app,
)

__all__ = ["DemoClient", "ErrorGenerator", "FileErrorGenerator", "make_demo_app"]
