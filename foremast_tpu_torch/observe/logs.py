"""Structured leveled logging for all components.

The reference scatters glog V-levels (barrelman), gin logs (service), and
an unused leveled-logger scaffold (`foremast-service/pkg/common/logger.go`);
here one JSON-lines logger serves every component.
"""

from __future__ import annotations

import json
import logging
import sys
import time

from foremast_tpu_torch.observe.spans import current_span


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(time.time(), 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        # correlate with the span pipeline: any record emitted inside an
        # open span carries its trace/span IDs, so logs, metrics and the
        # Perfetto dump all join on one ID (observe/spans.py)
        sp = current_span()
        if sp is not None:
            out["trace_id"] = sp.trace_id
            out["span_id"] = sp.span_id
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        extra = getattr(record, "ctx", None)
        if extra:
            out.update(extra)
        return json.dumps(out)


def setup_logging(level: int = logging.INFO, stream=None) -> None:
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(JsonFormatter())
    root = logging.getLogger("foremast_tpu_torch")
    root.handlers[:] = [handler]
    root.setLevel(level)
    root.propagate = False


def ctx_log(logger: logging.Logger, level: int, msg: str, **ctx) -> None:
    logger.log(level, msg, extra={"ctx": ctx})
