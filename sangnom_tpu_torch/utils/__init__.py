"""Observability: dispatch logging, the span layer and a trace context."""

from sangnom_tpu_torch.utils.logging import get_logger, log_dispatch  # noqa: F401
from sangnom_tpu_torch.utils.profiling import (  # noqa: F401
    count,
    counters,
    disable,
    drain,
    enable,
    profile_trace,
    span,
    tracing,
)
