"""Observability: dispatch logging, profiler scopes and a trace context."""

from sangnom_tpu_torch.utils.logging import get_logger, log_dispatch  # noqa: F401
from sangnom_tpu_torch.utils.profiling import profile_trace, stage_scope  # noqa: F401
