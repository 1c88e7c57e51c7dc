"""Structured logging of dispatch decisions.

Set the env var SANGNOM_TPU_TORCH_LOG=1 (or configure the 'sangnom_tpu_torch'
logger) to see one line per filter call: backend, dtype mapping, geometry,
thresholds (the observable analogue of the reference's silent ctor-time
backend selection, reference src/SangNom2.cpp:312-329).

Set SANGNOM_TPU_TORCH_TRACE=<dir> to record the port's spans for the whole
process and write them at exit as a Chrome trace in <dir>
(sangnom_tpu_torch.utils.profiling).
"""

from __future__ import annotations

import logging
import os

_logger: logging.Logger | None = None


def get_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        lg = logging.getLogger("sangnom_tpu_torch")
        if os.environ.get("SANGNOM_TPU_TORCH_LOG") and not lg.handlers:
            h = logging.StreamHandler()
            h.setFormatter(logging.Formatter("[sangnom_tpu_torch] %(message)s"))
            lg.addHandler(h)
            lg.setLevel(logging.INFO)
        _logger = lg
    return _logger


def log_dispatch(**fields) -> None:
    """One structured line per filter call."""
    lg = get_logger()
    if lg.isEnabledFor(logging.INFO):
        lg.info(" ".join(f"{k}={v}" for k, v in fields.items()))
