"""Bounded retry of idempotent I/O (the port's copy of ``retry_io`` in
scaling_tpu/resilience/guards.py)."""

from __future__ import annotations

import logging
import time
from typing import Callable, Tuple, Type

DEFAULT_RETRY_ATTEMPTS = 3
DEFAULT_RETRY_BACKOFF_SECONDS = 0.05

_log = logging.getLogger("scaling_tpu_torch")


def retry_io(fn: Callable, *, attempts: int = DEFAULT_RETRY_ATTEMPTS,
             base_delay: float = DEFAULT_RETRY_BACKOFF_SECONDS,
             retry_on: Tuple[Type[BaseException], ...] = (OSError,),
             what: str = "i/o operation"):
    """``fn()``, retried on ``retry_on`` with a delay that doubles from
    ``base_delay``; the last failure re-raises. Only for idempotent
    operations (index-based reads, whole-file writes)."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except retry_on as e:
            if attempt == attempts:
                _log.error(f"{what} failed after {attempts} attempt(s): {e!r}")
                raise
            delay = base_delay * (2 ** (attempt - 1))
            _log.warning(f"{what} failed (attempt {attempt}/{attempts}): {e!r}; "
                         f"retrying in {delay:.3f}s")
            time.sleep(delay)
