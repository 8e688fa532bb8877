"""In-loop guards (the port's copy of scaling_tpu/resilience/guards.py):
bounded retry of idempotent I/O, the non-finite-loss budget and the step
stall watchdog. All host-side."""

from __future__ import annotations

import logging
import math
import sys
import threading
import time
import traceback
from typing import Callable, Optional, Tuple, Type

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


class NonFiniteLossError(RuntimeError):
    """The non-finite budget was exhausted; carries the diagnosis."""


class NonFiniteGuard:
    """Skip-then-abort policy for overflow and NaN training signals.

    ``observe`` returns True while the streak of consecutive non-finite
    observations is within ``budget``; the observation after that raises
    :class:`NonFiniteLossError` with a diagnosis (the trainer saves a
    checkpoint first, so the run can be resumed from a finite state).
    """

    def __init__(self, budget: int):
        if budget < 0:
            raise ValueError(f"budget must be >= 0, got {budget}")
        self.budget = budget
        self.streak = 0

    def observe(self, step: int, loss: Optional[float], overflow: Optional[bool],
                loss_scale: Optional[float]) -> bool:
        nonfinite = bool(overflow) or (loss is not None and not math.isfinite(loss))
        if not nonfinite:
            self.streak = 0
            return True
        self.streak += 1
        _log.warning(f"non-finite training signal at step {step}: loss={loss} "
                     f"overflow={overflow} loss_scale={loss_scale} "
                     f"({self.streak}/{self.budget} consecutive tolerated)")
        if self.streak <= self.budget:
            return True
        raise NonFiniteLossError(
            f"aborting after {self.streak} consecutive non-finite steps (budget "
            f"{self.budget}): last step {step}, loss={loss}, overflow={overflow}, "
            f"loss_scale={loss_scale}. Likely causes: diverged optimization (check "
            "LR/warmup), a poisoned data shard (check consumed_samples against the data "
            "manifest), or bad hardware. Resume from the checkpoint just saved, or an "
            "earlier one if the saved state is already non-finite.")


def dump_thread_stacks() -> str:
    """Every thread's current Python stack, formatted (stall forensics)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        out.append("".join(traceback.format_stack(frame)))
    return "\n".join(out)


class StepStallWatchdog:
    """A daemon thread that fires when the train loop stops beating.

    The loop calls ``beat(step)`` at the top of every iteration; when no
    beat arrives for ``timeout_s`` the watchdog logs every thread's stack
    and calls ``on_stall(step, elapsed)``, once per stall. It cannot save
    mid-step itself (the step mutates the state in place), so the
    trainer's callback requests a save at the next loop boundary.

    ``_last_beat`` and ``_step`` are written by the loop and only read
    here: a stale read moves one poll's verdict by one interval, so they
    take no lock.
    """

    # Deliberately lock-free cross-thread scalars: the main loop writes
    # ``_last_beat`` (a monotonic float) and ``_step`` (an int) in
    # ``beat()``; the watchdog thread only READS them, and a torn or stale
    # read merely shifts one poll's staleness verdict by one interval —
    # GIL-atomic scalar handoff; a lock would make the per-step beat
    # contend with the poll loop for nothing.
    # sta: lock(_last_beat, _step)

    def __init__(self, timeout_s: float, on_stall: Optional[Callable[[int, float], None]] = None,
                 poll_interval_s: Optional[float] = None):
        if not timeout_s > 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = timeout_s
        self.on_stall = on_stall
        self._poll = poll_interval_s or min(timeout_s / 4, 1.0)
        self._last_beat = time.monotonic()
        self._step = 0
        self._fired_for_beat: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stall_count = 0

    def start(self) -> None:
        self._last_beat = time.monotonic()
        self._thread = threading.Thread(target=self._run, name="step-watchdog", daemon=True)
        self._thread.start()

    def beat(self, step: int) -> None:
        self._step = step
        self._last_beat = time.monotonic()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            last = self._last_beat
            elapsed = time.monotonic() - last
            if elapsed < self.timeout_s or self._fired_for_beat == last:
                continue
            self._fired_for_beat = last  # once per stall, not per poll
            self.stall_count += 1
            _log.error(f"step stall: no progress for {elapsed:.1f}s (timeout "
                       f"{self.timeout_s}s) after step {self._step}; thread stacks "
                       f"follow\n{dump_thread_stacks()}")
            if self.on_stall is not None:
                try:
                    self.on_stall(self._step, elapsed)
                except Exception as e:  # the watchdog outlives a failing callback
                    _log.error(f"watchdog on_stall callback failed: {e!r}")
