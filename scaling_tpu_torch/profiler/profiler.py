"""Profiling: synchronized timers, a step-windowed collector and a
``torch.profiler`` trace (counterpart of scaling_tpu/profiler/profiler.py).

- ``SynchronizedTimer.stop(wait_for)`` synchronises the CUDA device of
  ``wait_for`` before it reads the clock, so the span covers the device
  work queued by then;
- ``Profiler`` collects per-step phase timings (data load / step) inside
  the configured step window and writes them as one JSON list, in the JAX
  package's schema (``[{"step", "data_load", "step_time"}, ...]``);
- with ``capture_xla_trace`` (the JAX key, kept for config parity) the
  window also runs a ``torch.profiler.profile`` over CPU and CUDA
  activity and exports a Chrome/Perfetto trace JSON into
  ``<profiler_output parent>/xla_trace/``, the directory the JAX
  Profiler writes its trace to. The file holds a PyTorch trace: kernel
  names, launches and device times.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..logging.logger import logger
from ..obs.spans import synchronize_devices_of


@dataclasses.dataclass(frozen=True)
class ProfilerConfig:
    """The ``profiler`` section, under the JAX key names and defaults."""

    profile_steps: int = 0  # number of steps to profile; 0 disables
    profile_start_at_step: int = 10  # first profiled step (skips warm-up and builds)
    profiler_output: Optional[str] = None  # the observations JSON; the trace goes beside it
    capture_xla_trace: bool = False  # also trace the window with torch.profiler

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ProfilerConfig":
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown profiler keys: {sorted(unknown)}")
        return cls(**d)


class SynchronizedTimer:
    """Wall clock around device work; ``stop(wait_for)`` first waits for
    the device that holds ``wait_for``."""

    def __init__(self, name: str = ""):
        self.name = name
        self._start: Optional[float] = None
        self.durations: List[float] = []

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self, wait_for: Any = None) -> float:
        if wait_for is not None:
            synchronize_devices_of(wait_for)
        assert self._start is not None, "timer not started"
        d = time.perf_counter() - self._start
        self.durations.append(d)
        self._start = None
        return d

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


class Profiler:
    """Collects per-step phase timings inside the configured window."""

    def __init__(self, config: Optional[ProfilerConfig] = None):
        self.config = config or ProfilerConfig()
        self.observations: List[Dict[str, Any]] = []
        self._trace: Any = None  # the running torch.profiler.profile
        self.trace_path: Optional[Path] = None  # the last exported trace

    def enabled_at(self, step: int) -> bool:
        c = self.config
        return (c.profile_steps > 0
                and c.profile_start_at_step <= step < c.profile_start_at_step + c.profile_steps)

    def begin_step(self, step: int) -> None:
        c = self.config
        if (c.capture_xla_trace and c.profiler_output is not None
                and step == c.profile_start_at_step and self._trace is None):
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._trace = torch.profiler.profile(activities=activities)
            self._trace.__enter__()

    def record(self, step: int, durations: Dict[str, float]) -> None:
        if not self.enabled_at(step):
            return
        self.observations.append({"step": step, **durations})

    def end_step(self, step: int) -> None:
        c = self.config
        if step == c.profile_start_at_step + c.profile_steps - 1:
            self._stop_trace()
            self.flush()

    def _stop_trace(self) -> None:
        """End the window's trace and export it as Chrome trace JSON."""
        if self._trace is None:
            return
        trace, self._trace = self._trace, None
        trace.__exit__(None, None, None)
        trace_dir = Path(self.config.profiler_output).parent / "xla_trace"
        trace_dir.mkdir(parents=True, exist_ok=True)
        self.trace_path = trace_dir / f"trace_{time.strftime('%Y%m%d_%H%M%S')}.json"
        trace.export_chrome_trace(str(self.trace_path))
        logger.info(f"profiler: wrote a torch.profiler trace to {self.trace_path}")

    def close(self) -> None:
        """Abort-safe drain: stop a running trace and flush what the window
        collected so far. The trainer calls it from its ``finally``, so a
        run that dies mid-window keeps its partial observations.
        Idempotent: flush rewrites the same JSON on a clean exit."""
        if self._trace is not None:
            try:
                self._stop_trace()
            except RuntimeError as e:
                logger.warning(f"could not stop the running torch.profiler trace: {e!r}")
                self._trace = None
        self.flush()

    def flush(self) -> None:
        if self.config.profiler_output is None or not self.observations:
            return
        out = Path(self.config.profiler_output)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(self.observations, indent=2))
        logger.info(f"profiler: wrote {len(self.observations)} observations to {out}")
