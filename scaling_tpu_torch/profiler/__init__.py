"""Step-window profiling (counterpart of scaling_tpu/profiler/)."""

from .profiler import Profiler, ProfilerConfig, SynchronizedTimer

__all__ = ["Profiler", "ProfilerConfig", "SynchronizedTimer"]
