"""Per-step telemetry the trainer drives on every fetched step (the
port's copy of scaling_tpu/obs/telemetry.py).

The trainer owns one :class:`StepTelemetry`; ``on_step`` refreshes the
hardware gauges, the step-time EMA and, once the model has declared its
FLOPs per token with :meth:`configure`, the achieved-TFLOPs and MFU
gauges, returning the derived values so that they ride the step's
metric record. ``flush`` then snapshots the whole registry (every span
histogram included) to the metrics JSONL sink.

Contract: ``on_step`` never touches device tensors. It is safe on the hot
path with ``log_interval=1`` and adds no device sync outside profiler
windows.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..logging.logger import logger
from .hardware import StepTimeEMA, achieved_tflops, mfu, update_hardware_gauges
from .registry import MetricsRegistry, get_registry


class StepTelemetry:
    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 ema_alpha: float = 0.1):
        self.registry = registry if registry is not None else get_registry()
        self.ema = StepTimeEMA(ema_alpha)
        self.enabled = True
        self.hardware_gauges = True
        self._last_step: Optional[int] = None
        self.flops_per_token: Optional[float] = None
        self.tokens_per_step: Optional[float] = None
        self.world_size: int = 1
        self.peak_tflops: Optional[float] = None

    def configure(self, *, flops_per_token: Optional[float] = None,
                  tokens_per_step: Optional[float] = None,
                  world_size: Optional[int] = None,
                  peak_tflops: Optional[float] = None) -> None:
        """Declare the model/hardware constants MFU accounting needs.

        The transformer entry point calls this once at startup, with the
        card's peak only when the trainer runs on the card; a trainer left
        unconfigured still emits step-time and memory gauges, just no
        MFU."""
        if flops_per_token is not None:
            self.flops_per_token = float(flops_per_token)
        if tokens_per_step is not None:
            self.tokens_per_step = float(tokens_per_step)
        if world_size is not None:
            self.world_size = int(world_size)
        if peak_tflops is not None:
            self.peak_tflops = float(peak_tflops)

    def on_step(self, step: int, step_duration: Optional[float]) -> Dict[str, float]:
        """Update gauges for one fetched step; returns the derived
        metrics to merge into the step's log record."""
        if not self.enabled:
            return {}
        reg = self.registry
        out: Dict[str, float] = {}
        # on_step only runs on FETCHED steps; with log_interval>1 the
        # steps in between were dispatched-but-unlogged, so count the
        # step-number delta, not the call — anyone rating steps/s off
        # the counter must not be off by the log_interval factor
        if self._last_step is not None and step > self._last_step:
            reg.counter("train_steps_total").inc(step - self._last_step)
        else:
            reg.counter("train_steps_total").inc()
        self._last_step = step
        if step_duration is not None and step_duration > 0:
            reg.gauge("step_time_seconds").set(step_duration)
            ema = self.ema.update(step_duration)
            reg.gauge("step_time_ema_seconds").set(ema)
            out["step_time_ema"] = ema
            if self.flops_per_token and self.tokens_per_step:
                ach = achieved_tflops(
                    self.flops_per_token, self.tokens_per_step, step_duration
                )
                reg.gauge("achieved_tflops").set(ach)
                out["achieved_tflops"] = ach
                if self.peak_tflops:
                    u = mfu(ach, self.world_size, self.peak_tflops)
                    reg.gauge("mfu").set(u)
                    out["mfu"] = u
        if self.hardware_gauges:
            update_hardware_gauges(reg)
        return out

    def flush(self, step: int) -> None:
        """Snapshot the registry to the metrics JSONL sink (no-op when no
        sink path is configured — the always-on default costs nothing)."""
        try:
            self.registry.flush_step(step)
        except Exception as e:
            # a full disk — or a serialization surprise from some
            # subsystem's odd metric value — must degrade telemetry,
            # never abort training
            logger.warning(f"metrics registry flush failed: {e!r}")
