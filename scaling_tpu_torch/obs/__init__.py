"""Unified telemetry (the port's counterpart of scaling_tpu/obs/).

- :mod:`.registry`: the process-wide metrics registry (counters, gauges,
  histograms with labels), per-step JSONL flush and Prometheus textfile.
- :mod:`.spans`: ``with obs.span("ckpt.commit", step=N)`` phase tracing,
  emitted through ``logger.log_event`` into the stream of the
  supervision events.
- :mod:`.hardware`: device-memory and live-allocation gauges from the
  CUDA caching allocator, the step-time EMA, achieved TFLOPs and MFU.
- :mod:`.telemetry`: the per-step telemetry the trainer owns.
- :mod:`.report` / ``python -m scaling_tpu_torch.obs``: the run-dir
  analyzer turning events and metrics JSONL into a health report.

torch is imported inside functions only: the analyzer initialises no
CUDA.
"""

from .hardware import (
    StepTimeEMA,
    achieved_tflops,
    device_memory_snapshot,
    mfu,
    update_hardware_gauges,
)
from .registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    host_id,
)
from .spans import (
    Span,
    current_span,
    current_trace,
    current_trace_id,
    derive_trace_id,
    new_trace_id,
    span,
    trace_context,
)
from .telemetry import StepTelemetry

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "StepTelemetry",
    "StepTimeEMA",
    "achieved_tflops",
    "current_span",
    "current_trace",
    "current_trace_id",
    "derive_trace_id",
    "device_memory_snapshot",
    "get_registry",
    "host_id",
    "mfu",
    "new_trace_id",
    "span",
    "trace_context",
    "update_hardware_gauges",
]
