"""Hardware gauges: device memory, live allocations, step-time EMA, MFU
(the port's copy of scaling_tpu/obs/hardware.py).

Everything here is host-side bookkeeping: ``torch.cuda.memory_stats`` and
the device's ``total_memory`` are queries of the caching allocator and of
the device properties CUDA caches, and neither waits for device work, so
the per-step gauge update adds no device sync (checked with
``torch.cuda.set_sync_debug_mode("error")`` on the card and with the
sync primitives trapped on the CPU).

MFU follows the PaLM appendix-B accounting the transformer entry point
already logs (models/transformer/utils/get_tflops.py): the model declares
its FLOPs per token once, the trainer divides the achieved token rate's
FLOPs by the card's peak. torch is imported inside the functions, so
``obs report`` never initialises CUDA.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

from .registry import MetricsRegistry, get_registry


def _cuda_devices() -> List[int]:
    """The CUDA devices this process has initialised; none on a CPU run."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    return list(range(torch.cuda.device_count()))


def _memory_stats() -> Dict[int, Dict]:
    """One ``torch.cuda.memory_stats`` dict a device; empty on a CPU run."""
    import torch

    return {d: torch.cuda.memory_stats(d) for d in _cuda_devices()}


@functools.lru_cache(maxsize=None)
def _total_memory(device: int) -> int:
    import torch

    return int(torch.cuda.get_device_properties(device).total_memory)


def device_memory_snapshot(stats: Optional[Dict[int, Dict]] = None) -> List[Dict]:
    """Per-device allocator stats: ``bytes_in_use`` and
    ``peak_bytes_in_use`` from ``allocated_bytes.all.current`` / ``.peak``,
    ``bytes_limit`` the device's total memory. ``stats`` is
    :func:`_memory_stats`'s, taken here when not given. A CPU run gets one
    record of zeros, as the JAX function gives on the CPU."""
    out: List[Dict] = []
    for d, s in (_memory_stats() if stats is None else stats).items():
        out.append({
            "device": d,
            "platform": "gpu",
            "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": _total_memory(d),
        })
    if not out:
        out.append({"device": 0, "platform": "cpu", "bytes_in_use": 0,
                    "peak_bytes_in_use": 0, "bytes_limit": 0})
    return out


def live_allocations(stats: Optional[Dict[int, Dict]] = None) -> int:
    """Live allocations of the caching allocator summed over the devices
    (``active.all.current``): the closest counterpart of the JAX gauge's
    ``len(jax.live_arrays())``, since views of one allocation count once.
    0 on a CPU run."""
    return sum(int(s.get("active.all.current", 0))
               for s in (_memory_stats() if stats is None else stats).values())


def update_hardware_gauges(registry: Optional[MetricsRegistry] = None) -> Dict:
    """Refresh the device-memory and live-allocation gauges from one
    allocator query a device; returns an aggregate summary (max across
    devices) for the step's metrics."""
    reg = registry if registry is not None else get_registry()
    stats = _memory_stats()
    max_in_use = 0
    max_peak = 0
    for rec in device_memory_snapshot(stats):
        labels = {"device": str(rec["device"])}
        reg.gauge("device_bytes_in_use", labels).set(rec["bytes_in_use"])
        reg.gauge("device_peak_bytes_in_use", labels).set(rec["peak_bytes_in_use"])
        max_in_use = max(max_in_use, rec["bytes_in_use"])
        max_peak = max(max_peak, rec["peak_bytes_in_use"])
    live = live_allocations(stats)
    reg.gauge("live_arrays").set(live)
    return {
        "device_bytes_in_use": max_in_use,
        "device_peak_bytes_in_use": max_peak,
        "live_arrays": live,
    }


class StepTimeEMA:
    """Exponential moving average of fetched step durations: the smooth
    signal regression gates and dashboards want, next to the raw value."""

    def __init__(self, alpha: float = 0.1):
        assert 0 < alpha <= 1
        self.alpha = alpha
        self.value: Optional[float] = None

    def update(self, duration_s: float) -> float:
        if self.value is None:
            self.value = float(duration_s)
        else:
            self.value = (
                self.alpha * float(duration_s) + (1 - self.alpha) * self.value
            )
        return self.value


def achieved_tflops(flops_per_token: float, tokens_per_step: float,
                    step_time_s: float) -> float:
    """Model-FLOPs throughput actually sustained, over all devices."""
    return flops_per_token * tokens_per_step / step_time_s / 1e12


def mfu(achieved_tflops_total: float, world_size: int,
        peak_tflops_per_device: float) -> float:
    """Model FLOPs Utilization: achieved over the devices' peak."""
    return achieved_tflops_total / (world_size * peak_tflops_per_device)
