"""Process-wide metrics registry: counters, gauges, histograms with labels
(the port's copy of scaling_tpu/obs/registry.py).

Every subsystem records into one registry, and the trainer flushes a
snapshot per fetched step to the metrics JSONL sink (the file
``logger.log_metrics`` appends its step records to) as a
``{"kind": "registry"}`` record, plus, when configured, a Prometheus
textfile for node-exporter-style scraping. Snapshots and textfile
renders equal the JAX registry's for the same calls.

Stdlib only: ``obs report`` and the supervisor import it.
"""

from __future__ import annotations

import bisect
import json
import math
import os
import threading
import time
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

# logging sits below obs: obs imports it, never the reverse
from ..logging.logger import append_jsonl_line

LabelKey = Tuple[Tuple[str, str], ...]

# cardinality guard: one call site interpolating an unbounded value
# into a label (a request id, a trace id, a raw path) would grow the
# registry — and every snapshot / textfile render, forever — without
# bound. Past this many distinct label sets per metric NAME, new series
# fold into one ``__overflow__`` series so aggregate totals stay right
# while the per-label split is capped.
MAX_SERIES_PER_METRIC = 64
OVERFLOW_LABELS: LabelKey = (("__overflow__", "true"),)

# latency-shaped default buckets (seconds): spans range from sub-ms file
# ops to multi-minute checkpoint writes / barrier waits
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0,
    60.0, 120.0, 300.0, 600.0,
)


def _label_key(labels: Optional[Mapping[str, object]]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_name(name: str, labels: LabelKey) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


def _prom_name(name: str, labels: LabelKey) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing count (steps taken, retries, relaunches)."""

    kind = "counter"

    def __init__(self, name: str, labels: LabelKey, lock: threading.Lock):
        self.name = name
        self.labels = labels
        self._lock = lock
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        # coerce like Gauge.set does: a numpy scalar slipped in here
        # would otherwise survive to json.dumps in flush_step and abort
        # the training step with a TypeError
        amount = float(amount)
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({amount})")
        with self._lock:
            self.value += amount


class Gauge:
    """Point-in-time value (bytes in use, MFU, heartbeat send lag)."""

    kind = "gauge"

    def __init__(self, name: str, labels: LabelKey, lock: threading.Lock):
        self.name = name
        self.labels = labels
        self._lock = lock
        self.value: Optional[float] = None

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)


class Histogram:
    """Bucketed distribution (span durations, barrier waits)."""

    kind = "histogram"

    def __init__(self, name: str, labels: LabelKey, lock: threading.Lock,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.labels = labels
        self._lock = lock
        self.buckets = tuple(sorted(buckets))
        # counts[i] = observations <= buckets[i]; counts[-1] = overflow
        self._counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        idx = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[idx] += 1
            self.sum += v
            self.count += 1

    def bucket_counts(self) -> Dict[str, int]:
        """Cumulative counts keyed by upper bound (Prometheus ``le``)."""
        out: Dict[str, int] = {}
        running = 0
        for bound, n in zip(self.buckets, self._counts):
            running += n
            out[f"{bound:g}"] = running
        out["+Inf"] = running + self._counts[-1]
        return out


class MetricsRegistry:
    """Registry of named metrics; get-or-create per (name, labels).

    ``flush_step`` appends one JSONL snapshot record and (optionally)
    rewrites the Prometheus textfile atomically. Thread-safe: the span
    recorder observes from watchdog/async-writer threads while the train
    loop flushes.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, LabelKey], object] = {}
        self._metrics_path: Optional[str] = None
        self._textfile_path: Optional[str] = None
        # cardinality guard state: distinct series per metric name, and
        # which names already warned (once per name, not per call)
        self._series_per_name: Dict[str, int] = {}
        self._overflow_warned: set = set()

    def configure(self, *, metrics_path: Optional[str] = None,
                  textfile_path: Optional[str] = None) -> None:
        """Pin explicit sink paths (otherwise ``flush_step`` falls back to
        the logger's resolved metrics path)."""
        if metrics_path is not None:
            self._metrics_path = metrics_path
        if textfile_path is not None:
            self._textfile_path = textfile_path

    def _get(self, cls, name: str, labels, **kwargs):
        key = (name, _label_key(labels))
        warn_overflow = False
        try:
            with self._lock:
                existing = self._metrics.get(key)
                if existing is None and key[1] \
                        and key[1] != OVERFLOW_LABELS \
                        and self._series_per_name.get(name, 0) \
                        >= MAX_SERIES_PER_METRIC:
                    # cap hit: this NEW label set folds into the shared
                    # overflow series instead of minting another one
                    if name not in self._overflow_warned:
                        self._overflow_warned.add(name)
                        warn_overflow = True
                    key = (name, OVERFLOW_LABELS)
                    existing = self._metrics.get(key)
                if existing is not None:
                    if not isinstance(existing, cls):
                        raise TypeError(
                            f"metric {name!r} already registered as "
                            f"{existing.kind}, requested {cls.kind}"
                        )
                    return existing
                metric = cls(name, key[1], self._lock, **kwargs)
                self._metrics[key] = metric
                self._series_per_name[name] = \
                    self._series_per_name.get(name, 0) + 1
                return metric
        finally:
            if warn_overflow:
                # outside the lock: the logger does I/O, and telemetry
                # must never stall a concurrent observe()
                from ..logging.logger import logger

                logger.warning(
                    f"metric {name!r} exceeded {MAX_SERIES_PER_METRIC} "
                    "distinct label sets — folding further series into "
                    "__overflow__ (an unbounded value is leaking into a "
                    "label; fix the call site)"
                )

    def counter(self, name: str, labels: Optional[Mapping] = None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels: Optional[Mapping] = None) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, labels: Optional[Mapping] = None,
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        kwargs = {"buckets": buckets} if buckets else {}
        return self._get(Histogram, name, labels, **kwargs)

    # ------------------------------------------------------------ export
    def snapshot(self) -> Dict[str, Dict]:
        """JSON-ready view: ``{"counters": {...}, "gauges": {...},
        "histograms": {name: {"sum":, "count":, "buckets": {...}}}}``."""
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        histograms: Dict[str, Dict] = {}
        # hold the lock across the reads, not just the item copy: a
        # histogram observed from the async-writer thread mid-snapshot
        # must not render sum/count/buckets that disagree
        with self._lock:
            items = sorted(self._metrics.items(), key=lambda kv: kv[0])
            for (name, labels), m in items:
                rendered = _render_name(name, labels)
                if isinstance(m, Counter):
                    counters[rendered] = m.value
                elif isinstance(m, Gauge):
                    if m.value is not None:
                        gauges[rendered] = m.value
                elif isinstance(m, Histogram):
                    histograms[rendered] = {
                        "sum": m.sum, "count": m.count,
                        "buckets": m.bucket_counts(),
                    }
        return {"counters": counters, "gauges": gauges,
                "histograms": histograms}

    def render_textfile(self) -> str:
        """Prometheus exposition text (textfile-collector compatible)."""
        lines: List[str] = []
        typed: set = set()
        # same locking rule as snapshot(): reads stay consistent with
        # concurrent observers
        with self._lock:
            items = sorted(self._metrics.items(), key=lambda kv: kv[0])
            for (name, labels), m in items:
                if name not in typed:
                    lines.append(f"# TYPE {name} {m.kind}")
                    typed.add(name)
                if isinstance(m, Histogram):
                    for le, n in m.bucket_counts().items():
                        blabels = labels + (("le", le),)
                        lines.append(f"{_prom_name(name + '_bucket', blabels)} {n}")
                    lines.append(f"{_prom_name(name + '_sum', labels)} {m.sum:g}")
                    lines.append(f"{_prom_name(name + '_count', labels)} {m.count}")
                else:
                    v = m.value
                    if v is None:
                        continue
                    rendered = "NaN" if isinstance(v, float) and math.isnan(v) else f"{v:g}"
                    lines.append(f"{_prom_name(name, labels)} {rendered}")
        return "\n".join(lines) + "\n"

    def write_textfile(self, path: Path | str) -> None:
        """Atomic replace: scrapers must never read a torn render."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".{path.name}.tmp{os.getpid()}")
        # stays raw: obs cannot import resilience's retry_io without
        # inverting the layering, and telemetry is best-effort: a retry
        # loop in the render would stall the step it measures (flush
        # callers catch and warn instead)
        tmp.write_text(self.render_textfile())  # sta: disable=STA011
        os.replace(tmp, path)  # sta: disable=STA011

    # ------------------------------------------------------------- flush
    def flush_step(self, step: int) -> None:
        """Append one snapshot record to the metrics JSONL sink.

        The path resolves to the explicitly configured one, else the
        logger's metrics path (``SCALING_TPU_METRICS_PATH`` env /
        ``LoggerConfig``); with neither configured this is a no-op, so
        always-on instrumentation costs nothing on unconfigured runs.
        The directory of an explicit path is made here; that of the
        logger's is the logger's to make, and a flush never recreates one
        removed under a config left behind (it writes nothing then)."""
        path = self._metrics_path
        if path is None:
            from ..logging.logger import logger

            path = logger.metrics_path()
            if path is None or not Path(path).parent.is_dir():
                return
        else:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
        rec = {
            "kind": "registry", "step": step, "ts": time.time(),
            "host": host_id(), **self.snapshot(),
        }
        append_jsonl_line(path, json.dumps(_json_safe(rec), sort_keys=True))
        textfile = self._textfile_path or os.environ.get(
            "SCALING_TPU_METRICS_TEXTFILE"
        )
        if textfile:
            self.write_textfile(textfile)

    def reset(self) -> None:
        """Drop every metric (tests; a fresh process never needs this)."""
        with self._lock:
            self._metrics.clear()
            self._series_per_name.clear()
            self._overflow_warned.clear()


def _json_safe(obj):
    """Map non-finite floats to None so the record is valid JSON for
    every parser (bare ``NaN`` tokens are a Python-only dialect; a NaN
    gauge during the incident the telemetry exists to diagnose must not
    corrupt the file). The textfile render keeps its own NaN handling."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


def host_id() -> int:
    """This process's host id: the supervisor's env var when present,
    else the logger's rank — the SAME fallback ``log_metrics`` stamps on
    step records, so the two record kinds in one metrics file can never
    disagree about who wrote them."""
    from ..logging.logger import _host_id

    return _host_id(0)  # the port runs one rank


_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry every subsystem records into."""
    return _default
