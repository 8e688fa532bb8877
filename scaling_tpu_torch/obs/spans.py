"""Phase tracing: ``with obs.span("ckpt.commit", step=N): ...`` (the
port's copy of scaling_tpu/obs/spans.py).

Every span lands twice:

- as an observation in the default registry's ``span_seconds`` histogram
  (labelled by span name), flushed with the per-step registry snapshot;
- as a structured ``span`` event through ``logger.log_event``, so the
  supervision events and the telemetry share one stream, which
  ``python -m scaling_tpu_torch.obs report`` reads.

Spans nest (a stack per thread; the parent's name is recorded on the
child, and a span opened on another thread, such as the asynchronous
checkpoint writer's, has no parent from the main thread) and are
exception-safe: a body that raises still emits the span, marked
``ok=false`` with the exception type, and the exception propagates.

Distributed tracing rides the same stream: a per-thread trace context,
adopted with :func:`trace_context` or inherited from the enclosing span,
stamps ``trace`` / ``span_id`` / ``parent_span_id`` onto span events, and
a provider registered with ``logger.set_trace_provider`` stamps ``trace``
onto every other ``log_event`` record emitted under an active context.
Without a context no ids are allocated and no trace fields appear.

A span measures host wall time. The card runs asynchronously, so a span
around kernel launches closes when they are queued, not when they have
run (``step.fwdbwd`` is such a dispatch span); ``sp.wait_for(t)``
synchronises ``t``'s CUDA device inside the measured window when the
caller wants the device time. The default never synchronises: the step
path gains no device sync outside profiler windows.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Any, Iterator, Optional

from ..logging.logger import logger, set_trace_provider
from .registry import get_registry

_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = []
        _local.stack = stack
    return stack


# ------------------------------------------------------------- trace ids
def new_trace_id() -> str:
    """A fresh 16-hex trace id (one per originating request)."""
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    """A fresh 8-hex span id (allocated only for traced spans)."""
    return uuid.uuid4().hex[:8]


def derive_trace_id(*parts: Any) -> str:
    """Deterministic trace id from identity parts. Cross-host work that
    shares an identity but never an RPC envelope — a capacity lease
    ``(host, epoch)``, a checkpoint ``commit:step-N`` — derives the SAME
    trace id independently on every host, so the analyzer reassembles
    one fleet-wide trace without any context having crossed the wire."""
    raw = "\x1f".join(str(p) for p in parts)
    return hashlib.sha1(raw.encode("utf-8")).hexdigest()[:16]


@contextmanager
def trace_context(trace_id: Optional[str],
                  parent_span_id: Optional[str] = None) -> Iterator[None]:
    """Adopt an inbound trace context for this thread.

    Spans opened in the body (and ``log_event`` records emitted in it)
    carry ``trace_id``; the previous context is restored on exit, so
    nested adoption — a worker dispatching one request per envelope —
    composes. ``trace_id=None`` adopts the empty context (explicitly
    masking any ambient trace, which the warmup path relies on)."""
    prev = getattr(_local, "trace", None)
    _local.trace = (trace_id, parent_span_id) if trace_id else None
    try:
        yield
    finally:
        _local.trace = prev


def current_trace() -> Optional[dict]:
    """The active trace context as a JSON-safe dict — the exact value an
    RPC envelope's ``trace`` key carries (``{"trace_id": ...,
    "parent_span_id": ...}``), or ``None`` outside any context. The
    innermost traced span wins over an adopted context so the receiver
    links to the sender's actual span."""
    stack = _stack()
    if stack and stack[-1].trace_id:
        return {"trace_id": stack[-1].trace_id,
                "parent_span_id": stack[-1].span_id}
    ctx = getattr(_local, "trace", None)
    if ctx is not None and ctx[0]:
        return {"trace_id": ctx[0], "parent_span_id": ctx[1]}
    return None


def current_trace_id() -> Optional[str]:
    """Just the active ``trace_id`` (what journal records store)."""
    t = current_trace()
    return t["trace_id"] if t else None


def _trace_event_fields() -> Optional[dict]:
    """Provider for :func:`logger.set_trace_provider`: the ``trace``
    field to stamp onto non-span ``log_event`` records. Explicit fields
    win over the provider in ``log_event``, and the provider returns
    ``None`` outside any context so trace-less records stay
    byte-identical to the pre-tracing stream."""
    tid = current_trace_id()
    return {"trace": tid} if tid else None


set_trace_provider(_trace_event_fields)


class Span:
    """Handle yielded by :func:`span`; mutate it to enrich the record."""

    __slots__ = ("name", "fields", "_wait_for", "duration_s", "trace_id",
                 "span_id", "parent_span_id")

    def __init__(self, name: str, fields: dict):
        self.name = name
        self.fields = fields
        self._wait_for: Any = None
        self.duration_s: Optional[float] = None
        self.trace_id: Optional[str] = None
        self.span_id: Optional[str] = None
        self.parent_span_id: Optional[str] = None

    def wait_for(self, x: Any) -> Any:
        """Synchronise the CUDA device of ``x`` (a tensor, or a list, tuple
        or dict of them) before the span closes, so the measured time
        covers its device work; CPU tensors need nothing. Returns ``x``."""
        self._wait_for = x
        return x

    def annotate(self, **fields: Any) -> None:
        """Attach extra fields to the emitted span event."""
        self.fields.update(fields)


def current_span() -> Optional[Span]:
    stack = _stack()
    return stack[-1] if stack else None


@contextmanager
def span(name: str, *, step: Optional[int] = None, level: str = "debug",
         registry=None, **fields: Any) -> Iterator[Span]:
    """Trace one phase. ``level`` controls only the console mirror of the
    event (per-step phases default to ``debug`` so steady-state training
    does not quadruple its console output); the events file — when
    configured — receives every span regardless."""
    sp = Span(name, dict(fields))
    stack = _stack()
    parent = stack[-1].name if stack else None
    # resolve the trace lineage at entry, per thread: the enclosing span
    # wins (its span_id becomes the parent link), else the adopted
    # context; with neither the span stays trace-less and allocates no
    # ids at all — the pre-tracing fast path, byte-identical records
    if stack and stack[-1].trace_id:
        sp.trace_id = stack[-1].trace_id
        sp.parent_span_id = stack[-1].span_id
    else:
        ctx = getattr(_local, "trace", None)
        if ctx is not None and ctx[0]:
            sp.trace_id, sp.parent_span_id = ctx
    if sp.trace_id:
        sp.span_id = new_span_id()
    stack.append(sp)
    ok = True
    error: Optional[str] = None
    start = time.perf_counter()
    try:
        yield sp
        if sp._wait_for is not None:
            # inside the measured window: the caller asked for
            # SynchronizedTimer semantics on this span, never the default
            synchronize_devices_of(sp._wait_for)
    except BaseException as e:
        ok = False
        error = type(e).__name__
        raise
    finally:
        duration = time.perf_counter() - start
        sp.duration_s = duration
        stack.pop()
        _emit(sp, parent, duration, ok, error, step, level, registry)


def _emit(sp: Span, parent: Optional[str], duration: float, ok: bool,
          error: Optional[str], step: Optional[int], level: str,
          registry) -> None:
    reg = registry if registry is not None else get_registry()
    reg.histogram("span_seconds", labels={"span": sp.name}).observe(duration)
    event_fields = dict(sp.fields)
    event_fields.update(span=sp.name, dur_s=round(duration, 6), ok=ok)
    if parent is not None:
        event_fields["parent"] = parent
    if step is not None:
        event_fields["step"] = step
    if error is not None:
        event_fields["error"] = error
    # trace lineage (explicit annotate() fields win, like host below):
    # only traced spans carry the columns, so trace-less runs emit the
    # exact records they always did
    if sp.trace_id is not None:
        event_fields.setdefault("trace", sp.trace_id)
        event_fields.setdefault("span_id", sp.span_id)
        if sp.parent_span_id is not None:
            event_fields.setdefault("parent_span_id", sp.parent_span_id)
    # host + relaunch epoch ride every span so the analyzer can attribute
    # per host AND per supervisor epoch — the same step gets re-saved and
    # the same barrier re-waited after a relaunch, and merging those
    # incidents would corrupt the arrived-last verdict
    for env_var, field in (("SCALING_TPU_HOST_ID", "host"),
                           ("SCALING_TPU_COORD_EPOCH", "epoch")):
        raw = os.environ.get(env_var)
        if raw is not None and field not in event_fields:
            try:
                event_fields[field] = int(raw)
            except ValueError:
                logger.warning(f"non-integer {env_var} {raw!r} ignored")
    # spans skip the per-record fsync: 3-4 of them land per training
    # step, and the durability contract belongs to lifecycle events
    logger.log_event("span", _level=level, _fsync=False, **event_fields)


def synchronize_devices_of(x: Any) -> None:
    """Wait for the work queued on every CUDA device that holds a tensor
    of ``x`` (a tensor, or a list, tuple or dict of them); nothing for
    CPU tensors and other values."""
    import torch

    devices = set()
    stack = [x]
    while stack:
        item = stack.pop()
        if isinstance(item, torch.Tensor):
            if item.is_cuda:
                devices.add(item.device)
        elif isinstance(item, dict):
            stack.extend(item.values())
        elif isinstance(item, (list, tuple)):
            stack.extend(item)
    for device in devices:
        # opt-in via sp.wait_for(x), never the default: the caller asked
        # for the device's time inside the measured window
        torch.cuda.synchronize(device)  # sta: disable=STA010
