"""Launch counters for the port's kernels and their plain versions.

Each kernel wrapper adds one to ``KERNEL[name]`` where it launches its
kernel, and each plain version adds one to ``PLAIN[name]`` where it runs.
A run that resets both, drives the serving or the training path on the
card and then reads them shows which kernels that path went through, and
that it never reached a plain version (``chip_smoke.py`` does exactly
that).

The counters are exact under threads (the threaded serving fleet ticks
one engine a thread): every update goes through :func:`add` under one
lock, and :func:`snapshot` copies a counter under it. ``tally()`` also
collects the launches made by the current thread alone, which is how the
threaded fleet tells one replica's launches from another's.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Dict, Iterator

# kernel names: "paged_attention" (native pool), "paged_attention_int8"
# (int8 pool, dequantised in the kernel), "rms_norm", "rms_norm_bwd",
# "flash_attention_fwd", "flash_attention_bwd" (one count per backward
# call, which launches its three kernels)
KERNEL: Counter = Counter()
PLAIN: Counter = Counter()
# K1's launches by query width: (name, s) -> launches, beside KERNEL's count
# (s = 1 is the separate decode program, s = the chunk the chunk program)
WIDTHS: Counter = Counter()
# K3's launches by variant, beside KERNEL["rms_norm_bwd"]: ("rms_norm_bwd",
# "dx_dw") or ("rms_norm_bwd", "dx_only") (a frozen gain)
VARIANTS: Counter = Counter()

_LOCK = threading.Lock()
_local = threading.local()


def add(counter: Counter, key) -> None:
    """One launch counted in ``counter`` (one of the four above), and in
    every ``tally()`` open on this thread when it is KERNEL or PLAIN."""
    with _LOCK:
        counter[key] += 1
        for t in getattr(_local, "tallies", ()):
            if counter is KERNEL:
                t["kernel"][key] += 1
            elif counter is PLAIN:
                t["plain"][key] += 1


def snapshot(counter: Counter) -> Dict:
    """A copy of ``counter``, taken while no thread updates it."""
    with _LOCK:
        return dict(counter)


@contextlib.contextmanager
def tally() -> Iterator[Dict[str, Counter]]:
    """``{"kernel": Counter, "plain": Counter}`` of the launches this
    thread makes inside the block (other threads' launches stay out)."""
    t = {"kernel": Counter(), "plain": Counter()}
    stack = getattr(_local, "tallies", None)
    if stack is None:
        stack = _local.tallies = []
    stack.append(t)
    try:
        yield t
    finally:
        stack.remove(t)


def reset() -> None:
    with _LOCK:
        KERNEL.clear()
        PLAIN.clear()
        WIDTHS.clear()
        VARIANTS.clear()
