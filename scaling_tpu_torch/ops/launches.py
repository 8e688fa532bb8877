"""Launch counters for the port's kernels and their plain versions.

Each kernel wrapper adds one to ``KERNEL[name]`` where it launches its
kernel, and each plain version adds one to ``PLAIN[name]`` where it runs.
A run that resets both, drives the serving path on the card and then
reads them shows which kernels that path went through, and that it never
reached a plain version (``chip_smoke.py`` does exactly that).
"""

from __future__ import annotations

from collections import Counter

# kernel names: "paged_attention" (native pool), "paged_attention_int8"
# (int8 pool, dequantised in the kernel), "rms_norm"
KERNEL: Counter = Counter()
PLAIN: Counter = Counter()


def reset() -> None:
    KERNEL.clear()
    PLAIN.clear()
