"""Launch counters for the port's kernels and their plain versions.

Each kernel wrapper adds one to ``KERNEL[name]`` where it launches its
kernel, and each plain version adds one to ``PLAIN[name]`` where it runs.
A run that resets both, drives the serving or the training path on the
card and then reads them shows which kernels that path went through, and
that it never reached a plain version (``chip_smoke.py`` does exactly
that).
"""

from __future__ import annotations

from collections import Counter

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


def reset() -> None:
    KERNEL.clear()
    PLAIN.clear()
    WIDTHS.clear()
    VARIANTS.clear()
