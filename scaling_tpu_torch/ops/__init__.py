"""The port's kernels, each beside its plain PyTorch version.

- ``paged_attention`` (K1): CUDA C++, ``csrc/paged_attention.cu``;
- ``rms_norm`` (K2): Triton, ``_rms_norm_triton.py``;
- ``rms_norm_bwd`` (K3): CUDA C++, ``csrc/rms_norm_bwd.cu``, with a dx-only
  variant for a gain that needs no gradient;
- ``flash_attention_fwd`` (K4) and ``flash_attention_bwd`` (K5): CUDA C++,
  ``csrc/flash_attention.cu``.

``launches`` counts kernel launches and plain-version runs by name.
``cross_entropy`` is plain PyTorch (the JAX version is XLA, not a kernel).
"""

from . import launches
from .flash_attention import (
    FlashAttention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_plain,
)
from .paged_attention import paged_attention, paged_attention_plain
from .rms_norm import RMSNormFunction, rms_norm, rms_norm_bwd, rms_norm_bwd_plain, rms_norm_plain

__all__ = [
    "FlashAttention",
    "RMSNormFunction",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "flash_attention_fwd",
    "flash_attention_plain",
    "launches",
    "paged_attention",
    "paged_attention_plain",
    "rms_norm",
    "rms_norm_bwd",
    "rms_norm_bwd_plain",
    "rms_norm_plain",
]
