"""The port's kernels, each beside its plain PyTorch version.

- ``paged_attention`` (K1): CUDA C++, ``csrc/paged_attention.cu``;
- ``rms_norm`` (K2): Triton, ``_rms_norm_triton.py``.

``launches`` counts kernel launches and plain-version runs by name.
"""

from . import launches
from .paged_attention import paged_attention, paged_attention_plain
from .rms_norm import rms_norm, rms_norm_plain

__all__ = [
    "launches",
    "paged_attention",
    "paged_attention_plain",
    "rms_norm",
    "rms_norm_plain",
]
