"""Layers of the port (counterparts of scaling_tpu/nn/ at model-parallel size 1)."""

from .activation_function import ActivationFunction, get_activation_function
from .attention import (
    PagedKVCacheView,
    ParallelSelfAttention,
    kv_quantize_int8,
    paged_flat_slots,
    paged_scatter_kv,
    repeat_kv,
)
from .linear import Embedding, Linear
from .mlp import ParallelSwiGLUMLP
from .norm import RMSNorm
from .rotary import RotaryEmbedding

__all__ = [
    "ActivationFunction",
    "Embedding",
    "Linear",
    "PagedKVCacheView",
    "ParallelSelfAttention",
    "ParallelSwiGLUMLP",
    "RMSNorm",
    "RotaryEmbedding",
    "get_activation_function",
    "kv_quantize_int8",
    "paged_flat_slots",
    "paged_scatter_kv",
    "repeat_kv",
]
