"""Layers of the port (counterparts of scaling_tpu/nn/ at model-parallel size 1)."""

from .activation_function import ActivationFunction, get_activation_function
from .attention import (
    PagedKVCacheView,
    ParallelSelfAttention,
    dense_kv_write,
    flash_path_active,
    kv_quantize_int8,
    multi_head_attention,
    paged_flat_slots,
    paged_scatter_kv,
    repeat_kv,
)
from .linear import Embedding, Linear
from .masked_softmax import MaskedSoftmax, MaskedSoftmaxConfig
from .mlp import ParallelMLP, ParallelSwiGLUMLP
from .norm import LayerNorm, RMSNorm, get_norm
from .rotary import RotaryEmbedding, RotaryEmbeddingComplex
from .seq_packing import segment_ids_to_mask

__all__ = [
    "ActivationFunction",
    "Embedding",
    "LayerNorm",
    "Linear",
    "MaskedSoftmax",
    "MaskedSoftmaxConfig",
    "PagedKVCacheView",
    "ParallelMLP",
    "ParallelSelfAttention",
    "ParallelSwiGLUMLP",
    "RMSNorm",
    "RotaryEmbedding",
    "RotaryEmbeddingComplex",
    "dense_kv_write",
    "flash_path_active",
    "get_activation_function",
    "get_norm",
    "kv_quantize_int8",
    "multi_head_attention",
    "paged_flat_slots",
    "paged_scatter_kv",
    "repeat_kv",
    "segment_ids_to_mask",
]
