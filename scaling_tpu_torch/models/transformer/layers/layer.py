"""The transformer block (``TransformerLayer.__call__`` of
scaling_tpu/models/transformer/layers/layer.py): pre-norm attention with a
residual, then pre-norm SwiGLU MLP with a residual. Serving attends over
the paged KV pool; training (no cache) over the sequence, within equal
``segment_ids``. No adapters, LoRA or MoE; no dropout (the training path
refuses a config that asks for it)."""

from __future__ import annotations

from typing import Optional

import torch

from ....nn.attention import PagedKVCacheView, ParallelSelfAttention
from ....nn.mlp import ParallelSwiGLUMLP
from ....nn.norm import RMSNorm
from ....nn.rotary import RotaryEmbedding
from ..config import TransformerArchitectureConfig


class TransformerLayer(torch.nn.Module):
    def __init__(self, arch: TransformerArchitectureConfig, layer_index: int = 0,
                 device=None):
        super().__init__()
        self.layer_index = layer_index
        norm = dict(eps=arch.layernorm_eps, fused=arch.fused_norm, dtype=arch.dtype,
                    device=device)
        self.input_layernorm = RMSNorm(arch.hidden_size, **norm)
        self.attention = ParallelSelfAttention(
            hidden_size=arch.hidden_size,
            num_attention_heads=arch.num_attention_heads,
            num_kv_heads=arch.attention_num_kv_heads,
            qkv_in_one=arch.qkv_in_one,
            bias=arch.attention_bias,
            rotary=RotaryEmbedding(arch.rotary_dimensions, arch.sequence_length,
                                   arch.rotary_embedding_base, device=device),
            masked_softmax_config=arch.masked_softmax_config,
            causal=arch.causal,
            num_local_attention_heads=arch.num_local_attention_heads,
            local_attention_window_size=arch.local_attention_window_size,
            dropout_attention_probs=arch.dropout_attention_probs,
            dtype=arch.dtype,
            device=device,
        )
        self.post_attention_layernorm = RMSNorm(arch.hidden_size, **norm)
        self.mlp = ParallelSwiGLUMLP(arch.hidden_size, arch.mlp_factor,
                                     bias=arch.mlp_bias, dtype=arch.dtype, device=device)

    def forward(self, h: torch.Tensor, position_ids: torch.Tensor,
                kv_cache: Optional[PagedKVCacheView] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        attn = self.attention(self.input_layernorm(h), position_ids, kv_cache, segment_ids)
        h = h + attn.to(h.dtype)
        return h + self.mlp(self.post_attention_layernorm(h)).to(h.dtype)
