"""The transformer block (``TransformerLayer.__call__`` of
scaling_tpu/models/transformer/layers/layer.py): pre-norm attention with a
residual, then pre-norm MLP (the default GELU MLP or SwiGLU) with a
residual. Serving attends over the paged KV pool, ``generate`` over a
dense cache; training (no cache) over the sequence, within equal
``segment_ids``. No adapters, LoRA or MoE; no dropout (the training path
refuses a config that asks for it)."""

from __future__ import annotations

from typing import Optional

import torch

from ....nn.attention import ParallelSelfAttention
from ....nn.mlp import ParallelMLP, ParallelSwiGLUMLP
from ....nn.norm import get_norm
from ....nn.rotary import get_rotary
from ..config import TransformerArchitectureConfig


class TransformerLayer(torch.nn.Module):
    def __init__(self, arch: TransformerArchitectureConfig, layer_index: int = 0,
                 device=None):
        super().__init__()
        self.layer_index = layer_index
        norm = dict(eps=arch.layernorm_eps, fused=arch.fused_norm, dtype=arch.dtype,
                    device=device)
        self.input_layernorm = get_norm(arch.norm_type, arch.hidden_size, **norm)
        self.attention = ParallelSelfAttention(
            hidden_size=arch.hidden_size,
            num_attention_heads=arch.num_attention_heads,
            num_kv_heads=arch.attention_num_kv_heads,
            qkv_in_one=arch.qkv_in_one,
            bias=arch.attention_bias,
            rotary=get_rotary(arch.relative_position_embedding_type, arch.rotary_dimensions,
                              arch.sequence_length, arch.rotary_embedding_base,
                              device=device),
            masked_softmax_config=arch.masked_softmax_config,
            causal=arch.causal,
            num_local_attention_heads=arch.num_local_attention_heads,
            local_attention_window_size=arch.local_attention_window_size,
            dropout_attention_probs=arch.dropout_attention_probs,
            key_query_norm=arch.key_query_norm,
            norm_type=arch.norm_type,
            norm_eps=arch.layernorm_eps,
            fused_norm=arch.fused_norm,
            dtype=arch.dtype,
            device=device,
        )
        self.post_attention_layernorm = get_norm(arch.norm_type, arch.hidden_size, **norm)
        if arch.mlp_type == "swiglu":
            self.mlp = ParallelSwiGLUMLP(arch.hidden_size, arch.mlp_factor,
                                         bias=arch.mlp_bias, dtype=arch.dtype, device=device)
        else:
            self.mlp = ParallelMLP(arch.hidden_size, arch.mlp_factor,
                                   activation=arch.activation_function, bias=arch.mlp_bias,
                                   dtype=arch.dtype, device=device)

    def forward(self, h: torch.Tensor, position_ids: torch.Tensor, kv_cache=None,
                segment_ids: Optional[torch.Tensor] = None,
                cache_offset: Optional[int] = None,
                scores_manipulation: Optional[torch.Tensor] = None,
                return_kv: bool = False):
        """The block's output, or ``(output, (k, v))`` with ``return_kv``."""
        attn = self.attention(self.input_layernorm(h), position_ids, kv_cache, segment_ids,
                              cache_offset, scores_manipulation, return_kv)
        new_kv = None
        if return_kv:
            attn, new_kv = attn
        h = h + attn.to(h.dtype)
        h = h + self.mlp(self.post_attention_layernorm(h)).to(h.dtype)
        return h if new_kv is None else (h, new_kv)
