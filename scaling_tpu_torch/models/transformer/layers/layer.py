"""The transformer block (``TransformerLayer.__call__`` of
scaling_tpu/models/transformer/layers/layer.py): pre-norm attention with a
residual, then pre-norm MLP (the default GELU MLP or SwiGLU) with a
residual. Serving attends over the paged KV pool, ``generate`` over a
dense cache; training (no cache) over the sequence, within equal
``segment_ids``. With ``mlp_type: moe`` the MLP is the routed expert MLP
(``nn.moe``, GLU with the config's activation), whose load-balance loss
the block returns beside its output when asked (``return_aux``), as the
JAX block adds it to the IO dict's ``aux_loss``. Under muP the attention
scales its scores by ``sqrt(base_head_dim) / head_dim``.

In a training pass (a ``DropoutContext`` given) the attention's and the
MLP's outputs go through dropout, then through the bottleneck adapters
(``adapter_config``) when there are any, before each residual, in the
JAX order. LoRA deltas live in the attention (``nn.attention``). Under
context parallelism (``context``) the attention crosses the context group;
a pipeline's token slice attends over its earlier slices through a
``nn.attention.TokenSliceCache`` and hands its own K/V back
(``return_kv``).
The layer's dropout sites are ``layer_{i}.after_attention`` and
``layer_{i}.after_mlp``, ``layer_{i}`` its name in the stack.

Under sequence parallelism (``ModelShard.sequence_parallel``) the block's
input, its norms, the dropout after each branch, the adapters and the
residual stream hold this model rank's shard of the sequence: the attention
and the MLP gather their input along the sequence and reduce-scatter their
output (the MLP's ``sequence_parallel_output``; see ``nn.mlp``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ....nn.attention import ParallelSelfAttention
from ....nn.base_layer import ContextShard, DropoutContext, dropout
from ....nn.linear import ModelShard
from ....nn.mlp import ParallelMLP, ParallelSwiGLUMLP
from ....nn.moe import ParallelMoEMLP
from ....nn.norm import get_norm
from ....nn.rotary import get_rotary
from ..config import TransformerArchitectureConfig


class Adapter(torch.nn.Module):
    """Bottleneck adapter ``up(gelu(down(x)))`` (``Adapter`` of the JAX
    layer); the residual is the caller's. ``down`` and ``up`` are stored
    ``(out, in)``, the JAX ``(in, out)`` transposed, and drawn from a
    normal of std ``init_std``."""

    def __init__(self, hidden_size: int, downsampling_factor: float, init_std: float,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        # multiplicative, as in the JAX layer: 0.25 -> a 4x bottleneck
        bottleneck = max(1, int(hidden_size * downsampling_factor))
        self.init_std = init_std
        self.down = torch.nn.Parameter(torch.empty(bottleneck, hidden_size, dtype=dtype,
                                                   device=device))
        self.up = torch.nn.Parameter(torch.empty(hidden_size, bottleneck, dtype=dtype,
                                                 device=device))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        # initialisation streams the parameters from one generator in a fixed
        # order (the model's definition order), never reseeded between draws
        self.down.normal_(0.0, self.init_std, generator=generator)
        self.up.normal_(0.0, self.init_std, generator=generator)  # sta: disable=STA004

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(F.linear(x, self.down.to(x.dtype)), approximate="tanh")
        return F.linear(h, self.up.to(x.dtype))


class TransformerLayer(torch.nn.Module):
    def __init__(self, arch: TransformerArchitectureConfig, layer_index: int = 0,
                 device=None, shard: ModelShard = ModelShard(),
                 context: ContextShard = ContextShard()):
        super().__init__()
        self.layer_index = layer_index
        self.site = f"layer_{layer_index + 1}"  # the layer's name in the stack
        self.dropout_after_attention = arch.dropout_after_attention
        self.dropout_after_mlp = arch.dropout_after_mlp
        bitfit = arch.bitfit_bias_config.name if arch.bitfit_bias_config else None
        norm = dict(eps=arch.layernorm_eps, fused=arch.fused_norm, dtype=arch.dtype,
                    device=device, bitfit_bias_name=bitfit)
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
            scaling_factor=arch.attention_scale,
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
            bitfit_bias_name=bitfit,
            lora_config=arch.lora_config,
            site=f"{self.site}.attention",
            shard=shard,
            context=context,
        )
        self.post_attention_layernorm = get_norm(arch.norm_type, arch.hidden_size, **norm)
        if arch.is_moe:
            self.mlp = ParallelMoEMLP(arch.hidden_size, arch.mlp_factor, arch.moe_num_experts,
                                      top_k=arch.moe_top_k,
                                      capacity_factor=arch.moe_capacity_factor,
                                      aux_loss_coef=arch.moe_aux_loss_coef, glu=True,
                                      activation=arch.activation_function, dtype=arch.dtype,
                                      device=device)
        elif arch.mlp_type == "swiglu":
            self.mlp = ParallelSwiGLUMLP(arch.hidden_size, arch.mlp_factor,
                                         bias=arch.mlp_bias, dtype=arch.dtype, device=device,
                                         bitfit_bias_name=bitfit, shard=shard,
                                         sequence_parallel_output=shard.sequence_parallel)
        else:
            self.mlp = ParallelMLP(arch.hidden_size, arch.mlp_factor,
                                   activation=arch.activation_function, bias=arch.mlp_bias,
                                   dtype=arch.dtype, device=device, bitfit_bias_name=bitfit,
                                   shard=shard, sequence_parallel_output=shard.sequence_parallel)
        self.adapter_attention: Optional[str] = None  # child names, as the JAX param keys
        self.adapter_mlp: Optional[str] = None
        cfg = arch.adapter_config
        if cfg is not None:
            for where, factor in (("attention", cfg.attention_downsampling_factor),
                                  ("mlp", cfg.mlp_downsampling_factor)):
                if factor:
                    name = f"adapter_{where}_{cfg.name}"
                    self.add_module(name, Adapter(arch.hidden_size, factor, cfg.init_std,
                                                  dtype=arch.dtype, device=device))
                    setattr(self, f"adapter_{where}", name)

    def _adapt(self, x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
        return x if name is None else x + getattr(self, name)(x)

    def merge_lora_weights(self) -> None:
        """Fold the attention block's LoRA deltas into its base weights."""
        self.attention.merge_lora_weights()

    def forward(self, h: torch.Tensor, position_ids: torch.Tensor, kv_cache=None,
                segment_ids: Optional[torch.Tensor] = None,
                cache_offset: Optional[int] = None,
                scores_manipulation: Optional[torch.Tensor] = None,
                return_kv: bool = False, ctx: Optional[DropoutContext] = None,
                return_aux: bool = False, scores_log_additive: bool = True):
        """The block's output, or ``(output, (k, v))`` with ``return_kv``,
        or ``(output, aux)`` with ``return_aux`` (the MoE load-balance loss,
        an f32 scalar; a MoE block computes it only then); ``ctx`` is the
        training pass's dropout context (None: none); ``scores_manipulation``
        is log-additive unless ``scores_log_additive`` is False."""
        attn = self.attention(self.input_layernorm(h), position_ids, kv_cache, segment_ids,
                              cache_offset, scores_manipulation, return_kv, ctx,
                              scores_log_additive=scores_log_additive)
        new_kv = None
        if return_kv:
            attn, new_kv = attn
        attn = dropout(attn, self.dropout_after_attention, ctx, f"{self.site}.after_attention",
                       sequence_sharded=True)
        h = h + self._adapt(attn, self.adapter_attention).to(h.dtype)
        normed = self.post_attention_layernorm(h)
        aux = None
        if isinstance(self.mlp, ParallelMoEMLP):
            mlp_out, aux = self.mlp(normed, with_aux=return_aux)
        else:
            mlp_out = self.mlp(normed)
        mlp_out = dropout(mlp_out, self.dropout_after_mlp, ctx, f"{self.site}.after_mlp",
                          sequence_sharded=True)
        h = h + self._adapt(mlp_out, self.adapter_mlp).to(h.dtype)
        if return_aux:
            return h, aux
        return h if new_kv is None else (h, new_kv)

