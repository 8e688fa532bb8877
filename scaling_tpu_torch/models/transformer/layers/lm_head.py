"""Final norm, LM heads and the embedding head (``LayerNormWrapper``,
``TransformerLMHead``, ``TransformerLMHeadTied`` and
``TransformerEmbeddingHead`` of
scaling_tpu/models/transformer/layers/lm_head.py). Under BitFit the final
norm's bias is ``bias_{name}``.

The tied head projects with the embedding table of ``EmbeddingInput``: it
holds that module without registering it, so the table is one
``Parameter`` that appears once in ``named_parameters()`` and in the
state dict, under the embedding layer's name (``layer_0``), as the JAX
package keeps it once under the tied spec's owner. Autograd adds the
gradients of both uses into it, and the optimizer keeps one state for it.

Over a model group the head's product is vocab-parallel (the untied
head's rows, or the tied table's shard) and its logits are all-gathered
to the full vocabulary before the loss, as JAX does. Under sequence
parallelism the final norm runs on the rank's shard of the sequence and the
head enters its region by an all-gather along the sequence
(``ModelShard.enter``), so the logits cover the whole local sequence.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ....nn.linear import ColumnParallelLinear, ModelShard, xavier_normal_
from ....parallel.collectives import gather_from_model_region
from ....nn.norm import get_norm
from ..config import TransformerArchitectureConfig
from .embedding import EmbeddingInput


class LayerNormWrapper(torch.nn.Module):
    def __init__(self, arch: TransformerArchitectureConfig, device=None):
        super().__init__()
        bitfit = arch.bitfit_bias_config.name if arch.bitfit_bias_config else None
        self.norm = get_norm(arch.norm_type, arch.hidden_size, eps=arch.layernorm_eps,
                             fused=arch.fused_norm, dtype=arch.dtype, device=device,
                             bitfit_bias_name=bitfit)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.norm(h)


class _ZeroInitLinear(ColumnParallelLinear):
    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        self.weight.zero_()


class TransformerLMHead(torch.nn.Module):
    """The untied head. Under muP its logits carry ``output_mult`` and,
    with ``readout_zero_init``, it starts at zero (the width correction is
    the head's ``1/m`` learning rate, not a logit multiplier)."""

    def __init__(self, arch: TransformerArchitectureConfig, device=None,
                 shard: ModelShard = ModelShard()):
        super().__init__()
        mup = arch.mup
        linear = (_ZeroInitLinear if mup is not None and mup.readout_zero_init
                  else ColumnParallelLinear)
        self.linear = linear(arch.hidden_size, arch.vocab_size, bias=False, dtype=arch.dtype,
                             device=device, shard=shard, gather_output=True)
        # the multiplier in the logits' dtype, as the JAX head casts it
        self.logit_mult = (None if mup is None
                           else float(torch.tensor(mup.output_mult, dtype=arch.dtype)))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        logits = self.linear(h)
        return logits if self.logit_mult is None else logits * self.logit_mult


class TransformerLMHeadTied(torch.nn.Module):
    def __init__(self, embedding: EmbeddingInput):
        super().__init__()
        object.__setattr__(self, "tied_embedding", embedding)  # not a submodule

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        table = self.tied_embedding.embedding
        group = table.shard.group
        return gather_from_model_region(F.linear(table.shard.enter(h), table.weight), group)


class TransformerEmbeddingHead(torch.nn.Module):
    """The weighted mean over the sequence of the final norm's output (the
    JAX ``embeddings`` the norm records), weights ``loss_weights`` (ones
    when absent), then the projection stack ``proj_{i}_{name}`` with GELU
    between projections. The projections are stored ``(out, in)``, the
    JAX ``(in, out)`` transposed."""

    def __init__(self, arch: TransformerArchitectureConfig, device=None):
        super().__init__()
        cfg = arch.embedding_head_config
        dims = [arch.hidden_size] + list(cfg.proj_layers)
        self.names = [f"proj_{i}_{cfg.name}" for i in range(len(dims) - 1)]
        for name, d_in, d_out in zip(self.names, dims[:-1], dims[1:]):
            self.register_parameter(name, torch.nn.Parameter(torch.empty(
                d_out, d_in, dtype=arch.dtype, device=device)))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        for name in self.names:
            xavier_normal_(getattr(self, name), generator)

    def forward(self, h: torch.Tensor, loss_weights: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """``h`` (b, s, hidden) -> (b, last projection's width)."""
        if loss_weights is None:
            loss_weights = torch.ones(h.shape[:2], dtype=torch.float32, device=h.device)
        w = loss_weights.float()
        denom = w.sum(dim=1, keepdim=True).clamp_min(1.0)
        pooled = ((h.float() * w[..., None]).sum(dim=1) / denom).to(h.dtype)
        for i, name in enumerate(self.names):
            pooled = F.linear(pooled, getattr(self, name).to(pooled.dtype))
            if i < len(self.names) - 1:
                pooled = F.gelu(pooled, approximate="tanh")  # jax.nn.gelu's default
        return pooled
