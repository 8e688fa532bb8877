"""Final norm and LM heads (``LayerNormWrapper``, ``TransformerLMHead`` and
``TransformerLMHeadTied`` of scaling_tpu/models/transformer/layers/lm_head.py).

The tied head projects with the embedding table of ``EmbeddingInput``: it
holds that module without registering it, so the table is one
``Parameter`` that appears once in ``named_parameters()`` and in the
state dict, under the embedding layer's name (``layer_0``), as the JAX
package keeps it once under the tied spec's owner. Autograd adds the
gradients of both uses into it, and the optimizer keeps one state for it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ....nn.linear import Linear
from ....nn.norm import get_norm
from ..config import TransformerArchitectureConfig
from .embedding import EmbeddingInput


class LayerNormWrapper(torch.nn.Module):
    def __init__(self, arch: TransformerArchitectureConfig, device=None):
        super().__init__()
        self.norm = get_norm(arch.norm_type, arch.hidden_size, eps=arch.layernorm_eps,
                             fused=arch.fused_norm, dtype=arch.dtype, device=device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.norm(h)


class TransformerLMHead(torch.nn.Module):
    def __init__(self, arch: TransformerArchitectureConfig, device=None):
        super().__init__()
        self.linear = Linear(arch.hidden_size, arch.vocab_size, bias=False,
                             dtype=arch.dtype, device=device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.linear(h)


class TransformerLMHeadTied(torch.nn.Module):
    def __init__(self, embedding: EmbeddingInput):
        super().__init__()
        object.__setattr__(self, "tied_embedding", embedding)  # not a submodule

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return F.linear(h, self.tied_embedding.embedding.weight)
