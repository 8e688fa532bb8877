"""Final norm and untied LM head (``LayerNormWrapper`` and
``TransformerLMHead`` of scaling_tpu/models/transformer/layers/lm_head.py)."""

from __future__ import annotations

import torch

from ....nn.linear import Linear
from ....nn.norm import RMSNorm
from ..config import TransformerArchitectureConfig


class LayerNormWrapper(torch.nn.Module):
    def __init__(self, arch: TransformerArchitectureConfig, device=None):
        super().__init__()
        self.norm = RMSNorm(arch.hidden_size, eps=arch.layernorm_eps,
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
