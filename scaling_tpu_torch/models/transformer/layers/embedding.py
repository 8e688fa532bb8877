"""Token embedding input layer (``EmbeddingInput`` of
scaling_tpu/models/transformer/layers/embedding.py, without softprompt or
image splices; dropout is off in inference)."""

from __future__ import annotations

import torch

from ....nn.linear import Embedding
from ..config import TransformerArchitectureConfig


class EmbeddingInput(torch.nn.Module):
    def __init__(self, arch: TransformerArchitectureConfig, device=None):
        super().__init__()
        self.embedding = Embedding(arch.vocab_size, arch.hidden_size,
                                   dtype=arch.dtype, device=device)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        return self.embedding(token_ids.long())
