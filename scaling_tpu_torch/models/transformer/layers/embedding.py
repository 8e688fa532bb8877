"""Token embedding input layer (``EmbeddingInput`` of
scaling_tpu/models/transformer/layers/embedding.py, without the image
splice): the table lookup, the soft prompt (``softprompt_config``) written
over the first ``n_tokens`` positions, then embedding dropout at the site
``layer_0.embedding`` in a training pass. ``finetunable_token_ids`` is
accepted and inert, as in the JAX package (see the config)."""

from __future__ import annotations

from typing import Optional

import torch

from ....nn.base_layer import DropoutContext, dropout
from ....nn.linear import Embedding
from ..config import TransformerArchitectureConfig


class EmbeddingInput(torch.nn.Module):
    def __init__(self, arch: TransformerArchitectureConfig, device=None):
        super().__init__()
        self.embedding = Embedding(arch.vocab_size, arch.hidden_size,
                                   dtype=arch.dtype, device=device)
        self.dropout_rate = arch.dropout_embedding
        self.softprompt: Optional[str] = None  # the parameter's name, as the JAX key
        if arch.softprompt_config is not None:
            self.softprompt = f"softprompt_{arch.softprompt_config.name}"
            self.register_parameter(self.softprompt, torch.nn.Parameter(torch.empty(
                arch.softprompt_config.n_tokens, arch.hidden_size, dtype=arch.dtype,
                device=device)))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        """The soft prompt from a normal of std 0.5 (the table is the
        ``Embedding``'s own)."""
        if self.softprompt is not None:
            getattr(self, self.softprompt).normal_(0.0, 0.5, generator=generator)

    def forward(self, token_ids: torch.Tensor,
                ctx: Optional[DropoutContext] = None) -> torch.Tensor:
        h = self.embedding(token_ids.long())
        if self.softprompt is not None:
            sp = getattr(self, self.softprompt)
            n = sp.shape[0]
            if h.shape[1] < n:
                raise ValueError(f"a soft prompt of {n} tokens needs at least {n} positions, "
                                 f"got {h.shape[1]}")
            h = torch.cat([sp.to(h.dtype)[None].expand(h.shape[0], -1, -1), h[:, n:]], dim=1)
        return dropout(h, self.dropout_rate, ctx, "layer_0.embedding")
