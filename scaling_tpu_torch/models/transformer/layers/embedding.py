"""Token embedding input layer (``EmbeddingInput`` of
scaling_tpu/models/transformer/layers/embedding.py): the table lookup; with
``image_encoder`` the encoded images spliced over their placeholder
positions (each image's 144 tokens from its start ``input_image_locations``,
an image whose ``input_image_mask`` entry is False left out, later images
over earlier ones, a start clamped so that the span fits, as JAX's
``dynamic_update_slice`` clamps it); the soft prompt (``softprompt_config``)
written over the first ``n_tokens`` slots of the sequence; then embedding
dropout at the site ``layer_0.embedding`` in a training pass.
``finetunable_token_ids`` is accepted and inert, as in the JAX package (see
the config). Over a model group the table is vocab-parallel
(``nn.linear.VocabParallelEmbedding``), and under sequence parallelism its
output is this model rank's ``1/mp`` of the rows.

The tensor the layer embeds may be a piece of the sequence: a context
rank's slice, a pipeline's token slice, and under sequence parallelism the
model rank's shard of either. The JAX layer embeds the whole sequence once
(scaling_tpu/models/transformer/layers/embedding.py), so the prompt goes
only where a row's absolute slot is below ``n_tokens``: the caller passes
the slot of the piece's first token (``slot_offset``: ``context rank x
s / cp``, or ``k x slice length`` for token slice ``k``) and the whole
sequence's length (``total_len``), and the layer adds its model rank's
offset within the piece under sequence parallelism. A prompt may span
several pieces; one longer than the whole sequence raises."""

from __future__ import annotations

from typing import Optional

import torch

from ....nn.base_layer import DropoutContext, dropout
from ....nn.linear import ModelShard, VocabParallelEmbedding
from ..config import TransformerArchitectureConfig
from ..image_encoder import ImageEncoder


class EmbeddingInput(torch.nn.Module):
    def __init__(self, arch: TransformerArchitectureConfig, device=None,
                 shard: ModelShard = ModelShard()):
        super().__init__()
        self.embedding = VocabParallelEmbedding(arch.vocab_size, arch.hidden_size,
                                                dtype=arch.dtype, device=device, shard=shard)
        self.dropout_rate = arch.dropout_embedding
        self.image_encoder: Optional[ImageEncoder] = None
        if arch.image_encoder:
            self.image_encoder = ImageEncoder(
                arch.hidden_size, width=arch.image_encoder_width,
                layers=arch.image_encoder_layers, heads=arch.image_encoder_heads,
                dropout_p=arch.dropout_image_encoder, dtype=arch.dtype,
                backbone=arch.image_encoder_backbone,
                resnet_stages=arch.image_encoder_resnet_stages,
                resnet_channels=arch.image_encoder_resnet_channels, device=device)
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

    def splice_images(self, h: torch.Tensor, images: torch.Tensor, locations: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      ctx: Optional[DropoutContext] = None) -> torch.Tensor:
        """``h`` (b, s, hidden) with the encoded ``images`` (b, n, H, W, 3)
        written from ``locations`` (b, n) on, where ``mask`` (b, n) is True
        (every image without one). One gather a slot, no host sync."""
        b, n = images.shape[:2]
        enc = self.image_encoder(images.reshape((b * n,) + images.shape[2:]), ctx)
        enc = enc.reshape(b, n, enc.shape[-2], enc.shape[-1]).to(h.dtype)
        tokens, s = enc.shape[2], h.shape[1]
        starts = locations.long().clamp(0, max(s - tokens, 0))
        rel = torch.arange(s, device=h.device)[None] - starts[:, :, None]  # (b, n, s)
        inside = (rel >= 0) & (rel < tokens)
        if mask is not None:
            inside = inside & mask.bool()[:, :, None]
        idx = rel.clamp(0, tokens - 1)[..., None].expand(-1, -1, -1, h.shape[-1])
        for j in range(n):
            h = torch.where(inside[:, j, :, None], enc[:, j].gather(1, idx[:, j]), h)
        return h

    def forward(self, token_ids: torch.Tensor, ctx: Optional[DropoutContext] = None,
                images: Optional[torch.Tensor] = None,
                image_locations: Optional[torch.Tensor] = None,
                image_mask: Optional[torch.Tensor] = None, slot_offset: int = 0,
                total_len: Optional[int] = None) -> torch.Tensor:
        h = self.embedding(token_ids.long())
        if self.image_encoder is not None and images is not None:
            h = self.splice_images(h, images, image_locations, image_mask, ctx)
        if self.softprompt is not None:
            shard = self.embedding.shard
            if shard.sequence_parallel:  # this rank's rows of the piece
                slot_offset += shard.rank * h.shape[1]
            h = self.write_softprompt(h, slot_offset,
                                      token_ids.shape[1] if total_len is None else total_len)
        return dropout(h, self.dropout_rate, ctx, "layer_0.embedding", sequence_sharded=True)

    def write_softprompt(self, h: torch.Tensor, slot_offset: int, total_len: int
                         ) -> torch.Tensor:
        """``h``, the rows from absolute slot ``slot_offset`` on, with the
        soft prompt over the rows whose slot is below ``n_tokens``."""
        sp = getattr(self, self.softprompt)
        n = sp.shape[0]
        if total_len < n:
            raise ValueError(f"a soft prompt of {n} tokens needs at least {n} positions, "
                             f"got {total_len}")
        rows = min(max(n - slot_offset, 0), h.shape[1])
        if rows == 0:
            return h
        prompt = sp[slot_offset:slot_offset + rows].to(h.dtype)
        return torch.cat([prompt[None].expand(h.shape[0], -1, -1), h[:, rows:]], dim=1)
