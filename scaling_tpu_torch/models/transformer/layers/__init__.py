"""Layers of the transformer stack (counterpart of
scaling_tpu/models/transformer/layers/)."""

from .embedding import EmbeddingInput
from .layer import Adapter, TransformerLayer
from .lm_head import (
    LayerNormWrapper,
    TransformerEmbeddingHead,
    TransformerLMHead,
    TransformerLMHeadTied,
)

__all__ = ["Adapter", "EmbeddingInput", "LayerNormWrapper", "TransformerEmbeddingHead",
           "TransformerLMHead", "TransformerLMHeadTied", "TransformerLayer"]
