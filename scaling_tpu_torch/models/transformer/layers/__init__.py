"""Layers of the transformer stack (counterpart of
scaling_tpu/models/transformer/layers/)."""

from .embedding import EmbeddingInput
from .layer import TransformerLayer
from .lm_head import LayerNormWrapper, TransformerLMHead, TransformerLMHeadTied

__all__ = ["EmbeddingInput", "LayerNormWrapper", "TransformerLMHead", "TransformerLMHeadTied",
           "TransformerLayer"]
