"""The transformer of the port (counterpart of scaling_tpu/models/transformer/)."""

from .config import TransformerArchitectureConfig
from .inference import TransformerInferenceModule, sample_rows
from .model import TransformerModel, get_transformer_layers

__all__ = [
    "TransformerArchitectureConfig",
    "TransformerInferenceModule",
    "TransformerModel",
    "get_transformer_layers",
    "sample_rows",
]
