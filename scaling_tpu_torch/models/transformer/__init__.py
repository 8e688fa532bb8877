"""The transformer of the port (counterpart of scaling_tpu/models/transformer/)."""

from .config import TransformerArchitectureConfig, TransformerConfig
from .inference import TransformerInferenceModule, sample_rows
from .model import (
    TransformerModel,
    get_parameter_groups,
    get_transformer_layers,
    init_model,
    init_optimizer,
    loss_function,
)

__all__ = [
    "TransformerArchitectureConfig",
    "TransformerConfig",
    "TransformerInferenceModule",
    "TransformerModel",
    "get_parameter_groups",
    "get_transformer_layers",
    "init_model",
    "init_optimizer",
    "loss_function",
    "sample_rows",
]
