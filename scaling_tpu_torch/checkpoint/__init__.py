"""Checkpoints in the JAX package's npz layout (counterpart of
scaling_tpu/checkpoint/)."""

from .checkpoint import (
    enforce_allow_lists,
    load_model_checkpoint,
    load_optimizer_checkpoint,
    save_model_checkpoint,
    save_optimizer_checkpoint,
)

__all__ = [
    "enforce_allow_lists",
    "load_model_checkpoint",
    "load_optimizer_checkpoint",
    "save_model_checkpoint",
    "save_optimizer_checkpoint",
]
