"""Activation function registry (counterpart of scaling_tpu/nn/activation_function.py).

``gelu`` is the tanh approximation, the default of ``jax.nn.gelu``."""

from __future__ import annotations

from enum import Enum
from typing import Callable

import torch
import torch.nn.functional as F


class ActivationFunction(Enum):
    GELU = "gelu"
    SILU = "silu"
    RELU = "relu"
    TANH = "tanh"
    SIGMOID = "sigmoid"


_FUNCTIONS: dict[ActivationFunction, Callable[[torch.Tensor], torch.Tensor]] = {
    ActivationFunction.GELU: lambda x: F.gelu(x, approximate="tanh"),
    ActivationFunction.SILU: F.silu,
    ActivationFunction.RELU: F.relu,
    ActivationFunction.TANH: torch.tanh,
    ActivationFunction.SIGMOID: torch.sigmoid,
}


def get_activation_function(activation: ActivationFunction) -> Callable:
    return _FUNCTIONS[ActivationFunction(activation)]
