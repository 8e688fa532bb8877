"""MLPs (``ParallelMLP`` and ``ParallelSwiGLUMLP`` of scaling_tpu/nn/mlp.py,
mp=1): ``dense_out(act(dense_in(x)))``, and SwiGLU
``down(silu(gate(x)) * up(x))``."""

from __future__ import annotations

import torch

from .activation_function import ActivationFunction, get_activation_function
from .linear import Linear


def _intermediate(io_features: int, factor: float) -> int:
    intermediate = io_features * factor
    if float(int(intermediate)) != intermediate:
        raise ValueError("io_features * intermediate_feature_factor must be a natural number")
    return int(intermediate)


class ParallelMLP(torch.nn.Module):
    def __init__(self, io_features: int, intermediate_feature_factor: float = 4.0,
                 activation: ActivationFunction = ActivationFunction.GELU, bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        intermediate = _intermediate(io_features, intermediate_feature_factor)
        self.activation_fn = get_activation_function(activation)
        common = dict(bias=bias, dtype=dtype, device=device)
        self.dense_in = Linear(io_features, intermediate, **common)
        self.dense_out = Linear(intermediate, io_features, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense_out(self.activation_fn(self.dense_in(x)))


class ParallelSwiGLUMLP(torch.nn.Module):
    def __init__(self, io_features: int, intermediate_feature_factor: float,
                 bias: bool = False, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        intermediate = _intermediate(io_features, intermediate_feature_factor)
        self.silu = get_activation_function(ActivationFunction.SILU)
        common = dict(bias=bias, dtype=dtype, device=device)
        self.gate_proj = Linear(io_features, intermediate, **common)
        self.up_proj = Linear(io_features, intermediate, **common)
        self.down_proj = Linear(intermediate, io_features, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(self.silu(self.gate_proj(x)) * self.up_proj(x))
