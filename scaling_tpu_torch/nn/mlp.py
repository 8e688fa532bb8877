"""SwiGLU MLP (``ParallelSwiGLUMLP`` of scaling_tpu/nn/mlp.py, mp=1):
``down(silu(gate(x)) * up(x))``."""

from __future__ import annotations

import torch

from .activation_function import ActivationFunction, get_activation_function
from .linear import Linear


class ParallelSwiGLUMLP(torch.nn.Module):
    def __init__(self, io_features: int, intermediate_feature_factor: float,
                 bias: bool = False, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        intermediate = io_features * intermediate_feature_factor
        if float(int(intermediate)) != intermediate:
            raise ValueError(
                "io_features * intermediate_feature_factor must be a natural number"
            )
        intermediate = int(intermediate)
        self.silu = get_activation_function(ActivationFunction.SILU)
        common = dict(bias=bias, dtype=dtype, device=device)
        self.gate_proj = Linear(io_features, intermediate, **common)
        self.up_proj = Linear(io_features, intermediate, **common)
        self.down_proj = Linear(intermediate, io_features, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(self.silu(self.gate_proj(x)) * self.up_proj(x))
