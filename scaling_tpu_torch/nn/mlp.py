"""MLPs (``ParallelMLP`` and ``ParallelSwiGLUMLP`` of scaling_tpu/nn/mlp.py):
``dense_out(act(dense_in(x)))``, and SwiGLU ``down(silu(gate(x)) * up(x))``.
Under BitFit every linear's bias is ``bias_{name}``. Over a model group
(``shard``) the input enters the model region once, the first products
are column-parallel (this rank's slice of the intermediate width), the
activation runs on the slice, and the last product is row-parallel."""

from __future__ import annotations

from typing import Optional

import torch

from .activation_function import ActivationFunction, get_activation_function
from ..parallel.collectives import copy_to_model_region
from .linear import ColumnParallelLinear, ModelShard, RowParallelLinear


def _intermediate(io_features: int, factor: float) -> int:
    intermediate = io_features * factor
    if float(int(intermediate)) != intermediate:
        raise ValueError("io_features * intermediate_feature_factor must be a natural number")
    return int(intermediate)


class ParallelMLP(torch.nn.Module):
    def __init__(self, io_features: int, intermediate_feature_factor: float = 4.0,
                 activation: ActivationFunction = ActivationFunction.GELU, bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None,
                 bitfit_bias_name: Optional[str] = None, shard: ModelShard = ModelShard()):
        super().__init__()
        intermediate = _intermediate(io_features, intermediate_feature_factor)
        self.activation_fn = get_activation_function(activation)
        self.shard = shard
        common = dict(bias=bias, dtype=dtype, device=device, bitfit_bias_name=bitfit_bias_name,
                      shard=shard)
        self.dense_in = ColumnParallelLinear(io_features, intermediate, copy_input=False,
                                             **common)
        self.dense_out = RowParallelLinear(intermediate, io_features, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_model_region(x, self.shard.group)
        return self.dense_out(self.activation_fn(self.dense_in(x)))


class ParallelSwiGLUMLP(torch.nn.Module):
    def __init__(self, io_features: int, intermediate_feature_factor: float,
                 bias: bool = False, dtype: torch.dtype = torch.float32, device=None,
                 bitfit_bias_name: Optional[str] = None, shard: ModelShard = ModelShard()):
        super().__init__()
        intermediate = _intermediate(io_features, intermediate_feature_factor)
        self.silu = get_activation_function(ActivationFunction.SILU)
        self.shard = shard
        common = dict(bias=bias, dtype=dtype, device=device, bitfit_bias_name=bitfit_bias_name,
                      shard=shard)
        self.gate_proj = ColumnParallelLinear(io_features, intermediate, copy_input=False,
                                              **common)
        self.up_proj = ColumnParallelLinear(io_features, intermediate, copy_input=False,
                                            **common)
        self.down_proj = RowParallelLinear(intermediate, io_features, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_model_region(x, self.shard.group)
        return self.down_proj(self.silu(self.gate_proj(x)) * self.up_proj(x))
