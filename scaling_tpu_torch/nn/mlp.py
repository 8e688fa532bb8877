"""MLPs (``ParallelMLP`` and ``ParallelSwiGLUMLP`` of scaling_tpu/nn/mlp.py):
``dense_out(act(dense_in(x)))``, and SwiGLU ``down(silu(gate(x)) * up(x))``.
Under BitFit every linear's bias is ``bias_{name}``. Over a model group
(``shard``) the input enters the model region once, the first products
are column-parallel (this rank's slice of the intermediate width), the
activation runs on the slice, and the last product is row-parallel.

``sequence_parallel_output`` (JAX's flag) makes the last product leave the
region by a reduce-scatter along the sequence under sequence parallelism
(``ModelShard.sequence_parallel``), where its input also enters by an
all-gather along the sequence. JAX's transformer layer leaves the flag
False and lets GSPMD reshard the all-reduced output for the
sequence-sharded residual; the port's layer sets it, because its residual
stream stays sharded along the sequence. The arithmetic is the same: an
all-reduce followed by taking this rank's rows has, as its backward, an
all-gather of the rows' gradient, which is what the reduce-scatter's
backward is."""

from __future__ import annotations

from typing import Optional

import torch

from .activation_function import ActivationFunction, get_activation_function
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
                 bitfit_bias_name: Optional[str] = None, shard: ModelShard = ModelShard(),
                 sequence_parallel_output: bool = False):
        super().__init__()
        intermediate = _intermediate(io_features, intermediate_feature_factor)
        self.activation_fn = get_activation_function(activation)
        self.shard = shard
        common = dict(bias=bias, dtype=dtype, device=device, bitfit_bias_name=bitfit_bias_name,
                      shard=shard)
        self.dense_in = ColumnParallelLinear(io_features, intermediate, copy_input=False,
                                             **common)
        self.dense_out = RowParallelLinear(intermediate, io_features,
                                           parallel_output=sequence_parallel_output, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.shard.enter(x)
        return self.dense_out(self.activation_fn(self.dense_in(x)))


class ParallelSwiGLUMLP(torch.nn.Module):
    def __init__(self, io_features: int, intermediate_feature_factor: float,
                 bias: bool = False, dtype: torch.dtype = torch.float32, device=None,
                 bitfit_bias_name: Optional[str] = None, shard: ModelShard = ModelShard(),
                 sequence_parallel_output: bool = False):
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
        self.down_proj = RowParallelLinear(intermediate, io_features,
                                           parallel_output=sequence_parallel_output, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.shard.enter(x)
        return self.down_proj(self.silu(self.gate_proj(x)) * self.up_proj(x))
