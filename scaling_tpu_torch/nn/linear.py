"""Linear layers and the token embedding, whole or split over the model
group (counterpart of scaling_tpu/nn/linear.py).

The products are plain ``F.linear``, as the JAX package leaves them to
XLA. Weights use PyTorch's ``(out, in)`` layout; the JAX package stores
``(in, out)``, which ``models/transformer/convert.py`` transposes.

Over a model group of ``mp`` ranks (``ModelShard``), with JAX's partition
specs and names: ``ColumnParallelLinear`` keeps rank ``r``'s contiguous
``1/mp`` of the output rows (and of the bias), ``RowParallelLinear`` its
``1/mp`` of the input columns, summed over the group after the product,
with its bias replicated and added once, after the sum;
``VocabParallelEmbedding`` its ``1/mp`` of the vocabulary rows: ids
outside the slice look up zeros and the group sums. A column-parallel
linear enters the model region (``copy_to_model_region``) unless its
caller already did (``copy_input=False``: the attention and the MLP enter
once for all their column products); with ``gather_output`` its output is
all-gathered (the LM head's logits).

Under sequence parallelism (``ModelShard.sequence_parallel``, JAX's
``sequence_parallel`` over mp > 1) the activations between the
tensor-parallel regions hold this rank's contiguous ``1/mp`` of the
sequence: a region is entered by an all-gather along the sequence
(``ModelShard.enter``, in place of ``copy_to_model_region``; its backward
reduce-scatters), a ``RowParallelLinear`` with ``parallel_output`` (JAX's
flag) leaves it by a reduce-scatter along the sequence in place of the
all-reduce (its backward all-gathers), the bias added after it, and
``VocabParallelEmbedding`` reduce-scatters its partial lookups likewise.
These are the collectives that JAX's ``shard_activation_sp`` layouts
make GSPMD insert (scaling_tpu/nn/linear.py).

Parameters are allocated uninitialised; ``init_`` fills them from an
explicit ``torch.Generator`` with the JAX package's initialiser
(xavier normal, ``std = sqrt(2 / (fan_in + fan_out))``, zero biases), or
a state dict is loaded over them. A split layer draws the whole leaf from
the generator and keeps its slice, so a rank's shard is the slice of the
one-rank initialisation from the same seed. Under BitFit (``bitfit_bias_name``) a
linear's bias is named ``bias_{name}``, as in the JAX layers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..parallel.collectives import (
    copy_to_model_region,
    gather_from_model_region,
    gather_sequence,
    reduce_from_model_region,
    scatter_sequence,
)


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """A layer's place in the model group: ``size`` ranks, this one
    ``rank``, ``group`` the process group (None for one rank);
    ``sequence_parallel``: the activations outside the tensor-parallel
    regions are this rank's sequence shard."""

    size: int = 1
    rank: int = 0
    group: Any = None
    sequence_parallel: bool = False

    @classmethod
    def of(cls, topology) -> "ModelShard":
        if topology is None or topology.model_parallel_size == 1:
            return cls()
        return cls(topology.model_parallel_size, topology.model_parallel_rank,
                   topology.model_group, topology.sequence_parallel)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (b, s, h) into a tensor-parallel region: gathered along the
        sequence under sequence parallelism, else ``copy_to_model_region``."""
        if self.sequence_parallel:
            return gather_sequence(x, self.group, 1)
        return copy_to_model_region(x, self.group)

    def leave(self, y: torch.Tensor, parallel_output: bool = False) -> torch.Tensor:
        """The group's partial sums ``y`` out of a tensor-parallel region:
        reduce-scattered along the sequence when ``parallel_output`` under
        sequence parallelism, else all-reduced."""
        if parallel_output and self.sequence_parallel:
            return scatter_sequence(y, self.group, 1)
        return reduce_from_model_region(y, self.group)

    def split(self, n: int, what: str) -> int:
        if n % self.size:
            raise ValueError(f"{what} {n} does not split over model_parallel_size {self.size}")
        return n // self.size

    def rows(self, n: int) -> slice:
        """This rank's contiguous slice of ``n`` rows."""
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def _draw_slice(full_shape, dim: int, shard: ModelShard, draw) -> torch.Tensor:
    """``draw(shape)`` of the whole leaf, narrowed to this rank's slice."""
    full = draw(full_shape)
    return full if shard.size == 1 else full[(slice(None),) * dim + (shard.rows(
        full_shape[dim]),)]


def xavier_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    fan_out, fan_in = weight.shape[0], weight.shape[1]
    weight.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)), generator=generator)


class Linear(torch.nn.Linear):
    """``y = x W^T + b``; the JAX package's Column/RowParallelLinear at mp=1.
    With ``bitfit_bias_name`` the bias (if any) is ``bias_{name}``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None,
                 bitfit_bias_name: Optional[str] = None):
        super().__init__(in_features, out_features, bias=bias, dtype=dtype, device=device)
        self.bias_name = f"bias_{bitfit_bias_name}" if bitfit_bias_name else "bias"
        if bias and bitfit_bias_name:
            b = self._parameters.pop("bias")
            self.register_parameter("bias", None)
            self.register_parameter(self.bias_name, b)

    @property
    def host_bias(self) -> Optional[torch.nn.Parameter]:
        """The bias under its name, or None."""
        return getattr(self, self.bias_name)

    def reset_parameters(self) -> None:  # filled by init_ or a state dict
        pass

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        xavier_normal_(self.weight, generator)
        if self.host_bias is not None:
            self.host_bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.host_bias)


class ColumnParallelLinear(Linear):
    """``Linear`` with this rank's slice of the output features."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None,
                 bitfit_bias_name: Optional[str] = None, shard: ModelShard = ModelShard(),
                 copy_input: bool = True, gather_output: bool = False):
        super().__init__(in_features, shard.split(out_features, "out_features"), bias=bias,
                         dtype=dtype, device=device, bitfit_bias_name=bitfit_bias_name)
        self.shard, self.global_out = shard, out_features
        self.copy_input, self.gather_output = copy_input, gather_output

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        std = math.sqrt(2.0 / (self.in_features + self.global_out))
        w = self.weight
        self.weight.copy_(_draw_slice(
            (self.global_out, self.in_features), 0, self.shard,
            lambda shape: torch.empty(shape, dtype=w.dtype, device=w.device).normal_(
                0.0, std, generator=generator)))
        if self.host_bias is not None:
            self.host_bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.copy_input:
            x = self.shard.enter(x)
        y = F.linear(x, self.weight, self.host_bias)
        return gather_from_model_region(y, self.shard.group) if self.gather_output else y


class RowParallelLinear(Linear):
    """``Linear`` with this rank's slice of the input features; the
    partial products are summed over the model group (reduce-scattered
    along the sequence with ``parallel_output`` under sequence
    parallelism), then the bias (whole on every rank) is added."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None,
                 bitfit_bias_name: Optional[str] = None, shard: ModelShard = ModelShard(),
                 parallel_output: bool = False):
        super().__init__(shard.split(in_features, "in_features"), out_features, bias=bias,
                         dtype=dtype, device=device, bitfit_bias_name=bitfit_bias_name)
        self.shard, self.global_in = shard, in_features
        self.parallel_output = parallel_output

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        std = math.sqrt(2.0 / (self.global_in + self.out_features))
        w = self.weight
        self.weight.copy_(_draw_slice(
            (self.out_features, self.global_in), 1, self.shard,
            lambda shape: torch.empty(shape, dtype=w.dtype, device=w.device).normal_(
                0.0, std, generator=generator)))
        if self.host_bias is not None:
            self.host_bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.shard.size == 1:
            return F.linear(x, self.weight, self.host_bias)
        y = self.shard.leave(F.linear(x, self.weight), self.parallel_output)
        bias = self.host_bias
        return y if bias is None else y + bias


class Embedding(torch.nn.Embedding):
    """Token embedding, ``weight`` is ``(vocab, hidden)`` as in the JAX
    package's VocabParallelEmbedding."""

    def reset_parameters(self) -> None:  # filled by init_ or a state dict
        pass

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        # the JAX table is (vocab, hidden) with fan_in = vocab
        vocab, hidden = self.weight.shape
        self.weight.normal_(0.0, math.sqrt(2.0 / (vocab + hidden)),
                            generator=generator)


class VocabParallelEmbedding(Embedding):
    """``Embedding`` with this rank's slice of the vocabulary rows; the
    ranks' lookups are summed (reduce-scattered along the sequence under
    sequence parallelism)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 dtype: Optional[torch.dtype] = None, device=None,
                 shard: ModelShard = ModelShard()):
        super().__init__(shard.split(num_embeddings, "vocab_size"), embedding_dim, dtype=dtype,
                         device=device)
        self.shard, self.global_vocab = shard, num_embeddings
        self.vocab_start = shard.rows(num_embeddings).start

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        hidden = self.weight.shape[1]
        std = math.sqrt(2.0 / (self.global_vocab + hidden))
        w = self.weight
        self.weight.copy_(_draw_slice(
            (self.global_vocab, hidden), 0, self.shard,
            lambda shape: torch.empty(shape, dtype=w.dtype, device=w.device).normal_(
                0.0, std, generator=generator)))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.shard.size == 1:
            return super().forward(ids)
        local = ids - self.vocab_start
        outside = (local < 0) | (local >= self.num_embeddings)
        y = F.embedding(local.masked_fill(outside, 0), self.weight)
        y = y.masked_fill(outside[..., None], 0)
        return self.shard.leave(y, parallel_output=True)
