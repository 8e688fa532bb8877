"""Linear layers and the token embedding, on one device.

Counterpart of scaling_tpu/nn/linear.py at model-parallel size 1: the
products are plain ``F.linear``, as the JAX package leaves them to XLA.
Weights use PyTorch's ``(out, in)`` layout; the JAX package stores
``(in, out)``, which ``models/transformer/convert.py`` transposes.

Parameters are allocated uninitialised; ``init_`` fills them from an
explicit ``torch.Generator`` with the JAX package's initialiser
(xavier normal, ``std = sqrt(2 / (fan_in + fan_out))``, zero biases), or
a state dict is loaded over them. Under BitFit (``bitfit_bias_name``) a
linear's bias is named ``bias_{name}``, as in the JAX layers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


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
