"""Linear layers and the token embedding, on one device.

Counterpart of scaling_tpu/nn/linear.py at model-parallel size 1: the
products are plain ``F.linear``, as the JAX package leaves them to XLA.
Weights use PyTorch's ``(out, in)`` layout; the JAX package stores
``(in, out)``, which ``models/transformer/convert.py`` transposes.

Parameters are allocated uninitialised; ``init_`` fills them from an
explicit ``torch.Generator`` with the JAX package's initialiser
(xavier normal, ``std = sqrt(2 / (fan_in + fan_out))``, zero biases), or
a state dict is loaded over them.
"""

from __future__ import annotations

import math

import torch


def xavier_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    fan_out, fan_in = weight.shape[0], weight.shape[1]
    weight.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)), generator=generator)


class Linear(torch.nn.Linear):
    """``y = x W^T + b``; the JAX package's Column/RowParallelLinear at mp=1."""

    def reset_parameters(self) -> None:  # filled by init_ or a state dict
        pass

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        xavier_normal_(self.weight, generator)
        if self.bias is not None:
            self.bias.zero_()


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
