"""LayerNorm and RMSNorm (counterparts of ``LayerNorm``, ``RMSNorm`` and
``get_norm`` in scaling_tpu/nn/norm.py).

Both compute their statistics in f32 and return x's dtype:
``LayerNorm`` is ``(x - mean) * rsqrt(var + eps) * w + b``, plain
PyTorch ops under autograd at every ``optimization_type``, as the JAX
package leaves it to XLA; ``RMSNorm`` is ``x * rsqrt(mean(x^2) + eps) * w``.

``fused=True`` (``layernorm.optimization_type: fused``) sends an RMSNorm
through ``ops.RMSNormFunction`` (kernel K2 forward, K3 backward: Triton on
CUDA tensors, their plain versions on CPU tensors) where
``rms_norm_fused_supported`` allows it: the JAX gate without its platform
check, a hidden size that is a multiple of 128. Any other width takes the
plain ops, as the JAX layer takes its XLA path; the route depends on the
width alone, so it is the same on the CPU and on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.rms_norm import LANES, RMSNormFunction


def rms_norm_fused_supported(dim: int) -> bool:
    """Whether a fused RMSNorm of width ``dim`` runs kernels K2/K3."""
    return dim % LANES == 0


class LayerNorm(torch.nn.Module):
    """Weight and bias; the bias is ``bias_{bitfit_bias_name}`` when one is
    given, as in the JAX layer."""

    def __init__(self, dimensions: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 device=None, bitfit_bias_name: Optional[str] = None):
        super().__init__()
        self.eps = eps
        self.bias_name = f"bias_{bitfit_bias_name}" if bitfit_bias_name else "bias"
        self.weight = torch.nn.Parameter(torch.ones(dimensions, dtype=dtype, device=device))
        self.register_parameter(self.bias_name, torch.nn.Parameter(
            torch.zeros(dimensions, dtype=dtype, device=device)))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        getattr(self, self.bias_name).zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + getattr(self, self.bias_name).float()).to(x.dtype)


class RMSNorm(torch.nn.Module):
    def __init__(self, dimensions: int, eps: float = 1e-5, fused: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.fused = fused and rms_norm_fused_supported(dimensions)
        self.weight = torch.nn.Parameter(
            torch.ones(dimensions, dtype=dtype, device=device)
        )

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return RMSNormFunction.apply(x.contiguous(), self.weight, self.eps)
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.weight.float()).to(x.dtype)


def get_norm(norm_type: str, dimensions: int, eps: float = 1e-5, fused: bool = False,
             dtype: torch.dtype = torch.float32, device=None) -> torch.nn.Module:
    """``layernorm`` or ``rms``; ``fused`` applies to RMSNorm only, as in JAX."""
    if norm_type == "layernorm":
        return LayerNorm(dimensions, eps, dtype=dtype, device=device)
    if norm_type == "rms":
        return RMSNorm(dimensions, eps, fused=fused, dtype=dtype, device=device)
    raise NotImplementedError(f"norm type {norm_type!r}")
