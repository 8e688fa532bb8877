"""RMSNorm (counterpart of ``RMSNorm`` in scaling_tpu/nn/norm.py).

``fused=True`` (``layernorm.optimization_type: fused``) goes through
``ops.RMSNormFunction``: kernel K2 forward and kernel K3 backward, the
Triton kernels on CUDA tensors and their plain versions on CPU tensors.
``fused=False`` (``torch``) is plain PyTorch ops under autograd, as the
JAX package leaves that path to XLA. Both compute
``x * rsqrt(mean(x^2) + eps) * w`` with f32 statistics, output in x's dtype.
"""

from __future__ import annotations

import torch

from ..ops.rms_norm import RMSNormFunction


class RMSNorm(torch.nn.Module):
    def __init__(self, dimensions: int, eps: float = 1e-5, fused: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.fused = fused
        self.weight = torch.nn.Parameter(
            torch.ones(dimensions, dtype=dtype, device=device)
        )

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return RMSNormFunction.apply(x, self.weight, self.eps)
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.weight.float()).to(x.dtype)
