"""RMSNorm forward (kernel K2) and backward (kernel K3).

Replaces the TPU kernel ``rms_norm_fused`` of ``scaling_tpu/ops/rms_norm.py``:
its forward (``_rms_fwd_impl``), ``y = x * rsqrt(mean(x^2) + eps) * w``
over the last dim with f32 statistics and ``y`` in x's dtype, and its
backward (``_rms_bwd``), with ``r`` recomputed and ``gw = g * w``:

    dx = r * gw - x * r^3 * mean(gw * x)     (in x's dtype)
    dw = sum_rows(g * x * r)                 (f32, returned in w's dtype)

Both kernels are Triton (``ops/_rms_norm_triton.py``,
``ops/_rms_norm_bwd_triton.py``). That route fits these functions: row
reductions, elementwise scales and one column reduction, no tensor cores,
no traffic between programs beyond the backward's dw partials. Both are
bound by bytes; the arithmetic is a few operations per element. Triton
is imported only when a kernel first launches, so the package imports
where Triton is absent.

``rms_norm_plain`` and ``rms_norm_bwd_plain`` are the same functions in
explicit f32 PyTorch ops. Dispatch goes by the tensor's device: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs the plain
version. ``RMSNormFunction`` is the ``torch.autograd.Function`` whose
forward is K2 and whose backward is K3.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import launches

LANES = 128  # the hidden dim must be a multiple of this, as on the TPU side
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last dim of ``x`` with gain ``weight`` (d,)."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: no kernel for device {x.device}")
    return _launch(x, weight, eps)


def rms_norm_bwd(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of ``rms_norm(x, weight, eps)`` for the cotangent ``g``."""
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(x, weight, g, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm_bwd: no kernel for device {x.device}")
    return _launch_bwd(x, weight, g, eps)


class RMSNormFunction(torch.autograd.Function):
    """Forward K2, backward K3; saves x and w (r is recomputed, as on the TPU)."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return rms_norm(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, g.contiguous(), ctx.eps)
        return dx, dw, None


def _check(x: torch.Tensor, weight: torch.Tensor, what: str) -> int:
    d = x.shape[-1]
    if d % LANES != 0:
        raise ValueError(f"{what}: hidden dim {d} is not a multiple of {LANES}")
    if weight.shape != (d,) or weight.device != x.device:
        raise ValueError(
            f"{what}: weight {tuple(weight.shape)} on {weight.device} does "
            f"not fit x {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous() or not weight.is_contiguous():
        raise ValueError(f"{what}: x and weight must be contiguous")
    if x.dtype not in _DTYPES or weight.dtype not in _DTYPES:
        raise ValueError(f"{what}: dtype {x.dtype}/{weight.dtype} not supported")
    return d


def _launch(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    d = _check(x, weight, "rms_norm")
    from . import _rms_norm_triton

    x2 = x.reshape(-1, d)
    y = torch.empty_like(x2)
    _rms_norm_triton.launch(x2, weight, y, float(eps))
    launches.KERNEL["rms_norm"] += 1
    return y.reshape(x.shape)


def _launch_bwd(x, weight, g, eps):
    d = _check(x, weight, "rms_norm_bwd")
    if g.shape != x.shape or g.device != x.device or not g.is_contiguous():
        raise ValueError(f"rms_norm_bwd: g {tuple(g.shape)} does not fit x {tuple(x.shape)}")
    from . import _rms_norm_bwd_triton

    x2 = x.reshape(-1, d)
    dx = torch.empty_like(x2)
    dw = torch.empty_like(weight)
    _rms_norm_bwd_triton.launch(x2, weight, g.reshape(-1, d), dx, dw, float(eps))
    launches.KERNEL["rms_norm_bwd"] += 1
    return dx.reshape(x.shape), dw


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """The forward kernel's function in explicit f32 PyTorch ops."""
    launches.PLAIN["rms_norm"] += 1
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * r * weight.float()).to(x.dtype)


def rms_norm_bwd_plain(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                       eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's function in explicit f32 PyTorch ops:
    ``(dx in x's dtype, dw in w's dtype)``."""
    launches.PLAIN["rms_norm_bwd"] += 1
    x32, g32 = x.float(), g.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    gw = g32 * weight.float()
    mean_gwx = (gw * x32).mean(dim=-1, keepdim=True)
    dx = r * gw - x32 * r.pow(3) * mean_gwx
    dw = (g32 * x32 * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(weight.dtype)
