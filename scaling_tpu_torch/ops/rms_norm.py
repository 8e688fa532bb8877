"""RMSNorm forward (kernel K2).

Replaces the TPU kernel ``rms_norm_fused``'s forward (``_rms_fwd_impl``
in ``scaling_tpu/ops/rms_norm.py``): ``y = x * rsqrt(mean(x^2) + eps) * w``
over the last dim, statistics in f32, ``y`` in x's dtype.

The kernel is Triton (``ops/_rms_norm_triton.py``). That route fits this
function: it is one reduction along a row followed by an elementwise
scale, needs no tensor cores and no communication between programs, and
each program owns a block of whole rows. It is bound by bytes (read x
and w once, write y once); the arithmetic is a few operations per
element. Triton is imported only when the kernel first launches, so the
package imports where Triton is absent.

``rms_norm_plain`` is the same function written with explicit f32 PyTorch
ops. Dispatch goes by the tensor's device: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs the plain version.
"""

from __future__ import annotations

import torch

from . import launches

LANES = 128  # the hidden dim must be a multiple of this, as on the TPU side


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last dim of ``x`` with gain ``weight`` (d,)."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: no kernel for device {x.device}")
    return _launch(x, weight, eps)


def _launch(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    d = x.shape[-1]
    if d % LANES != 0:
        raise ValueError(f"rms_norm: hidden dim {d} is not a multiple of {LANES}")
    if weight.shape != (d,) or weight.device != x.device:
        raise ValueError(
            f"rms_norm: weight {tuple(weight.shape)} on {weight.device} does "
            f"not fit x {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous() or not weight.is_contiguous():
        raise ValueError("rms_norm: x and weight must be contiguous")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"rms_norm: dtype {x.dtype} not supported")
    from . import _rms_norm_triton

    x2 = x.reshape(-1, d)
    y = torch.empty_like(x2)
    _rms_norm_triton.launch(x2, weight, y, float(eps))
    launches.KERNEL["rms_norm"] += 1
    return y.reshape(x.shape)


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel's function in explicit f32 PyTorch ops."""
    launches.PLAIN["rms_norm"] += 1
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * r * weight.float()).to(x.dtype)
