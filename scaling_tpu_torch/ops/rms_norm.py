"""RMSNorm forward (kernel K2) and backward (kernel K3).

Replaces the TPU kernel ``rms_norm_fused`` of ``scaling_tpu/ops/rms_norm.py``:
its forward (``_rms_fwd_impl``), ``y = x * rsqrt(mean(x^2) + eps) * w``
over the last dim with f32 statistics and ``y`` in x's dtype, and its
backward (``_rms_bwd``), with ``r`` recomputed and ``gw = g * w``:

    dx = r * gw - x * r^3 * mean(gw * x)     (in x's dtype)
    dw = sum_rows(g * x * r)                 (f32, returned in w's dtype)

The forward is Triton (``ops/_rms_norm_triton.py``): row reductions and
an elementwise scale, the case that route is for. The backward is CUDA
C++ (``csrc/rms_norm_bwd.cu``, built by ``cuda_build`` at first use): one
launch of a persistent grid that streams rows through a ring of bulk
asynchronous copies, keeps each lane's columns of dw in registers over
its band and adds the blocks' partials in the same launch, in a fixed
order. ``plan_bwd`` is its launch plan, a pure function of the shapes.
Its dx-only variant (``need_dw=False``) leaves dw out; the autograd
Function takes it for a gain that needs no gradient (a frozen norm of a
LoRA finetune). Both are bound by bytes. Triton is imported, and the
CUDA source built, only when a kernel first launches, so the package
imports where neither exists.

``rms_norm_plain`` and ``rms_norm_bwd_plain`` are the same functions in
explicit f32 PyTorch ops. Dispatch goes by the tensor's device: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs the plain
version. ``RMSNormFunction`` is the ``torch.autograd.Function`` whose
forward is K2 and whose backward is K3.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from . import cuda_build, launches

LANES = 128  # the hidden dim must be a multiple of this, as on the TPU side
# the dtypes the kernels take (the JAX kernel's f32/bf16/f16): a table of
# what the wrapper accepts, not a precision choice
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)  # sta: disable=STA006


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last dim of ``x`` with gain ``weight`` (d,)."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: no kernel for device {x.device}")
    return _launch(x, weight, eps)


def rms_norm_bwd(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor, eps: float,
                 need_dw: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(dx, dw)`` of ``rms_norm(x, weight, eps)`` for the cotangent ``g``;
    ``dw`` is None when ``need_dw`` is False (the dx-only variant)."""
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(x, weight, g, eps, need_dw)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm_bwd: no kernel for device {x.device}")
    return _launch_bwd(x, weight, g, eps, need_dw)


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
        # a frozen gain takes the dx-only variant and gets no gradient
        dx, dw = rms_norm_bwd(x, weight, g.contiguous(), ctx.eps, ctx.needs_input_grad[1])
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
    launches.add(launches.KERNEL, "rms_norm")
    return y.reshape(x.shape)


# The launch plan of K3 (csrc/rms_norm_bwd.cu), mirrored by its checks there.
SMEM_PER_BLOCK = 232_448        # bytes of shared memory an H100 block can use (227 KB)
STATIC_SMEM = 6144              # the kernel's static arrays
RING_HEADER = 1024              # the ring's mbarriers and row sums
CONSUMER_WARPS = 8              # warps of a block; each takes rows
STAGE_BYTES = 64 * 1024         # most x and g a ring stage holds (8 KB a warp: 256 B a lane)
RING_BYTES = 128 * 1024         # x and g the ring aims to hold (two stages at the training rows)
MAX_STAGES = 8
MAX_FINISHERS = 64              # blocks that add the partials into dw


@dataclass(frozen=True)
class BwdPlan:
    """How K3 covers an (n, d) problem. ``stages`` 0: rows too wide for the
    ring take the chunked walk (the whole block on one row at a time)."""

    grid: int
    rows_per_stage: int
    warps_per_row: int
    stages: int
    finishers: int      # the last blocks to arrive, which add the partials into dw
    smem_bytes: int     # dynamic shared memory of the launch

    @property
    def wide(self) -> bool:
        return self.stages == 0

    def bands(self, n: int) -> List[Tuple[int, int]]:
        """Each block's contiguous rows ``[start, stop)``, as the kernel cuts them."""
        return [(n * b // self.grid, n * (b + 1) // self.grid) for b in range(self.grid)]

    def partial_bytes(self, d: int) -> int:
        """The f32 partials of dw: a row of d a block."""
        return 4 * d * self.grid


@functools.lru_cache(maxsize=256)
def plan_bwd(n: int, d: int, x_bytes: int, g_bytes: int, sms: int) -> BwdPlan:
    """K3's grid, ring and finish for ``n`` rows of width ``d`` (a multiple
    of 128) with x and g elements of ``x_bytes`` and ``g_bytes``, on a card
    of ``sms`` SMs: up to 8 whole rows a stage of at most 64 KB, the 8
    consumer warps split evenly among them (so a lane takes at most 256
    bytes of x and g of a row), and stages to fill about 128 KB, at least
    2 and at most 8, as far as 227 KB holds them beside w (as f32). A row
    wider than a stage, or a ring of fewer than 2 stages, takes the chunked
    walk. One block an SM; the last ``grid // 2`` blocks to finish (1 to
    64) add the partials."""
    row_bytes = d * (x_bytes + g_bytes)
    rows = CONSUMER_WARPS
    while rows > 1 and rows * row_bytes > STAGE_BYTES:
        rows //= 2
    stage = rows * row_bytes
    w_bytes = -(-4 * d // 128) * 128  # w as f32, beside the ring
    stages = min(MAX_STAGES, (SMEM_PER_BLOCK - STATIC_SMEM - RING_HEADER - w_bytes) // stage,
                 max(2, RING_BYTES // stage))
    if stage > STAGE_BYTES or stages < 2:
        rows, stages, smem, work = 1, 0, 0, n
    else:
        smem, work = RING_HEADER + w_bytes + stages * stage, -(-n // rows)
    grid = max(1, min(sms, work))
    return BwdPlan(grid, rows, CONSUMER_WARPS // rows, stages,
                   max(1, min(MAX_FINISHERS, grid // 2)), smem)


_SMS: Dict[int, int] = {}
# (device, stream) -> the finish's two tickets: zeroed once, put back to 0 by every launch
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # sta: disable=STA006


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its storage offset leaves it off the
    16-byte boundary the bulk copies and 16-byte loads need (x, g, w)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_bwd(x, weight, g, eps, need_dw=True):
    d = _check(x, weight, "rms_norm_bwd")
    if g.shape != x.shape or g.device != x.device or not g.is_contiguous():
        raise ValueError(f"rms_norm_bwd: g {tuple(g.shape)} does not fit x {tuple(x.shape)}")
    if g.dtype not in _DTYPES:
        raise ValueError(f"rms_norm_bwd: g's dtype {g.dtype} not supported")
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    x2, g2, w = _aligned(x.reshape(-1, d)), _aligned(g.reshape(-1, d)), _aligned(weight)
    n = x2.shape[0]
    plan = plan_bwd(n, d, x2.element_size(), g2.element_size(), _SMS[dev])
    dx = torch.empty_like(x2)
    dw = part = tickets = None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if need_dw:
        dw = torch.empty_like(weight)
        part = torch.empty(plan.grid, d, dtype=torch.float32, device=x.device)
        key = (dev, stream)
        if key not in _TICKETS:
            _TICKETS[key] = torch.zeros(2, dtype=torch.int32, device=x.device)
        tickets = _TICKETS[key]

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _library().rms_norm_bwd_launch(
        _DTYPE_CODES[x2.dtype], _DTYPE_CODES[g2.dtype], _DTYPE_CODES[w.dtype],
        int(need_dw), x2.data_ptr(), w.data_ptr(), g2.data_ptr(), dx.data_ptr(),
        ptr(dw), ptr(part), ptr(tickets), n, d, float(eps), plan.grid,
        plan.rows_per_stage, plan.warps_per_row, plan.stages, plan.finishers, stream,
    )
    if err != 0:
        msg = _library().rms_norm_bwd_error_string(err).decode()
        raise RuntimeError(f"rms_norm_bwd kernel launch failed: {msg} ({err})")
    launches.add(launches.KERNEL, "rms_norm_bwd")
    launches.add(launches.VARIANTS, ("rms_norm_bwd", "dx_dw" if need_dw else "dx_only"))
    return dx.reshape(x.shape), dw


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("rms_norm_bwd")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rms_norm_bwd_launch.argtypes = [
            ci, ci, ci, ci,             # x, g, w dtypes; with_dw
            vp, vp, vp, vp, vp,         # x, w, g, dx, dw
            vp, vp,                     # part, tickets
            ctypes.c_longlong, ci, ctypes.c_float,  # n, d, eps
            ci, ci, ci, ci, ci,         # grid, rows_per_stage, warps_per_row, stages, finishers
            vp,                         # stream
        ]
        lib.rms_norm_bwd_launch.restype = ci
        lib.rms_norm_bwd_error_string.argtypes = [ci]
        lib.rms_norm_bwd_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """The forward kernel's function in explicit f32 PyTorch ops."""
    launches.add(launches.PLAIN, "rms_norm")
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * r * weight.float()).to(x.dtype)


def rms_norm_bwd_plain(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor, eps: float,
                       need_dw: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The backward kernel's function in explicit f32 PyTorch ops:
    ``(dx in x's dtype, dw in w's dtype)``, dw None without ``need_dw``."""
    launches.add(launches.PLAIN, "rms_norm_bwd")
    x32, g32 = x.float(), g.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    gw = g32 * weight.float()
    mean_gwx = (gw * x32).mean(dim=-1, keepdim=True)
    dx = r * gw - x32 * r.pow(3) * mean_gwx
    if not need_dw:
        return dx.to(x.dtype), None
    dw = (g32 * x32 * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(weight.dtype)
