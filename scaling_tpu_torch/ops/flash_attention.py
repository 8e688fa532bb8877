"""Flash attention forward and backward (kernels K4 and K5).

Replaces the TPU kernel behind ``flash_attention_fused`` of
``scaling_tpu/ops/flash_attention.py`` (jax's splash attention, its
forward and its dq / dkv backward passes): causal attention of
``(b, s, n, d)`` queries over UNREPEATED ``(b, s, n_kv, d)`` keys and
values (GQA: query head ``i`` reads KV head ``i // n_rep``), allowed only
within equal ``segment_ids`` (packed documents); the trailing
``num_local_heads`` query heads also need ``q - local_window <= k``.

Numerics follow the JAX wrapper: ``flash_attention`` multiplies q by
``sm_scale`` in q's dtype BEFORE the kernel, so the kernels take no scale
and autograd carries the scale into dq; the softmax is f32; the output
is cast to q's dtype; the forward also returns the f32 log-sum-exp
``(b, n, s)`` that the backward recomputes the probabilities from.

The kernels are CUDA C++ for Hopper (``csrc/flash_attention.cu``, built
with nvcc for sm_90a and called through ctypes); the source's note says
what bounds them and how they are laid out. Beside them,
``flash_attention_plain`` and ``flash_attention_bwd_plain`` compute the
same functions with plain PyTorch ops (``repeat_kv`` and a masked f32
softmax; the backward by its explicit formulas, not autograd).

Dispatch goes by the tensor's device: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version. ``FlashAttention`` is
the ``torch.autograd.Function`` whose forward is K4 and whose backward is
K5, so the CPU tests run the same Function the card runs.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import cuda_build, launches

TILE = 64  # q and kv rows per tile in the kernels; the sequence must be a multiple
HEAD_DIMS = (64, 128)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """At least f32 (f64 stays f64, so gradcheck can hold the formulas)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(b, s, n_kv, d) -> (b, s, n_kv * n_rep, d), head ``i`` from ``i // n_rep``."""
    return x if n_rep == 1 else x.repeat_interleave(n_rep, dim=2)


def attention_allowed(segment_ids: torch.Tensor, n: int, num_local_heads: int,
                      local_window: Optional[int]) -> torch.Tensor:
    """(b, n, s, s) bool: query ``q`` may attend key ``k`` in head ``h``."""
    s = segment_ids.shape[1]
    idx = torch.arange(s, device=segment_ids.device)
    rel = idx[:, None] - idx[None, :]  # q - k
    same = segment_ids[:, :, None] == segment_ids[:, None, :]  # (b, s, s)
    allowed = (same & (rel >= 0)[None])[:, None].expand(-1, n, -1, -1)
    if num_local_heads > 0:
        local = (rel <= local_window)[None, None]
        is_local = (torch.arange(n, device=segment_ids.device) >= n - num_local_heads)
        allowed = allowed & (local | ~is_local[None, :, None, None])
    return allowed


def flash_attention_plain(q, k, v, segment_ids, num_local_heads: int = 0,
                          local_window: Optional[int] = None):
    """K4's function in plain PyTorch: ``(out (b, s, n, d) in q's dtype,
    lse (b, n, s) f32)``. q is already scaled."""
    launches.add(launches.PLAIN, "flash_attention_fwd")
    b, s, n, d = q.shape
    n_rep = n // k.shape[2]
    kr, vr = _repeat_kv(_f32(k), n_rep), _repeat_kv(_f32(v), n_rep)
    scores = torch.einsum("bqnd,bknd->bnqk", _f32(q), kr)
    allowed = attention_allowed(segment_ids, n, num_local_heads, local_window)
    scores = scores.masked_fill(~allowed, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)  # (b, n, s); the diagonal is always allowed
    probs = torch.exp(scores - lse[..., None])
    out = torch.einsum("bnqk,bknd->bqnd", probs, vr)
    return out.to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, out, lse, dout, segment_ids,
                              num_local_heads: int = 0,
                              local_window: Optional[int] = None):
    """K5's function in plain PyTorch, by the explicit formulas:
    ``P = exp(S - lse)``, ``D = rowsum(dO * O)``, ``dS = P * (dP - D)``,
    ``dQ = dS K``, ``dK = dS^T Q`` and ``dV = P^T dO``, the last two summed
    over each GQA group. Returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    launches.add(launches.PLAIN, "flash_attention_bwd")
    b, s, n, d = q.shape
    n_kv = k.shape[2]
    n_rep = n // n_kv
    q32, do32 = _f32(q), _f32(dout)
    kr, vr = _repeat_kv(_f32(k), n_rep), _repeat_kv(_f32(v), n_rep)
    scores = torch.einsum("bqnd,bknd->bnqk", q32, kr)
    allowed = attention_allowed(segment_ids, n, num_local_heads, local_window)
    probs = torch.where(allowed, torch.exp(scores - lse[..., None]), 0.0)
    delta = (do32 * _f32(out)).sum(-1).transpose(1, 2)  # (b, n, s)
    dprobs = torch.einsum("bqnd,bknd->bnqk", do32, vr)
    dscores = probs * (dprobs - delta[..., None])
    dq = torch.einsum("bnqk,bknd->bqnd", dscores, kr)
    dk = torch.einsum("bnqk,bqnd->bknd", dscores, q32)
    dv = torch.einsum("bnqk,bqnd->bknd", probs, do32)
    dk = dk.reshape(b, s, n_kv, n_rep, d).sum(3)
    dv = dv.reshape(b, s, n_kv, n_rep, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_fwd(q, k, v, segment_ids, num_local_heads: int = 0,
                        local_window: Optional[int] = None):
    """K4: ``(out, lse)``; the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, segment_ids, num_local_heads, local_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _launch_fwd(q, k, v, segment_ids, num_local_heads, local_window)


def flash_attention_bwd(q, k, v, out, lse, dout, segment_ids,
                        num_local_heads: int = 0, local_window: Optional[int] = None):
    """K5: ``(dq, dk, dv)``; the kernels for CUDA tensors, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, segment_ids,
                                         num_local_heads, local_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _launch_bwd(q, k, v, out, lse, dout, segment_ids, num_local_heads,
                       local_window)


class FlashAttention(torch.autograd.Function):
    """Forward K4, backward K5. Saves q, k, v, the output and the f32 lse;
    the probabilities are recomputed in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, num_local_heads, local_window):
        out, lse = flash_attention_fwd(q, k, v, segment_ids, num_local_heads,
                                       local_window)
        ctx.save_for_backward(q, k, v, segment_ids, out, lse)
        ctx.local = (num_local_heads, local_window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, segment_ids, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         segment_ids, *ctx.local)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    segment_ids: Optional[torch.Tensor] = None, *,
                    sm_scale: float = 1.0, num_local_heads: int = 0,
                    local_window: Optional[int] = None) -> torch.Tensor:
    """Causal flash attention, ``(b, s, n, d)`` out in q's dtype.

    q ``(b, s, n, d)``; k, v ``(b, s, n_kv, d)`` unrepeated; segment_ids
    ``(b, s)`` (None: one document per row). q is scaled by ``sm_scale``
    in its own dtype first, as the JAX wrapper does."""
    b, s, n, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != d or n % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} do not fit")
    if num_local_heads > 0 and local_window is None:
        raise ValueError("flash_attention: local heads need a local_window")
    if segment_ids is None:
        segment_ids = torch.zeros(b, s, dtype=torch.int32, device=q.device)
    q = q * torch.tensor(sm_scale, dtype=q.dtype)
    return FlashAttention.apply(q, k, v, segment_ids.to(torch.int32).contiguous(),
                                int(num_local_heads),
                                None if local_window is None else int(local_window))


# ------------------------------------------------------------------ the card
def _check_operand(t: torch.Tensor, what: str, q: torch.Tensor) -> None:
    if t.device != q.device:
        raise ValueError(f"flash_attention: {what} on {t.device}, q on {q.device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention: {what} is {t.dtype}; the kernels take bfloat16")
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(
            f"flash_attention: {what} needs a unit last stride, strides that are "
            "multiples of 8 and 16-byte alignment (the kernels copy by TMA)")


def _check_shapes(q, k, v, segment_ids, num_local_heads, local_window):
    b, s, n, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not supported {HEAD_DIMS}")
    if s % TILE:
        raise ValueError(f"flash_attention: sequence {s} is not a multiple of {TILE}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _check_operand(t, what, q)
    if tuple(segment_ids.shape) != (b, s) or segment_ids.dtype != torch.int32 \
            or not segment_ids.is_contiguous() or segment_ids.device != q.device:
        raise ValueError("flash_attention: segment_ids must be contiguous int32 (b, s) "
                         "on q's device")
    if not 0 <= num_local_heads <= n:
        raise ValueError(f"flash_attention: {num_local_heads} local heads of {n}")
    return num_local_heads, (local_window if num_local_heads else 0)


def _strides(*tensors) -> ctypes.Array:
    vals = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _launch_fwd(q, k, v, segment_ids, num_local_heads, local_window):
    n_local, window = _check_shapes(q, k, v, segment_ids, num_local_heads, local_window)
    b, s, n, d = q.shape
    lib = _library()
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty(b, n, s, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd_launch(
            d, q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, s, n, k.shape[2],
            _strides(q, k, v, out), n_local, window, stream)
    _raise_on(lib, err, "flash_attention_fwd")
    launches.add(launches.KERNEL, "flash_attention_fwd")
    return out, lse


def _launch_bwd(q, k, v, out, lse, dout, segment_ids, num_local_heads, local_window):
    n_local, window = _check_shapes(q, k, v, segment_ids, num_local_heads, local_window)
    b, s, n, d = q.shape
    for t, what in ((out, "out"), (dout, "dout")):
        _check_operand(t, what, q)
        if t.shape != q.shape:
            raise ValueError(f"flash_attention: {what} {tuple(t.shape)} != q {tuple(q.shape)}")
    if lse.shape != (b, n, s) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attention: lse must be contiguous f32 (b, n, s)")
    lib = _library()
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    delta = torch.empty(b, n, s, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_launch(
            d, q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(),
            out.data_ptr(), lse.data_ptr(), dout.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, n, k.shape[2],
            _strides(q, k, v, out, dout, dq, dk, dv), n_local, window, stream)
    _raise_on(lib, err, "flash_attention_bwd")
    launches.add(launches.KERNEL, "flash_attention_bwd")
    return dq, dk, dv


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("flash_attention")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_longlong)
        lib.flash_attention_fwd_launch.argtypes = [
            ci, vp, vp, vp, vp, vp, vp,          # head_dim, q, k, v, seg, out, lse
            ci, ci, ci, ci, strides, ci, ci, vp,  # b, s, n, n_kv, strides, local, window, stream
        ]
        lib.flash_attention_bwd_launch.argtypes = [
            ci, vp, vp, vp, vp, vp, vp, vp, vp,  # head_dim, q, k, v, seg, out, lse, dout, delta
            vp, vp, vp,                          # dq, dk, dv
            ci, ci, ci, ci, strides, ci, ci, vp,
        ]
        lib.flash_attention_fwd_launch.restype = ci
        lib.flash_attention_bwd_launch.restype = ci
        lib.flash_attention_error_string.argtypes = [ci]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_smem_bytes.argtypes = [ci, ci]  # head_dim, kernel
        lib.flash_attention_smem_bytes.restype = ci
        lib._argtypes_set = True
    return lib


__all__ = [
    "FlashAttention",
    "attention_allowed",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "flash_attention_fwd",
    "flash_attention_plain",
]
