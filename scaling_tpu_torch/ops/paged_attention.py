"""Paged attention over the block-paged KV pool (kernel K1).

Replaces the TPU kernel ``paged_decode_attention`` of
``scaling_tpu/nn/paged_attention.py``: flash-style attention of each
row's queries over the row's pool blocks, addressed through its block
table. Slot ``k`` of a row is visible to its query token ``i`` iff
``k < valid_len[row]`` (written) and ``k <= q_slot_base[row] + i``
(causal). Queries may be one decode token or a prefill chunk; the caller
has already scattered the new tokens' K/V into the pool. The int8 pool
variant dequantises with the per-slot-per-head scales of
``nn.attention.kv_quantize_int8``.

The kernel is CUDA C++ for Hopper (``csrc/paged_attention.cu``, built
with nvcc for sm_90a and called through ctypes); its note says what
bounds it and how it is laid out. For bf16 q it runs its products on
tensor cores and splits each row's context across SMs: the launcher
plans the splits from the host-known window alone (``split_count``,
``split_slots``) and allocates the f32 partials the splits hand to the
merge pass. f32 q takes an exact f32 kernel on CUDA cores, which admits
``block_size * head_dim <= 4096``. Beside them, ``paged_attention_plain``
computes the same function with plain PyTorch ops: it gathers each row's
block window and runs a masked f32 softmax.

Dispatch goes by the tensor's device: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version. Nothing on the card
falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build, launches

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
SPLIT_SLOTS = 512  # slots of a row's context one split walks (8 KV tiles of 64)
Q_ROWS = 128       # query vectors (tokens x query heads of a kv head) one block owns
EXACT_MAX_ELEMS = 4096  # the f32 kernel's block_size * head_dim ceiling


def split_count(max_blocks: int, block_size: int) -> int:
    """Splits of the grid's split axis: the window ``max_blocks *
    block_size`` in ``SPLIT_SLOTS`` pieces, from host-known shapes alone
    (no device sync to learn ``valid_len``)."""
    return -(-max_blocks * block_size // SPLIT_SLOTS)


def split_slots(split: int, valid_len: int, max_blocks: int, block_size: int) -> range:
    """The slots split ``split`` of a row walks, as the kernel computes
    them: its piece of the window, cut at the row's ``valid_len`` (empty
    for a split at or past it, which exits at once)."""
    visible = min(valid_len, max_blocks * block_size)
    start = split * SPLIT_SLOTS
    return range(start, max(start, min(visible, start + SPLIT_SLOTS)))


def paged_attention(
    q: torch.Tensor,            # (rows, s, n, h) rotary-applied queries
    pool_k: torch.Tensor,       # (num_blocks, block_size, n_kv, h)
    pool_v: torch.Tensor,
    block_table: torch.Tensor,  # (rows, max_blocks) int32; 0 = trash
    valid_len: torch.Tensor,    # (rows,) int32 visible slots per row
    q_slot_base: torch.Tensor,  # (rows,) int32 slot of the first query
    *,
    sm_scale: float,
    num_repeat_kv: int = 1,
    scale_k: Optional[torch.Tensor] = None,  # (num_blocks, block_size, n_kv)
    scale_v: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns ``(rows, s, n, h)`` in q's dtype."""
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, pool_k, pool_v, block_table, valid_len, q_slot_base,
            sm_scale=sm_scale, num_repeat_kv=num_repeat_kv,
            scale_k=scale_k, scale_v=scale_v,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    return _launch(q, pool_k, pool_v, block_table, valid_len, q_slot_base,
                   sm_scale, num_repeat_kv, scale_k, scale_v)


def _check(t: torch.Tensor, what: str, device, dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"paged_attention: {what} on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise ValueError(f"paged_attention: {what} is {t.dtype}, needs {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"paged_attention: {what} has shape {tuple(t.shape)}, needs {tuple(shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"paged_attention: {what} must be contiguous")


def _launch(q, pool_k, pool_v, block_table, valid_len, q_slot_base,
            sm_scale, num_repeat_kv, scale_k, scale_v) -> torch.Tensor:
    rows, s, n, h = q.shape
    num_blocks, block_size, n_kv, _ = pool_k.shape
    max_blocks = block_table.shape[1]
    quantized = scale_k is not None
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"paged_attention: q dtype {q.dtype} not supported")
    if h not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head dim {h} not supported {HEAD_DIMS}")
    if q.dtype == torch.float32 and block_size * h > EXACT_MAX_ELEMS:
        raise ValueError(
            f"paged_attention: f32 q takes the exact kernel, which needs block_size "
            f"{block_size} x head dim {h} <= {EXACT_MAX_ELEMS}")
    if n != n_kv * num_repeat_kv:
        raise ValueError(
            f"paged_attention: {n} query heads != {n_kv} kv heads x {num_repeat_kv}"
        )
    dev = q.device
    pool_shape = (num_blocks, block_size, n_kv, h)
    pool_dtype = torch.int8 if quantized else q.dtype
    _check(q, "q", dev, q.dtype, (rows, s, n, h))
    _check(pool_k, "pool_k", dev, pool_dtype, pool_shape)
    _check(pool_v, "pool_v", dev, pool_dtype, pool_shape)
    if any(t.data_ptr() % 16 for t in (q, pool_k, pool_v)):
        raise ValueError("paged_attention: q and the pools must be 16-byte aligned")
    if quantized:
        if scale_v is None:
            raise ValueError("paged_attention: scale_k given without scale_v")
        _check(scale_k, "scale_k", dev, torch.float32, pool_shape[:3])
        _check(scale_v, "scale_v", dev, torch.float32, pool_shape[:3])
    _check(block_table, "block_table", dev, torch.int32, (rows, max_blocks))
    _check(valid_len, "valid_len", dev, torch.int32, (rows,))
    _check(q_slot_base, "q_slot_base", dev, torch.int32, (rows,))

    lib = _library()
    out = torch.empty_like(q)
    n_splits = split_count(max_blocks, block_size)
    part_o = part_ml = None
    if q.dtype == torch.bfloat16 and n_splits > 1:
        units = rows * n_kv * -(-s * num_repeat_kv // Q_ROWS) * n_splits * Q_ROWS
        part_o = torch.empty(units * h, dtype=torch.float32, device=dev)
        part_ml = torch.empty(units * 2, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paged_attention_launch(
            _DTYPE_CODES[q.dtype], int(quantized), h,
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            scale_k.data_ptr() if quantized else None,
            scale_v.data_ptr() if quantized else None,
            block_table.data_ptr(), valid_len.data_ptr(), q_slot_base.data_ptr(),
            out.data_ptr(), None if part_o is None else part_o.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            rows, s, n, n_kv, block_size, max_blocks, SPLIT_SLOTS, n_splits,
            float(sm_scale), stream,
        )
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: {msg} ({err})")
    launches.KERNEL["paged_attention_int8" if quantized else "paged_attention"] += 1
    return out


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("paged_attention")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_launch.argtypes = [
            ci, ci, ci,                 # dtype, quantized, head_dim
            vp, vp, vp, vp, vp,         # q, pool_k, pool_v, scale_k, scale_v
            vp, vp, vp, vp,             # table, valid_len, q_slot_base, out
            vp, vp,                     # part_o, part_ml
            ci, ci, ci, ci, ci, ci,     # rows, s, n, n_kv, block_size, max_blocks
            ci, ci,                     # split_slots, n_splits
            ctypes.c_float, vp,         # sm_scale, stream
        ]
        lib.paged_attention_launch.restype = ci
        lib.paged_attention_error_string.argtypes = [ci]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def paged_attention_plain(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    block_table: torch.Tensor,
    valid_len: torch.Tensor,
    q_slot_base: torch.Tensor,
    *,
    sm_scale: float,
    num_repeat_kv: int = 1,
    scale_k: Optional[torch.Tensor] = None,
    scale_v: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather each row's block
    window, dequantise, masked f32 softmax. A row with no visible slot
    gives zeros (the kernel's safe shift and ``l == 0`` guard)."""
    launches.PLAIN["paged_attention_int8" if scale_k is not None
                   else "paged_attention"] += 1
    rows, s, n, h = q.shape
    _, block_size, n_kv, _ = pool_k.shape
    window = block_table.shape[1] * block_size
    tab = block_table.long()
    gk = pool_k[tab].reshape(rows, window, n_kv, h).float()
    gv = pool_v[tab].reshape(rows, window, n_kv, h).float()
    if scale_k is not None:
        gk = gk * scale_k[tab].reshape(rows, window, n_kv, 1).float()
        gv = gv * scale_v[tab].reshape(rows, window, n_kv, 1).float()
    # query head kv * n_rep + r reads kv head kv (the GQA repeat order)
    qg = q.float().reshape(rows, s, n_kv, num_repeat_kv, h)
    scores = torch.einsum("bsgrh,bkgh->bgrsk", qg, gk) * sm_scale
    slots = torch.arange(window, device=q.device)
    q_slot = q_slot_base.long()[:, None] + torch.arange(s, device=q.device)
    allowed = (slots[None, None, :] < valid_len.long()[:, None, None]) & (
        slots[None, None, :] <= q_slot[:, :, None]
    )  # (rows, s, window)
    scores = scores.masked_fill(~allowed[:, None, None], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True).permute(0, 3, 1, 2, 4)  # (b, s, g, r, 1)
    out = torch.einsum("bgrsk,bkgh->bsgrh", p, gv) / torch.where(l == 0, 1.0, l)
    return out.reshape(rows, s, n, h).to(q.dtype)
