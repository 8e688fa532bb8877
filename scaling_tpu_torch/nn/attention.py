"""Self attention, serving half (counterpart of scaling_tpu/nn/attention.py).

What the paged serving path needs: the q/k/v projections (fused or
separate, GQA through ``num_kv_heads``), rotary, the block-paged KV pool
view and its writer, kernel K1 over the pool, and the output projection.
Training attention (the unfused softmax, flash, context parallelism,
local heads, LoRA) is not ported yet.

The pool is updated IN PLACE: ``paged_scatter_kv`` writes the new
tokens' K/V into the pool tensors the view holds, so no updated pools
are handed back (the JAX package returns new arrays and absorbs them).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..ops.paged_attention import paged_attention
from .linear import Linear
from .rotary import RotaryEmbedding


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(b, s, n_kv, h) -> (b, s, n_kv * n_rep, h) for GQA."""
    if n_rep == 1:
        return x
    b, s, n_kv, h = x.shape
    return x[:, :, :, None, :].expand(b, s, n_kv, n_rep, h).reshape(b, s, n_kv * n_rep, h)


@dataclasses.dataclass
class PagedKVCacheView:
    """One layer's slice of the block-paged KV pool plus the batch's
    addressing state. Block 0 is the trash block: it absorbs writes from
    inactive rows and padding.

    ``pool_k``/``pool_v`` are ``(num_blocks, block_size, n_kv, h)``, in the
    model dtype or int8 with per-slot-per-head ``scale_k``/``scale_v`` of
    shape ``(num_blocks, block_size, n_kv)``. ``new_len`` (per row) is how
    many of the ``s`` presented tokens are real; None means all of them."""

    pool_k: torch.Tensor
    pool_v: torch.Tensor
    block_table: torch.Tensor  # (b, max_blocks) int32; 0 = trash
    context_len: torch.Tensor  # (b,) int32 tokens already cached per row
    scale_k: Optional[torch.Tensor] = None
    scale_v: Optional[torch.Tensor] = None
    new_len: Optional[torch.Tensor] = None  # (b,) int32

    @property
    def quantized(self) -> bool:
        return self.scale_k is not None


def kv_quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token-per-head int8: ``x`` (..., n_kv, h) -> (q, scale)
    with ``scale`` (..., n_kv) f32. ``torch.round`` rounds half to even,
    like ``jnp.round``."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def paged_flat_slots(block_table: torch.Tensor, positions: torch.Tensor,
                     block_size: int) -> torch.Tensor:
    """Per-row logical ``positions`` (b, s) -> flat pool slots
    ``block_id * block_size + offset`` through each row's block table.
    Positions past the table's reach go to the trash block, never into
    the row's last real block."""
    max_blocks = block_table.shape[1]
    positions = positions.long()
    blk_idx = positions // block_size
    blocks = torch.gather(block_table.long(), 1, blk_idx.clamp(0, max_blocks - 1))
    blocks = torch.where(blk_idx < max_blocks, blocks, 0)
    return blocks * block_size + positions % block_size


def paged_scatter_kv(view: PagedKVCacheView, flat: torch.Tensor,
                     k_rows: torch.Tensor, v_rows: torch.Tensor) -> None:
    """Write new K/V rows ``(n, n_kv, h)`` into the pool at flat slots
    ``flat`` ``(n,)``, quantising when the pool is int8 — in place. The
    order of duplicate writes (padding into the trash block) is undefined."""
    num_blocks, block_size, n_kv, h = view.pool_k.shape
    flat = flat.long()
    pk = view.pool_k.view(num_blocks * block_size, n_kv, h)
    pv = view.pool_v.view(num_blocks * block_size, n_kv, h)
    if view.quantized:
        qk, sk = kv_quantize_int8(k_rows)
        qv, sv = kv_quantize_int8(v_rows)
        pk.index_copy_(0, flat, qk)
        pv.index_copy_(0, flat, qv)
        view.scale_k.view(num_blocks * block_size, n_kv).index_copy_(0, flat, sk)
        view.scale_v.view(num_blocks * block_size, n_kv).index_copy_(0, flat, sv)
    else:
        pk.index_copy_(0, flat, k_rows.to(pk.dtype))
        pv.index_copy_(0, flat, v_rows.to(pv.dtype))


class ParallelSelfAttention(torch.nn.Module):
    """Projections -> rotary -> paged attention (K1) -> output projection."""

    def __init__(self, hidden_size: int, num_attention_heads: int,
                 num_kv_heads: Optional[int] = None, qkv_in_one: bool = False,
                 bias: bool = True, rotary: Optional[RotaryEmbedding] = None,
                 scaling_factor: Optional[float] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if hidden_size % num_attention_heads:
            raise ValueError("hidden_size must divide over num_attention_heads")
        self.hidden_size = hidden_size
        self.num_attention_heads = num_attention_heads
        self.head_dim = hidden_size // num_attention_heads
        self.num_kv_heads = num_kv_heads or num_attention_heads
        if num_attention_heads % self.num_kv_heads:
            raise ValueError("num_attention_heads must divide over the kv heads")
        self.num_repeat_kv = num_attention_heads // self.num_kv_heads
        if qkv_in_one and self.num_repeat_kv != 1:
            raise ValueError("a fused qkv weight cannot hold differing kv heads")
        self.qkv_in_one = qkv_in_one
        self.scaling_factor = (
            scaling_factor if scaling_factor is not None
            else 1.0 / math.sqrt(self.head_dim)
        )
        common = dict(bias=bias, dtype=dtype, device=device)
        if qkv_in_one:
            self.query_key_value = Linear(hidden_size, 3 * hidden_size, **common)
        else:
            kv_size = self.num_kv_heads * self.head_dim
            self.query = Linear(hidden_size, hidden_size, **common)
            self.key = Linear(hidden_size, kv_size, **common)
            self.value = Linear(hidden_size, kv_size, **common)
        self.dense = Linear(hidden_size, hidden_size, **common)
        self.rotary_embedding = rotary

    def _qkv(self, x: torch.Tensor):
        b, s, _ = x.shape
        if self.qkv_in_one:
            qkv = self.query_key_value(x).reshape(
                b, s, self.num_attention_heads, 3 * self.head_dim
            )
            return qkv.split(self.head_dim, dim=-1)
        q = self.query(x).reshape(b, s, self.num_attention_heads, self.head_dim)
        k = self.key(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.value(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        return q, k, v

    def forward(self, x: torch.Tensor, position_ids: torch.Tensor,
                kv_cache: PagedKVCacheView) -> torch.Tensor:
        q, k, v = self._qkv(x)
        if self.rotary_embedding is not None:
            q, k = self.rotary_embedding(q, k, position_ids)
        out = self._paged_attention(q, k, v, kv_cache)
        return self._project_out(out)

    def _paged_attention(self, q, k, v, view: PagedKVCacheView) -> torch.Tensor:
        """Scatter the ``s`` new tokens per row into the pool (padding past
        ``new_len`` into the trash block), then attend each row over its
        blocks with kernel K1."""
        b, s = q.shape[:2]
        block_size = view.pool_k.shape[1]
        ctx_len = view.context_len.int()
        if view.new_len is None:
            new_len = torch.full((b,), s, dtype=torch.int32, device=q.device)
        else:
            new_len = view.new_len.int()
        steps = torch.arange(s, dtype=torch.int32, device=q.device)[None, :]
        positions = ctx_len[:, None] + steps
        flat = paged_flat_slots(view.block_table, positions, block_size)
        flat = torch.where(steps < new_len[:, None], flat, 0)
        paged_scatter_kv(view, flat.reshape(-1),
                         k.reshape(b * s, *k.shape[2:]), v.reshape(b * s, *v.shape[2:]))
        return paged_attention(
            q.contiguous(), view.pool_k, view.pool_v,
            view.block_table.int().contiguous(), (ctx_len + new_len).contiguous(),
            ctx_len.contiguous(),
            sm_scale=self.scaling_factor, num_repeat_kv=self.num_repeat_kv,
            scale_k=view.scale_k, scale_v=view.scale_v,
        )

    def _project_out(self, out: torch.Tensor) -> torch.Tensor:
        b, s = out.shape[:2]
        return self.dense(out.reshape(b, s, self.hidden_size))
