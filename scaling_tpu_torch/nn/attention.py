"""Self attention (counterpart of scaling_tpu/nn/attention.py).

Projections (fused or separate, GQA through ``num_kv_heads``), optional
key/query norm (over the head dim, before rotary), rotary or none, then
one of three attention paths, and the output projection:

- the paged serving path: the block-paged KV pool view and its writer,
  kernel K1 over the pool;
- the dense KV cache of ``generate``: a ``(k, v)`` or ``(k, v, segment
  ids)`` tuple of ``(b, max_len, ...)`` buffers, written at
  ``cache_offset`` (``dense_kv_write``); queries attend unfused over the
  written slots with grouped products over the unrepeated K/V, causal by
  slot, within equal segment ids when the cache
  carries them, with an optional additive score term (the left-pad mask
  of ragged prompts). Under left padding a row's rotary positions lag its
  slots: ``position_ids`` stay the rotary clock, the slots the causal one;
- no cache (training, prefill, full-sequence logits): causal attention
  within equal ``segment_ids`` (packed documents), optional trailing
  local-window heads. ``flash_path_active`` decides, as in the JAX layer,
  between the flash kernels (K4 forward, K5 backward,
  ``ops.flash_attention``) with unrepeated KV, and the unfused path
  (``multi_head_attention`` over a ``segment_ids_to_mask`` mask and
  ``MaskedSoftmax``). There is no TPU gate here: on the CPU the flash
  path runs the kernels' plain versions.

Context parallelism, LoRA, multiplicative score manipulation and
attention-probability dropout are not ported.

The pool and the dense cache are updated IN PLACE: the writers put the
new tokens' K/V into the tensors the caller holds, so no updated caches
are handed back (the JAX package returns new arrays and absorbs them).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..ops.flash_attention import HEAD_DIMS, flash_attention
from ..ops.paged_attention import paged_attention
from .linear import Linear
from .masked_softmax import MaskedSoftmax, MaskedSoftmaxConfig
from .norm import get_norm
from .seq_packing import segment_ids_to_mask

FLASH_MIN_BLOCK = 128  # the flash path needs seq % 128 == 0 (the JAX gate's rule)


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


def dense_kv_write(cache: Tuple[torch.Tensor, ...], k: torch.Tensor, v: torch.Tensor,
                   offset: int, segment_ids: Optional[torch.Tensor] = None) -> None:
    """Write ``s`` new tokens' K/V (and, into a 3-tuple cache, their
    segment ids) at slots ``offset .. offset + s - 1`` of every row of a
    dense ``(b, max_len, ...)`` cache, in place, in the cache's dtype."""
    s = k.shape[1]
    cache[0][:, offset:offset + s] = k
    cache[1][:, offset:offset + s] = v
    if len(cache) == 3:
        cache[2][:, offset:offset + s] = 0 if segment_ids is None else segment_ids


def flash_path_active(*, kernel_is_flash: bool, causal: bool,
                      dropout_attention_probs: float, deterministic: bool,
                      context_parallel_size: int, seq_len: int, head_dim: int,
                      dtype: torch.dtype, has_kv_cache: bool = False,
                      has_scores_manipulation: bool = False) -> bool:
    """The flash-vs-unfused gate of the JAX layer (``flash_path_active``),
    without its TPU platform check: causal, no cache, no probability
    dropout, no context parallelism and ``seq_len % 128 == 0``. Where the
    JAX gate routes every ``head_dim >= 64`` and every dtype to splash,
    this one routes only what K4/K5 are built for: the head dims
    ``HEAD_DIMS`` in bf16. Any other head dim or dtype goes to the unfused
    path, as ``head_dim < 64`` does in both packages. The route depends on
    shapes and dtypes alone, so it is the same on the CPU and on the card."""
    if not kernel_is_flash or has_kv_cache or has_scores_manipulation:
        return False
    if not causal or context_parallel_size > 1:
        return False
    if dropout_attention_probs > 0.0 and not deterministic:
        return False
    return (seq_len % FLASH_MIN_BLOCK == 0 and head_dim in HEAD_DIMS
            and dtype == torch.bfloat16)


def multi_head_attention(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                         mask: torch.Tensor, scaling_factor: float,
                         softmax: MaskedSoftmax,
                         scores_manipulation: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unfused attention: QK^T -> masked softmax -> PV. q (b, s_q, n, h),
    k/v (b, s_k, n_kv, h) with ``n_kv`` dividing ``n``: query head ``i``
    reads kv head ``i // (n / n_kv)``, as ``repeat_kv`` lays them out, and
    the grouped products read each kv head once, with no repeated copy.
    mask (b, 1, s_q, s_k) True = forbidden, ``scores_manipulation`` added
    to the scaled scores (log-additive). Returns (b, s_q, n, h)."""
    b, s_q, n, h = query.shape
    n_kv = key.shape[2]
    q = query.reshape(b, s_q, n_kv, n // n_kv, h)
    scores = torch.einsum("bqgrh,bkgh->bgrqk", q, key).reshape(b, n, s_q, -1) * scaling_factor
    if scores_manipulation is not None:
        scores = scores + scores_manipulation.to(scores.dtype)
    probs = softmax(scores, mask).reshape(b, n_kv, n // n_kv, s_q, -1)
    out = torch.einsum("bgrqk,bkgh->bqgrh", probs.to(value.dtype), value)
    return out.reshape(b, s_q, n, h)


class ParallelSelfAttention(torch.nn.Module):
    """Projections -> key/query norm -> rotary -> attention -> output
    projection. With a paged KV view: kernel K1 over the pool; with a dense
    cache tuple: unfused attention over its slots; without a cache: flash
    (K4/K5) or unfused attention over the sequence."""

    def __init__(self, hidden_size: int, num_attention_heads: int,
                 num_kv_heads: Optional[int] = None, qkv_in_one: bool = False,
                 bias: bool = True, rotary: Optional[torch.nn.Module] = None,
                 scaling_factor: Optional[float] = None,
                 masked_softmax_config: Optional[MaskedSoftmaxConfig] = None,
                 causal: bool = True, num_local_attention_heads: int = 0,
                 local_attention_window_size: Optional[int] = None,
                 dropout_attention_probs: float = 0.0, key_query_norm: bool = False,
                 norm_type: str = "layernorm", norm_eps: float = 1e-5,
                 fused_norm: bool = False,
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
        self.key_query_norm = key_query_norm
        if key_query_norm:
            norm = dict(eps=norm_eps, fused=fused_norm, dtype=dtype, device=device)
            self.norm_query = get_norm(norm_type, self.head_dim, **norm)
            self.norm_key = get_norm(norm_type, self.head_dim, **norm)
        self.masked_softmax = MaskedSoftmax(masked_softmax_config or MaskedSoftmaxConfig())
        self.use_flash = self.masked_softmax.config.kernel == "flash_attention"
        self.causal = causal
        if num_local_attention_heads > 0 and local_attention_window_size is None:
            raise ValueError("local_attention_window_size needs to be set with "
                             "num_local_attention_heads")
        self.num_local_attention_heads = num_local_attention_heads
        self.local_attention_window_size = local_attention_window_size
        self.dropout_attention_probs = dropout_attention_probs

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
                kv_cache=None, segment_ids: Optional[torch.Tensor] = None,
                cache_offset: Optional[int] = None,
                scores_manipulation: Optional[torch.Tensor] = None,
                return_kv: bool = False):
        """``kv_cache``: a ``PagedKVCacheView``, a dense cache tuple written
        at ``cache_offset``, or None. Returns the output, or ``(output,
        (k, v))`` with ``return_kv`` (the new tokens' K/V after rotary)."""
        q, k, v = self._qkv(x)
        if self.key_query_norm:
            q, k = self.norm_query(q), self.norm_key(k)
        if self.rotary_embedding is not None:
            q, k = self.rotary_embedding(q, k, position_ids)
        if kv_cache is not None and (self.num_local_attention_heads or not self.causal):
            raise NotImplementedError(
                "the cached decode paths are causal and have no local-window heads")
        if isinstance(kv_cache, PagedKVCacheView):
            out = self._paged_attention(q, k, v, kv_cache)
        elif kv_cache is not None:
            out = self._dense_cache_attention(q, k, v, kv_cache, cache_offset, segment_ids,
                                              scores_manipulation)
        else:
            out = self._attention(q, k, v, segment_ids, scores_manipulation)
        out = self._project_out(out)
        return (out, (k, v)) if return_kv else out

    def _attention(self, q, k, v, segment_ids: Optional[torch.Tensor],
                   scores_manipulation: Optional[torch.Tensor] = None) -> torch.Tensor:
        """No cache: the training forward (``ParallelSelfAttention.__call__``
        of the JAX layer without context parallelism)."""
        b, s = q.shape[:2]
        if segment_ids is None:
            segment_ids = torch.zeros(b, s, dtype=torch.int32, device=q.device)
        if self.dropout_attention_probs > 0.0 and self.training:
            raise NotImplementedError("attention-probability dropout is not ported")
        n_local = self.num_local_attention_heads
        if flash_path_active(
            kernel_is_flash=self.use_flash, causal=self.causal,
            dropout_attention_probs=self.dropout_attention_probs,
            deterministic=not self.training, context_parallel_size=1,
            seq_len=s, head_dim=self.head_dim, dtype=q.dtype,
            has_scores_manipulation=scores_manipulation is not None,
        ):
            return flash_attention(q, k, v, segment_ids, sm_scale=self.scaling_factor,
                                   num_local_heads=n_local,
                                   local_window=self.local_attention_window_size)
        mask = segment_ids_to_mask(segment_ids, causal=self.causal)
        if n_local == 0:
            return multi_head_attention(q, k, v, mask, self.scaling_factor,
                                        self.masked_softmax, scores_manipulation)
        # mixed heads: the first n - n_local global, the last n_local in the window
        k = repeat_kv(k, self.num_repeat_kv)
        v = repeat_kv(v, self.num_repeat_kv)
        local_mask = segment_ids_to_mask(segment_ids, causal=self.causal,
                                         local_window=self.local_attention_window_size)
        n_global = self.num_attention_heads - n_local
        out_l = multi_head_attention(q[:, :, n_global:], k[:, :, n_global:],
                                     v[:, :, n_global:], local_mask,
                                     self.scaling_factor, self.masked_softmax,
                                     scores_manipulation)
        if n_global == 0:
            return out_l
        out_g = multi_head_attention(q[:, :, :n_global], k[:, :, :n_global],
                                     v[:, :, :n_global], mask, self.scaling_factor,
                                     self.masked_softmax, scores_manipulation)
        return torch.cat([out_g, out_l], dim=2)

    def _dense_cache_attention(self, q, k, v, cache, offset: int,
                               segment_ids: Optional[torch.Tensor],
                               scores_manipulation: Optional[torch.Tensor]) -> torch.Tensor:
        """Write the ``s`` new tokens at slots ``offset..``, then attend
        over the written slots ``0 .. offset + s - 1`` alone, each query at
        or before its own slot (and, with a 3-tuple cache, in its segment).
        ``scores_manipulation`` spans the whole cache and is cut to them."""
        b, s = q.shape[:2]
        dense_kv_write(cache, k, v, offset, segment_ids)
        end = offset + s
        slots_k = torch.arange(end, device=q.device)
        slots_q = offset + torch.arange(s, device=q.device)
        allowed = (slots_k[None, :] <= slots_q[:, None])[None]  # (1, s, end)
        if len(cache) == 3:
            seg_q = (torch.zeros(b, s, dtype=cache[2].dtype, device=q.device)
                     if segment_ids is None else segment_ids)
            allowed = allowed & (cache[2][:, None, :end] == seg_q[:, :, None])
        if scores_manipulation is not None:
            scores_manipulation = scores_manipulation[..., :end]
        return multi_head_attention(q, cache[0][:, :end], cache[1][:, :end], ~allowed[:, None],
                                    self.scaling_factor, self.masked_softmax,
                                    scores_manipulation)

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
