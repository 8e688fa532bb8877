"""Ulysses attention: context parallelism by all-to-all over the context
group (counterpart of scaling_tpu/ops/ulysses_attention.py).

Each context rank holds a contiguous ``1/cp`` of the sequence for all of
its heads. Three all-to-alls (q, k, v: ``collectives.all_to_all``, whose
backward is the inverse exchange) trade that for the whole sequence of
``1/cp`` of the heads, K/V unrepeated (GQA: they travel with their
``n_kv/cp`` head shard), and the segment ids are all-gathered. Attention
then runs on the whole sequence, and a fourth all-to-all gives each rank
its sequence slice of every head back.

After the exchange the local attention is the one-rank causal attention of
a head shard, the flash kernels' work: where ``nn.attention.flash_path_active``
takes the shape (causal, ``seq % 128 == 0``, head dim 64 or 128, bf16, the
context counted out) it runs K4 forward and K5 backward
(``ops.flash_attention``); otherwise the grouped-query attention with a
stable f32 softmax that JAX's fallback computes, as JAX's gate routes it.

Bytes a call (``collectives.STATS``), b, s_loc, n, n_kv, d and the element
size e: forward all-to-alls of ``b·s_loc·n·d·e`` (q and the output) and
``b·s_loc·n_kv·d·e`` (k and v), an all-gather of ``cp·b·s_loc·4`` (the
segment ids); backward the same four all-to-alls (the output's gradient,
then dq, dk and dv).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.collectives import all_gather_cat, all_to_all

_NEG = -1e9


def _grouped_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       seg: torch.Tensor, causal: bool, sm_scale: float) -> torch.Tensor:
    """JAX's fallback: ``(b, s, n, d)`` over unrepeated ``(b, s, n_kv, d)``
    K/V in f32, masked rows zeroed, out in q's dtype."""
    b, s, n, d = q.shape
    n_kv = k.shape[2]
    g = n // n_kv
    qf = q.float().reshape(b, s, n_kv, g, d) * sm_scale
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    allowed = seg[:, :, None] == seg[:, None, :]
    if causal:
        pos = torch.arange(s, device=q.device)
        allowed = allowed & (pos[None, None, :] <= pos[None, :, None])
    masked = allowed[:, None, None]
    scores = torch.where(masked, scores, _NEG)
    m = scores.amax(dim=-1, keepdim=True)
    # a fully masked row has exp(_NEG - _NEG) = 1: the mask kills it
    p = torch.exp(scores - m) * masked
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p / l, v.float())
    return out.reshape(b, s, n, d).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      segment_ids: Optional[torch.Tensor], context, causal: bool = True,
                      sm_scale: float = 1.0) -> torch.Tensor:
    """Attention of this context rank's sequence slice: q ``(b, s_loc, n,
    d)``, k/v ``(b, s_loc, n_kv, d)`` unrepeated, segment ids ``(b, s_loc)``
    (None: one segment); ``context`` a ``nn.base_layer.ContextShard``.
    Returns ``(b, s_loc, n, d)`` in q's dtype. ``n`` and ``n_kv`` must
    divide over the context group (the caller repeats K/V as far as that
    needs)."""
    from ..nn.attention import flash_path_active
    from .flash_attention import flash_attention

    cp = context.size
    b, s_loc, n, d = q.shape
    n_kv = k.shape[2]
    if n % cp:
        raise ValueError(f"ulysses needs local query heads ({n}) divisible by the context "
                         f"axis ({cp}); lower cp or use the ring variant")
    if n_kv % cp:
        raise ValueError(f"ulysses needs local kv heads ({n_kv}) divisible by the context "
                         f"axis ({cp}); the caller repeats kv minimally to make this hold")
    if segment_ids is None:
        segment_ids = torch.zeros((b, s_loc), dtype=torch.int32, device=q.device)
    group = context.group
    # scatter the heads, gather the sequence (rank i holds slice i, so the
    # concatenation is the global order)
    qg, kg, vg = (all_to_all(t, group, split_dim=2, concat_dim=1) for t in (q, k, v))
    seg = all_gather_cat(segment_ids.to(torch.int32).contiguous(), group, dim=1)
    s = s_loc * cp
    if causal and flash_path_active(kernel_is_flash=True, causal=True,
                                    dropout_attention_probs=0.0, deterministic=True,
                                    context_parallel_size=1, seq_len=s, head_dim=d,
                                    dtype=q.dtype):
        out = flash_attention(qg, kg, vg, seg, sm_scale=sm_scale)
    else:
        out = _grouped_attention(qg, kg, vg, seg, causal, sm_scale)
    # scatter the sequence back, gather this slice's heads
    return all_to_all(out, group, split_dim=1, concat_dim=2)
