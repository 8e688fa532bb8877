"""Ring attention: context parallelism over the context group (counterpart
of scaling_tpu/ops/ring_attention.py).

Each context rank holds a contiguous ``1/cp`` of the sequence: its Q stays
put and the K/V blocks (with their segment ids) travel round the ring, one
hop a step (``collectives.ring_send`` / ``ring_recv`` over the two-rank
groups of ``Topology``: gloo refuses send/recv of CUDA tensors, a broadcast
over two ranks is not). At step ``t`` rank ``r`` holds the block of rank
``r - t``, whose tokens sit at absolute positions ``owner * s_loc ..``, so
the causal mask and the segment mask are those of the one-rank sequence.

Within a step the block is consumed in ``_kv_chunk``-wide tiles with the
online-softmax recurrence, so the one score tile alive is ``(s_loc x
chunk)`` a head; ``_kv_chunk`` is JAX's divisor rule exactly. The forward
keeps only the output and the per-query logsumexp. The backward is JAX's
custom VJP: a second ring pass recomputes each tile's probabilities from
the logsumexp, and the f32 dK/dV accumulators travel with their blocks, so
after ``cp`` hops every block's gradient is home. It is a
``torch.autograd.Function``: autograd through the loop of tiles would keep
every tile.

JAX computes this with XLA einsums and no Pallas kernel; plain ``torch``
products are its counterpart here (no kernel to port). Two differences of
schedule, none of arithmetic: a tile wholly after the queries under the
causal mask is skipped (JAX computes it and its probabilities are zero, so
the recurrence's state is unchanged bit for bit), and the last step's K/V
hop, which JAX makes and never reads, is not made. K/V stay unrepeated
(GQA): query head ``i`` reads kv head ``i // (n / n_kv)``.

Bytes a call (``collectives.STATS``), b, s_loc, n_kv, d and the K/V
element size e: forward ``(cp - 1)`` hops of ``2·b·s_loc·n_kv·d·e`` (K and V
in one tensor) and ``4·b·s_loc`` (segment ids); backward the same K/V and
segment hops and ``cp`` hops of ``2·b·s_loc·n_kv·d·4`` (the f32 dK/dV).
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import torch

from ..parallel.collectives import ring_recv, ring_send

_NEG = -1e9
_DEFAULT_KV_CHUNK = 1024


def _kv_chunk(s_loc: int, requested: Optional[int] = None) -> int:
    """Largest divisor of ``s_loc`` at most the requested chunk (default
    ``_DEFAULT_KV_CHUNK``); one full tile when the best divisor is a sliver
    (below 128, or the cap if smaller), with JAX's warning where that loses
    the memory bound."""
    cap = min(requested or _DEFAULT_KV_CHUNK, s_loc)
    for c in range(cap, 0, -1):
        if s_loc % c == 0:
            if c >= min(128, cap):
                return c
            break
    if s_loc > cap:
        warnings.warn(
            f"ring attention: per-device sequence length {s_loc} has no "
            f"divisor in [{min(128, cap)}, {cap}]; falling back to one "
            f"full ({s_loc} x {s_loc}) score tile per step, losing the "
            f"chunked memory bound"
        )
    return s_loc


def _tile_mask(seg_q: torch.Tensor, seg_c: torch.Tensor, q_pos: torch.Tensor,
               k_pos: torch.Tensor, causal: bool) -> torch.Tensor:
    """(b, 1, 1, s_q, chunk) bool: equal segments, and key at or before
    query under ``causal``."""
    allowed = seg_q[:, :, None] == seg_c[:, None, :]
    if causal:
        allowed = allowed & (k_pos[None, None, :] <= q_pos[None, :, None])
    return allowed[:, None, None]


class _Ring:
    """The hops of one call: blocks go to the next rank and come from the
    previous one, each hop a send and a receive posted together."""

    def __init__(self, context):
        self.size, self.rank = context.size, context.rank
        self.send_group, self.recv_group = context.ring_send, context.ring_recv
        self.src = context.prev_rank

    def start(self, tensors: List[torch.Tensor]):
        """Post the hop of ``tensors`` (each sent from a copy of its own,
        which gloo may write back into); returns (received buffers,
        handles)."""
        handles, got = [], []
        for t in tensors:
            out = t.detach().clone(memory_format=torch.contiguous_format)
            handles.append((ring_send(out, self.send_group), out))
        for t in tensors:
            buf = torch.empty_like(t, memory_format=torch.contiguous_format)
            handles.append((ring_recv(buf, self.src, self.recv_group), buf))
            got.append(buf)
        return got, handles

    @staticmethod
    def finish(handles) -> None:
        for work, _ in handles:
            work.wait()


def _tiles(s_loc: int, chunk: int, owner: int, my: int, causal: bool):
    """The (start, stop) of each tile of the block of rank ``owner`` that
    the queries of rank ``my`` may attend (every tile without ``causal``)."""
    for start in range(0, s_loc, chunk):
        if causal and owner * s_loc + start > my * s_loc + s_loc - 1:
            continue  # wholly after every query
        yield start, start + chunk


def _ring_forward(q, k, v, seg, ring: _Ring, causal: bool, sm_scale: float,
                  kv_chunk: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s_loc, n, d = q.shape
    n_kv = k.shape[2]
    g = n // n_kv
    chunk = _kv_chunk(s_loc, kv_chunk)
    dev = q.device
    q_pos = ring.rank * s_loc + torch.arange(s_loc, device=dev)
    qf = q.float().reshape(b, s_loc, n_kv, g, d) * sm_scale
    m = torch.full((b, n_kv, g, s_loc), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, n_kv, g, s_loc), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, s_loc, n_kv, g, d), dtype=torch.float32, device=dev)
    kv, seg_blk = torch.stack([k, v]), seg
    for step in range(ring.size):
        owner = (ring.rank - step) % ring.size
        handles = None
        if step < ring.size - 1:
            (kv_next, seg_next), handles = ring.start([kv, seg_blk])
        for lo, hi in _tiles(s_loc, chunk, owner, ring.rank, causal):
            k_pos = owner * s_loc + torch.arange(lo, hi, device=dev)
            kc, vc = kv[0, :, lo:hi].float(), kv[1, :, lo:hi].float()
            s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc)
            masked = _tile_mask(seg, seg_blk[:, lo:hi], q_pos, k_pos, causal)
            s = torch.where(masked, s, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # a fully masked tile has s == m_new == _NEG: the mask, not the
            # exp, zeroes it
            p = torch.exp(s - m_new[..., None]) * masked
            correction = torch.exp(m - m_new)
            l = l * correction + p.sum(dim=-1)
            acc = acc * correction.permute(0, 3, 1, 2)[..., None] + torch.einsum(
                "bhgqk,bkhd->bqhgd", p, vc)
            m = m_new
        if handles is not None:
            _Ring.finish(handles)
            kv, seg_blk = kv_next, seg_next
    l_safe = l.clamp_min(1e-20)
    out = acc / l_safe.permute(0, 3, 1, 2)[..., None]
    lse = m + torch.log(l_safe)  # (b, n_kv, g, s_loc)
    return out.reshape(b, s_loc, n, d).to(q.dtype), lse


def _ring_backward(q, k, v, seg, out, lse, dout, ring: _Ring, causal: bool, sm_scale: float,
                   kv_chunk: Optional[int]):
    """The flash backward identities over the ring (P the normalised
    probabilities): ``dV_j = sum_i P_ij dO_i``, ``dS_ij = P_ij (dO_i · V_j -
    delta_i)`` with ``delta_i = dO_i · O_i``, ``dQ_i = sm_scale sum_j dS_ij
    K_j``, ``dK_j = sum_i dS_ij Q_i sm_scale``."""
    b, s_loc, n, d = q.shape
    n_kv = k.shape[2]
    g = n // n_kv
    chunk = _kv_chunk(s_loc, kv_chunk)
    dev = q.device
    q_pos = ring.rank * s_loc + torch.arange(s_loc, device=dev)
    qf = q.float().reshape(b, s_loc, n_kv, g, d) * sm_scale
    do = dout.float().reshape(b, s_loc, n_kv, g, d)
    of = out.float().reshape(b, s_loc, n_kv, g, d)
    delta = (do * of).sum(dim=-1).permute(0, 2, 3, 1)  # (b, n_kv, g, s_loc), as lse
    dq = torch.zeros((b, s_loc, n_kv, g, d), dtype=torch.float32, device=dev)
    dkv = torch.zeros((2, b, s_loc, n_kv, d), dtype=torch.float32, device=dev)
    kv, seg_blk = torch.stack([k, v]), seg
    for step in range(ring.size):
        owner = (ring.rank - step) % ring.size
        handles = None
        if step < ring.size - 1:
            (kv_next, seg_next), handles = ring.start([kv, seg_blk])
        for lo, hi in _tiles(s_loc, chunk, owner, ring.rank, causal):
            k_pos = owner * s_loc + torch.arange(lo, hi, device=dev)
            kc, vc = kv[0, :, lo:hi].float(), kv[1, :, lo:hi].float()
            s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc)
            masked = _tile_mask(seg, seg_blk[:, lo:hi], q_pos, k_pos, causal)
            # lse is a per-query constant, so P normalises directly; a fully
            # masked row has lse = _NEG + log(eps): the mask wins
            p = torch.exp(torch.where(masked, s, _NEG) - lse[..., None]) * masked
            dp = torch.einsum("bqhgd,bkhd->bhgqk", do, vc)
            ds = p * (dp - delta[..., None])
            dq += torch.einsum("bhgqk,bkhd->bqhgd", ds, kc)
            dkv[0, :, lo:hi] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
            dkv[1, :, lo:hi] += torch.einsum("bhgqk,bqhgd->bkhd", p, do)
        if ring.size > 1:  # the accumulators go on with their block: after cp hops, home
            (dkv,), grad_handles = ring.start([dkv])
            _Ring.finish(grad_handles)
        if handles is not None:
            _Ring.finish(handles)
            kv, seg_blk = kv_next, seg_next
    dq = (dq * sm_scale).reshape(b, s_loc, n, d).to(q.dtype)
    return dq, dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg, ring, causal, sm_scale, kv_chunk):
        out, lse = _ring_forward(q, k, v, seg, ring, causal, sm_scale, kv_chunk)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.ring, ctx.causal, ctx.sm_scale, ctx.kv_chunk = ring, causal, sm_scale, kv_chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, seg, out, lse, dout.contiguous(), ctx.ring,
                                    ctx.causal, ctx.sm_scale, ctx.kv_chunk)
        return dq, dk, dv, None, None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   segment_ids: Optional[torch.Tensor], context, causal: bool = True,
                   sm_scale: float = 1.0, kv_chunk: Optional[int] = None) -> torch.Tensor:
    """Attention of this context rank's queries over the whole sequence:
    q ``(b, s_loc, n, d)``, k/v ``(b, s_loc, n_kv, d)`` unrepeated, the
    segment ids ``(b, s_loc)`` of this rank's slice (None: one segment);
    ``context`` a ``nn.base_layer.ContextShard``. Returns ``(b, s_loc, n,
    d)`` in q's dtype. ``kv_chunk`` caps the score tile's width."""
    if segment_ids is None:
        segment_ids = torch.zeros(q.shape[:2], dtype=torch.int32, device=q.device)
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"ring attention needs the query heads ({q.shape[2]}) a multiple "
                         f"of the kv heads ({k.shape[2]})")
    return RingAttention.apply(q, k, v, segment_ids.to(torch.int32).contiguous(),
                               _Ring(context), causal, float(sm_scale), kv_chunk)
