"""The collectives of data, tensor and pipeline parallelism (what GSPMD
derives for the JAX package from its partition specs,
scaling_tpu/parallel/sharding.py, and the collective-permutes of its
spatial pipeline, scaling_tpu/parallel/pipeline.py).

This is the one module of the port that calls ``torch.distributed``
collectives, so every byte they move is counted here (``STATS``):

- ``copy_to_model_region``: identity forward, all-reduce of the gradient
  over the model group backward (the input of a column-parallel region);
- ``reduce_from_model_region``: all-reduce over the model group forward,
  identity backward (the output of a row-parallel product, the
  vocab-parallel embedding);
- ``gather_from_model_region``: all-gather along a dim forward, this
  rank's slice of the gradient backward (vocab-sharded logits, which every
  model rank turns into the same loss);
- ``gather_shared_from_model_region``: all-gather forward, the sum over
  the model group of the gradient's slices backward (K/V heads that
  several model ranks read, where ``n_kv % mp != 0``);
- ``all_reduce_``, ``flat_all_reduce_``, ``all_gather_cat``, ``barrier``,
  ``any_rank``: the
  data group's gradient reduction, ZeRO's parameter gather, the
  checkpoint's gather and the step boundary's agreement;
- ``broadcast_``: the pipe group's loss and metrics from the last stage,
  and the checkpoint's leaves from their stage to the writing rank;
  ``broadcast_object`` / ``gather_objects``: host objects (the metrics'
  names, the stages' optimised parameters) over a group;
- ``p2p_send`` / ``p2p_recv``: the stage transport, an activation to the
  next stage or a gradient to the previous one (counted as ``p2p_send_*``
  and ``p2p_recv_*``, and the receiver's host wait as
  ``p2p_recv_wait_ns``);
- ``ring_send`` / ``ring_recv``: a hop of ring attention's K/V blocks (and
  of their gradients' accumulators) to the next context rank, the same
  two-rank broadcast as the stage transport, both ends asynchronous
  (counted as ``ring_send_*`` and ``ring_recv_*``);
- ``all_to_all``: Ulysses's exchange of a sequence shard for a head shard
  over the context group, an autograd Function whose backward is the
  inverse exchange (counted as ``all_to_all_*``, each call the whole tensor
  it is given);
- ``gather_param``: ZeRO-3's per-use all-gather of a parameter's data
  slice over the data group (counted as ``param_gather_*``), whose
  backward reduce-scatters the f32 gradient (``grad_reduce_scatter_*``)
  and hands this rank's summed slice to a sink, not to autograd: the
  parameter is bf16 in a bf16 model, and autograd would round the f32 sum
  to it;
- ``gather_sequence`` / ``scatter_sequence``: sequence parallelism's entry
  into a tensor-parallel region (an all-gather along the sequence over the
  model group, its backward a reduce-scatter) and exit from one (a
  reduce-scatter, its backward an all-gather), counted as
  ``seq_gather_*`` and ``seq_reduce_scatter_*`` in both directions.

A group of one rank (or none) makes each of them the identity. Under the
gloo backend (ranks that share a card, ``topology.choose_backend``) the
collectives run on the CUDA tensors themselves: ``dist_probe.py`` found on
the H100 machine with torch 2.11 that gloo takes every collective the port
calls on CUDA tensors (PERF.md), so nothing is staged through the host.
Point-to-point ``send``/``recv`` is the one it refused, so the stage
transport is a ``broadcast`` over a two-rank group with the sender as its
source, which gloo takes on the card and NCCL where each rank has a card
of its own: one path for both backends. A broadcast is a collective, so
the two ends must issue a group's transfers in one order. Each direction
of each stage pair is a group of its own (``Topology.channels``), which
carries its transfers in the order the schedule produces them at the
sender and consumes them at the receiver, the same order; the sender's
broadcast is asynchronous (it returns a handle and the sender goes on), the
receiver's waits for the data, as the schedule simulator models a send and
a receive. The shapes are static (``(micro_batch_size, sequence,
hidden)`` in the compute dtype), so the receiver allocates the buffer.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List

import torch
import torch.distributed as dist

STATS: Dict[str, int] = {}


def _count(op: str, nbytes: int) -> None:
    STATS[f"{op}_calls"] = STATS.get(f"{op}_calls", 0) + 1
    STATS[f"{op}_bytes"] = STATS.get(f"{op}_bytes", 0) + nbytes


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` summed (or ``op``-reduced) over ``group``, in place."""
    if _size(group) == 1:
        return t
    _count("all_reduce", t.numel() * t.element_size())
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0, op: str = "all_gather"
                   ) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group-rank order
    (the bytes counted as the output's, under ``op``)."""
    n = _size(group)
    if n == 1:
        return t
    t = t.contiguous()
    _count(op, n * t.numel() * t.element_size())
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter_cat(t: torch.Tensor, group, dim: int = 0, op: str = "reduce_scatter"
                       ) -> torch.Tensor:
    """``t`` summed over ``group``, this rank's contiguous ``1/n`` of the sum
    along ``dim`` (the bytes counted as the input's, under ``op``)."""
    n = _size(group)
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"a reduce-scatter over {n} ranks needs dim {dim} of {tuple(t.shape)} "
                         f"divisible by {n}")
    _count(op, t.numel() * t.element_size())
    parts = [c.contiguous() for c in t.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def chunk_of(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's contiguous slice of ``t`` along ``dim``."""
    n = _size(group)
    if n == 1:
        return t
    return t.chunk(n, dim=dim)[group_rank(group)].contiguous()


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of global rank ``src`` on every rank of ``group``, in place."""
    if _size(group) == 1:
        return t
    _count("broadcast", t.numel() * t.element_size())
    dist.broadcast(t, src=src, group=group)
    return t


def broadcast_object(obj: Any, src: int, group) -> Any:
    """Global rank ``src``'s picklable ``obj`` on every rank of ``group``."""
    if _size(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def gather_objects(obj: Any, group) -> List[Any]:
    """Every rank's picklable ``obj`` of ``group``, in group-rank order."""
    if _size(group) == 1:
        return [obj]
    out: List[Any] = [None] * _size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def p2p_send(t: torch.Tensor, group):
    """Start sending ``t`` to the other rank of the two-rank ``group``;
    returns the handle to wait on. ``t`` must stay unchanged until then, and
    may be written (with its own values) when the transfer ends: gloo copies
    a CUDA tensor's result back into it."""
    _count("p2p_send", t.numel() * t.element_size())
    return dist.broadcast(t, src=dist.get_rank(), group=group, async_op=True)


def p2p_recv(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Receive into ``t`` what global rank ``src`` sends over ``group``; the
    host's wait is added to ``STATS["p2p_recv_wait_ns"]``."""
    _count("p2p_recv", t.numel() * t.element_size())
    start = time.perf_counter_ns()
    dist.broadcast(t, src=src, group=group)
    STATS["p2p_recv_wait_ns"] = STATS.get("p2p_recv_wait_ns", 0) + (
        time.perf_counter_ns() - start)
    return t


def ring_send(t: torch.Tensor, group):
    """Start sending ``t`` over a ring hop's two-rank ``group`` (this rank
    its source); returns the handle. As ``p2p_send``: ``t`` must be a tensor
    of its own, which gloo may write back into when the transfer ends."""
    _count("ring_send", t.numel() * t.element_size())
    return dist.broadcast(t, src=dist.get_rank(), group=group, async_op=True)


def ring_recv(t: torch.Tensor, src: int, group):
    """Start receiving into ``t`` what global rank ``src`` sends over a ring
    hop's ``group``; returns the handle to wait on before ``t`` is read."""
    _count("ring_recv", t.numel() * t.element_size())
    return dist.broadcast(t, src=src, group=group, async_op=True)


def _all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    n = _size(group)
    send = torch.stack(x.chunk(n, dim=split_dim))  # piece j goes to rank j
    out = torch.empty_like(send)
    _count("all_to_all", send.numel() * send.element_size())
    dist.all_to_all_single(out, send, group=group)
    return torch.cat(out.unbind(0), dim=concat_dim)  # piece i came from rank i


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.split_dim, ctx.concat_dim = group, split_dim, concat_dim
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group, ctx.concat_dim, ctx.split_dim), None, None, None


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``x`` cut into ``n`` pieces along
    ``split_dim``, piece ``j`` sent to group rank ``j``, the pieces received
    concatenated along ``concat_dim`` in group-rank order; the gradient
    goes back by the inverse exchange."""
    if _size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_dim % x.ndim, concat_dim % x.ndim)


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, group, dim, sink):
        ctx.group, ctx.dim, ctx.sink = group, dim, sink
        return all_gather_cat(p, group, dim, "param_gather")

    @staticmethod
    def backward(ctx, grad):
        ctx.sink(reduce_scatter_cat(grad.float(), ctx.group, ctx.dim, "grad_reduce_scatter"))
        return None, None, None, None


def gather_param(p: torch.Tensor, group, dim: int,
                 sink: Callable[[torch.Tensor], None]) -> torch.Tensor:
    """ZeRO-3: the whole parameter from this rank's data slice ``p`` (the
    group's slices concatenated along ``dim``). In the backward the
    gradient is cast to f32, reduce-scattered over ``group`` and this
    rank's slice of the sum handed to ``sink``; ``p`` gets no ``.grad``."""
    return _GatherParam.apply(p, group, dim, sink)


class _GatherSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim, "seq_gather")

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_cat(grad, ctx.group, ctx.dim, "seq_reduce_scatter"), None, None


class _ScatterSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter_cat(x, group, dim, "seq_reduce_scatter")

    @staticmethod
    def backward(ctx, grad):
        return all_gather_cat(grad, ctx.group, ctx.dim, "seq_gather"), None, None


def gather_sequence(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Sequence parallelism into a tensor-parallel region: the model
    group's sequence shards of ``x`` gathered along ``dim``; the backward
    reduce-scatters the gradient (sums the ranks' partial gradients and
    keeps this rank's rows)."""
    return x if _size(group) == 1 else _GatherSequence.apply(x, group, dim % x.ndim)


def scatter_sequence(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Sequence parallelism out of a tensor-parallel region: the ranks'
    partial sums of ``x`` reduce-scattered along ``dim`` (this rank's rows
    of the sum); the backward all-gathers the gradient."""
    return x if _size(group) == 1 else _ScatterSequence.apply(x, group, dim % x.ndim)


def barrier(group=None) -> None:
    if dist.is_initialized():
        dist.barrier(group=group)


def any_rank(flag: bool, group=None) -> bool:
    """Whether ``flag`` is True on any rank of ``group`` (a gloo group: the
    world's under gloo, ``Topology.host_group`` under NCCL): one all-reduce
    of one host integer, no device sync, the same answer on every rank."""
    if not dist.is_initialized():
        return flag
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    _count("all_reduce", t.element_size())
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    # a host tensor: the read waits for the peers, not for the device
    return t.tolist()[0] > 0  # sta: disable=STA010


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, reduce_grad):
        ctx.group, ctx.dim, ctx.reduce_grad = group, dim, reduce_grad
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.reduce_grad:
            grad = all_reduce_(grad.contiguous().clone(), ctx.group)
        return chunk_of(grad, ctx.group, ctx.dim), None, None, None


def copy_to_model_region(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else _CopyToRegion.apply(x, group)


def reduce_from_model_region(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else _ReduceFromRegion.apply(x, group)


def gather_from_model_region(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    dim = dim % x.ndim
    return x if _size(group) == 1 else _GatherFromRegion.apply(x, group, dim, False)


def gather_shared_from_model_region(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    dim = dim % x.ndim
    return x if _size(group) == 1 else _GatherFromRegion.apply(x, group, dim, True)


def flat_all_reduce_(tensors: List[torch.Tensor], group) -> None:
    """Sum each of ``tensors`` over ``group`` in place, in one collective a
    dtype (the data group's gradient reduction)."""
    if _size(group) == 1 or not tensors:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        all_reduce_(flat, group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
