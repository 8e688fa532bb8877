"""The collectives of data and tensor parallelism (what GSPMD derives for
the JAX package from its partition specs, scaling_tpu/parallel/sharding.py).

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
  checkpoint's gather and the step boundary's agreement.

A group of one rank (or none) makes each of them the identity. Under the
gloo backend (ranks that share a card, ``topology.choose_backend``) the
collectives run on the CUDA tensors themselves: ``dist_probe.py`` found on
the H100 machine with torch 2.11 that gloo takes every collective the port
calls on CUDA tensors (PERF.md), so nothing is staged through the host.
Point-to-point ``send``/``recv`` is the one it refused; the port sends
nothing point to point.
"""

from __future__ import annotations

from typing import Dict, List

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


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group-rank order."""
    n = _size(group)
    if n == 1:
        return t
    t = t.contiguous()
    _count("all_gather", n * t.numel() * t.element_size())
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def chunk_of(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's contiguous slice of ``t`` along ``dim``."""
    n = _size(group)
    if n == 1:
        return t
    return t.chunk(n, dim=dim)[group_rank(group)].contiguous()


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
