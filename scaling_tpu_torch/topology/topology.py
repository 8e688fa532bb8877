"""The layout of a run over its worker processes (counterpart of
scaling_tpu/topology/topology.py).

The JAX package drives one ``Mesh`` with the axes (pipe, data, context,
model) from one process and lets GSPMD insert the collectives. The port
runs one process a rank, as the reference framework does, and keeps
JAX's rank surface: the flat rank is ``((pp_rank * dp + dp_rank) * cp +
cp_rank) * mp + mp_rank``, and ``get_global_rank``, the ``*_rank_of``
accessors, ``is_first/last_pipe_parallel_rank`` and ``is_io_rank`` give
what JAX's give for every grid.

``Topology`` holds this process's rank (from the process group, not from
``config.global_rank``), its device, and the per-axis process groups:
the model group (the ranks of one pipe stage, data and context rank,
which split the weights), the data group (the ranks of one stage, context
and model rank, which split the batch and, under ZeRO, the optimizer
state), the context group (the ranks of one data and model rank, which
split each micro-batch's sequence: Ulysses's all-to-alls), the gradient
group (data x context: the ranks that hold one model slice, over which the
gradients and the loss are summed; the data group at ``cp`` 1), the ring's
channels (a two-rank group for each hop ``c -> c + 1 mod cp`` of the
context ranks of one data and model rank: ``ring_send`` to the next,
``ring_recv`` from the previous), the pipe group (the stages of one data
and model rank: the loss's broadcast and the checkpoint's gather), the
stage transport's channels (a two-rank group for each direction of each
adjacent stage pair, and under interleaved virtual stages for the wrap
from the last stage to the first and back: ``channel``), the tied group
(the first and the last stage, which hold the two copies of a tied
embedding table), and under NCCL a gloo group of the world for host-side
agreement (``host_group``). Every rank creates every group, in one order
(``torch.distributed.new_group`` is collective over the world).

The backend rule (``choose_backend``) is decided before
``init_process_group`` and never by trying one backend and catching its
failure: NCCL where each local rank has a card of its own; gloo where
ranks share a card (NCCL refuses two ranks on one device) or run on the
CPU. Under gloo the collectives run on the CUDA tensors themselves, and the
stage transport is a broadcast, which gloo takes there
(``parallel/collectives.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from .config import TopologyConfig

def choose_backend(device_type: str, local_world_size: int, device_count: int) -> str:
    """``nccl`` when every local rank has a CUDA device of its own, else
    ``gloo`` (ranks that share a card, or the CPU)."""
    if device_type == "cuda" and local_world_size <= device_count:
        return "nccl"
    return "gloo"


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """A rank's device: ``cuda:(local_rank % device_count)`` on the card,
    the CPU otherwise."""
    if device_type == "cuda":
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return torch.device("cpu")


def init_distributed(world_size: int, rank: int, master_addr: str, master_port: int,
                     device_type: str = "cuda", local_world_size: Optional[int] = None) -> str:
    """``init_process_group`` over ``tcp://master_addr:master_port`` with the
    backend of ``choose_backend``; returns the backend. A no-op for one
    process or a group that already exists."""
    if world_size <= 1 or dist.is_initialized():
        return dist.get_backend() if dist.is_initialized() else "none"
    count = torch.cuda.device_count() if device_type == "cuda" else 0
    backend = choose_backend(device_type, local_world_size or world_size, count)
    dist.init_process_group(backend, init_method=f"tcp://{master_addr}:{master_port}",
                            world_size=world_size, rank=rank)
    return backend


class Topology:
    """This rank's place in the (pipe, data, context, model) grid, its
    device and its process groups. ``Topology(config)`` without a process
    group is rank 0 of a one-rank world."""

    def __init__(self, config: TopologyConfig, global_rank: Optional[int] = None,
                 device: Optional[torch.device] = None):
        self.config = config
        if global_rank is None:
            global_rank = dist.get_rank() if dist.is_initialized() else 0
        if dist.is_initialized() and dist.get_world_size() != config.world_size:
            raise ValueError(f"the topology needs {config.world_size} ranks, the process "
                             f"group has {dist.get_world_size()}")
        if not dist.is_initialized() and config.world_size > 1:
            raise RuntimeError(
                f"a topology of {config.world_size} ranks needs torch.distributed: launch "
                "the workers through runner_main (initialize_distributed joins the group)")
        if not 0 <= global_rank < config.world_size:
            raise ValueError(f"rank {global_rank} outside a world of {config.world_size}")
        self.global_rank = global_rank
        self.device = device
        self.backend = dist.get_backend() if dist.is_initialized() else None
        # host_group: a gloo group of the world for host-side agreement
        # (None under gloo, whose world group takes CPU tensors already)
        self.model_group = self.data_group = self.host_group = None
        self.context_group = self.grad_group = None
        self.ring_send = self.ring_recv = None
        self.pipe_group = self.tied_group = None
        self.model_ranks = [global_rank]
        self.data_ranks = [global_rank]
        self.context_ranks = [global_rank]
        self.grad_ranks = [global_rank]
        self.pipe_ranks = [global_rank]
        # (source stage, destination stage) -> this rank's two-rank group
        self.channels: Dict[Tuple[int, int], object] = {}
        if config.world_size > 1:
            self._new_groups()
            if self.backend != "gloo":
                self.host_group = dist.new_group(backend="gloo")

    def _new_groups(self) -> None:
        """Every model group, then every data group, under context
        parallelism every context group, gradient group and ring channel,
        then every pipe group, the channels and the tied groups, in rank
        order, on every rank."""
        pp, dp, mp = self.pipe_parallel_size, self.data_parallel_size, self.model_parallel_size
        cp = self.context_parallel_size
        for p in range(pp):
            for d in range(dp):
                for c in range(cp):
                    ranks = [self.get_global_rank(p, d, m, c) for m in range(mp)]
                    group = dist.new_group(ranks)
                    if self.global_rank in ranks:
                        self.model_group, self.model_ranks = group, ranks
        for p in range(pp):
            for c in range(cp):
                for m in range(mp):
                    ranks = [self.get_global_rank(p, d, m, c) for d in range(dp)]
                    group = dist.new_group(ranks)
                    if self.global_rank in ranks:
                        self.data_group, self.data_ranks = group, ranks
        if cp > 1:
            self._new_context_groups()
        else:
            self.grad_group, self.grad_ranks = self.data_group, self.data_ranks
        if pp == 1:
            return
        for d in range(dp):
            for m in range(mp):
                ranks = [self.get_global_rank(p, d, m) for p in range(pp)]
                group = dist.new_group(ranks)
                if self.global_rank in ranks:
                    self.pipe_group, self.pipe_ranks = group, ranks
                    if pp == 2:  # the first and last stage: the pipe group itself
                        self.tied_group = group
        for d in range(dp):
            for m in range(mp):
                for src, dst in channel_pairs(pp, self.config.pipe_virtual_size):
                    ranks = [self.get_global_rank(src, d, m), self.get_global_rank(dst, d, m)]
                    group = dist.new_group(sorted(ranks))
                    if self.global_rank in ranks:
                        self.channels[(src, dst)] = group
        if pp > 2:
            for d in range(dp):
                for m in range(mp):
                    ranks = [self.get_global_rank(0, d, m), self.get_global_rank(pp - 1, d, m)]
                    group = dist.new_group(ranks)
                    if self.global_rank in ranks:
                        self.tied_group = group

    def _new_context_groups(self) -> None:
        """Every context group, every gradient group (data x context) and
        every ring hop's channel (``c -> c + 1 mod cp``, two ranks: at
        ``cp`` 2 the two hops join one pair of ranks, each a group of its
        own). The pipe is 1 under context parallelism."""
        dp, cp, mp = self.data_parallel_size, self.context_parallel_size, self.model_parallel_size
        for d in range(dp):
            for m in range(mp):
                ranks = [self.get_global_rank(0, d, m, c) for c in range(cp)]
                group = dist.new_group(ranks)
                if self.global_rank in ranks:
                    self.context_group, self.context_ranks = group, ranks
        for m in range(mp):
            ranks = sorted(self.get_global_rank(0, d, m, c) for d in range(dp)
                           for c in range(cp))
            group = dist.new_group(ranks)
            if self.global_rank in ranks:
                self.grad_group, self.grad_ranks = group, ranks
        for d in range(dp):
            for m in range(mp):
                for c in range(cp):
                    src = self.get_global_rank(0, d, m, c)
                    dst = self.get_global_rank(0, d, m, (c + 1) % cp)
                    group = dist.new_group(sorted([src, dst]))
                    if self.global_rank == src:
                        self.ring_send = group
                    if self.global_rank == dst:
                        self.ring_recv = group

    def context_rank(self, context_parallel_rank: int) -> int:
        """The global rank of context rank ``context_parallel_rank`` at this
        rank's data and model rank (the pipe is 1 under context
        parallelism)."""
        return self.get_global_rank(0, self.data_parallel_rank, self.model_parallel_rank,
                                    context_parallel_rank)

    def stage_rank(self, stage: int) -> int:
        """The global rank of pipe stage ``stage`` at this rank's data and
        model rank."""
        return self.get_global_rank(stage, self.data_parallel_rank, self.model_parallel_rank)

    # ------------------------------------------------------------- sizes
    @property
    def world_size(self) -> int:
        return self.config.world_size

    @property
    def model_parallel_size(self) -> int:
        return self.config.model_parallel_size

    @property
    def data_parallel_size(self) -> int:
        return self.config.data_parallel_size

    @property
    def pipe_parallel_size(self) -> int:
        return self.config.pipe_parallel_size

    @property
    def pipe_virtual_size(self) -> int:
        return self.config.pipe_virtual_size

    @property
    def context_parallel_size(self) -> int:
        return self.config.context_parallel_size

    @property
    def context_parallel_variant(self) -> str:
        return self.config.context_parallel_variant

    @property
    def pipe_token_slices(self) -> int:
        return self.config.pipe_token_slices

    @property
    def micro_batch_size(self) -> int:
        return self.config.micro_batch_size

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps

    @property
    def global_batch_size(self) -> int:
        return self.config.global_batch_size

    # -------------------------------------------------------- rank math
    def get_global_rank(self, pipe_parallel_rank: int, data_parallel_rank: int,
                        model_parallel_rank: int, context_parallel_rank: int = 0) -> int:
        return grid_rank(self.sizes, pipe_parallel_rank, data_parallel_rank,
                         model_parallel_rank, context_parallel_rank)

    @property
    def sizes(self) -> Tuple[int, int, int, int]:
        """(pp, dp, cp, mp)."""
        return (self.pipe_parallel_size, self.data_parallel_size,
                self.context_parallel_size, self.model_parallel_size)

    def pipe_parallel_rank_of(self, global_rank: int) -> int:
        return rank_coords(self.sizes, global_rank)[0]

    def data_parallel_rank_of(self, global_rank: int) -> int:
        return rank_coords(self.sizes, global_rank)[1]

    def context_parallel_rank_of(self, global_rank: int) -> int:
        return rank_coords(self.sizes, global_rank)[2]

    def model_parallel_rank_of(self, global_rank: int) -> int:
        return rank_coords(self.sizes, global_rank)[3]

    @property
    def pipe_parallel_rank(self) -> int:
        return self.pipe_parallel_rank_of(self.global_rank)

    @property
    def data_parallel_rank(self) -> int:
        return self.data_parallel_rank_of(self.global_rank)

    @property
    def context_parallel_rank(self) -> int:
        return self.context_parallel_rank_of(self.global_rank)

    @property
    def model_parallel_rank(self) -> int:
        return self.model_parallel_rank_of(self.global_rank)

    def is_first_pipe_parallel_rank(self, global_rank: Optional[int] = None) -> bool:
        r = self.global_rank if global_rank is None else global_rank
        return self.pipe_parallel_rank_of(r) == 0

    def is_last_pipe_parallel_rank(self, global_rank: Optional[int] = None) -> bool:
        r = self.global_rank if global_rank is None else global_rank
        return self.pipe_parallel_rank_of(r) == self.pipe_parallel_size - 1

    def is_io_rank(self, global_rank: Optional[int] = None) -> bool:
        """Ranks that touch input data: first/last pipe stage at mp rank 0."""
        r = self.global_rank if global_rank is None else global_rank
        return self.model_parallel_rank_of(r) == 0 and (
            self.is_first_pipe_parallel_rank(r) or self.is_last_pipe_parallel_rank(r))

    def describe(self) -> Dict[str, object]:
        """The layout as the logs and ``chip_smoke.py`` print it."""
        return {"world_size": self.world_size, "pipe_parallel_size": self.pipe_parallel_size,
                "pipe_virtual_size": self.pipe_virtual_size,
                "pipe_token_slices": self.pipe_token_slices,
                "data_parallel_size": self.data_parallel_size,
                "context_parallel_size": self.context_parallel_size,
                "context_parallel_variant": self.context_parallel_variant,
                "model_parallel_size": self.model_parallel_size, "backend": self.backend,
                "global_rank": self.global_rank, "device": str(self.device)}


def channel_pairs(pp: int, vpp: int = 1) -> List[Tuple[int, int]]:
    """The (source, destination) stages of the stage transport's channels,
    in creation order: each adjacent pair's two directions and, under
    interleaved virtual stages over more than two stages, the wrap from the
    last stage to the first and back (at two stages the wrap is the same
    pair of ranks, whose channels the linear hops already made)."""
    pairs = []
    for s in range(pp - 1):
        pairs += [(s, s + 1), (s + 1, s)]
    if vpp > 1 and pp > 2:
        pairs += [(pp - 1, 0), (0, pp - 1)]
    return pairs


def grid_rank(sizes: Tuple[int, int, int, int], pipe_rank: int, data_rank: int,
              model_rank: int, context_rank: int = 0) -> int:
    """The flat rank of a (pipe, data, context, model) coordinate in a grid
    of ``sizes`` (pp, dp, cp, mp): JAX's ``Topology.get_global_rank``."""
    pp, dp, cp, mp = sizes
    for name, r, n in (("pipe", pipe_rank, pp), ("data", data_rank, dp),
                       ("context", context_rank, cp), ("model", model_rank, mp)):
        if not 0 <= r < n:
            raise ValueError(f"{name} rank {r} outside 0..{n - 1}")
    return ((pipe_rank * dp + data_rank) * cp + context_rank) * mp + model_rank


def rank_coords(sizes: Tuple[int, int, int, int], global_rank: int) -> List[int]:
    """(pipe, data, context, model) of ``global_rank``."""
    pp, dp, cp, mp = sizes
    return [global_rank // (dp * cp * mp), (global_rank // (cp * mp)) % dp,
            (global_rank // mp) % cp, global_rank % mp]
