"""Which layers a pipe stage holds (counterpart of the partitioning of
scaling_tpu/parallel/pipeline.py).

The JAX package stacks the transformer layers ``(pp, layers_per_stage)``
(``(pp, vpp, layers_per_virtual)`` under virtual stages) and shards the
stage dim over its pipe axis. The port runs one process a stage, which
builds only its own layers (``stage_plan``): the ``pp * vpp`` chunks of
the stack, chunk ``c`` the layers between bounds ``c`` and ``c + 1`` of
the partition, go round-robin over the stages, so stage ``s`` holds chunks
``r * pp + s`` for ``r`` in ``0 .. vpp - 1`` (``PipelinedBody
._stack_layer_major``); at ``vpp`` 1 a stage holds one chunk. The bounds
are always ``pipe_partition_uniform``'s, as JAX's executor stacks the
layers whatever ``pipe_partition_method`` says; a
``pipe_partition_overwrite`` other than those bounds is refused by name
(JAX carries the key but places no layer by it). JAX's check stays:
``num_layers`` must be a multiple of ``pp * vpp``. The balanced and
from-indices partitions are kept as JAX's pure functions.

The edges are the reference's placement: the embedding on the first
stage, the final norm, the head (and an embedding head) on the last. JAX
instead shards their vocabulary dims over (pipe, model)
(``_lift_edge_meta_over_pipe``), the same memory. A tied head keeps a copy
of the embedding table on the last stage, whose gradient is summed with
the first stage's (``PipelineEngine``'s tied reduction).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


def pipe_partition_uniform(num_items: int, num_partitions: int) -> List[int]:
    """Boundaries ``[b_0 .. b_n]``: an even split, the residual spread from
    the front."""
    base, residual = divmod(num_items, num_partitions)
    bounds = [0]
    for i in range(num_partitions):
        bounds.append(bounds[-1] + base + (1 if i < residual else 0))
    return bounds


def pipe_partition_balanced(weights: List[int], num_partitions: int) -> List[int]:
    """Boundaries minimising the heaviest partition (a binary search over
    the bottleneck)."""
    weights_arr = np.asarray(weights, dtype=np.int64)
    prefix = np.concatenate([[0], np.cumsum(weights_arr)])

    def partitions_needed(limit: int) -> Optional[List[int]]:
        bounds, start = [0], 0
        for _ in range(num_partitions):
            # the furthest end with sum(start..end) <= limit
            end = int(np.searchsorted(prefix, prefix[start] + limit, side="right")) - 1
            if end <= start and start < len(weights_arr):
                return None  # a single item exceeds the limit
            end = min(end, len(weights_arr))
            bounds.append(end)
            start = end
            if start >= len(weights_arr):
                bounds.extend([len(weights_arr)] * (num_partitions - (len(bounds) - 1)))
                return bounds[: num_partitions + 1]
        return bounds if start >= len(weights_arr) else None

    lo, hi = int(weights_arr.max(initial=0)), int(prefix[-1])
    best = None
    while lo <= hi:
        mid = (lo + hi) // 2
        b = partitions_needed(mid)
        if b is not None:
            best, hi = b, mid - 1
        else:
            lo = mid + 1
    assert best is not None
    return best


def pipe_partition_from_indices(bounds: List[int], num_items: int,
                                num_partitions: int) -> List[int]:
    assert len(bounds) == num_partitions + 1
    assert bounds[0] == 0 and bounds[-1] == num_items
    assert all(b2 >= b1 for b1, b2 in zip(bounds, bounds[1:]))
    return list(bounds)


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """Pipe stage ``stage`` of ``pp`` under ``vpp`` virtual stages:
    ``chunks[r]`` the (0-based) transformer layers of its virtual index
    ``r`` (chunk ``r * pp + stage``)."""

    pp: int
    vpp: int
    stage: int
    chunks: Tuple[Tuple[int, ...], ...]

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.pp - 1

    @property
    def layers(self) -> Tuple[int, ...]:
        return tuple(i for chunk in self.chunks for i in chunk)


def partition_bounds(topology, num_layers: int) -> List[int]:
    """The bounds of the ``pp * vpp`` chunks of ``num_layers`` layers, the
    uniform partition (``topology``: a ``TopologyConfig``)."""
    n = topology.pipe_parallel_size * topology.pipe_virtual_size
    if num_layers % n:
        raise ValueError(
            f"pipelining needs num_layers ({num_layers}) divisible by pipe_parallel_size "
            f"({topology.pipe_parallel_size}) * pipe_virtual_size "
            f"({topology.pipe_virtual_size})")
    bounds = pipe_partition_uniform(num_layers, n)
    overwrite = topology.pipe_partition_overwrite
    if overwrite is not None and list(overwrite) != bounds:
        raise NotImplementedError(
            f"pipe_partition_overwrite={list(overwrite)} is not ported: the stages hold the "
            f"uniform partition {bounds}, as JAX's executor stacks the layers")
    return bounds


def stage_plan(topology, num_layers: int, stage: int) -> StagePlan:
    """Stage ``stage``'s layers (``topology``: a ``TopologyConfig``)."""
    pp, vpp = topology.pipe_parallel_size, topology.pipe_virtual_size
    bounds = partition_bounds(topology, num_layers)
    chunks = tuple(tuple(range(bounds[r * pp + stage], bounds[r * pp + stage + 1]))
                   for r in range(vpp))
    return StagePlan(pp, vpp, stage, chunks)


def stage_of_layer(topology, num_layers: int, index: int) -> int:
    """The pipe stage that holds (and stores) logical layer ``index`` of a
    stack of ``num_layers`` transformer layers: the embedding (0) on the
    first, transformer layer ``index`` on its chunk's, the edges after them
    on the last."""
    if index == 0:
        return 0
    if index > num_layers:
        return topology.pipe_parallel_size - 1
    bounds = partition_bounds(topology, num_layers)
    chunk = next(c for c in range(len(bounds) - 1) if bounds[c] < index <= bounds[c + 1])
    return chunk % topology.pipe_parallel_size
