"""Dropout on one device (counterpart of ``ForwardContext.dropout`` of
scaling_tpu/nn/base_layer.py).

``dropout(x, rate, ctx, site)`` returns ``where(mask, x / keep, 0)`` in
x's dtype, ``keep = 1 - rate``, as the JAX package does, and is the
identity when ``rate`` is 0 or ``ctx`` is None (a deterministic pass:
eval, generate, serve).

The JAX context folds a running call counter into the step's key, which
is sound under ``jax.checkpoint`` because the counter advances at trace
time. Here the masks of a training step come from explicit
``torch.Generator`` s on x's device, each seeded by a pure function of
the context's key (the trainer seed, the tag ``"dropout"``, the
iteration and the micro-batch index) and the STATIC site id of the call
(``layer_3.attention.query_lora``). No generator state is carried, so
a remat region's recompute (``parallel_module.remat``, or
``torch.utils.checkpoint`` under save_dots) draws the forward's masks
again, a resume draws the masks of the run it resumes, and nothing of
the RNG goes into a checkpoint. A ``mask_source`` may stand in for the
draw; the parity tests replay the JAX package's masks through it.

Over several ranks the masks are the one-rank masks' slices, as JAX
draws one global mask: a context with ``batch_shard=(rank, size)`` (the
data rank) draws each mask at ``size`` times the local batch and keeps
its rows, and a call with ``head_shard=(dim, rank, size)`` (a model
rank's heads) draws the whole head dim and keeps its slice. A context
with ``seq_shard=(rank, size)`` (a context rank's contiguous ``1/size`` of
the sequence, or token slice ``rank`` of ``size`` in a pipeline) draws the
sequence dim (``seq_dim``, dim 1 of an activation) whole and keeps its
slice; an attention-probability mask's key dim (``key_dim``) is drawn whole
too and cut to the keys a token slice attends, its prefix. Under sequence
parallelism a context also carries ``sp_shard=(model rank, mp)``: the
sites between the tensor-parallel regions (``sequence_sharded=True``: the
embedding's, ``after_attention``, ``after_mlp``) hold this model rank's
``1/mp`` of the local sequence, so their seq shard composes the two,
``(rank * mp + model rank, size * mp)``; the sites inside a region see the
whole local sequence and keep ``seq_shard``.

``ContextShard`` carries a layer's place in the context group (JAX's
``ForwardContext.context_parallel_size`` and ``context_parallel_variant``):
the attention reads it to run ring or Ulysses attention.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

# (context key, site, shape, keep probability, device) -> bool mask, True = kept
MaskSource = Callable[[Tuple, str, Sequence[int], float, torch.device], torch.Tensor]


def dropout_key(seed: int, iteration: int) -> Tuple:
    """The key of one training step (JAX ``rng.key("dropout", iteration)``)."""
    return (int(seed), "dropout", int(iteration))


def site_seed(key: Tuple, site: str) -> int:
    """The generator seed of ``site`` under ``key``: 63 bits of a hash."""
    digest = hashlib.blake2b(repr((key, site)).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def draw_mask(key: Tuple, site: str, shape: Sequence[int], keep: float,
              device: torch.device) -> torch.Tensor:
    """The default mask source: ``uniform < keep`` from a generator on
    ``device`` seeded by ``site_seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(site_seed(key, site))
    return torch.rand(tuple(shape), generator=gen, device=device) < keep


class DropoutContext:
    """The dropout state of one forward: a key and the mask source."""

    def __init__(self, key: Tuple, mask_source: Optional[MaskSource] = None,
                 batch_shard: Tuple[int, int] = (0, 1), seq_shard: Tuple[int, int] = (0, 1),
                 sp_shard: Tuple[int, int] = (0, 1)):
        self.key = tuple(key)
        self.mask_source = mask_source or draw_mask
        self.batch_shard = batch_shard
        self.seq_shard = seq_shard
        self.sp_shard = sp_shard

    def for_micro_batch(self, index: int) -> "DropoutContext":
        """The context of micro-batch ``index`` (JAX ``fold_in(key, index)``)."""
        return DropoutContext(self.key + (int(index),), self.mask_source, self.batch_shard,
                              self.seq_shard, self.sp_shard)

    def for_seq_shard(self, rank: int, size: int) -> "DropoutContext":
        """The context of sequence slice ``rank`` of ``size``."""
        return DropoutContext(self.key, self.mask_source, self.batch_shard, (rank, size),
                              self.sp_shard)

    def sequence_shard(self, sequence_sharded: bool = False) -> Tuple[int, int]:
        """The (rank, size) of the sequence slice a site's tensor holds:
        ``seq_shard``, composed with ``sp_shard`` for a site between the
        tensor-parallel regions."""
        (rank, size), (m, mp) = self.seq_shard, self.sp_shard
        return (rank * mp + m, size * mp) if sequence_sharded else (rank, size)

    def dropout(self, x: torch.Tensor, rate: float, site: str,
                head_shard: Optional[Tuple[int, int, int]] = None, seq_dim: int = 1,
                key_dim: Optional[int] = None, sequence_sharded: bool = False) -> torch.Tensor:
        if rate == 0.0:
            return x
        keep = 1.0 - rate
        shape, index = list(x.shape), [slice(None)] * x.ndim
        seq_rank, seq_size = self.sequence_shard(sequence_sharded)
        if key_dim is not None and seq_size > 1:  # the keys: a prefix of the whole sequence
            shape[key_dim] = shape[seq_dim] * seq_size
            index[key_dim] = slice(0, x.shape[key_dim])
        for dim, rank, size in ((0,) + self.batch_shard, head_shard or (0, 0, 1),
                                (seq_dim, seq_rank, seq_size)):
            if size > 1:
                index[dim] = slice(rank * shape[dim], (rank + 1) * shape[dim])
                shape[dim] *= size
        mask = self.mask_source(self.key, site, shape, keep, x.device)[tuple(index)]
        return torch.where(mask.to(x.device), x / keep, 0).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, ctx: Optional[DropoutContext],
            site: str, head_shard: Optional[Tuple[int, int, int]] = None, seq_dim: int = 1,
            key_dim: Optional[int] = None, sequence_sharded: bool = False) -> torch.Tensor:
    """Dropout at ``site``; the identity without a context or at rate 0.
    ``sequence_sharded``: the site lies between the tensor-parallel regions
    (its tensor is a sequence shard under sequence parallelism)."""
    if ctx is None or rate == 0.0:
        return x
    return ctx.dropout(x, rate, site, head_shard, seq_dim, key_dim, sequence_sharded)


@dataclasses.dataclass(frozen=True)
class ContextShard:
    """A layer's place in the context group: ``size`` ranks split each
    sequence, this one holds contiguous slice ``rank``; ``variant`` is
    ``ring`` or ``ulysses``; ``group`` the context group (Ulysses's
    all-to-alls, the segment ids' gather), ``ring_send`` / ``ring_recv``
    the two-rank groups of the hops to the next rank and from the previous
    one (``prev_rank``: the previous rank's global rank, the receive's
    source). One rank: none of it."""

    size: int = 1
    rank: int = 0
    variant: str = "ring"
    group: Any = None
    ring_send: Any = None
    ring_recv: Any = None
    prev_rank: int = 0

    @classmethod
    def of(cls, topology) -> "ContextShard":
        """This rank's shard of a ``topology.Topology`` (one rank: None or
        a context size of 1)."""
        if topology is None or topology.context_parallel_size == 1:
            return cls()
        cp, c = topology.context_parallel_size, topology.context_parallel_rank
        return cls(cp, c, topology.context_parallel_variant, topology.context_group,
                   topology.ring_send, topology.ring_recv,
                   topology.context_rank((c - 1) % cp))
