"""The ``topology`` section of a config (a subset of
scaling_tpu/topology/config.py's ``TopologyConfig``): data, model (tensor),
context and pipeline parallelism over several worker processes, with JAX's
derivation of the sizes (three of ``model_parallel_size``,
``pipe_parallel_size``, ``data_parallel_size`` and ``world_size`` determine
the fourth, ``context_parallel_size`` counted into the world; a config that
gives fewer takes 1 for each missing parallel size) and of the batch split
(two of ``micro_batch_size``, ``gradient_accumulation_steps`` and
``global_batch_size``, with ``global = micro x accumulation x data``: the
context ranks of a data rank split its micro-batches along the sequence),
interleaved virtual stages (``pipe_virtual_size``, with JAX's checks: it
needs ``pipe_parallel_size`` above 1 and an accumulation that
``pipe_parallel_size`` divides), TeraPipe token slices
(``pipe_token_slices``: it needs ``pipe_parallel_size`` above 1 and
excludes virtual stages), context parallelism (``context_parallel_size``,
which excludes pipelining, and ``context_parallel_variant``, ``ring`` or
``ulysses``), the stage partition (``pipe_partition_method``,
``pipe_partition_overwrite``: the uniform one, as JAX's executor places the
layers; ``parallel.pipeline``), ``activation_checkpointing_type``
(``disabled``, ``every_layer``, ``every_layer_save_dots`` or
``every_pipe_stage``) and ``sequence_parallel`` (Megatron-style sequence
sharding of the activations between tensor-parallel regions over the model
group; off at ``model_parallel_size`` 1, where it has no effect in JAX;
``check_sequence_parallel`` refuses by name a local sequence, after context
parallelism and token slices, that the model group does not divide, where
GSPMD would pad).

An unknown key raises ValueError; the JAX key names and check messages are
kept.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


class ActivationCheckpointingType:
    DISABLED = "disabled"
    EVERY_LAYER = "every_layer"
    EVERY_LAYER_SAVE_DOTS = "every_layer_save_dots"  # per-layer remat keeping matmul outputs
    EVERY_PIPE_STAGE = "every_pipe_stage"  # one remat region a stage's chunk


# keys at these values change nothing here; the launcher gives each
# process its rank (``global_rank``) and slot (``local_slot``)
_INERT = {"global_rank": None, "local_slot": None}
PARTITION_METHODS = ("uniform", "balanced")
CONTEXT_PARALLEL_VARIANTS = ("ring", "ulysses")


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    micro_batch_size: int
    gradient_accumulation_steps: int = 1
    activation_checkpointing_type: str = ActivationCheckpointingType.DISABLED
    model_parallel_size: int = 1
    data_parallel_size: int = 1
    pipe_parallel_size: int = 1
    pipe_virtual_size: int = 1
    pipe_partition_method: str = "uniform"
    pipe_partition_overwrite: Optional[Tuple[int, ...]] = None
    pipe_token_slices: int = 1
    context_parallel_size: int = 1
    context_parallel_variant: str = "ring"
    sequence_parallel: bool = False

    def __post_init__(self):
        if not isinstance(self.sequence_parallel, bool):
            raise ValueError(f"sequence_parallel must be true or false, got "
                             f"{self.sequence_parallel!r}")
        if self.model_parallel_size == 1:  # no effect at mp 1, as in JAX
            object.__setattr__(self, "sequence_parallel", False)
        if self.micro_batch_size <= 0 or self.gradient_accumulation_steps <= 0:
            raise ValueError("micro_batch_size and gradient_accumulation_steps must be > 0")
        if min(self.model_parallel_size, self.data_parallel_size, self.pipe_parallel_size,
               self.pipe_virtual_size, self.pipe_token_slices,
               self.context_parallel_size) <= 0:
            raise ValueError("model_parallel_size, data_parallel_size, pipe_parallel_size, "
                             "pipe_virtual_size, pipe_token_slices and context_parallel_size "
                             "must be > 0")
        if self.context_parallel_variant not in CONTEXT_PARALLEL_VARIANTS:
            raise ValueError(f"context_parallel_variant {self.context_parallel_variant!r}: "
                             f"expected one of {CONTEXT_PARALLEL_VARIANTS}")
        if self.activation_checkpointing_type not in (
                ActivationCheckpointingType.DISABLED, ActivationCheckpointingType.EVERY_LAYER,
                ActivationCheckpointingType.EVERY_LAYER_SAVE_DOTS,
                ActivationCheckpointingType.EVERY_PIPE_STAGE):
            raise NotImplementedError(
                f"activation_checkpointing_type {self.activation_checkpointing_type!r} is "
                "not ported (disabled, every_layer, every_layer_save_dots, every_pipe_stage)")
        if self.pipe_partition_method not in PARTITION_METHODS:
            raise NotImplementedError(
                f"pipe_partition_method={self.pipe_partition_method!r} is not ported")
        # JAX's checks (scaling_tpu/topology/config.py)
        if self.context_parallel_size > 1 and self.pipe_parallel_size > 1:
            raise ValueError("context_parallel_size > 1 requires pipe_parallel_size == 1 "
                             "(ring attention replaces pipelining for long sequences)")
        if self.pipe_virtual_size > 1 and self.pipe_parallel_size < 2:
            raise ValueError("pipe_virtual_size > 1 requires pipe_parallel_size > 1 (virtual "
                             "stages interleave over the physical stage ring)")
        if self.pipe_token_slices > 1 and self.pipe_parallel_size < 2:
            raise ValueError("pipe_token_slices > 1 requires pipe_parallel_size > 1 (token "
                             "slices pipeline through the physical stages)")
        if self.pipe_virtual_size > 1 and self.pipe_token_slices > 1:
            raise ValueError("pipe_virtual_size and pipe_token_slices are mutually exclusive "
                             "(the executor interleaves micro-batches OR token slices, not "
                             "both)")
        if self.pipe_virtual_size > 1 and (
                self.gradient_accumulation_steps % self.pipe_parallel_size):
            raise ValueError(
                f"interleaved virtual stages need gradient_accumulation_steps "
                f"({self.gradient_accumulation_steps}) divisible by pipe_parallel_size "
                f"({self.pipe_parallel_size}): micro-batches are injected in full groups of pp")

    def check_sequence_parallel(self, sequence_length: int) -> None:
        """Under sequence parallelism, the local sequence (``sequence_length``
        over the context ranks and the token slices) must divide over the
        model group."""
        if not self.sequence_parallel:
            return
        local = sequence_length // (self.context_parallel_size * self.pipe_token_slices)
        if local % self.model_parallel_size:
            raise ValueError(
                f"sequence_parallel: the local sequence ({sequence_length} over "
                f"context_parallel_size {self.context_parallel_size} x pipe_token_slices "
                f"{self.pipe_token_slices} = {local}) does not divide over "
                f"model_parallel_size {self.model_parallel_size}")

    @property
    def world_size(self) -> int:
        return (self.model_parallel_size * self.data_parallel_size * self.pipe_parallel_size
                * self.context_parallel_size)

    @property
    def global_batch_size(self) -> int:
        return self.micro_batch_size * self.gradient_accumulation_steps * self.data_parallel_size

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TopologyConfig":
        d = dict(d)
        for key, values in _INERT.items():
            value = d.pop(key, None)
            if values is not None and value is not None and value not in values:
                raise NotImplementedError(f"{key}={value!r} is not ported")
        mp = d.pop("model_parallel_size", None)
        dp = d.pop("data_parallel_size", None)
        pp = d.pop("pipe_parallel_size", None)
        cp = d.pop("context_parallel_size", None) or 1
        world = d.pop("world_size", None)
        if sum(v is not None for v in (mp, pp, dp, world)) < 3:  # JAX: three of four
            mp, pp, dp = mp or 1, pp or 1, dp or 1
        if world is None:
            world = mp * pp * dp * cp
        if mp is None:
            mp = world // (pp * dp * cp)
        if pp is None:
            pp = world // (mp * dp * cp)
        if dp is None:
            dp = world // (mp * pp * cp)
        if mp * pp * dp * cp != world:
            raise ValueError(f"world_size {world} does not equal model_parallel_size ({mp}) x "
                             f"pipe_parallel_size ({pp}) x data_parallel_size ({dp}) x "
                             f"context_parallel_size ({cp})")
        gbs: Optional[int] = d.pop("global_batch_size", None)
        mbs = d.pop("micro_batch_size", None)
        gas = d.pop("gradient_accumulation_steps", None)
        if sum(v is not None for v in (gbs, mbs, gas)) < 2:
            raise ValueError("two of global_batch_size, micro_batch_size and "
                             "gradient_accumulation_steps must be set")
        if mbs is None:
            mbs = gbs // (gas * dp)
        if gas is None:
            gas = gbs // (mbs * dp)
        if gbs is not None and gbs != mbs * gas * dp:
            raise ValueError(f"global_batch_size {gbs} != micro_batch_size {mbs} x "
                             f"gradient_accumulation_steps {gas} x data_parallel_size {dp}")
        ckpt = d.pop("activation_checkpointing_type", ActivationCheckpointingType.DISABLED)
        vpp = d.pop("pipe_virtual_size", None) or 1
        method = d.pop("pipe_partition_method", None) or "uniform"
        overwrite = d.pop("pipe_partition_overwrite", None)
        slices = d.pop("pipe_token_slices", None) or 1
        variant = d.pop("context_parallel_variant", None) or "ring"
        sequence_parallel = d.pop("sequence_parallel", None)
        if d:
            raise ValueError(f"unknown topology keys: {sorted(d)}")
        return cls(micro_batch_size=mbs, gradient_accumulation_steps=gas,
                   activation_checkpointing_type=ckpt, model_parallel_size=mp,
                   data_parallel_size=dp, pipe_parallel_size=pp, pipe_virtual_size=vpp,
                   pipe_partition_method=method,
                   pipe_partition_overwrite=None if overwrite is None else tuple(overwrite),
                   pipe_token_slices=slices, context_parallel_size=cp,
                   context_parallel_variant=variant,
                   sequence_parallel=False if sequence_parallel is None else sequence_parallel)
