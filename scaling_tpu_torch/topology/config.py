"""The ``topology`` section of a config (a subset of
scaling_tpu/topology/config.py's ``TopologyConfig``): data, model (tensor)
and pipeline parallelism over several worker processes, with JAX's
derivation of the sizes (three of ``model_parallel_size``,
``pipe_parallel_size``, ``data_parallel_size`` and ``world_size`` determine
the fourth; a config that gives fewer takes 1 for each missing parallel
size) and of the batch split (two of ``micro_batch_size``,
``gradient_accumulation_steps`` and ``global_batch_size``, with ``global =
micro x accumulation x data``), interleaved virtual stages
(``pipe_virtual_size``, with JAX's checks: it needs ``pipe_parallel_size``
above 1 and an accumulation that ``pipe_parallel_size`` divides), the
stage partition (``pipe_partition_method``, ``pipe_partition_overwrite``:
the uniform one, as JAX's executor places the layers; ``parallel.pipeline``),
and ``activation_checkpointing_type`` (``disabled``, ``every_layer``,
``every_layer_save_dots`` or ``every_pipe_stage``).

Context parallelism, token slices and sequence parallelism are not
ported: each raises NotImplementedError by name. An unknown key raises
ValueError; the JAX key names are kept.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


class ActivationCheckpointingType:
    DISABLED = "disabled"
    EVERY_LAYER = "every_layer"
    EVERY_LAYER_SAVE_DOTS = "every_layer_save_dots"  # per-layer remat keeping matmul outputs
    EVERY_PIPE_STAGE = "every_pipe_stage"  # one remat region a stage's chunk


# key -> (the value that leaves it off, why it is refused)
_REFUSED = {
    "context_parallel_size": (1, "context parallelism (ring, Ulysses) is not ported"),
    "pipe_token_slices": (1, "pipeline token slices are not ported"),
    "sequence_parallel": (False, "sequence parallelism is not ported"),
}
# keys at these values change nothing here; the launcher gives each
# process its rank (``global_rank``) and slot (``local_slot``)
_INERT = {"global_rank": None, "local_slot": None,
          "context_parallel_variant": ("ring", "ulysses")}
PARTITION_METHODS = ("uniform", "balanced")


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

    def __post_init__(self):
        if self.micro_batch_size <= 0 or self.gradient_accumulation_steps <= 0:
            raise ValueError("micro_batch_size and gradient_accumulation_steps must be > 0")
        if min(self.model_parallel_size, self.data_parallel_size, self.pipe_parallel_size,
               self.pipe_virtual_size) <= 0:
            raise ValueError("model_parallel_size, data_parallel_size, pipe_parallel_size and "
                             "pipe_virtual_size must be > 0")
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
        if self.pipe_virtual_size > 1 and self.pipe_parallel_size < 2:
            raise ValueError("pipe_virtual_size > 1 requires pipe_parallel_size > 1 (virtual "
                             "stages interleave over the physical stage ring)")
        if self.pipe_virtual_size > 1 and (
                self.gradient_accumulation_steps % self.pipe_parallel_size):
            raise ValueError(
                f"interleaved virtual stages need gradient_accumulation_steps "
                f"({self.gradient_accumulation_steps}) divisible by pipe_parallel_size "
                f"({self.pipe_parallel_size}): micro-batches are injected in full groups of pp")

    @property
    def world_size(self) -> int:
        return self.model_parallel_size * self.data_parallel_size * self.pipe_parallel_size

    @property
    def context_parallel_size(self) -> int:
        return 1

    @property
    def global_batch_size(self) -> int:
        return self.micro_batch_size * self.gradient_accumulation_steps * self.data_parallel_size

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TopologyConfig":
        d = dict(d)
        for key, (off, why) in _REFUSED.items():
            value = d.pop(key, None)
            if value is not None and value != off:
                raise NotImplementedError(f"{key}={value!r}: {why}")
        for key, values in _INERT.items():
            value = d.pop(key, None)
            if values is not None and value is not None and value not in values:
                raise NotImplementedError(f"{key}={value!r} is not ported")
        mp = d.pop("model_parallel_size", None)
        dp = d.pop("data_parallel_size", None)
        pp = d.pop("pipe_parallel_size", None)
        world = d.pop("world_size", None)
        if sum(v is not None for v in (mp, pp, dp, world)) < 3:  # JAX: three of four
            mp, pp, dp = mp or 1, pp or 1, dp or 1
        if world is None:
            world = mp * pp * dp
        if mp is None:
            mp = world // (pp * dp)
        if pp is None:
            pp = world // (mp * dp)
        if dp is None:
            dp = world // (mp * pp)
        if mp * pp * dp != world:
            raise ValueError(f"world_size {world} does not equal model_parallel_size ({mp}) x "
                             f"pipe_parallel_size ({pp}) x data_parallel_size ({dp})")
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
        if d:
            raise ValueError(f"unknown topology keys: {sorted(d)}")
        return cls(micro_batch_size=mbs, gradient_accumulation_steps=gas,
                   activation_checkpointing_type=ckpt, model_parallel_size=mp,
                   data_parallel_size=dp, pipe_parallel_size=pp, pipe_virtual_size=vpp,
                   pipe_partition_method=method,
                   pipe_partition_overwrite=None if overwrite is None else tuple(overwrite))
