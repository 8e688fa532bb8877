"""The ``topology`` section of a config (a subset of
scaling_tpu/topology/config.py's ``TopologyConfig``): the port trains on
one device, so every parallel size must be 1. It reads the batch split
(``micro_batch_size``, ``gradient_accumulation_steps``,
``global_batch_size``: two of the three, as in the JAX config) and
``activation_checkpointing_type`` (``disabled``, ``every_layer`` or
``every_layer_save_dots``).
Any other value raises NotImplementedError and an unknown key
ValueError; the JAX key names are kept.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


class ActivationCheckpointingType:
    DISABLED = "disabled"
    EVERY_LAYER = "every_layer"
    EVERY_LAYER_SAVE_DOTS = "every_layer_save_dots"  # per-layer remat keeping matmul outputs


_PARALLEL = ("model_parallel_size", "pipe_parallel_size", "data_parallel_size",
             "context_parallel_size", "world_size", "pipe_virtual_size", "pipe_token_slices")
# keys at these values change nothing on one device
_INERT = {"global_rank": (None, 0), "local_slot": (None, 0),
          "context_parallel_variant": ("ring",), "sequence_parallel": (False,),
          "pipe_partition_method": ("uniform", "balanced"),
          "pipe_partition_overwrite": (None,)}


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    micro_batch_size: int
    gradient_accumulation_steps: int = 1
    activation_checkpointing_type: str = ActivationCheckpointingType.DISABLED

    def __post_init__(self):
        if self.micro_batch_size <= 0 or self.gradient_accumulation_steps <= 0:
            raise ValueError("micro_batch_size and gradient_accumulation_steps must be > 0")
        if self.activation_checkpointing_type not in (
                ActivationCheckpointingType.DISABLED, ActivationCheckpointingType.EVERY_LAYER,
                ActivationCheckpointingType.EVERY_LAYER_SAVE_DOTS):
            raise NotImplementedError(
                f"activation_checkpointing_type {self.activation_checkpointing_type!r} is "
                "not ported (disabled, every_layer, every_layer_save_dots)")

    @property
    def global_batch_size(self) -> int:
        return self.micro_batch_size * self.gradient_accumulation_steps

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TopologyConfig":
        d = dict(d)
        for key in _PARALLEL:
            value = d.pop(key, None)
            if value not in (None, 1):
                raise NotImplementedError(f"{key}={value}: the port trains on one device")
        for key, values in _INERT.items():
            value = d.pop(key, values[0])
            if value not in values:
                raise NotImplementedError(f"{key}={value!r} is not ported")
        gbs: Optional[int] = d.pop("global_batch_size", None)
        mbs = d.pop("micro_batch_size", None)
        gas = d.pop("gradient_accumulation_steps", None)
        if sum(v is not None for v in (gbs, mbs, gas)) < 2:
            raise ValueError("two of global_batch_size, micro_batch_size and "
                             "gradient_accumulation_steps must be set")
        if mbs is None:
            mbs = gbs // gas
        if gas is None:
            gas = gbs // mbs
        if gbs is not None and gbs != mbs * gas:
            raise ValueError(f"global_batch_size {gbs} != micro_batch_size {mbs} x "
                             f"gradient_accumulation_steps {gas}")
        ckpt = d.pop("activation_checkpointing_type", ActivationCheckpointingType.DISABLED)
        if d:
            raise ValueError(f"unknown topology keys: {sorted(d)}")
        return cls(micro_batch_size=mbs, gradient_accumulation_steps=gas,
                   activation_checkpointing_type=ckpt)
