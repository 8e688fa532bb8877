"""Dynamic loss scaling (counterpart of scaling_tpu/optimizer/loss_scaler.py).

Ride the edge of the highest non-overflowing scale: on overflow burn a
hysteresis credit or back off by ``factor`` (floored at ``min_scale``);
after ``window`` consecutive clean steps scale back up by ``factor``.
The state is host-side: the optimizer reads the overflow flag from the
card once per step when the scaler is on.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class LossScalerConfig:
    enable: bool = False
    initial_scale: float = 2.0 ** 32
    window: int = 1000
    hysteresis: float = 2
    consecutive_hysteresis: bool = False
    min_scale: float = 1.0
    factor: float = 2.0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LossScalerConfig":
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown loss_scaler keys: {sorted(unknown)}")
        return cls(**d)


@dataclasses.dataclass
class LossScalerState:
    current_scale: float
    current_hysteresis: float
    no_overflow_steps: int = 0


class LossScalerOutput(NamedTuple):
    overflow: bool
    no_overflow_steps: int
    current_loss_scale: float


def has_inf_or_nan(leaf_norms: List[torch.Tensor]) -> torch.Tensor:
    """Device bool: some leaf holds a non-finite value. Takes the leaves'
    L2 norms (one ``_foreach_norm``): a norm is non-finite iff its leaf
    holds inf or nan, or its squares sum past f32's range (|norm| >
    ~1.8e19, far beyond any gradient the scaler lets through)."""
    return ~torch.isfinite(torch.stack(leaf_norms)).all()


class LossScaler:
    def __init__(self, config: LossScalerConfig):
        self.config = config

    def init_state(self) -> LossScalerState:
        return LossScalerState(float(self.config.initial_scale), float(self.config.hysteresis))

    def scale_loss(self, loss: torch.Tensor, state: LossScalerState) -> torch.Tensor:
        if not self.config.enable:
            return loss
        return loss * state.current_scale

    def step(self, state: LossScalerState, overflow: bool) -> LossScalerOutput:
        """Advance ``state`` in place after a step with ``overflow``."""
        c = self.config
        if not c.enable:
            return LossScalerOutput(False, state.no_overflow_steps, state.current_scale)
        if overflow:
            if c.hysteresis != 1 and state.current_hysteresis > 1:
                state.current_hysteresis -= 1
            else:
                state.current_scale = max(state.current_scale / c.factor, c.min_scale)
            state.no_overflow_steps = 0
        else:
            window_hit = state.no_overflow_steps > 0 and state.no_overflow_steps % c.window == 0
            if window_hit:
                state.current_scale *= c.factor
            if c.consecutive_hysteresis or window_hit:
                state.current_hysteresis = float(c.hysteresis)
            state.no_overflow_steps += 1
        return LossScalerOutput(overflow, state.no_overflow_steps, state.current_scale)
