"""Learning-rate schedules (counterpart of
scaling_tpu/optimizer/learning_rate_scheduler.py): linear warmup to the
base LR, then constant, linear or cosine decay to
``learning_rate_minimum`` at ``learning_rate_decay_iters``, flat minimum
afterwards. Plain Python math on the host: the step count is a host
integer in the port, so no device op is spent on the schedule.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

DECAY_STYLES = ("constant", "linear", "cosine")


@dataclasses.dataclass(frozen=True)
class LearningRateSchedulerConfig:
    learning_rate: float = 0.0
    learning_rate_minimum: float = 0.0
    learning_rate_decay_style: str = "cosine"
    learning_rate_decay_iters: int = 0
    learning_rate_warmup_steps: int = 0

    def __post_init__(self):
        if self.learning_rate_decay_style not in DECAY_STYLES:
            raise ValueError(f"learning_rate_decay_style must be one of {DECAY_STYLES}")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LearningRateSchedulerConfig":
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown learning_rate_scheduler keys: {sorted(unknown)}")
        return cls(**d)


class LearningRateScheduler:
    def __init__(self, config: LearningRateSchedulerConfig):
        self.config = config

    def get_lr(self, step_index: int) -> float:
        c = self.config
        step = float(step_index)
        warmup_lr = c.learning_rate * step / max(float(c.learning_rate_warmup_steps), 1.0)
        if c.learning_rate_decay_style == "constant":
            post_warmup = c.learning_rate
        else:
            decay_span = max(float(c.learning_rate_decay_iters - c.learning_rate_warmup_steps),
                             1.0)
            ratio = min(max((step - c.learning_rate_warmup_steps) / decay_span, 0.0), 1.0)
            if c.learning_rate_decay_style == "linear":
                coeff = 1.0 - ratio
            else:
                coeff = 0.5 * (math.cos(math.pi * ratio) + 1.0)
            post_warmup = c.learning_rate_minimum + coeff * (
                c.learning_rate - c.learning_rate_minimum)
            if step > c.learning_rate_decay_iters:
                post_warmup = c.learning_rate_minimum
        in_warmup = c.learning_rate_warmup_steps > 0 and step <= c.learning_rate_warmup_steps
        return warmup_lr if in_warmup else post_warmup
