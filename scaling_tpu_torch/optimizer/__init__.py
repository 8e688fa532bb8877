"""AdamW with f32 masters, LR schedules and loss scaling (counterpart of
scaling_tpu/optimizer/)."""

from .learning_rate_scheduler import LearningRateScheduler, LearningRateSchedulerConfig
from .loss_scaler import (
    LossScaler,
    LossScalerConfig,
    LossScalerOutput,
    LossScalerState,
    has_inf_or_nan,
)
from .optimizer import (
    Optimizer,
    OptimizerConfig,
    OptimizerParamGroup,
    OptimizerState,
    OptimizerStepOutput,
)

__all__ = [
    "LearningRateScheduler",
    "LearningRateSchedulerConfig",
    "LossScaler",
    "LossScalerConfig",
    "LossScalerOutput",
    "LossScalerState",
    "Optimizer",
    "OptimizerConfig",
    "OptimizerParamGroup",
    "OptimizerState",
    "OptimizerStepOutput",
    "has_inf_or_nan",
]
