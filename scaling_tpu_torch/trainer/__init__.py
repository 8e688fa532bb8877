"""The training loop (counterpart of scaling_tpu/trainer/)."""

from .trainer import BaseTrainer, EvaluationStepOutput, TrainerConfig, TrainStepOutput

__all__ = ["BaseTrainer", "EvaluationStepOutput", "TrainStepOutput", "TrainerConfig"]
