"""The training step on one device (counterpart of scaling_tpu/parallel/)."""

from .parallel_module import ParallelModule

__all__ = ["ParallelModule"]
