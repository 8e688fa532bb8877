"""The training step, whole, sharded or pipelined, the pipeline's schedules
and the collectives (counterpart of scaling_tpu/parallel/).
``ParallelModule`` is imported on first use: the layers and the optimizer
import ``parallel.collectives``, which ``parallel_module`` imports them
back through."""

__all__ = ["ParallelModule"]


def __getattr__(name):
    if name == "ParallelModule":
        from .parallel_module import ParallelModule

        return ParallelModule
    raise AttributeError(name)
