"""Launching and supervising the workers of a run on this host (the
port's counterpart of scaling_tpu/runner/). ``runner_main(config.runner,
payload)`` is the entry: it starts ``runner.script`` (by default
``scaling_tpu_torch.models.transformer.train``) with the run's config as
``--payload``, under the supervisor when ``runner.supervise`` is set."""

from .config import LaunchConfig, RunnerConfig, RunnerType
from .runner import get_resource_pool, initialize_distributed, runner_main
from .supervise import supervise_main

__all__ = [
    "LaunchConfig",
    "RunnerConfig",
    "RunnerType",
    "get_resource_pool",
    "initialize_distributed",
    "runner_main",
    "supervise_main",
]
