"""Bounded auto-resume (the port's copy of scaling_tpu/resilience/resume.py).

``run_with_resume`` rebuilds the trainer after a recoverable failure;
the new trainer's ``load_checkpoint`` restores the newest checkpoint that
verifies, and training goes on, up to ``restart_budget`` restarts. A
resumed run repeats the losses of an uninterrupted one: the data stream
is a function of (seed, consumed_samples).

Recoverable by default is transient I/O (``OSError``: storage blips,
injected faults). Not by default: ``NonFiniteLossError`` (a diverged run
restarts into the same divergence), configuration errors and OOMs.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Optional, Tuple, Type

_log = logging.getLogger("scaling_tpu_torch")


def run_with_resume(trainer_factory: Callable[[], Any], restart_budget: int = 3,
                    recoverable: Tuple[Type[BaseException], ...] = (OSError,),
                    log_metrics_fn: Optional[Callable] = None) -> Any:
    """Train to completion, restarting on ``recoverable`` failures.

    ``trainer_factory`` builds a fresh, initialised trainer whose
    ``load_dir`` is the run's ``save_dir`` (``assert_checkpoint_loaded``
    off for the cold start). Returns the trainer that finished; the last
    failure re-raises once the budget is spent."""
    restarts = 0
    while True:
        trainer = trainer_factory()
        try:
            trainer.run_training(log_metrics_fn=log_metrics_fn)
            return trainer
        except recoverable as e:
            trainer.stop_prefetch()  # releases the failed trainer and its tensors
            restarts += 1
            if restarts > restart_budget:
                _log.error(f"restart budget exhausted ({restart_budget}); giving up on "
                           f"{type(e).__name__}: {e}")
                raise
            _log.warning(f"recoverable failure ({type(e).__name__}: {e}); restart "
                         f"{restarts}/{restart_budget} from the newest valid checkpoint")
