"""Determined AI cluster glue (counterpart of
``scaling_tpu/determined/__init__.py``).

Determined is OPTIONAL infrastructure, not a trainer dependency. The
capability set the reference framework's glue provided — preemption
polling, metric reporting, checkpoint hand-off, latest-checkpoint
discovery — maps onto hooks the port's trainer already exposes
(``external_preemption``, ``metrics_hooks``, ``checkpoint_hooks``, a
load-dir override to ``initialize``). This module wires a Determined core
context into those hooks when, and only when, the SDK is importable AND
the process runs inside a Determined task; everywhere else ``detect()``
returns None and training proceeds exactly as before. The reference's
Determined-side checkpoint GC is replaced by the trainer's own checkpoint
pruning, which runs on any cluster.
"""

from __future__ import annotations

import contextlib
import importlib
from pathlib import Path
from typing import Any, Iterator, Optional

from ..logging import logger

__all__ = ["DeterminedGlue"]


def _process_count() -> int:
    """Processes of the job: ``torch.distributed``'s world when a process
    group is up, else one."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _import_sdk():
    try:
        return importlib.import_module("determined")
    except ImportError:
        return None


class DeterminedGlue:
    """One live Determined core context, adapted to trainer hooks."""

    def __init__(self, det: Any, core_context: Any):
        self._det = det
        self._ctx = core_context
        # det.core.init() returns a context-manager Context; keep it open
        # for the training run and close it in close()
        self._core = (
            core_context.__enter__() if hasattr(core_context, "__enter__")
            else core_context
        )

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def detect(cls) -> Optional["DeterminedGlue"]:
        """A glue instance when running inside a Determined task, else None
        (SDK missing, or installed but no cluster info — e.g. local runs)."""
        det = _import_sdk()
        if det is None:
            return None
        try:
            if det.get_cluster_info() is None:
                return None
            core_context = det.core.init()
        except Exception as e:  # a broken cluster env must not kill training
            logger.warning(f"determined detected but init failed: {e}")
            return None
        logger.info("running under Determined: preemption polling, metric "
                    "reporting and checkpoint hand-off active")
        return cls(det, core_context)

    def close(self) -> None:
        if hasattr(self._ctx, "__exit__"):
            self._ctx.__exit__(None, None, None)

    # ------------------------------------------------------------ adapters
    def should_preempt(self) -> bool:
        try:
            return bool(self._core.preempt.should_preempt())
        except Exception as e:
            # polled after EVERY step: a transient master error must not
            # kill a training run that was healthy moments ago (the real
            # preemption signal will come back on a later poll)
            logger.warning(f"determined preempt poll failed: {e}")
            return False

    def report_metrics(self, metrics: dict, step: int) -> None:
        try:
            numeric = {}
            for k, v in metrics.items():
                # hasattr(__float__) admits multi-element arrays whose
                # float() raises; the conversion stays inside the guard
                if isinstance(v, (int, float)) or hasattr(v, "__float__"):
                    try:
                        numeric[k] = float(v)
                    except (TypeError, ValueError):
                        continue
            self._core.train.report_training_metrics(
                steps_completed=int(step), metrics=numeric
            )
        except Exception as e:  # metrics must never abort a step
            logger.warning(f"determined metric report failed: {e}")

    def upload_checkpoint(self, step_dir: Path | str, step: int) -> None:
        """Hand a finished on-disk checkpoint to Determined's storage: the
        trainer's own save stays canonical and Determined receives a copy,
        so the same checkpoint works on and off the cluster.

        Several processes: each uploads with ``shard=True`` and Determined
        merges. If the installed SDK lacks sharded upload, process 0
        uploads alone — complete only when ``save_dir`` is a shared
        filesystem, so that fallback warns."""
        metadata = {"steps_completed": int(step)}
        try:
            if _process_count() > 1:
                try:
                    self._core.checkpoint.upload(
                        str(step_dir), metadata=metadata, shard=True
                    )
                    return
                except TypeError:
                    if _process_index() != 0:
                        return
                    logger.warning(
                        "determined SDK lacks sharded upload; uploading from "
                        "process 0 only — the checkpoint is complete only if "
                        "save_dir is a shared filesystem"
                    )
            self._core.checkpoint.upload(str(step_dir), metadata=metadata)
        except Exception as e:
            logger.warning(f"determined checkpoint upload failed: {e}")

    @contextlib.contextmanager
    def latest_checkpoint(self) -> Iterator[Optional[Path]]:
        """Download path of the experiment's latest checkpoint, or None on
        a fresh start."""
        info = self._det.get_cluster_info()
        latest = getattr(info, "latest_checkpoint", None) if info else None
        if latest is None:
            yield None
            return
        with self._core.checkpoint.restore_path(latest) as path:
            yield Path(path)

    # ------------------------------------------------------------ wiring
    def attach(self, trainer: Any) -> None:
        """Plug this context into the trainer's generic hook points.

        Preemption is polled on EVERY process (Determined expects all
        workers to call should_preempt). Metric reporting happens once
        per job, from process 0. Checkpoint upload runs on every process
        (see upload_checkpoint); a single process uploads exactly once."""
        trainer.external_preemption = self.should_preempt
        trainer.checkpoint_hooks.append(self.upload_checkpoint)
        if _process_index() == 0:
            trainer.metrics_hooks.append(self.report_metrics)
