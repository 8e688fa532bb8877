"""The restore's pre-flight across mesh shapes (the port's copy of the
policy half of scaling_tpu/resilience/reshard.py).

The checkpoint format holds global arrays per logical layer, so a
checkpoint another topology wrote loads on the port's one device as it
is. What this module adds is the policy around that: :func:`reshard_plan`
compares the checkpoint's ``MESH.json`` with the restoring topology and
refuses a global-shape disagreement (a different model, never a
reshard); :func:`rescale_consumed_samples` carries the data cursor across
the change of batch grid.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np

from .faults import get_fault_plan
from .guards import retry_io
from .meshmeta import mesh_matches, signature_label, topology_signature, validate_param_tree

_log = logging.getLogger("scaling_tpu_torch")


class ReshardError(ValueError):
    """The checkpoint cannot be restored onto this topology (another model,
    or a batch grid that does not divide its data cursor). Not a corruption
    error: an older checkpoint would meet the same wall."""


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    """One restore's mesh transition."""

    saved: Dict[str, int]
    restoring: Dict[str, int]

    @property
    def saved_label(self) -> str:
        return signature_label(self.saved)

    @property
    def restoring_label(self) -> str:
        return signature_label(self.restoring)

    def event_fields(self) -> dict:
        """The fields of the ``ckpt-reshard`` event."""
        return {"saved": self.saved_label, "restoring": self.restoring_label,
                "saved_world": self.saved["world_size"],
                "restoring_world": self.restoring["world_size"],
                "saved_hosts": self.saved["num_hosts"],
                "restoring_hosts": self.restoring["num_hosts"]}


def reshard_plan(mesh_meta: Optional[dict], current_topology: Dict[str, Any],
                 current_params: Optional[Dict[str, dict]] = None) -> Optional[ReshardPlan]:
    """None for a checkpoint without ``MESH.json`` or one saved at this
    topology; else the transition, after the global shapes of
    ``current_params`` passed the pre-flight (ReshardError otherwise)."""
    if mesh_meta is None or mesh_matches(mesh_meta, current_topology):
        return None
    plan = ReshardPlan(saved=topology_signature(mesh_meta.get("topology", {})),
                       restoring=topology_signature(current_topology))
    if current_params is not None:
        problems = validate_param_tree(mesh_meta, current_params)
        if problems:
            raise ReshardError(f"cannot reshard {plan.saved_label} -> "
                               f"{plan.restoring_label}: " + "; ".join(problems))
    return plan


def fire_reshard_point(step_dir: Union[Path, str], plan: ReshardPlan) -> None:
    """The ``ckpt.reshard`` fault point: fired once per engaged reshard
    restore, before any leaf is loaded."""
    get_fault_plan().fire("ckpt.reshard", path=step_dir)
    _log.info(f"resharding checkpoint {Path(step_dir).name}: "
              f"{plan.saved_label} -> {plan.restoring_label}")


def rescale_consumed_samples(consumed_samples: int, *, micro_batch_size: int,
                             data_parallel_size: int, what: str = "consumed_samples",
                             on_misaligned: str = "error") -> int:
    """The data cursor across a mesh change. ``consumed_samples`` counts
    global samples, so the same number resumes the stream exactly,
    provided the new ``micro_batch_size * data_parallel_size`` grid divides
    it. ``on_misaligned="error"`` (the training cursor) raises otherwise;
    ``"floor"`` (the evaluation cursor) aligns down with a warning."""
    grid = micro_batch_size * data_parallel_size
    if grid <= 0:
        raise ReshardError(f"invalid batch grid mbs*dp = {grid}")
    if consumed_samples % grid == 0:
        return consumed_samples
    if on_misaligned == "floor":
        aligned = (consumed_samples // grid) * grid
        _log.warning(f"{what} ({consumed_samples}) is not a multiple of the new mbs*dp grid "
                     f"({grid}); aligning down to {aligned} "
                     f"({consumed_samples - aligned} sample(s) will be re-seen)")
        return aligned
    raise ReshardError(
        f"{what} ({consumed_samples}) is not divisible by the new micro_batch_size * "
        f"data_parallel_size ({grid}): resuming here would split a micro-batch stride "
        f"mid-step. Pick a batch hierarchy whose mbs*dp divides {consumed_samples}; the "
        "saving run's global_batch_size always does")


def iter_global_leaves(step_dir: Union[Path, str], *, retry_attempts: int = 3,
                       retry_backoff: float = 0.05) -> Iterator[Tuple[str, str, np.ndarray]]:
    """``(file name, entry name, global array)`` for every model and
    optimizer artifact of an npz checkpoint, one array in memory at a
    time. Each file is opened through ``retry_io``, behind the
    ``restore.assemble`` fault point: any reader gets the global arrays
    without a model and without the mesh that saved them."""
    step_dir = Path(step_dir)
    files = (sorted(step_dir.glob("model_state_layer_*.npz"))
             + sorted(step_dir.glob("optimizer_state_layer_*.npz")))
    for f in files:
        def open_file(path=f):
            get_fault_plan().fire("restore.assemble", path=path)
            return np.load(path, allow_pickle=False)

        z = retry_io(open_file, attempts=retry_attempts, base_delay=retry_backoff,
                     what=f"reshard assemble {f.name}")
        try:
            for name in z.files:
                yield f.name, name, z[name]
        finally:
            z.close()
