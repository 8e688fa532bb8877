"""Atomic checkpoint commit, integrity manifest and verified restore (the
subset of scaling_tpu/resilience/ the trainer uses)."""

from .commit import CheckpointCommit, checkpoint_candidates
from .guards import retry_io
from .manifest import (
    CheckpointCorruptionError,
    prune_manifest_entries,
    read_manifest,
    verify_checkpoint,
)

__all__ = [
    "CheckpointCommit",
    "CheckpointCorruptionError",
    "checkpoint_candidates",
    "prune_manifest_entries",
    "read_manifest",
    "retry_io",
    "verify_checkpoint",
]
