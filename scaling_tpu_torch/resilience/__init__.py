"""Crash consistency and fault tolerance (the port's copy of
scaling_tpu/resilience/): fault injection, the atomic commit, the
integrity manifest and verified restore, ``MESH.json`` and the reshard
pre-flight, the in-loop guards, bounded auto-resume, and the supervision
control plane (heartbeats, barriers and flags over a shared directory or
a coordinator's TCP server)."""

from .commit import CheckpointCommit, checkpoint_candidates, scan_step_dirs, select_checkpoint
from .controlplane import (
    BarrierTimeout,
    ControlPlane,
    FileControlPlane,
    JobAborted,
    TcpControlPlane,
    TcpControlPlaneServer,
    controlplane_from_env,
    straggler_table,
)
from .faults import FaultPlan, InjectedFault, get_fault_plan, set_fault_plan
from .guards import (
    NonFiniteGuard,
    NonFiniteLossError,
    StepStallWatchdog,
    dump_thread_stacks,
    retry_io,
)
from .manifest import (
    CheckpointCorruptionError,
    prune_manifest_entries,
    read_manifest,
    verify_checkpoint,
)
from .meshmeta import (
    MESH_NAME,
    build_mesh_meta,
    mesh_matches,
    param_record,
    read_mesh_meta,
    signature_label,
    topology_signature,
    validate_param_tree,
    write_mesh_meta,
)
from .reshard import (
    ReshardError,
    ReshardPlan,
    fire_reshard_point,
    iter_global_leaves,
    rescale_consumed_samples,
    reshard_plan,
)
from .resume import run_with_resume

__all__ = [
    "MESH_NAME",
    "BarrierTimeout",
    "CheckpointCommit",
    "CheckpointCorruptionError",
    "ControlPlane",
    "FaultPlan",
    "FileControlPlane",
    "InjectedFault",
    "JobAborted",
    "NonFiniteGuard",
    "NonFiniteLossError",
    "ReshardError",
    "ReshardPlan",
    "StepStallWatchdog",
    "TcpControlPlane",
    "TcpControlPlaneServer",
    "build_mesh_meta",
    "checkpoint_candidates",
    "controlplane_from_env",
    "dump_thread_stacks",
    "fire_reshard_point",
    "get_fault_plan",
    "iter_global_leaves",
    "mesh_matches",
    "param_record",
    "prune_manifest_entries",
    "read_manifest",
    "read_mesh_meta",
    "rescale_consumed_samples",
    "reshard_plan",
    "retry_io",
    "run_with_resume",
    "scan_step_dirs",
    "select_checkpoint",
    "set_fault_plan",
    "signature_label",
    "straggler_table",
    "topology_signature",
    "validate_param_tree",
    "verify_checkpoint",
    "write_mesh_meta",
]
