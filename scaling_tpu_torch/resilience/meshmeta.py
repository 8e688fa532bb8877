"""Mesh-shape-independent checkpoint metadata, ``MESH.json`` (the port's
copy of scaling_tpu/resilience/meshmeta.py, same schema).

Every checkpoint carries, next to ``MANIFEST.json``, the logical
parameter tree (for each parameter its JAX key, global shape in the JAX
layout, dtype and the partition spec the JAX metas give it) and the
saving topology. A restore compares the recorded topology with its own
(:func:`mesh_matches`) and pre-flights the global shapes
(:func:`validate_param_tree`) before it loads anything. A checkpoint
without ``MESH.json`` restores as before, at the same shape, unverified.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from .guards import retry_io
from .manifest import CheckpointCorruptionError

MESH_NAME = "MESH.json"
MESH_SCHEMA_VERSION = 1

# the topology fields whose change means another mesh wrote the layout
SIGNATURE_FIELDS = (
    "world_size",
    "pipe_parallel_size",
    "data_parallel_size",
    "context_parallel_size",
    "model_parallel_size",
    "pipe_virtual_size",
    "pipe_token_slices",
    "num_hosts",
)


def _spec_entry(part: Any) -> Any:
    """One partition-spec dim as JSON: None, an axis name, or a list of
    fused axis names."""
    if part is None or isinstance(part, str):
        return part
    if isinstance(part, (tuple, list)):
        return [str(p) for p in part]
    return str(part)


def param_record(shape, dtype, partition_spec) -> dict:
    """One parameter's logical record (its global shape, never a shard's)."""
    return {
        "shape": [int(s) for s in shape],
        "dtype": str(dtype),
        "partition_spec": [_spec_entry(p) for p in (partition_spec or ())],
    }


def topology_signature(topo: Dict[str, Any]) -> Dict[str, Any]:
    """The layout-identity slice of a topology dict; a missing field takes
    its single-host, unsliced value."""
    defaults = {"num_hosts": 1, "pipe_virtual_size": 1, "pipe_token_slices": 1}
    return {f: int(topo.get(f, defaults.get(f, 1)) or defaults.get(f, 1))
            for f in SIGNATURE_FIELDS}


def signature_label(topo: Dict[str, Any]) -> str:
    """A short label: ``world4·pp2·dp2·cp1·mp1·hosts1``."""
    sig = topology_signature(topo)
    parts = [f"world{sig['world_size']}", f"pp{sig['pipe_parallel_size']}",
             f"dp{sig['data_parallel_size']}", f"cp{sig['context_parallel_size']}",
             f"mp{sig['model_parallel_size']}"]
    if sig["pipe_virtual_size"] > 1:
        parts.append(f"v{sig['pipe_virtual_size']}")
    if sig["pipe_token_slices"] > 1:
        parts.append(f"ts{sig['pipe_token_slices']}")
    parts.append(f"hosts{sig['num_hosts']}")
    return "·".join(parts)


def mesh_matches(meta: Dict[str, Any], current_topology: Dict[str, Any]) -> bool:
    """Whether the checkpoint's saving topology is the restoring one."""
    return topology_signature(meta.get("topology", {})) == topology_signature(current_topology)


def build_mesh_meta(topology: Dict[str, Any], params: Dict[str, dict],
                    optimizer: Optional[Dict[str, Any]] = None,
                    step: Optional[int] = None) -> dict:
    """The ``MESH.json`` payload. ``params`` maps a JAX key to its
    :func:`param_record`; ``optimizer`` holds the optimizer-state layout."""
    return {
        "schema_version": MESH_SCHEMA_VERSION,
        "step": step,
        "topology": dict(topology),
        "params": dict(params),
        "optimizer": dict(optimizer or {}),
    }


def write_mesh_meta(stage_dir: Union[Path, str], meta: dict) -> Path:
    """Write ``MESH.json`` into a checkpoint's staging directory, where the
    commit's manifest digests it like every other file."""
    out = Path(stage_dir) / MESH_NAME
    text = json.dumps(meta, indent=1, sort_keys=True)
    retry_io(lambda: out.write_text(text), what="MESH.json stage write")
    return out


def read_mesh_meta(step_dir: Union[Path, str]) -> Optional[dict]:
    """The parsed ``MESH.json``, or None when there is none. An unparseable
    or newer one raises CheckpointCorruptionError: a checkpoint that claims
    mesh metadata it cannot deliver must not restore as a legacy one."""
    f = Path(step_dir) / MESH_NAME
    if not f.is_file():
        return None
    try:
        payload = json.loads(f.read_text())
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointCorruptionError(f"{f}: unreadable MESH.json ({e})") from e
    if not isinstance(payload, dict):
        raise CheckpointCorruptionError(f"{f}: MESH.json is not an object")
    if payload.get("schema_version", 0) > MESH_SCHEMA_VERSION:
        raise CheckpointCorruptionError(
            f"{f}: MESH.json schema {payload.get('schema_version')} is newer than this "
            f"build understands ({MESH_SCHEMA_VERSION})")
    return payload


def validate_param_tree(meta: Dict[str, Any], current_params: Dict[str, dict]) -> List[str]:
    """The global-shape disagreements between the recorded tree and
    ``current_params`` ([] means compatible). Keys only one side has are
    left to the loader's allow lists."""
    problems: List[str] = []
    recorded = meta.get("params", {})
    for key, rec in current_params.items():
        old = recorded.get(key)
        if old is not None and list(old.get("shape", [])) != list(rec.get("shape", [])):
            problems.append(f"{key}: global shape {old.get('shape')} (saved) != "
                            f"{rec.get('shape')} (restoring): not a reshard, a different model")
    return problems
