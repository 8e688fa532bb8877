"""The ``runner`` section and the worker's launch parameters (the port's
counterpart of scaling_tpu/runner/config.py, under the same keys and
defaults).

The port launches workers on this host only, one process a card, and
supervises them. What needs more than one host or more than one device
is refused by name at any value but the default: docker launches
(``runner_type: pdsh_docker``, ``docker_config``), elastic resizing and
capacity arbitration (``downsize_after``, ``downsize_model``,
``upsize_after``, ``arbitrate`` and the capacity keys beside them) and
``use_determined``.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import enum
import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

DEFAULT_SCRIPT = "scaling_tpu_torch.models.transformer.train"


class RunnerType(enum.Enum):
    PDSH = "pdsh"
    PDSH_DOCKER = "pdsh_docker"


@dataclasses.dataclass(frozen=True)
class DockerConfig:
    """The keys of a containerised launch (not ported: any
    ``docker_config`` raises)."""

    docker_container: Optional[str] = None
    docker_sudo: bool = False
    docker_mounts: Optional[List[List[str]]] = None
    docker_args: List[str] = dataclasses.field(default_factory=list)


# the keys of the elastic and capacity machinery, at the values that leave
# it off
_NOT_PORTED = {
    "downsize_after": None, "downsize_model": None, "upsize_after": None, "arbitrate": False,
    "min_hosts": 1, "capacity_stale_seconds": 15.0, "capacity_poll_seconds": 0.5,
    "min_train_hosts": 1, "capacity_pressure_high": 0.5, "capacity_sustain_seconds": 2.0,
    "capacity_idle_seconds": 2.0, "capacity_cooldown_seconds": 5.0,
    "lease_timeout_seconds": 30.0, "min_replicas": 1, "use_determined": False,
    "docker_config": None,
}
_POSITIVE = ("heartbeat_timeout_seconds", "startup_grace_seconds", "worker_grace_seconds",
             "supervisor_poll_seconds")
_NON_NEGATIVE = ("restart_budget", "restart_backoff_seconds")


@dataclasses.dataclass(frozen=True)
class RunnerConfig:
    """How workers are launched and supervised. With ``supervise`` the
    workers run under ``runner.supervise``: heartbeats through a control
    plane under ``control_dir`` (a fresh subdirectory an epoch),
    dead- and hung-worker detection, teardown, and up to
    ``restart_budget`` relaunches with a backoff that doubles from
    ``restart_backoff_seconds``. ``heartbeat_timeout_seconds`` must
    budget the longest silent stretch (a checkpoint save with its eval
    window), ``startup_grace_seconds`` a worker's start to its first
    heartbeat (imports, the card's context, the model, the checkpoint's
    load)."""

    runner_type: RunnerType = RunnerType.PDSH
    hostsfile: Optional[Union[str, Path]] = None
    hosts: Optional[List[str]] = None
    master_port: int = 29500
    master_addr: Optional[str] = None
    script: Optional[str] = DEFAULT_SCRIPT
    default_gpu_count: int = 8
    docker_config: Optional[DockerConfig] = None
    use_determined: bool = False
    supervise: bool = False
    control_dir: Optional[Union[str, Path]] = None
    heartbeat_timeout_seconds: float = 60.0
    startup_grace_seconds: float = 600.0
    restart_budget: int = 3
    restart_backoff_seconds: float = 1.0
    worker_grace_seconds: float = 15.0
    supervisor_poll_seconds: float = 0.2
    downsize_after: Optional[int] = None
    min_hosts: int = 1
    downsize_model: Optional[str] = None
    upsize_after: Optional[int] = None
    capacity_stale_seconds: float = 15.0
    capacity_poll_seconds: float = 0.5
    arbitrate: bool = False
    min_train_hosts: int = 1
    capacity_pressure_high: float = 0.5
    capacity_sustain_seconds: float = 2.0
    capacity_idle_seconds: float = 2.0
    capacity_cooldown_seconds: float = 5.0
    lease_timeout_seconds: float = 30.0
    min_replicas: int = 1

    def __post_init__(self):
        if self.runner_type != RunnerType.PDSH:
            raise NotImplementedError(f"runner.runner_type {self.runner_type.value} is not "
                                      "ported: workers launch on this host")
        for key, off in _NOT_PORTED.items():
            if getattr(self, key) != off:
                raise NotImplementedError(f"runner.{key} is not ported")
        for key in _POSITIVE:
            if not getattr(self, key) > 0:
                raise ValueError(f"runner.{key} must be > 0")
        for key in _NON_NEGATIVE:
            if getattr(self, key) < 0:
                raise ValueError(f"runner.{key} must be >= 0")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunnerConfig":
        d = dict(d)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown runner keys: {sorted(unknown)}")
        if "runner_type" in d:
            d["runner_type"] = RunnerType(d["runner_type"])
        if d.get("docker_config") is not None:
            d["docker_config"] = DockerConfig(**d["docker_config"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    """One worker's launch parameters, read back from the environment and
    ``--payload`` (the base64 JSON of the run's config)."""

    master_addr: str = "127.0.0.1"
    master_port: int = 29500
    world_size: int = 1
    global_rank: int = 0
    local_slot: int = 0
    payload: Optional[dict] = None

    @classmethod
    def from_launcher_args(cls, argv: Optional[List[str]] = None) -> "LaunchConfig":
        parser = argparse.ArgumentParser()
        parser.add_argument("--payload", type=str, default=None)
        args, _ = parser.parse_known_args(argv)
        payload = None
        if args.payload:
            payload = json.loads(base64.urlsafe_b64decode(args.payload).decode())
        return cls(master_addr=os.environ.get("MASTER_ADDR", "127.0.0.1"),
                   master_port=int(os.environ.get("MASTER_PORT", "29500")),
                   world_size=int(os.environ.get("WORLD_SIZE", "1")),
                   global_rank=int(os.environ.get("RANK", "0")),
                   local_slot=int(os.environ.get("LOCAL_SLOT", "0")),
                   payload=payload)
