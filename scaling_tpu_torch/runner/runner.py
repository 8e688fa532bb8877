"""The launcher (the port's counterpart of scaling_tpu/runner/runner.py).

``runner_main`` resolves the resource pool from ``hostsfile`` or
``hosts``, and starts one worker process a slot on this host with the
run's config riding along as a base64 payload (``--payload``) and the
launch contract in its environment. With ``supervise`` it hands over to
``runner.supervise``; without, it babysits: a worker that exits
non-zero takes the others down (SIGTERM, then SIGKILL after a grace: a
peer may be stuck in a collective whose other side is gone). Hosts other
than this one would need the ssh launch, which is not ported: they raise
``NotImplementedError``.

On the worker's side ``initialize_distributed`` joins the workers into
one ``torch.distributed`` process group from the environment the
launcher wrote (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``), with the backend of
``topology.choose_backend``; it is a no-op for one process. Nothing here
touches the card: the launcher and the supervisor must leave all of its
memory to the workers.
"""

from __future__ import annotations

import base64
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

from ..obs.spans import span
from ..resilience.faults import get_fault_plan
from ..resilience.guards import retry_io
from .config import DEFAULT_SCRIPT, LaunchConfig, RunnerConfig

# the one definition of "local": spawn and teardown consult it
LOCAL_HOSTS = ("localhost", "127.0.0.1")
# seconds a torn-down worker has between SIGTERM and SIGKILL
TEARDOWN_GRACE_S = 10.0


def get_resource_pool(config: RunnerConfig) -> Dict[str, int]:
    """``hostsfile`` or ``hosts`` as an ordered ``{hostname: slots}``.
    Blank lines and ``#`` comments of a hostsfile are ignored; a host
    listed twice is an error (the last entry winning would launch the
    wrong world size)."""
    pool: Dict[str, int] = {}
    if config.hostsfile is not None:
        text = retry_io(Path(config.hostsfile).read_text,
                        what=f"hostsfile read {str(config.hostsfile)!r}")
        for lineno, raw in enumerate(text.splitlines(), start=1):
            line = raw.split("#")[0].strip()
            if not line:
                continue
            host, *rest = line.split()
            if host in pool:
                raise ValueError(
                    f"duplicate hostname {host!r} at line {lineno} of hostsfile "
                    f"{config.hostsfile}: each host must appear once (merge its slots= onto "
                    "the first entry)")
            slots = config.default_gpu_count
            for p in rest:
                if p.startswith("slots="):
                    slots = int(p.split("=")[1])
            pool[host] = slots
    elif config.hosts:
        for host in config.hosts:
            if host in pool:
                raise ValueError(f"duplicate hostname {host!r} in hosts list: each host must "
                                 "appear once")
            pool[host] = config.default_gpu_count
    else:
        pool["localhost"] = config.default_gpu_count
    return pool


def encode_payload(payload: Any) -> str:
    return base64.urlsafe_b64encode(json.dumps(payload).encode()).decode()


def build_worker_command(config: RunnerConfig, encoded_payload: str) -> List[str]:
    """The argv of one worker: this interpreter running ``config.script``
    as a module."""
    return [sys.executable, "-u", "-m", config.script or DEFAULT_SCRIPT,
            f"--payload={encoded_payload}"]


def is_local_pool(pool: Iterable[str]) -> bool:
    """Whether every host of ``pool`` (hostnames) is this machine."""
    return all(h in LOCAL_HOSTS for h in pool)


def refuse_remote(hosts: Iterable[str]) -> None:
    remote = sorted(h for h in hosts if h not in LOCAL_HOSTS)
    if remote:
        raise NotImplementedError(
            f"hosts {remote}: the ssh launch of workers on other hosts is not ported; "
            f"workers run on this host ({' or '.join(LOCAL_HOSTS)})")


def plan_workers(pool: Dict[str, int]) -> List[tuple]:
    """``(host, slot)`` a worker process. A pool of this host expands its
    slots into one process each; other hosts get one process each."""
    if is_local_pool(pool):
        return [(host, slot) for host, slots in pool.items() for slot in range(max(slots, 1))]
    return [(host, 0) for host in pool]


def worker_env(pool: Dict[str, int], workers: List[tuple], process_id: int,
               master_addr: str, master_port: int) -> Dict[str, str]:
    """The launch contract's environment of one worker, which
    ``LaunchConfig`` reads back (``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID`` keep the contract's names)."""
    host, slot = workers[process_id]
    return {
        "MASTER_ADDR": master_addr,
        "MASTER_PORT": str(master_port),
        # device slots, not processes
        "WORLD_SIZE": str(sum(max(s, 1) for s in pool.values())),
        "RANK": str(process_id),
        "LOCAL_SLOT": str(slot),
        "LOCAL_WORLD_SIZE": str(sum(1 for h, _ in workers if h == host)),
        "JAX_NUM_PROCESSES": str(len(workers)),
        "JAX_PROCESS_ID": str(process_id),
    }


def spawn_worker(config: RunnerConfig, host: str, env_exports: Dict[str, str],
                 encoded_payload: str) -> subprocess.Popen:
    """Start one worker process on this host."""
    get_fault_plan().fire("runner.worker.spawn")
    refuse_remote([host])
    return subprocess.Popen(build_worker_command(config, encoded_payload),
                            env={**os.environ, **env_exports})


def runner_main(config: RunnerConfig, payload: Any) -> int:
    """Launch ``config.script`` over the resource pool and return the exit
    code: under the supervisor with ``config.supervise``, else babysat
    (a worker that exits non-zero has the others terminated)."""
    if config.supervise:
        from .supervise import supervise_main

        return supervise_main(config, payload)
    pool = get_resource_pool(config)
    refuse_remote(pool)
    workers = plan_workers(pool)
    master_addr = config.master_addr or list(pool)[0]
    encoded = encode_payload(payload)
    procs = [spawn_worker(config, host, worker_env(pool, workers, i, master_addr,
                                                   config.master_port), encoded)
             for i, (host, _slot) in enumerate(workers)]
    exit_code, torn_down = 0, False
    try:
        while procs:
            for p in list(procs):
                ret = p.poll()
                if ret is None:
                    continue
                procs.remove(p)
                if ret != 0:  # the last non-zero code seen, as the JAX runner returns
                    exit_code = ret
                    if not torn_down:
                        torn_down = True
                        get_fault_plan().fire("runner.worker.kill")
                        with span("runner.teardown", rc=ret):
                            _terminate(procs)
            time.sleep(0.2)
    except KeyboardInterrupt:
        get_fault_plan().fire("runner.worker.kill")
        with span("runner.teardown", rc=130):
            _terminate(procs)
        exit_code = 130
    return exit_code


def _terminate(procs: List[subprocess.Popen]) -> None:
    """SIGTERM to every process of ``procs``, SIGKILL to those alive
    ``TEARDOWN_GRACE_S`` later."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + TEARDOWN_GRACE_S
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def initialize_distributed(launch_config: Optional[LaunchConfig] = None,
                           device_type: str = "cuda") -> str:
    """The worker's bootstrap: join the launch's process group (one rank a
    worker process) over the launcher's ``MASTER_ADDR:MASTER_PORT``, with
    the backend ``topology.choose_backend`` picks for ``device_type`` and
    the workers on this host. Returns the backend, or ``"none"`` for one
    process. A worker started without the launcher's environment raises."""
    num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return "none"
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "LOCAL_WORLD_SIZE")
               if k not in os.environ]
    if missing:
        raise ValueError(f"a launch of {num_processes} worker processes needs the "
                         f"launcher's environment; missing {missing}")
    from ..topology import init_distributed

    return init_distributed(num_processes, int(os.environ["RANK"]), os.environ["MASTER_ADDR"],
                            int(os.environ["MASTER_PORT"]), device_type=device_type,
                            local_world_size=int(os.environ["LOCAL_WORLD_SIZE"]))
