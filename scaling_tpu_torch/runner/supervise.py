"""The supervisor: heartbeat monitoring, teardown and bounded relaunch on
this host (the port's counterpart of scaling_tpu/runner/supervise.py,
without elastic resizing and without remote hosts).

A worker killed by SIGKILL, an OOM or a segfault stays dead, and one
wedged where its own watchdog cannot reach (a hung loop top, a stuck CUDA
call) stays wedged, until someone restarts it. The supervisor launches
the workers of one *coordinator epoch*, watches their exit codes and
control-plane heartbeats, and on a dead or hung worker

1. raises the ``abort`` flag, so that survivors waiting at a barrier exit
   within a poll;
2. SIGTERMs the survivors and SIGKILLs what outlives
   ``worker_grace_seconds`` (a thread stuck in a CUDA call runs no
   Python signal handler), reaping each before the next epoch: a new
   worker needs the memory on the card the old one held;
3. relaunches the workers as a fresh epoch (a new control-plane
   directory, a new coordinator port) under a restart budget with a
   backoff that doubles.

The relaunched worker resumes from the newest checkpoint that verifies
(its ``load_dir`` is its ``save_dir``), so the losses are those of an
uninterrupted run. SIGTERM to the supervisor is relayed as SIGTERM to
every worker (never a direct flag write, see :func:`_relay_sigterm`):
the workers save at one step boundary and exit 0, and the epoch ends
clean, with no relaunch.

Every transition is an event (``logger.log_event``): ``epoch-start``,
``host-dead``, ``teardown-complete``, ``relaunch``, ``preempt-relay``,
``epoch-clean-exit``, ``epoch-stalled``, ``give-up``; the spans
``supervisor.epoch``, ``supervisor.teardown`` and ``supervisor.backoff``
time them, one trace an epoch. The supervisor never touches the card.
"""

from __future__ import annotations

import shutil
import signal
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, List

from ..logging.logger import logger
from ..obs.spans import derive_trace_id, span, trace_context
from ..resilience.controlplane import (
    ABORT_FLAG,
    ENV_CONTROL_DIR,
    ENV_COORD_EPOCH,
    ENV_HOST_ID,
    ENV_NUM_HOSTS,
    PREEMPT_FLAG,
    STALL_FLAG,
    FileControlPlane,
    straggler_table,
)
from .config import RunnerConfig
from .runner import (
    encode_payload,
    get_resource_pool,
    plan_workers,
    refuse_remote,
    spawn_worker,
    worker_env,
)


def classify_workers(exit_codes: List, heartbeats: Dict, *, heartbeat_timeout_s: float,
                     startup_grace_s: float, epoch_elapsed_s: float,
                     now: float) -> Dict[str, List[int]]:
    """Split one epoch's workers into dead, hung and alive.

    Dead: exited non-zero (a signal shows as a negative code). Hung:
    still running with its newest heartbeat absent or older than
    ``heartbeat_timeout_s``, once ``startup_grace_s`` has passed: the
    grace covers every staleness of a starting worker (imports, the
    card's context, the checkpoint's load), not only a missing first
    heartbeat. A worker whose last heartbeat says ``done`` or
    ``preempted`` is winding down, never hung. A worker that exited 0 is
    neither."""
    dead: List[int] = []
    hung: List[int] = []
    alive: List[int] = []
    for host, rc in enumerate(exit_codes):
        if rc is not None:
            if rc != 0:
                dead.append(host)
            continue
        hb = heartbeats.get(host)
        stale = hb is None or (hb.status not in ("done", "preempted")
                               and hb.age(now) > heartbeat_timeout_s)
        if stale:
            (hung if epoch_elapsed_s > startup_grace_s else alive).append(host)
        else:
            alive.append(host)
    return {"dead": dead, "hung": hung, "alive": alive}


def restart_backoff(attempt: int, base_s: float, cap_s: float = 60.0) -> float:
    """The relaunch delay of restart ``attempt`` (from 1): doubling from
    ``base_s``, capped at ``cap_s``."""
    return min(base_s * (2 ** (max(attempt, 1) - 1)), cap_s)


def _signal_local(p: subprocess.Popen, sig: str) -> None:
    """SIGTERM (``TERM``) or SIGKILL a worker; a failure is logged, not
    raised (a signal races the process's exit)."""
    try:
        (p.terminate if sig == "TERM" else p.kill)()
    except OSError as e:
        logger.warning(f"SIG{sig} to worker pid {p.pid} failed: {e!r}")


def _relay_sigterm(procs: List[subprocess.Popen]) -> None:
    """Drain at the supervisor's SIGTERM: SIGTERM every live worker
    instead of setting the preempt flag. A flag with no barrier arrival
    can be seen by two lockstep workers on either side of a barrier's
    release and split their exit boundaries; a worker's own handler
    enters the broadcast protocol at one of its decision points."""
    for p in procs:
        if p.poll() is None:
            _signal_local(p, "TERM")


def _teardown(cp: FileControlPlane, procs: List[subprocess.Popen],
              config: RunnerConfig) -> None:
    """Stop the survivors of a failed epoch without hanging: the abort
    flag, SIGTERM, SIGKILL after the grace, and every process reaped."""
    with span("supervisor.teardown", level="info"):
        _teardown_inner(cp, procs, config)


def _teardown_inner(cp: FileControlPlane, procs: List[subprocess.Popen],
                    config: RunnerConfig) -> None:
    try:
        cp.set_flag(ABORT_FLAG, "host-dead")
    except (OSError, RuntimeError, ValueError) as e:
        # the signals below are the real teardown
        logger.warning(f"abort flag write failed (continuing): {e!r}")
    for p in procs:
        if p.poll() is None:
            _signal_local(p, "TERM")
    deadline = time.monotonic() + config.worker_grace_seconds
    while time.monotonic() < deadline and any(p.poll() is None for p in procs):
        time.sleep(0.05)
    killed = []
    for p in procs:
        if p.poll() is None:
            killed.append(p.pid)
            _signal_local(p, "KILL")
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            logger.error(f"worker pid {p.pid} unreaped after SIGKILL")
    if killed:
        logger.warning(f"worker pid(s) {killed} survived the {config.worker_grace_seconds}s "
                       "SIGTERM grace (wedged?); SIGKILLed")
    logger.log_event("teardown-complete", killed_pids=killed, remote_hosts=[])


def _run_epoch(config: RunnerConfig, pool: Dict[str, int], workers: List[tuple],
               encoded: str, master_addr: str, control_root: Path, epoch: int,
               state: Dict[str, Any]) -> int:
    """One coordinator epoch: spawn, monitor and, on a failure, tear
    down. Returns 0 for a clean epoch (training finished or drained by a
    preemption), 1 when a worker died or hung, or a stall drained the
    workers. ``state["gone"]`` holds the workers the epoch lost."""
    epoch_dir = control_root / f"epoch-{epoch}"
    if epoch_dir.exists():
        # a previous supervisor's coordination state over the same root:
        # a stale abort flag or arrival would poison the new workers
        shutil.rmtree(epoch_dir)
    epoch_dir.mkdir(parents=True)
    num_hosts = len(workers)
    # the supervisor's view: heartbeat reads and flag writes, no barriers
    cp = FileControlPlane(epoch_dir, host_id=0, num_hosts=num_hosts)
    # a fresh port an epoch: the dead epoch's may linger in TIME_WAIT
    master_port = config.master_port + epoch
    procs: List[subprocess.Popen] = []
    for process_id, (host, _slot) in enumerate(workers):
        env = worker_env(pool, workers, process_id, master_addr, master_port)
        env.update({ENV_CONTROL_DIR: str(epoch_dir), ENV_HOST_ID: str(process_id),
                    ENV_NUM_HOSTS: str(num_hosts), ENV_COORD_EPOCH: str(epoch)})
        procs.append(spawn_worker(config, host, env, encoded))
    logger.log_event("epoch-start", epoch=epoch, num_hosts=num_hosts, master_port=master_port,
                     pids=[p.pid for p in procs])
    started = time.monotonic()
    preempt_broadcast = False
    state["gone"] = []
    while True:
        time.sleep(config.supervisor_poll_seconds)
        if state["preempted"] and not preempt_broadcast:
            _relay_sigterm(procs)
            preempt_broadcast = True
            logger.log_event("preempt-relay", host="supervisor", epoch=epoch)
        rcs = [p.poll() for p in procs]
        if all(rc is not None for rc in rcs):
            if all(rc == 0 for rc in rcs):
                stall = cp.get_flag(STALL_FLAG)
                if stall is not None:
                    # a stall watchdog drained the workers: they saved and
                    # exited 0, but training is not done
                    logger.log_event("epoch-stalled", epoch=epoch, stall_step=stall)
                    logger.error(f"epoch {epoch}: clean exit but the stall flag is set "
                                 f"(step {stall}); relaunching to resume")
                    return 1
                logger.log_event("epoch-clean-exit", epoch=epoch, preempted=preempt_broadcast
                                 or bool(cp.get_flag(PREEMPT_FLAG)))
                return 0
            bad = {h: rcs[h] for h in range(num_hosts) if rcs[h] != 0}
            state["gone"] = sorted(bad)
            logger.log_event("host-dead", epoch=epoch, hosts=sorted(bad), reason="exit",
                             exit_codes=bad)
            _teardown(cp, procs, config)
            return 1
        now = time.time()
        heartbeats = cp.peer_heartbeats()
        verdict = classify_workers(rcs, heartbeats,
                                   heartbeat_timeout_s=config.heartbeat_timeout_seconds,
                                   startup_grace_s=config.startup_grace_seconds,
                                   epoch_elapsed_s=time.monotonic() - started, now=now)
        if not verdict["dead"] and not verdict["hung"]:
            continue
        gone = verdict["dead"] or verdict["hung"]
        state["gone"] = sorted(gone)
        reason = "exit" if verdict["dead"] else "heartbeat-stale"
        # the snapshot that gave the verdict, not a fresher read
        report = straggler_table(heartbeats, num_hosts, config.heartbeat_timeout_seconds,
                                 now=now)
        logger.error(f"epoch {epoch}: host(s) {gone} {reason}; tearing down survivors\n"
                     f"{report.render()}")
        logger.log_event("host-dead", epoch=epoch, hosts=gone, reason=reason,
                         exit_codes={h: rcs[h] for h in verdict["dead"]})
        _teardown(cp, procs, config)
        return 1


def supervise_main(config: RunnerConfig, payload: Any) -> int:
    """Run the pool under supervision until training completes, a
    preemption drains it, or the restart budget is spent; returns the
    exit code."""
    if config.control_dir is None:
        raise ValueError("runner.supervise=true needs runner.control_dir (a directory every "
                         "host can reach, for the heartbeat control plane)")
    pool = get_resource_pool(config)
    refuse_remote(pool)
    workers = plan_workers(pool)
    master_addr = config.master_addr or list(pool)[0]
    encoded = encode_payload(payload)
    control_root = Path(config.control_dir)
    control_root.mkdir(parents=True, exist_ok=True)

    # SIGTERM to the supervisor drains the workers, chained to the
    # handler installed before
    state: Dict[str, Any] = {"preempted": False}
    prev = signal.getsignal(signal.SIGTERM)

    def on_sigterm(signum, frame):
        state["preempted"] = True
        if callable(prev):  # SIG_DFL and SIG_IGN are not callable
            prev(signum, frame)

    signal.signal(signal.SIGTERM, on_sigterm)
    restarts = 0
    epoch = 0
    while True:
        # one trace an epoch, derived from (root, epoch): a relaunched
        # supervisor over the same run re-derives the same ids
        with trace_context(derive_trace_id("supervisor-epoch", str(control_root), epoch)):
            with span("supervisor.epoch", level="info", epoch=epoch) as ep:
                rc = _run_epoch(config, pool, workers, encoded, master_addr, control_root,
                                epoch, state)
                ep.annotate(rc=rc)
        if rc == 0:
            return 0
        if state["preempted"]:
            # an operator's shutdown that also lost a worker: no relaunch
            logger.error("epoch failed during preemption drain; not relaunching")
            return rc
        restarts += 1
        if restarts > config.restart_budget:
            logger.log_event("give-up", epoch=epoch, restarts=restarts - 1,
                             budget=config.restart_budget)
            logger.error(f"supervisor restart budget exhausted ({config.restart_budget}); "
                         "giving up")
            return rc
        delay = restart_backoff(restarts, config.restart_backoff_seconds, cap_s=float("inf"))
        epoch += 1
        logger.log_event("relaunch", epoch=epoch, restarts=restarts,
                         budget=config.restart_budget, backoff_s=delay)
        logger.warning(f"relaunching as coordinator epoch {epoch} in {delay:.1f}s (restart "
                       f"{restarts}/{config.restart_budget}); workers will resume from the "
                       "newest valid checkpoint")
        with span("supervisor.backoff", level="info", epoch=epoch):
            time.sleep(delay)
