"""Deterministic fault injection (the port's copy of
scaling_tpu/resilience/faults.py: the same environment variable, spec
grammar, actions and point names).

Code paths call ``get_fault_plan().fire("<point>")`` at named points;
with no plan armed that is a counter bump. A plan comes from the
``SCALING_TPU_FAULTS`` environment variable (inherited by a training
subprocess, so a parent can kill a child at an exact write) or from
:func:`set_fault_plan`.

Points wired into the port:

==================  =====================================================
point               fired
==================  =====================================================
``ckpt.write``      once per checkpoint npz write attempt, before the
                    bytes land (``checkpoint._write_npz``); ``corrupt``
                    truncates the file after the write
``ckpt.manifest``   before ``MANIFEST.json`` is written
                    (``CheckpointCommit.finalize``)
``ckpt.rename``     after the manifest and the fsyncs, before the atomic
                    staging-dir -> ``global_stepN`` rename
``ckpt.reshard``    once per engaged reshard restore (the checkpoint's
                    ``MESH.json`` topology differs from the restoring
                    one), before any leaf is loaded
                    (``reshard.fire_reshard_point``, from the Trainer's
                    load)
``restore.assemble`` once per checkpoint npz opened during a restore
                    (``checkpoint._open_artifact`` and the model-free
                    ``reshard.iter_global_leaves``); ``fail`` is an
                    ``OSError`` in the Trainer's bounded-retry load: a
                    transient one is retried, a persistent one demotes
                    the checkpoint to the next valid one
``data.read``       once per dataloader micro-batch read attempt
                    (``DataLoader._read_batch``, inside its retry)
``step.nan_grads``  once per train step after the step returns; ``nan``
                    poisons the observed loss (the parameters stay clean)
``signal.sigterm``  at the top of every ``run_training`` iteration;
                    ``sigterm`` delivers a real SIGTERM to this process
``host.kill``       same site; arm ``kill`` to crash at a step boundary
``host.hang``       same site; arm ``hang`` to wedge the loop
``barrier.timeout`` on every control-plane ``barrier()`` entry, before
                    this host's arrival: ``kill`` dies between the host's
                    work and the rendezvous
``ckpt.commit_barrier``
                    after this host's commit (manifest and rename), before
                    the ``commit:step-N`` barrier of several hosts
``runner.worker.spawn``
                    before the runner starts each worker process
                    (``runner.spawn_worker``); ``fail`` is a launch failure
``runner.worker.kill``
                    when the babysitting runner terminates the other
                    workers after one exited non-zero or on Ctrl-C
``serve.tick``      at the top of every serving-engine tick
                    (``serve.engine.ServeEngine.tick``): ``kill`` is the
                    crash-replay drill's mid-run crash, ``hang`` the
                    wedged tick the bench's watchdog kills
``serve.admit``     once per ``ServeEngine.submit`` call, before the
                    admission and backpressure decision
``serve.journal``   once per request-journal append
                    (``serve.journal.RequestJournal``); ``fail`` is an
                    IOError at the journal write
``serve.pool``      once per KV-block allocation batch of the scheduler
                    (admission, growth, copy-on-write forks)
``serve.supervisor.spawn``
                    before ``serve bench --restarts`` launches each child
``serve.stall.kill``
                    when the bench's tick watchdog fires, before it
                    SIGKILLs its own process
``serve.replica.spawn``
                    host side, once per replica subprocess launch
                    (``serve.replica_proc``: initial spawns, supervised
                    relaunches, autoscale spawns); ``fail`` is an OSError
                    the fleet supervisor's budgeted backoff absorbs
``serve.replica.rpc``
                    worker side, at the top of every handled RPC request
                    (submit, poll, stats, drain); ``fail`` drops that
                    reply and the host's ``retry_io`` retries. Advisory
                    network actions, applied by the handler: ``delay``
                    sleeps 0.25 s before serving (a slow link),
                    ``partition`` drops the request before it is served
                    (the op never happened), ``drop`` serves it and drops
                    the reply (admitted but unacknowledged: the window
                    the idempotent submit and the router's in-doubt parks
                    exist for)
``serve.replica.net_partition``
                    worker side, before a handled RPC is looked at;
                    ``partition@N xM @host=K`` cuts one host off for M
                    requests (the partition drill)
``serve.replica.rendezvous``
                    on every rendezvous-file operation: the worker's
                    address publish, the host's reads while it waits for
                    a spawned replica, the worker-config write; ``fail``
                    is an OSError inside the ``retry_io`` they all ride
``serve.replica.teardown``
                    host side, before one replica worker is force-killed;
                    ``fail`` aborts that kill
``serve.replica.kill``
                    worker side, before each engine tick while the
                    replica has work; ``kill@N@host=K`` (a worker exports
                    ``SCALING_TPU_HOST_ID=<replica id>``) SIGKILLs exactly
                    one replica mid-stream: the journal-exact failover
                    drill
``serve.replica.hung_kill``
                    host side, before the supervisor SIGKILLs a replica
                    it classified hung
``serve.fleet.teardown``
                    host side, once the process fleet's run is over,
                    before the bench waits for its workers to exit
==================  =====================================================

Spec grammar (comma list): ``point=action[@N][xM][@host=K][@epoch=E]``
fires ``action`` on hits ``N .. N+M-1`` of ``point`` (1-based; ``N``
defaults to 1, ``M`` to 1, ``x*`` means every hit from ``N`` on). A point
may appear in several entries; every rule sees every hit and the first
armed match fires. ``@host=K`` scopes a rule to the process whose
``SCALING_TPU_HOST_ID`` is ``K``, ``@epoch=E`` to the one whose
``SCALING_TPU_COORD_EPOCH`` is ``E``, both read at fire time; elsewhere
the rule never fires, though hits are counted. Actions:

- ``kill``     SIGKILL this process (no cleanup runs: a real crash)
- ``fail``     raise :class:`InjectedFault` (an ``IOError``, so the
               bounded-retry guards treat it as transient)
- ``sigterm``  deliver SIGTERM to this process
- ``hang``     block this thread forever
- ``corrupt``, ``nan``, ``drop``, ``delay``, ``partition``  advisory:
               returned to the call site, which applies it

Example: ``SCALING_TPU_FAULTS="ckpt.write=kill@13,data.read=fail@1x2"``.
"""

from __future__ import annotations

import logging
import os
import re
import signal
import time
from pathlib import Path
from typing import Dict, List, Optional, Union

ENV_VAR = "SCALING_TPU_FAULTS"
HOST_ID_ENV = "SCALING_TPU_HOST_ID"
EPOCH_ENV = "SCALING_TPU_COORD_EPOCH"

ACTIONS = ("kill", "fail", "sigterm", "hang", "corrupt", "nan", "drop", "delay", "partition")
# actions fire() carries out itself; the others are returned to the call site
_EXECUTED = ("kill", "fail", "sigterm", "hang")

_SPEC_RE = re.compile(
    r"^(?P<point>[a-z_.]+)=(?P<action>[a-z]+)"
    r"(?:@(?P<first>\d+))?(?:x(?P<count>\d+|\*))?"
    r"(?:@host=(?P<host>\d+))?(?:@epoch=(?P<epoch>\d+))?$"
)

_log = logging.getLogger("scaling_tpu_torch")


class InjectedFault(IOError):
    """A deliberately injected transient I/O failure (retryable)."""


class _Rule:
    __slots__ = ("action", "first", "count", "host", "epoch")

    def __init__(self, action: str, first: int, count: Optional[int],
                 host: Optional[int] = None, epoch: Optional[int] = None):
        self.action = action
        self.first = first
        self.count = count  # None: every hit from ``first`` on
        self.host = host
        self.epoch = epoch

    def matches(self, hit: int) -> bool:
        for wanted, env in ((self.host, HOST_ID_ENV), (self.epoch, EPOCH_ENV)):
            if wanted is not None:
                here = os.environ.get(env)
                if here is None or int(here) != wanted:
                    return False
        if hit < self.first:
            return False
        return self.count is None or hit < self.first + self.count


class FaultPlan:
    """A parsed plan and its per-point hit counters."""

    def __init__(self, spec: str = ""):
        self.spec = spec
        self._rules: Dict[str, List[_Rule]] = {}
        self._hits: Dict[str, int] = {}
        for entry in filter(None, (s.strip() for s in spec.split(","))):
            m = _SPEC_RE.match(entry)
            if not m:
                raise ValueError(f"bad fault spec entry {entry!r}; expected "
                                 "point=action[@N][xM] (e.g. ckpt.write=kill@13)")
            action = m.group("action")
            if action not in ACTIONS:
                raise ValueError(f"unknown fault action {action!r} in {entry!r}; "
                                 f"one of {ACTIONS}")
            count, host, epoch = m.group("count"), m.group("host"), m.group("epoch")
            self._rules.setdefault(m.group("point"), []).append(_Rule(
                action, int(m.group("first") or 1),
                None if count == "*" else int(count or 1),
                None if host is None else int(host),
                None if epoch is None else int(epoch)))

    def hits(self, point: str) -> int:
        return self._hits.get(point, 0)

    def fire(self, point: str, path=None) -> Optional[str]:
        """Count a hit at ``point`` and carry out the armed action: ``fail``
        raises, ``kill`` / ``sigterm`` signal this process, ``hang`` never
        returns; an advisory action's name is returned, None when nothing
        fired."""
        hit = self._hits.get(point, 0) + 1
        self._hits[point] = hit
        rule = next((r for r in self._rules.get(point, ()) if r.matches(hit)), None)
        if rule is None:
            return None
        where = f"{point} (hit {hit}{f', path={path}' if path else ''})"
        if rule.action in _EXECUTED:
            _log.warning(f"FAULT INJECTION: {rule.action} at {where}")
        if rule.action == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        if rule.action == "hang":
            while True:  # a wedged host: no exception, no exit
                time.sleep(60)
        if rule.action == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
            return None
        if rule.action == "fail":
            raise InjectedFault(f"injected fault at {where}")
        return rule.action

    @staticmethod
    def corrupt_file(path: Union[Path, str]) -> None:
        """Truncate ``path`` to half its size (write-time corruption)."""
        p = Path(path)
        size = p.stat().st_size
        # stays raw: the fault injector IS the fault source; wrapping the
        # deliberate corruption in retry/fault plumbing would make the
        # chaos tests depend on the machinery they exist to test
        with open(p, "r+b") as f:  # sta: disable=STA011
            f.truncate(max(size // 2, 1))
        _log.warning(f"FAULT INJECTION: corrupted {p} ({size} -> {max(size // 2, 1)} B)")


_plan: Optional[FaultPlan] = None


def get_fault_plan() -> FaultPlan:
    """The process-wide plan, parsed once from ``SCALING_TPU_FAULTS``."""
    global _plan
    if _plan is None:
        _plan = FaultPlan(os.environ.get(ENV_VAR, ""))
        if _plan._rules:
            _log.warning(f"fault injection armed: {_plan.spec}")
    return _plan


def set_fault_plan(plan: Optional[FaultPlan]) -> None:
    """Install a plan, or clear it (None: the environment is read again on
    the next use)."""
    global _plan
    _plan = plan
