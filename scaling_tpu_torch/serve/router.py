"""The fleet router: N data-parallel engine replicas behind one
dispatcher (counterpart of scaling_tpu/serve/router.py, the same policy
and names).

The router is dispatch policy over :class:`~.engine.ServeEngine`
replicas, reading the signals the engine already exports:

- **least-loaded dispatch**: a new request goes to the live replica with
  the smallest (queue depth, pool pressure), the numbers the
  ``serve_waiting_seqs`` / ``serve_pool_pressure`` gauges carry;
- **prefix affinity**: the router hashes the prompt's leading FULL
  blocks (the prefix trie's sharing granularity) and remembers which
  replica last served each block chain; a prompt whose longest hashed
  chain maps to a live replica goes there, so a family's shared system
  prompt is prefilled once a replica. The hashes are of int tuples, so
  they do not depend on ``PYTHONHASHSEED``: the same prompt and block
  size give the same integers in every process, and as in the JAX
  package's router;
- **retry elsewhere**: a replica answering ``submit`` with
  :class:`~.scheduler.Backpressure` (or :class:`ReplicaUnreachable`
  before the request left this host) is skipped for the next live one
  in load order; only when every replica shed does the fleet answer
  Backpressure;
- **in-doubt parks**: a submit whose RPC died after the request was sent
  may have been admitted with only the reply lost. The router parks it
  pinned to that replica (:class:`InDoubtAdmit`), re-offers it there on
  every supervisor tick (``resolve_in_doubt``; submit is idempotent by
  request id on the worker), and at failover hands it to the supervisor
  to arbitrate against the dead replica's journal (``take_in_doubt``):
  exactly one admission either way;
- **drain fan-out** (``begin_drain``, wired to SIGTERM by
  :func:`install_fleet_drain_handler`), and replica failure, restore and
  autoscale registration (``fail_replica`` / ``restore_replica`` /
  ``add_replica``).

The router dispatches through the handle surface (``submit``,
``begin_drain``, ``has_work``, ``queue_sizes``, ``next_req_id``), so the
in-process :class:`ReplicaHandle` and the subprocess-backed
``replica_proc.ProcReplicaHandle`` stand behind the same policy.
:class:`AutoscalePolicy` is the pure autoscaling decision over the
fleet's load snapshot. This module imports no torch and touches no
device: the engines own the forwards. All dispatch state changes under
one router lock.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

from .. import obs
from ..logging.logger import logger
from .scheduler import Backpressure

# bound on the remembered prefix chains: LRU beyond this (a router that
# never forgets would grow with every distinct prompt ever served)
PREFIX_MAP_CAP = 4096


class ReplicaUnreachable(OSError):
    """A replica's RPC channel is gone (process dead, socket refused,
    retries exhausted). Raised by process-backed handles; the router's
    dispatch loop skips the replica like a Backpressure answer and the
    supervisor's liveness pass owns the failover. The client sets
    ``maybe_admitted=True`` when any attempt got past send — the op may
    have executed remotely with only the reply lost (a submit in this
    state is parked in doubt, never re-dispatched elsewhere)."""

    maybe_admitted = False


class InDoubtAdmit:
    """A submit whose RPC died after the request left this host: the
    pinned replica may or may not have admitted it. The router owns it
    from here (``resolve_in_doubt`` / failover arbitration); callers
    treat it like an admit — the request is neither shed nor free to
    re-submit."""

    __slots__ = ("req_id", "replica_id")

    def __init__(self, req_id: int, replica_id: int):
        self.req_id = req_id
        self.replica_id = replica_id


@dataclasses.dataclass
class ReplicaStats:
    """Per-replica dispatch accounting (rendered by ``obs report``'s
    fleet rows and the ``serve-summary``'s ``replica_stats``)."""

    dispatches: int = 0
    affinity_dispatches: int = 0
    retries_taken: int = 0  # dispatches received as someone's retry
    sheds: int = 0  # Backpressure answers this replica returned

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class ReplicaHandle:
    """One engine replica as the router sees it: the engine, its id,
    a liveness flag, and the lock the fleet bench's tick thread and the
    router's submit path share (engine state is single-writer)."""

    def __init__(self, engine, replica_id: int):
        if engine.replica_id != replica_id:
            raise ValueError(
                f"engine carries replica_id {engine.replica_id!r} but the "
                f"router registers it as {replica_id} — set "
                "EngineConfig.replica_id so telemetry and journal "
                "namespaces agree with dispatch"
            )
        self.engine = engine
        self.replica_id = replica_id
        self.alive = True
        self.lock = threading.Lock()
        self.stats = ReplicaStats()

    def load(self) -> Tuple[int, float]:
        """(queue depth, pool pressure) — the least-loaded sort key.
        Queue depth counts waiting AND running (a replica with free
        slots but a deep backlog is not 'less loaded' than an idle
        one); pool pressure breaks ties the way the shed watermarks
        would."""
        sched = self.engine.scheduler
        depth = len(sched.waiting) + len(sched.running)
        return depth, sched.pool_pressure()

    # -- the engine-facing surface the router dispatches through; a
    # -- process-backed handle (replica_proc.ProcReplicaHandle)
    # -- overrides exactly these with RPC calls
    @property
    def block_size(self) -> int:
        return self.engine.config.block_size

    def submit(self, prompt: List[int], max_new_tokens: int, **kwargs):
        """Engine admission — Sequence on admit, Backpressure on shed.
        NOT under ``self.lock``: ``ServeEngine.submit`` only appends to
        the scheduler's waiting deque and reads load state, safe
        against a concurrent tick under the GIL (serializing submits
        behind the tick lock starves fleet admission)."""
        return self.engine.submit(prompt, max_new_tokens, **kwargs)

    def begin_drain(self) -> None:
        with self.lock:
            self.engine.begin_drain()

    @property
    def has_work(self) -> bool:
        return self.engine.scheduler.has_work

    def next_req_id(self) -> int:
        return self.engine._next_req_id

    def queue_sizes(self) -> Tuple[int, int]:
        """(running, waiting) — the failure event's context fields."""
        sched = self.engine.scheduler
        return len(sched.running), len(sched.waiting)


class FleetRouter:
    """Dispatch policy over N :class:`ServeEngine` replicas."""

    def __init__(self, engines: Optional[List] = None,
                 block_size: Optional[int] = None,
                 handles: Optional[List] = None):
        """Build from in-process ``engines`` (the threaded fleet)
        or from pre-built ``handles`` (process-backed replicas — any
        object answering the :class:`ReplicaHandle` surface)."""
        if handles is None:
            if not engines:
                raise ValueError("a fleet needs at least one replica")
            handles = [
                ReplicaHandle(
                    e, e.replica_id if e.replica_id is not None else i
                )
                for i, e in enumerate(engines)
            ]
        if not handles:
            raise ValueError("a fleet needs at least one replica")
        self.replicas: List[ReplicaHandle] = list(handles)
        ids = [r.replica_id for r in self.replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(
                f"duplicate replica ids {ids} — journal namespaces and "
                "telemetry labels would collide"
            )
        sizes = {r.block_size for r in self.replicas}
        if block_size is None:
            if len(sizes) != 1:
                raise ValueError(
                    f"replicas disagree on block_size ({sorted(sizes)}); "
                    "prefix-affinity hashes full blocks and needs ONE "
                    "granularity"
                )
            block_size = sizes.pop()
        self.block_size = block_size
        self._lock = threading.Lock()
        # prefix-chain hash -> replica id, insertion-ordered for LRU
        self._prefix_owner: Dict[int, int] = {}
        self._next_req_id = 0
        self.retries_elsewhere = 0
        self.rejected = 0  # submissions every live replica shed
        # req_id -> journal-submit-shaped record (+ "replica" pin) for
        # submits whose RPC died after send — exactly-once admission
        # bookkeeping (resolve_in_doubt / take_in_doubt)
        self._in_doubt: Dict[int, dict] = {}
        self.in_doubt_parks = 0  # total park events (telemetry)

    # ---------------------------------------------------------- plumbing
    @property
    def live(self) -> List[ReplicaHandle]:
        return [r for r in self.replicas if r.alive]

    def replica(self, replica_id: int) -> ReplicaHandle:
        for r in self.replicas:
            if r.replica_id == replica_id:
                return r
        raise KeyError(f"no replica {replica_id}")

    def _chain_hashes(self, prompt: List[int]) -> List[int]:
        """One hash per leading FULL block chain of ``prompt`` (chain i
        covers tokens [0, i*block_size)), longest last — mirroring the
        trie's path-from-root sharing rule, including its 'always leave
        one token to prefill' cap. Chains fold INCREMENTALLY (chain i =
        hash of (chain i-1, block i)) so a long prompt costs O(len),
        not O(len^2) rehashing on the dispatch path; int-tuple hashes
        are PYTHONHASHSEED-independent, so the mapping still holds
        across processes."""
        bs = self.block_size
        full = max(0, (len(prompt) - 1) // bs)
        chains: List[int] = []
        acc = 0
        for i in range(full):
            acc = hash((acc, tuple(prompt[i * bs:(i + 1) * bs])))
            chains.append(acc)
        return chains

    def _remember(self, chains: List[int], replica_id: int) -> None:
        for h in chains:
            self._prefix_owner.pop(h, None)  # re-insert = LRU refresh
            self._prefix_owner[h] = replica_id
        while len(self._prefix_owner) > PREFIX_MAP_CAP:
            self._prefix_owner.pop(next(iter(self._prefix_owner)))

    def affinity_replica(self, prompt: List[int]) -> Optional[int]:
        """The live replica whose trie most plausibly holds this
        prompt's longest leading block chain, or None (no affinity)."""
        alive = {r.replica_id for r in self.live}
        for h in reversed(self._chain_hashes(prompt)):
            rid = self._prefix_owner.get(h)
            if rid is not None and rid in alive:
                return rid
        return None

    # ------------------------------------------------------------ policy
    def submit(self, prompt: List[int], max_new_tokens: int, **kwargs):
        """Dispatch one request: prefix-affinity first, then least
        loaded; on Backpressure retry the remaining live replicas in
        load order. Returns the admitted :class:`Sequence` (its engine's
        replica id is on ``seq.request``'s serve events) or the LAST
        :class:`Backpressure` when the whole fleet shed. ``req_id`` is
        router-assigned (globally unique across replicas) unless the
        caller pins one (journal replay)."""
        with self._lock:
            req_id = kwargs.pop("req_id", None)
            if req_id is None:
                req_id = self._next_req_id
            self._next_req_id = max(self._next_req_id, req_id + 1)
            chains = self._chain_hashes(prompt)
            affinity = self.affinity_replica(prompt)
            by_load = sorted(
                self.live, key=lambda r: r.load() + (r.replica_id,)
            )
            if not by_load:
                raise RuntimeError("no live replicas in the fleet")
            order = list(by_load)
            if affinity is not None:
                order.sort(key=lambda r: r.replica_id != affinity)
        bp = None
        for attempt, handle in enumerate(order):
            # count_shed=False: a rejection the router retries is not a
            # client-visible shed — fleet-level rejections are counted
            # (and journaled) by the fleet bench instead.
            try:
                res = handle.submit(
                    prompt, max_new_tokens, req_id=req_id,
                    count_shed=False, **kwargs
                )
            except ReplicaUnreachable as err:
                if getattr(err, "maybe_admitted", False):
                    # the request LEFT this host before the channel
                    # died: the replica may have admitted it with only
                    # the reply lost. Re-dispatching elsewhere risks
                    # serving it TWICE — park it pinned to this replica;
                    # resolve_in_doubt / failover arbitration finish the
                    # story exactly once.
                    with self._lock:
                        self._in_doubt[req_id] = self._park_record(
                            req_id, handle.replica_id, prompt,
                            max_new_tokens, kwargs,
                        )
                        self.in_doubt_parks += 1
                    logger.log_event(
                        "serve-submit-in-doubt", req=req_id,
                        replica=handle.replica_id,
                    )
                    return InDoubtAdmit(req_id, handle.replica_id)
                # connection refused before anything was sent: the
                # process died under us mid-dispatch and the request
                # unambiguously never reached it — skip it like a shed
                # (the supervisor's liveness pass will classify it and
                # run the journal failover) and try the next replica
                bp = Backpressure(
                    reason="replica-unreachable", pool_pressure=1.0,
                    waiting=0, draining=False,
                )
                with self._lock:
                    if attempt + 1 < len(order):
                        self.retries_elsewhere += 1
                continue
            if isinstance(res, Backpressure):
                bp = res
                with self._lock:
                    handle.stats.sheds += 1
                    if not res.draining and attempt + 1 < len(order):
                        self.retries_elsewhere += 1
                continue
            with self._lock:
                handle.stats.dispatches += 1
                if affinity is not None and handle.replica_id == affinity:
                    handle.stats.affinity_dispatches += 1
                if attempt > 0:
                    handle.stats.retries_taken += 1
                self._remember(chains, handle.replica_id)
            return res
        with self._lock:
            self.rejected += 1
        return bp

    @staticmethod
    def _park_record(req_id: int, replica_id: int, prompt: List[int],
                     max_new_tokens: int, kwargs: dict) -> dict:
        """The in-doubt park entry: shaped exactly like a journal submit
        record (plus the ``replica`` pin) so an unadmitted park can join
        the supervisor's orphan re-dispatch verbatim."""
        return {
            "kind": "serve-submit",
            "req": int(req_id),
            "replica": int(replica_id),
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(max_new_tokens),
            "eos_token_id": kwargs.get("eos_token_id"),
            "temperature": kwargs.get("temperature", 0.0),
            "top_k": kwargs.get("top_k"),
            "top_p": kwargs.get("top_p"),
            "deadline_ms": kwargs.get("deadline_ms"),
            "ttft_deadline_ms": kwargs.get("ttft_deadline_ms"),
            # the originating request's trace rides the park so the
            # re-offer / failover re-dispatch inherits it (doubt-parking
            # must not break the one-request-one-trace invariant)
            "trace": obs.current_trace_id(),
        }

    def resolve_in_doubt(self) -> None:
        """Re-offer every parked in-doubt submit to its pinned replica
        (the supervisor calls this each tick). Idempotent submit makes
        the re-offer safe in every world: a replica that DID admit the
        original answers dup (park clears, nothing double-served); one
        that never saw it admits fresh (park clears); a definitive
        Backpressure proves not-admitted, so the request re-enters
        normal dispatch; a still-unreachable replica keeps the park for
        the next tick. Parks pinned to a dead replica are left for the
        failover's journal arbitration (``take_in_doubt``)."""
        if not self._in_doubt:
            return
        with self._lock:
            pending = list(self._in_doubt.values())
        for rec in pending:
            try:
                handle = self.replica(rec["replica"])
            except KeyError:
                continue
            if not handle.alive:
                continue
            kw = {
                k: rec.get(k)
                for k in ("eos_token_id", "temperature", "top_k",
                          "top_p", "deadline_ms", "ttft_deadline_ms")
            }
            # re-offers run on the supervisor's thread: adopt the parked
            # request's trace so the retry RPC (and an eventual fresh
            # admission) lands on the ORIGINAL trace, not a new one
            with obs.trace_context(rec.get("trace")):
                try:
                    res = handle.submit(
                        rec["prompt"], rec["max_new_tokens"],
                        req_id=rec["req"], count_shed=False, **kw,
                    )
                except ReplicaUnreachable:
                    continue  # still partitioned: parked until next tick
                with self._lock:
                    self._in_doubt.pop(rec["req"], None)
                if isinstance(res, Backpressure):
                    # definitive NOT-admitted: the original send never
                    # landed in the engine. The caller was already told
                    # "admitted", so ownership stands — force it through
                    # normal dispatch like an orphan (recovery work is
                    # never shed).
                    out = self.submit(
                        rec["prompt"], rec["max_new_tokens"],
                        req_id=rec["req"], force=True, **kw,
                    )
                    if isinstance(out, Backpressure):
                        with self._lock:  # nothing reachable: re-park
                            self._in_doubt[rec["req"]] = rec
                    continue
                logger.log_event(
                    "serve-in-doubt-resolved", req=rec["req"],
                    replica=rec["replica"],
                )

    def take_in_doubt(self, replica_id: int) -> List[dict]:
        """Pop every in-doubt submit parked on ``replica_id`` — the
        supervisor calls this at failover and arbitrates each record
        against the dead replica's journal (``journal.submitted_ids``):
        admitted -> the journal replay already owns it; never admitted
        -> the parked record (journal-submit-shaped by construction)
        joins the orphan re-dispatch. Either way, exactly once."""
        with self._lock:
            taken = [
                rec for rec in self._in_doubt.values()
                if rec["replica"] == replica_id
            ]
            for rec in taken:
                self._in_doubt.pop(rec["req"], None)
        return taken

    def begin_drain(self) -> None:
        """Drain the whole fleet (the SIGTERM handler's target): every
        live replica stops admitting and finishes in-flight work."""
        for handle in self.live:
            handle.begin_drain()

    def fail_replica(self, replica_id: int) -> None:
        """A replica crashed (or was killed): drop it from dispatch.
        Its incomplete requests are NOT rerouted here — they live in its
        journal namespace, and recovery is the same journal replay a
        single-engine crash uses (``restore_replica`` + re-submission
        with original req_ids keeps them token-exact)."""
        handle = self.replica(replica_id)
        handle.alive = False
        try:
            running, waiting = handle.queue_sizes()
        except (ReplicaUnreachable, OSError):
            running = waiting = -1  # dead process: last-known is gone
        logger.log_event(
            "serve-replica-failed", replica=replica_id,
            running=running, waiting=waiting,
        )

    def restore_replica(self, replica_id: int,
                        engine=None) -> ReplicaHandle:
        """Re-register a relaunched replica under a failed replica's id
        (stats continue; the caller replays the replica's journal into
        the fresh engine before opening it to new dispatch). In-process
        fleets pass the fresh ``engine``; process fleets rebind the
        handle's RPC channel themselves and pass None."""
        handle = self.replica(replica_id)
        if handle.alive:
            raise ValueError(f"replica {replica_id} is still live")
        if engine is not None:
            handle.engine = engine
        handle.alive = True
        logger.log_event("serve-replica-restored", replica=replica_id)
        return handle

    def add_replica(self, handle: ReplicaHandle) -> ReplicaHandle:
        """Register a NEW replica (autoscale spawn) — the id must be
        fresh; journal namespaces and telemetry labels key on it."""
        with self._lock:
            if handle.replica_id in {r.replica_id for r in self.replicas}:
                raise ValueError(
                    f"replica id {handle.replica_id} already registered"
                )
            if handle.block_size != self.block_size:
                raise ValueError(
                    f"new replica block_size {handle.block_size} != fleet "
                    f"{self.block_size} — prefix affinity needs ONE "
                    "granularity"
                )
            self.replicas.append(handle)
        logger.log_event("serve-replica-spawn", replica=handle.replica_id)
        return handle

    # --------------------------------------------------------- telemetry
    @property
    def has_work(self) -> bool:
        # an in-doubt park is pending work even when every engine's
        # queues are empty — the bench must not declare the run done
        # while an admission is unresolved
        return any(r.has_work for r in self.live) or bool(self._in_doubt)

    def sync_next_req_id(self) -> None:
        """After journal replay seeded engines with historical ids, the
        router's id counter must move past every engine's (ids are the
        sampler-key fold — a collision would alias two requests)."""
        with self._lock:
            for r in self.replicas:
                if not r.alive:
                    continue
                self._next_req_id = max(
                    self._next_req_id, r.next_req_id()
                )

    def stats(self) -> dict:
        """Router dispatch stats for the ``serve-summary`` /
        ``obs report`` fleet section."""
        with self._lock:
            per = {
                r.replica_id: r.stats.to_dict() for r in self.replicas
            }
            dispatches = sum(s["dispatches"] for s in per.values())
            affinity = sum(s["affinity_dispatches"] for s in per.values())
            return {
                "replicas": len(self.replicas),
                "live_replicas": len(self.live),
                "dispatches": dispatches,
                "affinity_dispatches": affinity,
                "affinity_hit_rate": (
                    round(affinity / dispatches, 4) if dispatches else 0.0
                ),
                "retries_elsewhere": self.retries_elsewhere,
                "rejected": self.rejected,
                "in_doubt_parks": self.in_doubt_parks,
                "in_doubt_pending": len(self._in_doubt),
                "per_replica": per,
            }


class AutoscalePolicy:
    """Pure host-side autoscaling policy: watermark hysteresis over the
    fleet's load snapshot, budgeted like supervisor relaunches.

    ``decide(now, replicas)`` consumes a snapshot — one dict per replica
    with ``replica`` (id), ``queue_depth``, ``pool_pressure``,
    ``in_flight``, ``alive`` — and returns ``None`` (hold),
    ``("spawn", None)``, or ``("drain", replica_id)``. No clocks, no
    I/O: the caller stamps ``now`` (``time.monotonic()``), so every
    branch is unit-testable with literal timestamps.

    - **spawn** when EVERY live replica is above the high watermark
      (``pool_pressure >= high_watermark`` or ``queue_depth >=
      queue_high``) sustained for ``sustain_s`` — one hot replica is a
      dispatch-imbalance problem, not a capacity problem;
    - **drain** when the fleet is idle (zero queue, zero in-flight,
      pressure at/below ``low_watermark`` everywhere) sustained for
      ``idle_sustain_s`` — the highest-id live replica goes first
      (spawned last, coldest trie). A drain NEVER fires while any
      request is in flight and NEVER takes the fleet below
      ``min_replicas``;
    - both actions are budgeted (``spawn_budget`` / ``drain_budget``
      per run) and separated by ``cooldown_s`` so a noisy load signal
      can't flap the fleet.
    """

    def __init__(self, *, min_replicas: int = 1, max_replicas: int = 4,
                 high_watermark: float = 0.8, queue_high: int = 8,
                 low_watermark: float = 0.2, sustain_s: float = 2.0,
                 idle_sustain_s: float = 5.0, spawn_budget: int = 2,
                 drain_budget: int = 2, cooldown_s: float = 5.0):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas < min_replicas")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.high_watermark = high_watermark
        self.queue_high = queue_high
        self.low_watermark = low_watermark
        self.sustain_s = sustain_s
        self.idle_sustain_s = idle_sustain_s
        self.spawn_budget = spawn_budget
        self.drain_budget = drain_budget
        self.cooldown_s = cooldown_s
        self.spawns = 0
        self.drains = 0
        self._high_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_action: Optional[float] = None

    def _hot(self, r: dict) -> bool:
        return (r["pool_pressure"] >= self.high_watermark
                or r["queue_depth"] >= self.queue_high)

    def decide(self, now: float,
               replicas: List[dict]) -> Optional[Tuple[str, Optional[int]]]:
        live = [r for r in replicas if r.get("alive", True)]
        if not live:
            return None
        in_cooldown = (self._last_action is not None
                       and now - self._last_action < self.cooldown_s)

        overloaded = all(self._hot(r) for r in live)
        if overloaded:
            if self._high_since is None:
                self._high_since = now
        else:
            self._high_since = None

        idle = all(
            r["queue_depth"] == 0 and r["in_flight"] == 0
            and r["pool_pressure"] <= self.low_watermark
            for r in live
        )
        if idle:
            if self._idle_since is None:
                self._idle_since = now
        else:
            self._idle_since = None

        if in_cooldown:
            return None
        if (self._high_since is not None
                and now - self._high_since >= self.sustain_s
                and len(live) < self.max_replicas
                and self.spawns < self.spawn_budget):
            self.spawns += 1
            self._last_action = now
            self._high_since = None
            return ("spawn", None)
        if (self._idle_since is not None
                and now - self._idle_since >= self.idle_sustain_s
                and len(live) > self.min_replicas
                and self.drains < self.drain_budget):
            # in_flight == 0 everywhere is part of `idle` — an idle
            # drain can never abandon a running request
            self.drains += 1
            self._last_action = now
            self._idle_since = None
            target = max(r["replica"] for r in live)
            return ("drain", target)
        return None


def install_fleet_drain_handler(router: FleetRouter) -> None:
    """SIGTERM -> drain the WHOLE fleet, chaining any prior handler —
    the fleet mirror of ``engine.install_drain_handler``: every replica
    stops admitting, in-flight requests finish or hit their deadlines,
    and the fleet bench exits 0 with a complete run dir."""
    import signal

    prev = signal.getsignal(signal.SIGTERM)

    def handler(signum, frame):
        router.begin_drain()
        if callable(prev):  # SIG_DFL/SIG_IGN are enum ints, skipped
            prev(signum, frame)

    signal.signal(signal.SIGTERM, handler)
