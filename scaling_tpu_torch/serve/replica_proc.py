"""Process replicas of the serving fleet (counterpart of
scaling_tpu/serve/replica_proc.py: the same wire format, rendezvous
file, journal namespaces, events and policies).

The threaded fleet shares one Python process: a crash, an OOM or a
poisoned request in one replica takes the fleet down, and every replica's
host work shares one GIL. Here each replica is a supervised subprocess:

- **Worker** (``python -m scaling_tpu_torch.serve.replica_proc --config
  F``): one :class:`~.engine.ServeEngine` behind a line-JSON RPC loop
  over TCP (serial accept loop, one short-lived thread a connection,
  requests capped at 64 KiB, a catch-all handler). Ops: ``submit``
  (idempotent by request id: a retried submit never enqueues twice),
  ``poll`` (cursor-based: a lost reply ships again instead of dropping
  records), ``stats`` (the engine's ``stats_snapshot``, which is also
  the heartbeat: the reply carries the tick loop's age, so a wedged loop
  shows while the RPC threads still answer), ``drain``, ``shutdown``.
  The config names the model (``model``, ``seed``: every replica builds
  the same random weights, so a re-dispatched request is regenerated on
  the same model) and the ``device``. The worker journals into the
  ``journal_r<id>`` namespace the threaded fleet uses, warms up, and only
  then appends its rendezvous record: readiness is that record.
- **Host**: :class:`ProcReplicaHandle` answers the router's
  :class:`~.router.ReplicaHandle` surface over RPC, so the router's
  policy stands as it is; every call rides ``retry_io`` with timeouts
  and raises :class:`~.router.ReplicaUnreachable` once the process is
  gone. :func:`classify_replicas` splits the fleet into dead (non-zero
  exit), hung (a stale heartbeat past the startup grace, SIGKILLed into
  dead) and alive.
- **Failover** (:class:`FleetSupervisor`): a dead replica's journal is
  harvested (``journal.failover_split``): its completed outputs join the
  run's results, its incomplete requests go to the survivors with their
  own request ids and ``force=True`` (the sampler keys fold the request
  id and the token index, so any replica regenerates the same tokens),
  and the replica relaunches on ``runner.supervise.restart_backoff``'s
  curve within a per-replica budget.
- **Autoscaling**: each supervision pass feeds the stats snapshots to
  :class:`~.router.AutoscalePolicy`: sustained fleet-wide pressure spawns
  a replica (a fresh id and journal namespace), sustained idle drains the
  youngest. Every step is an event (``serve-replica-{spawn,drain,
  restart,dead,hung,give-up,failover,restored,ready}``) that ``obs
  report`` renders in its fleet timeline.

Fault points (see ``resilience.faults``): ``serve.replica.spawn``,
``serve.replica.rpc`` (advisory ``drop`` / ``delay`` / ``partition``),
``serve.replica.net_partition``, ``serve.replica.rendezvous``,
``serve.replica.teardown``, ``serve.replica.kill`` (the worker, before a
tick while it has work) and ``serve.replica.hung_kill``.

The host side initialises no CUDA: only a worker builds a model, and each
worker owns its CUDA context. Replicas on other hosts (``hostname`` not
this machine) are not ported and raise ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from .. import obs
from ..logging.logger import logger
from ..obs import span
from ..resilience.faults import get_fault_plan
from ..resilience.guards import retry_io
from ..runner.runner import LOCAL_HOSTS
from ..runner.supervise import restart_backoff
from .journal import failover_split, journal_path, submitted_ids
from .router import AutoscalePolicy, FleetRouter, ReplicaStats, ReplicaUnreachable
from .scheduler import Backpressure

# a worker's start (the model build, the warm-up) may go silent for a long
# time; the grace bounds the host's wait for readiness and keeps hung
# verdicts off a replica until it has passed
DEFAULT_STARTUP_GRACE_S = 180.0
DEFAULT_HEARTBEAT_TIMEOUT_S = 10.0
# a drained worker that never hears shutdown exits on its own after this
# (the host is gone: don't serve a dead fleet forever)
DEFAULT_LINGER_S = 60.0


# ========================================================= rendezvous
RENDEZVOUS_NAME = "rendezvous.jsonl"


def rendezvous_file(run_dir) -> Path:
    return Path(run_dir) / RENDEZVOUS_NAME


def publish_rendezvous(path, record: dict) -> None:
    """Append one replica's address record to the rendezvous file: one
    whole line a write in append mode, so several writers never tear one
    another's records. Rides ``retry_io``, with the
    ``serve.replica.rendezvous`` fault point inside the retried op."""
    line = json.dumps(record) + "\n"

    def op():
        get_fault_plan().fire("serve.replica.rendezvous", path=path)
        with open(path, "a") as f:
            f.write(line)

    retry_io(op, what="replica rendezvous publish")


def read_rendezvous(path) -> Dict[int, dict]:
    """The newest rendezvous record of each replica id (a relaunch appends
    a later line, which wins). A torn tail line is skipped."""

    def op():
        get_fault_plan().fire("serve.replica.rendezvous", path=path)
        p = Path(path)
        if not p.is_file():
            return {}
        out: Dict[int, dict] = {}
        for line in p.read_text().splitlines():
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
                out[int(rec["replica"])] = rec
            except (ValueError, KeyError, TypeError):
                continue  # a torn tail or a foreign line
        return out

    return retry_io(op, what="replica rendezvous read")


# ======================================================== worker side
class ReplicaRpcServer:
    """Line-JSON RPC server of one replica worker: a serial accept loop
    with a short timeout, one short-lived daemon thread a connection,
    request lines capped at ``MAX_REQUEST_BYTES``, and a catch-all around
    the handler (a malformed request logs a warning and gets no reply;
    the host's retries own the recovery)."""

    MAX_REQUEST_BYTES = 64 * 1024

    def __init__(self, handler: Callable[[dict], dict],
                 host: str = "127.0.0.1", port: int = 0):
        self._handler = handler
        # stays raw: one-time server bind at worker startup; a port
        # conflict or a bad address is a configuration error that must
        # abort the worker loudly, not retry (host requests ride retry_io)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)  # sta: disable=STA011
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        # the accept timeout is set before the thread starts, so a close()
        # racing the loop's first pass finds it installed
        self._sock.settimeout(0.2)
        self.address = f"{host}:{self._sock.getsockname()[1]}"
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, name="replica-rpc-server",
                                        daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # the socket closed under us at shutdown
            threading.Thread(target=self._handle_conn, args=(conn,), daemon=True).start()

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            with conn:
                conn.settimeout(5.0)
                data = conn.makefile("r").readline(self.MAX_REQUEST_BYTES)
                if len(data) >= self.MAX_REQUEST_BYTES and not data.endswith("\n"):
                    raise ValueError(f"request line exceeds {self.MAX_REQUEST_BYTES} bytes")
                reply = self._handler(json.loads(data))
                conn.sendall((json.dumps(reply) + "\n").encode())
        except Exception as e:
            # any malformed request or injected fault: no reply, and the
            # host's retry owns it
            logger.warning(f"replica rpc request failed: {e!r}")

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError as e:
            logger.debug(f"replica rpc server close: {e!r}")
        self._thread.join(timeout=5)


class _ReplicaWorker:
    """One engine and its RPC surface; ``run`` is the tick loop.

    ``_loop_wall`` is written by the tick loop and read by the RPC threads
    without a lock on purpose: it is a float store, and taking the tick
    lock to read it would hide exactly the wedged tick it exists to show."""

    def __init__(self, engine, linger_s: float = DEFAULT_LINGER_S,
                 host_id: Optional[int] = None):
        self.engine = engine
        self.linger_s = linger_s
        self.host_id = host_id
        self.dup_submits = 0  # retried submits answered as duplicates
        self.tick_lock = threading.Lock()
        self.shutdown = threading.Event()
        self._loop_wall = time.monotonic()

    # ------------------------------------------------------------ ops
    def _knows(self, req_id: int) -> bool:
        sched = self.engine.scheduler
        seqs = list(sched.running.values()) + list(sched.waiting) + list(self.engine.finished)
        return any(s.request.req_id == req_id for s in seqs)

    @staticmethod
    def _record(seq) -> dict:
        stamps = seq.token_stamps
        return {
            "req": seq.request.req_id,
            "status": seq.finish_status,
            "toks": [int(t) for t in seq.generated],
            "prompt_len": len(seq.request.prompt),
            "ttft_s": (seq.first_token_s - seq.request.arrival_s
                       if seq.first_token_s is not None else None),
            "itls": [round(b - a, 6) for a, b in zip(stamps, stamps[1:])],
        }

    def handle(self, req: dict) -> dict:
        # the partition drill fires before the request is looked at: the
        # packet never arrived (no state change, no reply)
        if get_fault_plan().fire("serve.replica.net_partition") in ("partition", "drop"):
            raise OSError("injected network partition: request dropped")
        act = get_fault_plan().fire("serve.replica.rpc")
        if act == "delay":
            time.sleep(0.25)  # a slow link
        elif act == "partition":
            raise OSError("injected rpc partition: request dropped")
        reply = self._dispatch(req)
        if act == "drop":
            # the request WAS served; only the reply is lost
            raise OSError("injected rpc drop: reply lost after dispatch")
        return reply

    def _dispatch(self, req: dict) -> dict:
        tr = req.get("trace") or {}
        if tr.get("trace_id"):
            # the envelope's trace for this dispatch: the admit span and the
            # journal's submit record carry the originating request's trace
            with obs.trace_context(tr["trace_id"], tr.get("parent_span_id")):
                return self._dispatch_op(req)
        return self._dispatch_op(req)

    def _dispatch_op(self, req: dict) -> dict:
        op = req.get("op")
        if op == "submit":
            kw = dict(req.get("kw") or {})
            rid = kw.get("req_id")
            if rid is not None and self._knows(int(rid)):
                # the first attempt's reply was lost: enqueueing it again
                # would serve the request twice
                self.dup_submits += 1
                return {"ok": True, "admitted": True, "req": int(rid), "dup": True}
            # not under tick_lock: submit only appends to the waiting queue
            res = self.engine.submit(req["prompt"], int(req["max_new_tokens"]), **kw)
            if isinstance(res, Backpressure):
                return {"ok": True, "admitted": False, "bp": {
                    "reason": res.reason, "pool_pressure": res.pool_pressure,
                    "waiting": res.waiting, "draining": res.draining,
                }}
            return {"ok": True, "admitted": True, "req": res.request.req_id}
        if op == "stats":
            return {"ok": True, "stats": self.engine.stats_snapshot(),
                    "loop_age_s": time.monotonic() - self._loop_wall,
                    "host": self.host_id, "dups": self.dup_submits}
        if op == "poll":
            # read-only from a cursor: a reply lost to a retry ships again
            fin = list(self.engine.finished)
            start = max(0, int(req.get("from", 0)))
            return {"ok": True, "finished": [self._record(s) for s in fin[start:]],
                    "total": len(fin)}
        if op == "drain":
            with self.tick_lock:
                self.engine.begin_drain()
            return {"ok": True}
        if op == "shutdown":
            self.shutdown.set()
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}

    # ------------------------------------------------------ tick loop
    def run(self) -> int:
        idle_since: Optional[float] = None
        rid = self.engine.replica_id
        while True:
            self._loop_wall = time.monotonic()
            if self.engine.scheduler.has_work:
                idle_since = None
                # the chaos drill's SIGKILL lands here: requests in flight,
                # tokens mid-stream, submit records without a terminal status
                get_fault_plan().fire("serve.replica.kill")
                with self.tick_lock:
                    if self.engine.scheduler.has_work:
                        with span("serve.tick", step=self.engine.tick_index, replica=rid):
                            self.engine.tick()
                continue
            if self.shutdown.is_set():
                return 0
            if self.engine.draining:
                if idle_since is None:
                    idle_since = time.monotonic()
                elif time.monotonic() - idle_since > self.linger_s:
                    logger.warning(f"replica drained and host silent for "
                                   f"{self.linger_s:.0f}s; exiting")
                    return 0
            time.sleep(0.001)


def worker_main(argv: Optional[List[str]] = None) -> int:
    """One replica subprocess: build the model and the engine, warm up,
    start the RPC server, append the rendezvous record (readiness, last),
    then run the tick loop. A ``serve-start`` event records the device's
    free memory before the model is built, as the bench's does, and the
    ready event the free memory after the warm-up."""
    import argparse

    import torch

    from .. import resolve_device
    from ..obs import get_registry
    from ..ops import launches
    from .bench import build_inference
    from .engine import EngineConfig, ServeEngine, install_drain_handler
    from .journal import RequestJournal

    parser = argparse.ArgumentParser(prog="python -m scaling_tpu_torch.serve.replica_proc")
    parser.add_argument("--config", required=True, help="worker config JSON written by the host")
    args = parser.parse_args(argv)
    cfg = json.loads(retry_io(Path(args.config).read_text, what="replica config read"))
    replica_id = int(cfg["replica_id"])
    for key in ("control_dir", "bind_host", "advertise_host"):
        if cfg.get(key):
            raise NotImplementedError(f"replica worker config key {key!r} (host mode) "
                                      "is not ported")
    if cfg.get("metrics_path"):
        # whole lines a write in append mode: workers share the host's file
        get_registry().configure(metrics_path=cfg["metrics_path"])
    device = resolve_device(cfg.get("device", "cuda"))
    free = total = None
    if device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
    logger.log_event("serve-start", device=str(device), free_bytes=free, total_bytes=total,
                     replica=replica_id, incarnation=int(cfg.get("incarnation", 0)))
    inf = build_inference(cfg.get("model", "toy"), seed=int(cfg.get("seed", 0)), device=device)
    engine = ServeEngine(inf, EngineConfig(replica_id=replica_id, **cfg["engine"]),
                         device=device)
    install_drain_handler(engine)  # a SIGTERM to the worker drains this replica
    warmup = int(cfg.get("warmup", 0))
    if warmup > 0:
        engine.warmup_mode = True
        for _ in range(warmup):
            engine.submit([1], 2)
        engine.run_until_done()
        engine.warmup_mode = False
        engine.finished.clear()
    launches.reset()  # the stats count the launches of the measured run
    # after the warm-up: the journal starts at the first real request
    engine.attach_journal(RequestJournal(cfg["journal"]))
    host_id = cfg.get("host_id")
    worker = _ReplicaWorker(engine, linger_s=float(cfg.get("linger_s", DEFAULT_LINGER_S)),
                            host_id=int(host_id) if host_id is not None else None)
    server = ReplicaRpcServer(worker.handle)
    # readiness last: the warm-up is done and the server accepts
    publish_rendezvous(cfg["rendezvous_path"], {
        "replica": replica_id, "host": host_id, "addr": server.address,
        "pid": os.getpid(), "incarnation": int(cfg.get("incarnation", 0)),
    })
    # the card's free memory with this replica built and warm (beside the
    # JAX worker's fields): a relaunch that finds less than its first start
    # did, with the same fleet up, shows a dead worker's memory not freed
    free = torch.cuda.mem_get_info(device)[0] if device.type == "cuda" else None
    logger.log_event("serve-replica-ready", replica=replica_id, address=server.address,
                     host=host_id, free_bytes=free)
    try:
        return worker.run()
    finally:
        server.close()


# ========================================================== host side
class ReplicaProcClient:
    """RPC client of one replica worker: a fresh connection a request,
    bounded retries of transport errors, protocol errors (``ok`` false)
    never retried."""

    def __init__(self, address: str, timeout_s: float = 5.0):
        host, port = address.rsplit(":", 1)
        self._addr = (host, int(port))
        self._timeout = timeout_s
        self.retries = 0  # transport retries taken

    def _request_once(self, req: dict, state: Optional[dict] = None) -> dict:
        with socket.create_connection(self._addr, self._timeout) as conn:
            conn.sendall((json.dumps(req) + "\n").encode())
            if state is not None:
                # the request left this host: a failure from here on is
                # ambiguous (the worker may have served it, the reply lost)
                state["sent"] = True
            line = conn.makefile("r").readline()
            if not line:
                # the worker's catch-all dropped the reply: retried
                raise OSError("empty rpc reply (connection closed)")
            return json.loads(line)

    def request(self, req: dict, attempts: int = 3) -> dict:
        state = {"sent": False, "calls": 0}

        def once():
            state["calls"] += 1
            return self._request_once(req, state)

        try:
            reply = retry_io(once, attempts=attempts, retry_on=(OSError, ValueError),
                             what=f"replica rpc {req.get('op')!r}")
        except (OSError, ValueError) as e:
            self.retries += max(0, state["calls"] - 1)
            err = ReplicaUnreachable(f"replica at {self._addr[0]}:{self._addr[1]} "
                                     f"unreachable for {req.get('op')!r}: {e!r}")
            # True when an attempt got past the send: the op may have run
            # on the worker, and the router parks such a submit in doubt
            err.maybe_admitted = state["sent"]
            raise err from e
        self.retries += max(0, state["calls"] - 1)
        if not reply.get("ok"):
            raise RuntimeError(f"replica rpc {req} failed: {reply}")
        return reply


class RemoteAdmit:
    """A submit a subprocess replica admitted: the process fleet's
    stand-in for the in-process Sequence (the router needs only "not
    Backpressure"; the outputs come back through ``poll``)."""

    __slots__ = ("req_id", "replica_id")

    def __init__(self, req_id: int, replica_id: int):
        self.req_id = req_id
        self.replica_id = replica_id


class ProcReplicaHandle:
    """The router's :class:`~.router.ReplicaHandle` surface over a
    subprocess replica (``replica_id``, ``alive``, ``lock``, ``stats``,
    ``block_size``), RPC behind each method. Load answers come from the
    newest ``stats`` snapshot, refreshed every supervision pass, so
    dispatch reads a cache instead of paying a round trip an attempt.
    ``max_loop_age_s`` and ``max_rtt_s`` keep the longest tick-loop age
    and stats round trip seen, across relaunches."""

    def __init__(self, replica_id: int, proc, client: ReplicaProcClient,
                 block_size: int, host_id: Optional[int] = None,
                 hostname: Optional[str] = None, cfg_path: Optional[str] = None):
        self.engine = None  # no in-process engine behind this handle
        self.replica_id = replica_id
        self.alive = True
        self.lock = threading.Lock()
        self.stats = ReplicaStats()
        self.proc = proc
        self.client = client
        self.block_size = block_size
        self.host_id = host_id
        self.hostname = hostname
        self.cfg_path = cfg_path
        self.spawn_wall = time.monotonic()
        self.last_ok_wall = self.spawn_wall
        self.last_loop_age_s = 0.0
        self.last_stats: dict = {}
        self.last_dups = 0  # the worker's deduplicated submit retries
        self.rpc_retries_banked = 0  # retries of replaced clients
        self.restarts = 0
        self.retired = False  # drained away by the autoscaler
        self.poll_cursor = 0
        self.ticks_banked = 0  # ticks of incarnations since replaced
        self.max_loop_age_s = 0.0
        self.max_rtt_s = 0.0
        # launches of incarnations since replaced, as of their last heartbeat
        self.launches_banked = {"kernel": Counter(), "plain": Counter()}

    # ---------------------------------------------------------- rpc
    def _rpc(self, req: dict, attempts: int = 3) -> dict:
        with span("serve.replica.rpc_client", op=req.get("op"), replica=self.replica_id,
                  level="debug"):
            reply = self.client.request(req, attempts=attempts)
        self.last_ok_wall = time.monotonic()
        return reply

    def refresh(self) -> dict:
        """The ``stats`` RPC, the heartbeat: a reply refreshes
        ``last_ok_wall`` and the load cache, and its loop age shows a
        wedged tick loop whose RPC threads still answer."""
        t0 = time.monotonic()
        reply = self._rpc({"op": "stats", "trace": obs.current_trace()})
        self.max_rtt_s = max(self.max_rtt_s, time.monotonic() - t0)
        self.last_stats = reply["stats"]
        self.last_loop_age_s = float(reply.get("loop_age_s", 0.0))
        self.max_loop_age_s = max(self.max_loop_age_s, self.last_loop_age_s)
        self.last_dups = int(reply.get("dups", 0))
        return self.last_stats

    @property
    def rpc_retries(self) -> int:
        return self.rpc_retries_banked + self.client.retries

    def kill(self) -> None:
        """SIGKILL this replica's worker."""
        get_fault_plan().fire("serve.replica.teardown", path=f"replica {self.replica_id}")
        with span("serve.replica.teardown", replica=self.replica_id):
            try:
                self.proc.kill()
                self.proc.wait(timeout=10)
            except OSError as e:
                logger.warning(f"SIGKILL replica {self.replica_id} failed: {e!r}")

    def poll_finished(self) -> List[dict]:
        """Finished-request records the host has not seen yet (from the
        cursor: a lost reply ships again, never drops)."""
        reply = self._rpc({"op": "poll", "from": self.poll_cursor,
                           "trace": obs.current_trace()})
        recs = reply["finished"]
        self.poll_cursor = int(reply.get("total", self.poll_cursor + len(recs)))
        return recs

    def request_shutdown(self) -> None:
        try:
            self._rpc({"op": "shutdown", "trace": obs.current_trace()}, attempts=1)
        except (ReplicaUnreachable, RuntimeError):
            pass  # already gone: what shutdown wanted anyway

    def rebind(self, fresh: "ProcReplicaHandle") -> None:
        """Point this handle at a relaunched worker (the router identity,
        id and dispatch stats, survives the relaunch)."""
        # the dead incarnation's ticks as of its last heartbeat
        self.ticks_banked += int(self.last_stats.get("tick", 0))
        for kind in ("kernel", "plain"):
            self.launches_banked[kind].update(self.last_stats.get(f"{kind}_launches", {}))
        self.rpc_retries_banked += self.client.retries
        self.proc = fresh.proc
        self.client = fresh.client
        self.hostname = fresh.hostname
        self.host_id = fresh.host_id if fresh.host_id is not None else self.host_id
        self.cfg_path = fresh.cfg_path or self.cfg_path
        self.spawn_wall = fresh.spawn_wall
        self.last_ok_wall = fresh.last_ok_wall
        self.last_stats = {}
        self.last_loop_age_s = 0.0
        self.poll_cursor = 0
        self.restarts += 1

    # ------------------------------------------- ReplicaHandle surface
    def load(self) -> Tuple[int, float]:
        s = self.last_stats
        return int(s.get("queue_depth", 0)), float(s.get("pool_pressure", 0.0))

    def submit(self, prompt: List[int], max_new_tokens: int, **kwargs):
        # arrival_s is the host's clock, meaningless in the worker: the
        # worker stamps the admission itself
        kwargs.pop("arrival_s", None)
        reply = self._rpc({
            "op": "submit",
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(max_new_tokens),
            "kw": kwargs,
            # every envelope carries the ambient trace context (None
            # outside one): the worker adopts the originating request's
            "trace": obs.current_trace(),
        })
        if not reply.get("admitted"):
            bp = reply["bp"]
            return Backpressure(reason=bp["reason"], pool_pressure=float(bp["pool_pressure"]),
                                waiting=int(bp["waiting"]), draining=bool(bp["draining"]))
        # optimistic until the next refresh, a pass away: the fleet loop's
        # exit check reads the cached has_work, and the least-loaded sort
        # the cached queue depth (the JAX handle leaves the depth stale, so
        # a burst between two heartbeats, and every prompt family of it,
        # went to one replica)
        self.last_stats["has_work"] = True
        if not reply.get("dup"):
            for key in ("queue_depth", "waiting"):
                self.last_stats[key] = int(self.last_stats.get(key, 0)) + 1
        return RemoteAdmit(int(reply["req"]), self.replica_id)

    def begin_drain(self) -> None:
        try:
            self._rpc({"op": "drain", "trace": obs.current_trace()})
        except ReplicaUnreachable:
            pass  # a dead replica: the supervisor's liveness pass owns it

    @property
    def has_work(self) -> bool:
        return bool(self.last_stats.get("has_work", False))

    def next_req_id(self) -> int:
        return int(self.last_stats.get("next_req_id", 0))

    def queue_sizes(self) -> Tuple[int, int]:
        s = self.last_stats
        return int(s.get("running", 0)), int(s.get("waiting", 0))


def spawn_replica_proc(replica_id: int, worker_cfg: dict, run_dir, *,
                       env: Optional[dict] = None,
                       ready_timeout_s: float = DEFAULT_STARTUP_GRACE_S,
                       hostname: Optional[str] = None,
                       host_id: Optional[int] = None) -> ProcReplicaHandle:
    """Launch one replica worker on this machine and wait for its
    readiness: write the worker config, start the subprocess, and block
    until the rendezvous record of this incarnation appears.
    ``SCALING_TPU_HOST_ID`` is the replica id (so ``@host=K`` fault
    selectors pick one replica). Raises OSError when the worker dies
    during startup or the grace runs out (the supervisor's budgeted
    backoff absorbs it), NotImplementedError for another host."""
    if hostname is not None and hostname not in LOCAL_HOSTS:
        raise NotImplementedError(
            f"replica {replica_id} on host {hostname!r}: replicas on other hosts (the ssh "
            f"spawn of host mode) are not ported; they run on this host "
            f"({' or '.join(LOCAL_HOSTS)})")
    get_fault_plan().fire("serve.replica.spawn")
    run_dir = Path(run_dir)
    cfg_path = run_dir / f"replica_{replica_id}.json"
    rdv_path = rendezvous_file(run_dir)
    # a relaunch must not take the dead incarnation's record for
    # readiness: each spawn claims the next incarnation and waits for it
    prev = read_rendezvous(rdv_path).get(replica_id)
    incarnation = int(prev["incarnation"]) + 1 if prev else 0
    cfg = dict(worker_cfg, replica_id=replica_id, rendezvous_path=str(rdv_path),
               incarnation=incarnation, host_id=host_id,
               journal=str(journal_path(worker_cfg["journal_base"], replica_id)))
    cfg.pop("journal_base", None)
    text = json.dumps(cfg, indent=1)
    retry_io(lambda: cfg_path.write_text(text), what="replica config write")
    child_env = dict(os.environ if env is None else env)
    child_env["SCALING_TPU_HOST_ID"] = str(host_id if host_id is not None else replica_id)
    cmd = [sys.executable, "-m", "scaling_tpu_torch.serve.replica_proc",
           "--config", str(cfg_path)]
    with span("serve.replica.spawn", replica=replica_id, host=host_id):
        proc = subprocess.Popen(cmd, env=child_env)
        deadline = time.monotonic() + ready_timeout_s
        while True:
            rec = read_rendezvous(rdv_path).get(replica_id)
            if rec is not None and int(rec.get("incarnation", -1)) == incarnation:
                addr = str(rec["addr"])
                break
            rc = proc.poll()
            if rc is not None:
                raise OSError(f"replica {replica_id} died during startup (rc={rc})")
            if time.monotonic() > deadline:
                proc.kill()
                raise OSError(f"replica {replica_id} not ready within {ready_timeout_s:.0f}s")
            time.sleep(0.05)
    return ProcReplicaHandle(replica_id, proc, ReplicaProcClient(addr),
                             int(cfg["engine"]["block_size"]), host_id=host_id,
                             hostname=hostname, cfg_path=str(cfg_path))


# ---------------------------------------------------------- liveness
def classify_replicas(rows: List[dict], *,
                      heartbeat_timeout_s: float = DEFAULT_HEARTBEAT_TIMEOUT_S,
                      startup_grace_s: float = DEFAULT_STARTUP_GRACE_S,
                      now: Optional[float] = None) -> Dict[str, List[int]]:
    """Split the fleet into dead / hung / alive over per-replica rows
    ``{replica, exit_code, spawn_wall, last_ok_wall, loop_age_s, retired,
    draining}`` (``runner.supervise.classify_workers``'s policy).

    *dead*: the process exited non-zero (a SIGKILL is negative). *hung*:
    still running, the heartbeat stale, past the startup grace. An exit 0
    or a retired (autoscale-drained) replica is neither. Every timestamp
    is on the host's monotonic clock: ``last_ok_wall`` is stamped at the
    reply's receipt and ``loop_age_s`` is the worker's loop age at that
    receipt (a duration, free of clock skew), so the loop last beat at
    ``last_ok_wall - loop_age_s`` and its staleness is ``now - that``."""
    now = time.monotonic() if now is None else now
    dead: List[int] = []
    hung: List[int] = []
    alive: List[int] = []
    for r in rows:
        if r.get("retired"):
            continue  # drained on purpose: winding down, never hung
        rc = r.get("exit_code")
        if rc is not None:
            if rc != 0:
                dead.append(r["replica"])
            continue  # exit 0: finished or drained, neither alive nor dead
        # a wedged loop whose RPC threads still answer keeps the receipt
        # gap near zero, but its reported age grows
        age = (now - r["last_ok_wall"]) + max(0.0, float(r.get("loop_age_s", 0.0)))
        in_grace = now - r["spawn_wall"] <= startup_grace_s
        if age > heartbeat_timeout_s and not in_grace and not r.get("draining"):
            hung.append(r["replica"])
        else:
            alive.append(r["replica"])
    return {"dead": dead, "hung": hung, "alive": alive}


class FleetSupervisor:
    """Liveness, failover, relaunch and autoscaling of a fleet of
    :class:`ProcReplicaHandle` replicas.

    ``tick(now)`` is one supervision pass on the host's thread (the
    process fleet's host is single-threaded): refresh the heartbeats,
    classify, SIGKILL the hung, fail over the dead (journal harvest,
    re-dispatch to the survivors, a budgeted relaunch on the backoff
    curve), launch the relaunches that are due, and carry out the
    autoscale policy's decision."""

    def __init__(self, router: FleetRouter, spawn_fn: Callable[[int], ProcReplicaHandle],
                 journal_base, *, restart_budget: int = 3,
                 restart_backoff_s: float = 0.5,
                 heartbeat_timeout_s: float = DEFAULT_HEARTBEAT_TIMEOUT_S,
                 startup_grace_s: float = DEFAULT_STARTUP_GRACE_S,
                 policy: Optional[AutoscalePolicy] = None,
                 on_drain: Optional[Callable[[ProcReplicaHandle], None]] = None):
        self.router = router
        self.spawn_fn = spawn_fn
        self.journal_base = journal_base
        self.restart_budget = restart_budget
        self.restart_backoff_s = restart_backoff_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.startup_grace_s = startup_grace_s
        self.policy = policy
        # called with a replica about to be drained while it still answers:
        # the bench's last poll (records past its cursor would go with it)
        self.on_drain = on_drain
        # the failover harvest: outputs dead replicas delivered before dying
        self.recovered: Dict[int, List[int]] = {}
        self.recovered_timeouts = 0
        # incomplete submit records waiting for a live replica (non-empty
        # only while the whole fleet is down)
        self.orphans: List[dict] = []
        self.restarts = 0  # relaunches performed, fleet-wide
        self.redispatched = 0  # orphans served again by survivors
        self._attempts: Dict[int, int] = {}  # restarts a replica
        self._relaunch_due: Dict[int, dict] = {}
        self.gave_up: List[int] = []

    # ------------------------------------------------------ liveness
    def _snapshot_rows(self) -> List[dict]:
        return [{
            "replica": h.replica_id,
            "host": h.host_id,
            "exit_code": h.proc.poll(),
            "spawn_wall": h.spawn_wall,
            "last_ok_wall": h.last_ok_wall,
            "loop_age_s": h.last_loop_age_s,
            "retired": h.retired,
            "draining": bool(h.last_stats.get("draining", False)),
        } for h in self.router.replicas]

    def tick(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        for h in self.router.replicas:
            if not h.alive or h.retired:
                continue
            try:
                h.refresh()
            except ReplicaUnreachable:
                pass  # classified below from the exit code and heartbeat age
            except RuntimeError as e:
                logger.warning(f"replica {h.replica_id} stats: {e!r}")
        # re-offer the in-doubt submits (lost replies) to their replicas
        self.router.resolve_in_doubt()
        cls = classify_replicas(self._snapshot_rows(),
                                heartbeat_timeout_s=self.heartbeat_timeout_s,
                                startup_grace_s=self.startup_grace_s, now=now)
        for rid in cls["hung"]:
            h = self.router.replica(rid)
            logger.log_event("serve-replica-hung", replica=rid, host=h.host_id,
                             hb_age_s=round(now - h.last_ok_wall, 3),
                             loop_age_s=round(h.last_loop_age_s, 3))
            # a hung process holds its journal namespace: SIGKILL makes it
            # dead and the failover below owns it
            get_fault_plan().fire("serve.replica.hung_kill")
            with span("serve.replica.hung_kill", replica=rid, host=h.host_id):
                h.kill()
            cls["dead"].append(rid)
        for rid in cls["dead"]:
            self._failover(rid, now)
        for rid, rec in sorted(self._relaunch_due.items()):
            if rec["due"] <= now:
                self._relaunch(rid, rec["attempt"], now)
        self._dispatch_orphans()
        if self.policy is not None:
            self._autoscale(now)

    # ------------------------------------------------------ failover
    def _failover(self, replica_id: int, now: float) -> None:
        handle = self.router.replica(replica_id)
        if not handle.alive:
            return  # already failed over: the relaunch is pending or given up
        self.router.fail_replica(replica_id)
        dead_journal = journal_path(self.journal_base, replica_id)
        completed, incomplete, timeouts = failover_split(dead_journal)
        self.recovered.update({int(k): list(v) for k, v in completed.items()})
        self.recovered_timeouts += timeouts
        self.orphans.extend(incomplete)
        # the router's in-doubt parks against the journal: one with a
        # submit record was admitted (the split above owns it), one without
        # never was and joins the orphans; each request is served once
        parked = self.router.take_in_doubt(replica_id)
        unadmitted = 0
        if parked:
            admitted = submitted_ids(dead_journal)
            for rec in parked:
                if int(rec["req"]) not in admitted:
                    self.orphans.append(rec)
                    unadmitted += 1
        logger.log_event("serve-replica-dead", replica=replica_id, host=handle.host_id,
                         rc=handle.proc.poll(), recovered=len(completed),
                         redispatch=len(incomplete) + unadmitted, timeouts=timeouts)
        attempt = self._attempts.get(replica_id, 0) + 1
        if attempt > self.restart_budget:
            logger.log_event("serve-replica-give-up", replica=replica_id, host=handle.host_id,
                             attempts=attempt - 1, budget=self.restart_budget)
            self.gave_up.append(replica_id)
            return
        self._attempts[replica_id] = attempt
        delay = restart_backoff(attempt, self.restart_backoff_s)
        self._relaunch_due[replica_id] = {"due": now + delay, "attempt": attempt}
        logger.log_event("serve-replica-restart", replica=replica_id, host=handle.host_id,
                         attempt=attempt, budget=self.restart_budget,
                         backoff_s=round(delay, 3))

    def _relaunch(self, replica_id: int, attempt: int, now: float) -> None:
        self._relaunch_due.pop(replica_id, None)
        handle = self.router.replica(replica_id)
        # the dead stream was harvested at failover; the relaunch starts a
        # fresh journal in the same namespace (the old writer is gone)
        journal_path(self.journal_base, replica_id).unlink(missing_ok=True)
        try:
            fresh = self.spawn_fn(replica_id)
        except OSError as e:
            logger.warning(f"replica {replica_id} relaunch attempt {attempt} failed: {e!r}")
            next_attempt = self._attempts.get(replica_id, attempt) + 1
            if next_attempt > self.restart_budget:
                logger.log_event("serve-replica-give-up", replica=replica_id,
                                 attempts=next_attempt - 1, budget=self.restart_budget)
                self.gave_up.append(replica_id)
                return
            self._attempts[replica_id] = next_attempt
            delay = restart_backoff(next_attempt, self.restart_backoff_s)
            self._relaunch_due[replica_id] = {"due": now + delay, "attempt": next_attempt}
            return
        handle.rebind(fresh)
        self.router.restore_replica(replica_id)
        self.restarts += 1

    def _dispatch_orphans(self) -> None:
        if not self.orphans or not self.router.live:
            return
        still: List[dict] = []
        for rec in self.orphans:
            # the original request id and force=True: any replica gives the
            # same tokens, and recovery work is never shed. The record's
            # trace is adopted, so the survivor's work lands on the
            # originating request's trace
            with obs.trace_context(rec.get("trace")):
                res = self.router.submit(
                    rec["prompt"], rec["max_new_tokens"],
                    eos_token_id=rec.get("eos_token_id"),
                    temperature=rec.get("temperature", 0.0),
                    top_k=rec.get("top_k"), top_p=rec.get("top_p"),
                    deadline_ms=rec.get("deadline_ms"),
                    ttft_deadline_ms=rec.get("ttft_deadline_ms"),
                    req_id=int(rec["req"]), force=True,
                )
            if isinstance(res, Backpressure):
                still.append(rec)  # every replica unreachable: next pass
        if len(still) < len(self.orphans):
            self.redispatched += len(self.orphans) - len(still)
            logger.log_event("serve-replica-failover",
                             redispatched=len(self.orphans) - len(still),
                             stranded=len(still))
        self.orphans = still

    def pending_recovery(self) -> bool:
        """Work the bench loop must not exit under: stranded requests, or a
        relaunch still owed (the replica must come back, not only its work
        move)."""
        return bool(self.orphans) or bool(self._relaunch_due)

    # ----------------------------------------------------- autoscale
    def _autoscale(self, now: float) -> None:
        rows = []
        for h in self.router.replicas:
            s = h.last_stats
            rows.append({
                "replica": h.replica_id,
                "queue_depth": int(s.get("waiting", 0)),
                "pool_pressure": float(s.get("pool_pressure", 0.0)),
                "in_flight": int(s.get("running", 0)) + int(s.get("waiting", 0)),
                "alive": h.alive and not h.retired,
            })
        decision = self.policy.decide(now, rows)
        if decision is None:
            return
        action, target = decision
        if action == "spawn":
            self.spawn_replica()
        elif action == "drain":
            self.drain_replica(target)

    def spawn_replica(self) -> Optional[int]:
        """Launch one more replica at the next free id; returns the id, or
        None when the spawn failed."""
        new_id = max(h.replica_id for h in self.router.replicas) + 1
        try:
            fresh = self.spawn_fn(new_id)
        except OSError as e:
            logger.warning(f"autoscale spawn failed: {e!r}")
            return None
        self.router.add_replica(fresh)  # logs serve-replica-spawn
        try:
            fresh.refresh()
        except ReplicaUnreachable:
            pass
        return new_id

    def drain_replica(self, target: int, reason: str = "autoscale") -> None:
        """Retire one replica cleanly: the drain event, a last poll through
        ``on_drain`` while it still answers, then drain and shutdown."""
        handle = self.router.replica(target)
        logger.log_event("serve-replica-drain", replica=target, host=handle.host_id,
                         restarts=handle.restarts, reason=reason)
        if self.on_drain is not None:
            self.on_drain(handle)
        # the policy drains only a replica with nothing in flight, so drain
        # and shutdown make an immediate clean exit
        handle.begin_drain()
        handle.request_shutdown()
        handle.retired = True
        handle.alive = False


def main(argv: Optional[List[str]] = None) -> int:
    return worker_main(argv)


if __name__ == "__main__":
    sys.exit(main())
