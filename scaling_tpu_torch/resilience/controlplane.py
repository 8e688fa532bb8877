"""The supervision control plane: heartbeats, named barriers and broadcast
flags (the port's copy of scaling_tpu/resilience/controlplane.py: the same
environment variables, on-disk layout and wire format, so that a JAX peer
and a port peer read each other).

A collective whose peer is gone tells the survivors nothing: it hangs.
The control plane is the out-of-band channel beside it. Two backends with
one contract:

- :class:`FileControlPlane`: a shared directory. Heartbeats are atomic
  file replaces, barrier arrivals and flags are files. No daemon.
- :class:`TcpControlPlane`: a client of :class:`TcpControlPlaneServer`,
  a line-JSON socket server on the coordinator, for hosts that share no
  filesystem.

Contract (both backends):

- ``heartbeat(step)`` publishes this host's liveness and progress; a
  SIGKILLed host simply stops publishing.
- ``peer_heartbeats()`` returns every host's newest record: the
  supervisor's dead and hung detection and the stall watchdog's
  straggler table read it.
- ``barrier(name, timeout_s)`` blocks until all ``num_hosts`` arrive. It
  raises :class:`BarrierTimeout` when peers never show (the caller must
  not proceed: the commit barrier's guarantee) and :class:`JobAborted`
  as soon as the supervisor raises the abort flag.
- ``set_flag`` / ``get_flag`` broadcast small strings: ``preempt``
  (coordinated preemption), ``abort`` (teardown), ``stall``.

The supervisor gives every coordinator epoch a fresh root, so a relaunch
never sees the arrivals of the dead epoch. The fault point
``barrier.timeout`` fires on every barrier entry. Nothing here imports
torch.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import socket
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Union

from ..logging.logger import logger
from ..obs.registry import get_registry
from ..obs.spans import span
from .faults import get_fault_plan
from .guards import retry_io

ENV_CONTROL_DIR = "SCALING_TPU_CONTROL_DIR"
ENV_CONTROL_ADDR = "SCALING_TPU_CONTROL_ADDR"
ENV_HOST_ID = "SCALING_TPU_HOST_ID"
ENV_NUM_HOSTS = "SCALING_TPU_NUM_HOSTS"
ENV_COORD_EPOCH = "SCALING_TPU_COORD_EPOCH"

PREEMPT_FLAG = "preempt"
ABORT_FLAG = "abort"
# set beside PREEMPT when a step-stall watchdog, not an operator, drained
# the pod: the supervisor must relaunch after the clean exit, not finish
STALL_FLAG = "stall"

DEFAULT_BARRIER_POLL_S = 0.05


class BarrierTimeout(RuntimeError):
    """Peers never arrived: a host is dead, hung or partitioned."""


class JobAborted(RuntimeError):
    """The supervisor raised the abort flag: stop waiting and exit."""


@dataclasses.dataclass
class HostHeartbeat:
    host: int
    step: int
    status: str
    wall: float  # the publisher's time.time(), restamped by the reader's backend

    def age(self, now: Optional[float] = None) -> float:
        return (now if now is not None else time.time()) - self.wall

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class ControlPlane:
    """The backend-independent surface (see the module docstring)."""

    def __init__(self, host_id: int, num_hosts: int):
        assert 0 <= host_id < num_hosts
        self.host_id = host_id
        self.num_hosts = num_hosts
        self._last_step = 0

    # backend hooks
    def _publish_heartbeat(self, record: HostHeartbeat) -> None:
        raise NotImplementedError

    def _read_heartbeats(self) -> Dict[int, HostHeartbeat]:
        raise NotImplementedError

    def _arrive(self, name: str) -> None:
        raise NotImplementedError

    def _arrived_count(self, name: str) -> int:
        raise NotImplementedError

    def _prune_barrier(self, name: str) -> None:
        raise NotImplementedError

    def set_flag(self, name: str, value: str = "1") -> None:
        raise NotImplementedError

    def get_flag(self, name: str) -> Optional[str]:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def clock_offset(self) -> float:
        """This host's wall clock minus the control plane's reference
        clock, in seconds (best effort; 0.0 without a shared clock).
        ``obs trace`` subtracts it to put every host's records on one
        clock."""
        return 0.0

    # shared logic
    def heartbeat(self, step: int, status: str = "running") -> None:
        self._last_step = step
        t0 = time.perf_counter()
        self._publish_heartbeat(HostHeartbeat(self.host_id, step, status, time.time()))
        # the send lag leads control-plane storage trouble: a heartbeat
        # that takes seconds to publish soon reads as a stale host
        lag = time.perf_counter() - t0
        reg, labels = get_registry(), {"host": str(self.host_id)}
        reg.gauge("controlplane_heartbeat_send_seconds", labels).set(lag)
        reg.histogram("controlplane_heartbeat_send", labels).observe(lag)

    def peer_heartbeats(self) -> Dict[int, HostHeartbeat]:
        """The newest record of each host, this one's included."""
        return self._read_heartbeats()

    def arrive(self, name: str) -> None:
        """Register arrival at ``name`` without waiting: for an exit path
        that never re-enters the loop, so that a peer parked inside the
        barrier is released instead of waiting out its timeout."""
        self._arrive(name)

    def prune_barrier(self, name: str) -> None:
        """Drop a barrier's arrivals once no host can wait on it again
        (the lockstep protocol guarantees that two steps behind)."""
        self._prune_barrier(name)

    def barrier(self, name: str, timeout_s: float,
                poll_s: float = DEFAULT_BARRIER_POLL_S) -> None:
        """Block until all ``num_hosts`` arrive at ``name``; raises
        :class:`JobAborted` once the abort flag appears and
        :class:`BarrierTimeout` at the deadline. Traced as a
        ``barrier.wait`` span a host: the host that waits ~0 arrived
        last."""
        get_fault_plan().fire("barrier.timeout", path=name)
        with span("barrier.wait", barrier=name, host=self.host_id):
            self._barrier_wait(name, timeout_s, poll_s)

    def _barrier_wait(self, name: str, timeout_s: float, poll_s: float) -> None:
        self._arrive(name)
        deadline = time.monotonic() + timeout_s
        next_hb = time.monotonic() + 1.0
        # a long wait (a peer's checkpoint write ahead of the commit
        # barrier) backs off toward 1 s between polls
        sleep_s = poll_s
        while True:
            arrived = self._arrived_count(name)
            if arrived >= self.num_hosts:
                return
            if self.get_flag(ABORT_FLAG) is not None:
                raise JobAborted(f"abort flag raised while waiting at barrier {name!r} "
                                 f"({arrived}/{self.num_hosts} arrived)")
            if time.monotonic() >= deadline:
                raise BarrierTimeout(
                    f"barrier {name!r} timed out after {timeout_s}s: "
                    f"{arrived}/{self.num_hosts} hosts arrived "
                    "(a peer is dead, hung, or partitioned)")
            if time.monotonic() >= next_hb:
                # waiting at a barrier is alive: keep the staleness
                # detector pointed at truly wedged hosts
                self._publish_heartbeat(HostHeartbeat(
                    self.host_id, self._last_step, f"barrier:{name}", time.time()))
                next_hb = time.monotonic() + 1.0
            time.sleep(sleep_s)
            sleep_s = min(sleep_s * 1.5, 1.0)


class FileControlPlane(ControlPlane):
    """Shared-directory backend. Layout under ``root``::

        heartbeat/host<K>.json   newest heartbeat of each host
        barrier/<name>/host<K>   arrival markers
        flags/<name>             flag values

    Writers replace whole files with ``os.replace``, so readers never see
    a torn record. Every operation rides :func:`retry_io`: one transient
    error on shared storage must not crash a healthy worker."""

    def __init__(self, root: Union[Path, str], host_id: int, num_hosts: int):
        super().__init__(host_id, num_hosts)
        self.root = Path(root)
        for sub in ("heartbeat", "barrier", "flags"):
            (self.root / sub).mkdir(parents=True, exist_ok=True)

    def _atomic_write(self, path: Path, text: str) -> None:
        # pid and thread: the checkpoint writer thread refreshes the
        # heartbeat in a barrier wait while the loop publishes its own
        tmp = path.with_name(f".{path.name}.tmp{os.getpid()}.{threading.get_ident()}")
        tmp.write_text(text)
        os.replace(tmp, path)

    def _publish_heartbeat(self, record: HostHeartbeat) -> None:
        retry_io(lambda: self._atomic_write(self.root / "heartbeat" / f"host{record.host}.json",
                                            json.dumps(record.to_dict())),
                 what="heartbeat publish")

    def _read_heartbeats(self) -> Dict[int, HostHeartbeat]:
        return retry_io(self._read_heartbeats_once, what="heartbeat read")

    def _read_heartbeats_once(self) -> Dict[int, HostHeartbeat]:
        out: Dict[int, HostHeartbeat] = {}
        for f in (self.root / "heartbeat").glob("host*.json"):
            try:
                rec = json.loads(f.read_text())
                # the mtime comes from one clock (the file server's) for
                # every record: a publisher's skew drops out of the age
                rec["wall"] = f.stat().st_mtime
                out[int(rec["host"])] = HostHeartbeat(**rec)
            except (OSError, ValueError, KeyError, TypeError) as e:
                # a reader racing the first publish; never torn
                logger.debug(f"unreadable heartbeat {f}: {e!r}")
        return out

    def _barrier_dir(self, name: str) -> Path:
        # barrier names may carry ':' or '/' (commit:step-6)
        return self.root / "barrier" / name.replace("/", "_").replace(":", "_")

    def _arrive(self, name: str) -> None:
        def op():
            d = self._barrier_dir(name)
            d.mkdir(parents=True, exist_ok=True)
            self._atomic_write(d / f"host{self.host_id}", "1")

        retry_io(op, what=f"barrier arrival {name!r}")

    def _arrived_count(self, name: str) -> int:
        def op():
            d = self._barrier_dir(name)
            return sum(1 for _ in d.glob("host*")) if d.is_dir() else 0

        return retry_io(op, what=f"barrier count {name!r}")

    def _prune_barrier(self, name: str) -> None:
        # concurrent pruners race benignly: the loser sees ENOENT
        shutil.rmtree(self._barrier_dir(name), ignore_errors=True)

    def set_flag(self, name: str, value: str = "1") -> None:
        retry_io(lambda: self._atomic_write(self.root / "flags" / name, value),
                 what=f"flag set {name!r}")

    def get_flag(self, name: str) -> Optional[str]:
        def op():
            try:
                return (self.root / "flags" / name).read_text()
            except FileNotFoundError:
                return None  # the common case

        return retry_io(op, what=f"flag read {name!r}")

    def clock_offset(self) -> float:
        """Local wall clock against the file server's: a probe's mtime
        beside local ``time.time()``, the write's latency included."""
        def op():
            probe = self.root / "heartbeat" / f".clock{self.host_id}"
            self._atomic_write(probe, "1")
            return time.time() - probe.stat().st_mtime

        try:
            return retry_io(op, what="clock probe")
        except OSError:
            return 0.0  # alignment is best effort


class TcpControlPlaneServer:
    """The coordinator's state for :class:`TcpControlPlane`: one
    connection a request, one JSON line each way. Run it on the
    supervisor or host 0; workers connect to ``SCALING_TPU_CONTROL_ADDR``."""

    # requests are sub-KiB lines; a client streaming bytes without a
    # newline must not buffer without bound
    MAX_REQUEST_BYTES = 64 * 1024

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._hb: Dict[int, dict] = {}
        self._barriers: Dict[str, set] = {}
        self._flags: Dict[str, str] = {}
        self._capacity: Dict[str, Dict[str, dict]] = {}
        self._lock = threading.Lock()
        # stays raw: one-time server bind at startup; a port conflict or
        # a bad address is a configuration error that must abort loudly,
        # not retry (client requests ride retry_io)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)  # sta: disable=STA011
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.address = f"{host}:{self._sock.getsockname()[1]}"
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, name="controlplane-server",
                                        daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # closed under us during shutdown
            # a thread a connection: an idle prober must not park the
            # accept loop, and with it every host's heartbeat
            threading.Thread(target=self._handle_conn, args=(conn,), daemon=True).start()

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            with conn:
                conn.settimeout(5.0)
                data = conn.makefile("r").readline(self.MAX_REQUEST_BYTES)
                if len(data) >= self.MAX_REQUEST_BYTES and not data.endswith("\n"):
                    raise ValueError(f"request line exceeds {self.MAX_REQUEST_BYTES} bytes")
                reply = self._handle(json.loads(data))
                conn.sendall((json.dumps(reply) + "\n").encode())
        except Exception as e:
            # any malformed request (a port scanner, a skewed client) is
            # logged; the server goes on
            logger.warning(f"control-plane request failed: {e!r}")

    def _handle(self, req: dict) -> dict:
        with self._lock:
            op = req.get("op")
            if op == "hb":
                rec = dict(req["record"])
                # stamped on receipt with the server's clock: staleness
                # never compares a worker's clock with the supervisor's
                rec["wall"] = time.time()
                self._hb[int(req["host"])] = rec
                return {"ok": True}
            if op == "peers":
                # ``now`` lets the client move the walls onto its clock
                return {"ok": True, "peers": list(self._hb.values()), "now": time.time()}
            if op == "arrive":
                self._barriers.setdefault(req["name"], set()).add(int(req["host"]))
                return {"ok": True}
            if op == "count":
                return {"ok": True, "count": len(self._barriers.get(req["name"], ()))}
            if op == "prune":
                self._barriers.pop(req["name"], None)
                return {"ok": True}
            if op == "set_flag":
                self._flags[req["name"]] = req["value"]
                return {"ok": True}
            if op == "get_flag":
                return {"ok": True, "value": self._flags.get(req["name"])}
            # the capacity records of the wire protocol: kind-scoped
            # key/value records, stamped on receipt like heartbeats
            if op == "cap_set":
                rec = dict(req["record"])
                rec["wall"] = time.time()
                self._capacity.setdefault(req["kind"], {})[req["name"]] = rec
                return {"ok": True}
            if op == "cap_list":
                return {"ok": True, "records": list(self._capacity.get(req["kind"], {}).values()),
                        "now": time.time()}
            if op == "cap_del":
                self._capacity.get(req["kind"], {}).pop(req["name"], None)
                return {"ok": True}
            return {"ok": False, "error": f"unknown op {op!r}"}

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError as e:
            logger.debug(f"control-plane server close: {e!r}")
        self._thread.join(timeout=5)


class TcpControlPlane(ControlPlane):
    """Client of :class:`TcpControlPlaneServer` (``address`` is
    ``host:port``)."""

    def __init__(self, address: str, host_id: int, num_hosts: int,
                 connect_timeout_s: float = 5.0):
        super().__init__(host_id, num_hosts)
        host, port = address.rsplit(":", 1)
        self._addr = (host, int(port))
        self._timeout = connect_timeout_s

    def _request_once(self, req: dict) -> dict:
        with socket.create_connection(self._addr, self._timeout) as conn:
            conn.sendall((json.dumps(req) + "\n").encode())
            return json.loads(conn.makefile("r").readline())

    def _request(self, req: dict) -> dict:
        # a fresh connection a request: a momentary backlog overflow or
        # reset gets a bounded retry; a protocol error (ok false) does not
        reply = retry_io(lambda: self._request_once(req), retry_on=(OSError, ValueError),
                         what=f"control-plane request {req.get('op')!r}")
        if not reply.get("ok"):
            raise RuntimeError(f"control-plane request {req} failed: {reply}")
        return reply

    def _publish_heartbeat(self, record: HostHeartbeat) -> None:
        self._request({"op": "hb", "host": record.host, "record": record.to_dict()})

    def _read_heartbeats(self) -> Dict[int, HostHeartbeat]:
        reply = self._request({"op": "peers"})
        # the walls are the server's receipt stamps: moved onto this clock
        offset = time.time() - float(reply.get("now") or time.time())
        out: Dict[int, HostHeartbeat] = {}
        for r in reply["peers"]:
            rec = HostHeartbeat(**r)
            rec.wall += offset
            out[int(rec.host)] = rec
        return out

    def _arrive(self, name: str) -> None:
        self._request({"op": "arrive", "name": name, "host": self.host_id})

    def _arrived_count(self, name: str) -> int:
        return int(self._request({"op": "count", "name": name})["count"])

    def _prune_barrier(self, name: str) -> None:
        self._request({"op": "prune", "name": name})

    def set_flag(self, name: str, value: str = "1") -> None:
        # rare, high-signal control events (abort, preempt): a span each
        with span("cp.set_flag", flag=name, host=self.host_id, level="debug"):
            self._request({"op": "set_flag", "name": name, "value": value})

    def get_flag(self, name: str) -> Optional[str]:
        return self._request({"op": "get_flag", "name": name})["value"]

    def clock_offset(self) -> float:
        """Local wall clock against the coordinator's, from the ``now``
        of a ``peers`` reply; the round trip bounds the error."""
        try:
            with span("cp.clock_probe", host=self.host_id, level="debug"):
                reply = self._request({"op": "peers"})
            return time.time() - float(reply.get("now") or time.time())
        except (RuntimeError, OSError):
            return 0.0  # alignment is best effort

    # the capacity records (no capacity channel is ported; the wire
    # protocol carries them, so the client speaks them too)
    def capacity_set(self, kind: str, name: str, record: dict) -> None:
        with span("cp.cap_set", kind=kind, key=name, level="debug"):
            self._request({"op": "cap_set", "kind": kind, "name": name, "record": record})

    def capacity_list(self, kind: str) -> dict:
        """``records`` (each with the server's receipt ``wall``) and
        ``now``, the server's clock at the read."""
        with span("cp.cap_list", kind=kind, level="debug"):
            reply = self._request({"op": "cap_list", "kind": kind})
        return {"records": reply["records"], "now": reply["now"]}

    def capacity_del(self, kind: str, name: str) -> None:
        with span("cp.cap_del", kind=kind, key=name, level="debug"):
            self._request({"op": "cap_del", "kind": kind, "name": name})


def controlplane_from_env() -> Optional[ControlPlane]:
    """The control plane a launcher described in the environment:
    ``SCALING_TPU_CONTROL_DIR`` for the file backend,
    ``SCALING_TPU_CONTROL_ADDR`` (``host:port``) for TCP, with
    ``SCALING_TPU_HOST_ID`` and ``SCALING_TPU_NUM_HOSTS``. None when
    nothing is set (an unsupervised run pays nothing)."""
    control_dir = os.environ.get(ENV_CONTROL_DIR)
    control_addr = os.environ.get(ENV_CONTROL_ADDR)
    if not control_dir and not control_addr:
        return None
    host_id = int(os.environ.get(ENV_HOST_ID, "0"))
    num_hosts = int(os.environ.get(ENV_NUM_HOSTS, "1"))
    if control_dir:
        cp: ControlPlane = FileControlPlane(control_dir, host_id, num_hosts)
    else:
        cp = TcpControlPlane(control_addr, host_id, num_hosts)
    log_clock_offset(cp)
    return cp


def log_clock_offset(cp: ControlPlane) -> None:
    """One ``clock-offset`` event: this host's wall clock minus the
    control plane's reference clock, for ``obs trace``'s alignment."""
    logger.log_event("clock-offset", _level="debug", host=cp.host_id,
                     offset_s=round(cp.clock_offset(), 6))


def straggler_table(heartbeats: Dict[int, HostHeartbeat], num_hosts: int,
                    stale_after_s: float, now: Optional[float] = None) -> "StragglerReport":
    """Classify every expected host by its newest heartbeat: none, or one
    older than ``stale_after_s``, is dead; the rest keep their status, so
    that the watchdog tells "peer 2 is dead" from "we are the straggler"."""
    now = now if now is not None else time.time()
    rows, dead = [], []
    for host in range(num_hosts):
        hb = heartbeats.get(host)
        if hb is None:
            rows.append((host, None, None, "never-heartbeat"))
            dead.append(host)
            continue
        age = hb.age(now)
        if age > stale_after_s:
            dead.append(host)
        rows.append((host, hb.step, age, "dead" if age > stale_after_s else hb.status))
    return StragglerReport(rows=rows, dead_hosts=dead)


@dataclasses.dataclass
class StragglerReport:
    rows: list  # (host, step or None, age_s or None, state)
    dead_hosts: list

    def render(self) -> str:
        lines = [f"{'host':>4} {'step':>6} {'hb_age_s':>9} state"]
        for host, step, age, state in self.rows:
            lines.append(f"{host:>4} {step if step is not None else '-':>6} "
                         f"{f'{age:.1f}' if age is not None else '-':>9} {state}")
        return "\n".join(lines)
