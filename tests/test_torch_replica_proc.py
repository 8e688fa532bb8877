"""The process fleet's wire format and the supervisor's units against the
JAX package's: each package's RPC client talks to the other's server
with the same handler and both read the same replies; submit is
idempotent by request id and poll exact from its cursor (on a port
worker over a toy engine, a lost reply included); rendezvous records
written by either package read the same through both, and a relaunch
waits for its own incarnation; ``classify_replicas`` equals JAX's on a
table of rows; the ``serve.replica.*`` fault points fire at the same
calls; the supervisor's failover of a dead replica (journal harvest,
re-dispatch, relaunch on the backoff) equals JAX's."""

import json
import os
from collections import deque

import pytest

pytest.importorskip("jax")

import scaling_tpu.resilience.faults as jax_faults  # noqa: E402
import scaling_tpu.serve.replica_proc as jax_rp  # noqa: E402
import scaling_tpu.serve.router as jax_router  # noqa: E402
import scaling_tpu.serve.scheduler as jax_scheduler  # noqa: E402
import scaling_tpu_torch.resilience.faults as port_faults  # noqa: E402
import scaling_tpu_torch.serve.replica_proc as port_rp  # noqa: E402
import scaling_tpu_torch.serve.router as port_router  # noqa: E402
import scaling_tpu_torch.serve.scheduler as port_scheduler  # noqa: E402
from scaling_tpu_torch.serve.journal import RequestJournal  # noqa: E402
from scaling_tpu_torch.serve.scheduler import Request  # noqa: E402

PKG = {
    "jax": dict(rp=jax_rp, router=jax_router, sched=jax_scheduler, faults=jax_faults),
    "port": dict(rp=port_rp, router=port_router, sched=port_scheduler, faults=port_faults),
}


@pytest.fixture(autouse=True)
def clean_fault_plans(monkeypatch):
    monkeypatch.delenv("SCALING_TPU_HOST_ID", raising=False)
    for p in PKG.values():
        p["faults"].set_fault_plan(p["faults"].FaultPlan(""))
    yield
    for p in PKG.values():
        p["faults"].set_fault_plan(None)


def arm(spec):
    for p in PKG.values():
        p["faults"].set_fault_plan(p["faults"].FaultPlan(spec))


# ------------------------------------------------------------ fake engine
class FakeRequest:
    def __init__(self, req_id, prompt):
        self.req_id, self.prompt, self.arrival_s = req_id, list(prompt), 100.0


class FakeSeq:
    def __init__(self, req_id, prompt):
        self.request = FakeRequest(req_id, prompt)
        self.generated, self.token_stamps = [], []
        self.finish_status, self.first_token_s = None, None


class FakeScheduler:
    def __init__(self):
        self.running, self.waiting = {}, deque()

    @property
    def has_work(self):
        return bool(self.running or self.waiting)

    def pool_pressure(self):
        return 0.25


class FakeEngine:
    """The engine surface a replica worker serves, without a model: a
    tick finishes every waiting request with tokens made from its id."""

    def __init__(self, pkg, replica_id=0, ticks_of_work=None):
        self.bp = PKG[pkg]["sched"].Backpressure
        self.replica_id = replica_id
        self.scheduler = FakeScheduler()
        self.finished = []
        self.draining = False
        self.tick_index = 0
        self.next_id = 0
        self.ticks_of_work = ticks_of_work

    def submit(self, prompt, max_new_tokens, req_id=None, **kw):
        if self.draining and not kw.get("force"):
            return self.bp(reason="draining", pool_pressure=0.25,
                           waiting=len(self.scheduler.waiting), draining=True)
        req_id = self.next_id if req_id is None else req_id
        self.next_id = max(self.next_id, req_id + 1)
        seq = FakeSeq(req_id, prompt)
        self.scheduler.waiting.append(seq)
        return seq

    def tick(self):
        self.tick_index += 1
        if self.ticks_of_work is not None:
            self.ticks_of_work -= 1
            if self.ticks_of_work <= 0:
                self.scheduler.waiting.clear()
            return
        while self.scheduler.waiting:
            seq = self.scheduler.waiting.popleft()
            seq.generated = [seq.request.req_id + k for k in range(3)]
            seq.first_token_s = 100.5
            seq.token_stamps = [100.5, 100.75, 101.0]
            seq.finish_status = "completed"
            self.finished.append(seq)

    def begin_drain(self):
        self.draining = True

    def stats_snapshot(self):
        return {"replica": self.replica_id, "queue_depth": len(self.scheduler.waiting),
                "has_work": self.scheduler.has_work, "tick": self.tick_index,
                "draining": self.draining, "next_req_id": self.next_id}


def worker(pkg, engine_pkg=None, **kw):
    engine = FakeEngine(engine_pkg or pkg, **kw)
    return PKG[pkg]["rp"]._ReplicaWorker(engine), engine


def masked(reply):
    reply = dict(reply)
    reply.pop("loop_age_s", None)
    return reply


def conversation(server_pkg, client_pkg):
    """The same requests through ``server_pkg``'s server and
    ``client_pkg``'s client, the handler a port worker's."""
    w, engine = worker("port")
    server = PKG[server_pkg]["rp"].ReplicaRpcServer(w.handle)
    try:
        client = PKG[client_pkg]["rp"].ReplicaProcClient(server.address)
        replies = []
        for req in ({"op": "submit", "prompt": [1, 2, 3], "max_new_tokens": 3,
                     "kw": {"req_id": 0, "count_shed": False}},
                    {"op": "submit", "prompt": [1, 2, 3], "max_new_tokens": 3,
                     "kw": {"req_id": 0, "count_shed": False}},
                    {"op": "submit", "prompt": [4, 5], "max_new_tokens": 3,
                     "kw": {"req_id": 1}}):
            replies.append(client.request(req))
        engine.tick()
        for req in ({"op": "poll", "from": 0}, {"op": "poll", "from": 1},
                    {"op": "poll", "from": 2}, {"op": "stats"}, {"op": "drain"},
                    {"op": "submit", "prompt": [6], "max_new_tokens": 2, "kw": {"req_id": 2}}):
            replies.append(masked(client.request(req)))
        with pytest.raises(RuntimeError, match="unknown op"):
            client.request({"op": "teleport"})
        return replies
    finally:
        server.close()


def test_the_wire_format_reads_both_ways():
    got = {(s, c): conversation(s, c) for s in ("jax", "port") for c in ("jax", "port")}
    first = got[("port", "port")]
    assert all(v == first for v in got.values())
    assert first[1]["dup"] is True and first[3]["total"] == 2
    assert [r["req"] for r in first[3]["finished"]] == [0, 1]
    assert first[3]["finished"][0]["itls"] == [0.25, 0.25]
    assert first[5]["finished"] == [] and first[8]["admitted"] is False


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_transport_errors_retried_protocol_errors_not(pkg):
    rp = PKG[pkg]["rp"]
    calls = []

    def handler(req):
        calls.append(req["op"])
        if req["op"] == "flaky" and calls.count("flaky") == 1:
            raise RuntimeError("first call crashed")  # reply dropped
        if req["op"] == "reject":
            return {"ok": False, "error": "rejected"}
        if req["op"] == "crash":
            raise RuntimeError("always")
        return {"ok": True}

    server = rp.ReplicaRpcServer(handler)
    try:
        client = rp.ReplicaProcClient(server.address, timeout_s=1.0)
        assert client.request({"op": "flaky"})["ok"] and calls.count("flaky") == 2
        with pytest.raises(RuntimeError):
            client.request({"op": "reject"})
        assert calls.count("reject") == 1
        with pytest.raises(PKG[pkg]["router"].ReplicaUnreachable) as ei:
            client.request({"op": "crash"}, attempts=2)
        assert ei.value.maybe_admitted is True  # the request left this host
    finally:
        server.close()
    dead = rp.ReplicaProcClient(server.address, timeout_s=0.5)
    with pytest.raises(PKG[pkg]["router"].ReplicaUnreachable) as ei:
        dead.request({"op": "stats"}, attempts=1)
    assert ei.value.maybe_admitted is False  # refused: nothing was sent


def toy_worker():
    from scaling_tpu_torch.serve import EngineConfig, ServeEngine
    from scaling_tpu_torch.serve.bench import build_inference

    engine = ServeEngine(build_inference("toy", seed=0, device="cpu"),
                         EngineConfig(num_slots=2, block_size=4, num_blocks=32,
                                      max_blocks_per_seq=8, prefill_chunk=4, replica_id=0),
                         device="cpu")
    return port_rp._ReplicaWorker(engine), engine


def test_submit_is_idempotent_and_poll_is_cursor_exact():
    """On a port worker over the toy engine: a submit whose reply was lost
    (``serve.replica.rpc=drop``) is retried and answered as a duplicate,
    enqueued once; poll from a cursor ships exactly the records past it,
    and a poll whose reply was lost ships them again."""
    w, engine = toy_worker()
    server = port_rp.ReplicaRpcServer(w.handle)
    try:
        client = port_rp.ReplicaProcClient(server.address)
        arm("serve.replica.rpc=drop@1")
        reply = client.request({"op": "submit", "prompt": [5, 6, 7], "max_new_tokens": 3,
                                "kw": {"req_id": 4}})
        assert reply == {"ok": True, "admitted": True, "req": 4, "dup": True}
        assert client.retries == 1 and w.dup_submits == 1
        assert len(engine.scheduler.waiting) == 1
        arm("")
        client.request({"op": "submit", "prompt": [9, 9], "max_new_tokens": 2,
                        "kw": {"req_id": 5}})
        engine.run_until_done()
        first = client.request({"op": "poll", "from": 0})
        assert first["total"] == 2
        assert {r["req"]: len(r["toks"]) for r in first["finished"]} == {4: 3, 5: 2}
        assert client.request({"op": "poll", "from": 1})["finished"] == first["finished"][1:]
        arm("serve.replica.rpc=drop@1")
        again = client.request({"op": "poll", "from": 0})
        assert again == first
        stats = client.request({"op": "stats"})["stats"]
        assert stats["completed"] == 2 and stats["next_req_id"] == 6
    finally:
        server.close()


def test_stats_snapshot_has_the_jax_fields_and_the_launches():
    """Every field and name of the JAX engine's ``stats_snapshot``, and the
    port's launch counters beside them."""
    import inspect
    import re

    from scaling_tpu.serve.engine import ServeEngine as JaxEngine

    _, engine = toy_worker()
    engine.submit([1, 2, 3], 2)
    engine.run_until_done()
    snap = engine.stats_snapshot()
    jax_keys = set(re.findall(r'"(\w+)":', inspect.getsource(JaxEngine.stats_snapshot)))
    assert jax_keys <= set(snap) and len(jax_keys) == 21
    assert set(snap) - jax_keys == {"kernel_launches", "plain_launches"}
    assert snap["completed"] == 1 and snap["output_tokens"] == 2 and snap["tick"] > 0
    assert snap["plain_launches"]["paged_attention"] > 0
    json.dumps(snap)  # the stats reply is JSON


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_rendezvous_records_read_the_same(tmp_path, writer):
    path = PKG[writer]["rp"].rendezvous_file(tmp_path)
    publish = PKG[writer]["rp"].publish_rendezvous
    publish(path, {"replica": 0, "host": None, "addr": "127.0.0.1:1", "pid": 1,
                   "incarnation": 0})
    publish(path, {"replica": 1, "host": None, "addr": "127.0.0.1:2", "pid": 2,
                   "incarnation": 0})
    publish(path, {"replica": 0, "host": None, "addr": "127.0.0.1:3", "pid": 3,
                   "incarnation": 1})
    with open(path, "a") as f:
        f.write('{"replica": 1, "addr": "torn')  # a racing writer's tail
    got = {pkg: PKG[pkg]["rp"].read_rendezvous(path) for pkg in PKG}
    assert got["jax"] == got["port"]
    assert got["port"][0]["incarnation"] == 1 and got["port"][1]["addr"] == "127.0.0.1:2"
    assert port_rp.read_rendezvous(tmp_path / "missing.jsonl") == {}


def test_a_relaunch_waits_for_its_own_incarnation(tmp_path):
    """Two spawns of replica 0 (a toy CPU worker each): the second claims
    incarnation 1 and is ready only at its own record, not at the dead
    first one's; each answers stats and shuts down with exit 0."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("SCALING_TPU_")}
    env["OMP_NUM_THREADS"] = "1"
    cfg = {"journal_base": str(tmp_path / "journal.jsonl"), "warmup": 0, "model": "toy",
           "seed": 0, "device": "cpu",
           "engine": dict(num_slots=2, block_size=4, num_blocks=32, max_blocks_per_seq=8,
                          prefill_chunk=4)}
    addrs = []
    for incarnation in range(2):
        h = port_rp.spawn_replica_proc(0, cfg, tmp_path, env=env, ready_timeout_s=120)
        try:
            rec = port_rp.read_rendezvous(port_rp.rendezvous_file(tmp_path))[0]
            assert rec["incarnation"] == incarnation and rec["pid"] == h.proc.pid
            assert h.refresh()["replica"] == 0
            addrs.append(rec["addr"])
            h.request_shutdown()
            assert h.proc.wait(timeout=60) == 0
        finally:
            if h.proc.poll() is None:
                h.kill()
    written = json.loads((tmp_path / "replica_0.json").read_text())
    assert written["device"] == "cpu" and written["incarnation"] == 1
    assert written["journal"].endswith("journal_r0.jsonl")


def test_a_replica_on_another_host_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="not ported"):
        port_rp.spawn_replica_proc(0, {"journal_base": str(tmp_path / "j.jsonl"),
                                       "engine": {"block_size": 4}}, tmp_path,
                                   hostname="gpu-host-7")


ROWS = {
    "sigkill": [dict(replica=0, exit_code=-9), dict(replica=1)],
    "exit_nonzero": [dict(replica=0, exit_code=3)],
    "clean_exit_and_retired": [dict(replica=0, exit_code=0), dict(replica=1, retired=True)],
    "stale_past_grace": [dict(replica=0, last_ok_wall=80.0)],
    "stale_in_grace": [dict(replica=0, last_ok_wall=80.0, spawn_wall=95.0)],
    "wedged_loop": [dict(replica=0, last_ok_wall=99.9, loop_age_s=12.0)],
    "negative_age_clamped": [dict(replica=0, last_ok_wall=95.0, loop_age_s=-50.0)],
    "draining_never_hung": [dict(replica=0, last_ok_wall=50.0, draining=True)],
    "mixed": [dict(replica=0), dict(replica=1, exit_code=-9),
              dict(replica=2, last_ok_wall=10.0), dict(replica=3, exit_code=0)],
}


@pytest.mark.parametrize("name", sorted(ROWS))
@pytest.mark.parametrize("kw", [{}, {"heartbeat_timeout_s": 3.0, "startup_grace_s": 1.0}],
                         ids=["defaults", "tight"])
def test_classify_replicas_equals_jax(name, kw):
    base = dict(exit_code=None, spawn_wall=0.0, last_ok_wall=99.5, loop_age_s=0.1,
                retired=False, draining=False)
    rows = [dict(base, **r) for r in ROWS[name]]
    ours = port_rp.classify_replicas(rows, now=100.0, **kw)
    assert ours == jax_rp.classify_replicas(rows, now=100.0, **kw)
    assert sorted(sum(ours.values(), [])) == sorted(
        r["replica"] for r in rows if not r["retired"] and r["exit_code"] in (None, -9, 3))


def outcomes(pkg, calls):
    w, engine = worker(pkg)
    out = []
    for req in calls:
        try:
            out.append(("reply", masked(w.handle(dict(req)))))
        except OSError as e:
            out.append(("error", type(e).__name__, str(e)))
    plan = PKG[pkg]["faults"].get_fault_plan()
    return out, len(engine.scheduler.waiting), [
        plan.hits(p) for p in ("serve.replica.rpc", "serve.replica.net_partition")]


CALLS = [{"op": "submit", "prompt": [1, 2], "max_new_tokens": 2, "kw": {"req_id": i}}
         for i in range(4)] + [{"op": "stats"}]


@pytest.mark.parametrize("spec,host,errors", [
    ("serve.replica.rpc=drop@2", None, 1),
    ("serve.replica.rpc=partition@1x2", None, 2),
    ("serve.replica.rpc=delay@3", None, 0),
    ("serve.replica.net_partition=partition@2x2@host=3", "3", 2),
    ("serve.replica.net_partition=partition@2x2@host=3", "1", 0),
    ("serve.replica.rpc=fail@4", None, 1),
], ids=["drop", "partition", "delay", "net_partition", "net_partition_other_host", "fail"])
def test_rpc_fault_points_fire_at_the_same_calls(spec, host, errors, monkeypatch):
    """Each package's worker under one plan: the same requests served,
    dropped or failed at the same calls, the same hit counts."""
    if host is not None:
        monkeypatch.setenv("SCALING_TPU_HOST_ID", host)
    got = {}
    for pkg in PKG:
        arm(spec)
        got[pkg] = outcomes(pkg, CALLS)
    assert got["port"] == got["jax"]
    assert sum(o[0] == "error" for o in got["port"][0]) == errors


def test_kill_point_counts_the_ticks_with_work():
    """``serve.replica.kill`` fires before each tick while the worker has
    work (an advisory action here, so the loop runs on): the same hits in
    both packages' tick loops."""
    hits = {}
    for pkg in PKG:
        arm("serve.replica.kill=delay@2")
        w, engine = worker(pkg, ticks_of_work=3)
        engine.scheduler.waiting.append(FakeSeq(0, [1]))
        w.shutdown.set()
        assert w.run() == 0
        hits[pkg] = (PKG[pkg]["faults"].get_fault_plan().hits("serve.replica.kill"),
                     engine.tick_index)
    assert hits["port"] == hits["jax"] == (3, 3)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_spawn_and_rendezvous_points(pkg, tmp_path):
    """``serve.replica.spawn=fail`` fails the launch before anything starts
    (an OSError for the supervisor's backoff); ``serve.replica.rendezvous=
    fail@1`` is absorbed by the retry of a publish."""
    rp = PKG[pkg]["rp"]
    arm("serve.replica.spawn=fail@1")
    with pytest.raises(OSError):
        rp.spawn_replica_proc(0, {"journal_base": str(tmp_path / "j.jsonl"),
                                  "engine": {"block_size": 4}}, tmp_path)
    assert not (tmp_path / "replica_0.json").exists()
    arm("serve.replica.rendezvous=fail@1")
    rp.publish_rendezvous(tmp_path / "rdv.jsonl", {"replica": 0, "incarnation": 0})
    plan = PKG[pkg]["faults"].get_fault_plan()
    assert plan.hits("serve.replica.rendezvous") == 2
    assert rp.read_rendezvous(tmp_path / "rdv.jsonl")[0]["incarnation"] == 0


def test_teardown_point_aborts_the_kill():
    class Proc:
        killed = False

        def kill(self):
            self.killed = True

        def wait(self, timeout=None):
            return -9

    h = port_rp.ProcReplicaHandle(0, Proc(), port_rp.ReplicaProcClient("127.0.0.1:1"), 4)
    arm("serve.replica.teardown=fail@1")
    with pytest.raises(OSError):
        h.kill()
    assert not h.proc.killed
    h.kill()
    assert h.proc.killed


# ------------------------------------------------- the supervisor's failover
class FakeProc:
    def __init__(self, rc=None):
        self.rc = rc

    def poll(self):
        return self.rc

    def kill(self):
        self.rc = -9

    def wait(self, timeout=None):
        return self.rc


class SupHandle:
    """The ProcReplicaHandle surface the supervisor drives, in memory."""

    def __init__(self, pkg, rid, rc=None):
        self.router = PKG[pkg]["router"]
        self.replica_id, self.alive, self.retired = rid, True, False
        self.host_id, self.block_size = None, 4
        self.stats = self.router.ReplicaStats()
        self.proc = FakeProc(rc)
        self.spawn_wall = self.last_ok_wall = 0.0
        self.last_loop_age_s = 0.0
        self.last_stats = {}
        self.submits = []
        self.restarts = 0

    def refresh(self):
        if self.proc.poll() is not None:
            raise self.router.ReplicaUnreachable("dead")
        self.last_ok_wall = 99.0
        return self.last_stats

    def load(self):
        return len(self.submits), 0.0

    def submit(self, prompt, max_new_tokens, **kw):
        if self.proc.poll() is not None:
            raise self.router.ReplicaUnreachable("dead")
        self.submits.append((kw["req_id"], list(prompt), kw.get("force")))
        return ("admitted", self.replica_id)

    def begin_drain(self):
        pass

    @property
    def has_work(self):
        return bool(self.submits)

    def next_req_id(self):
        return 0

    def queue_sizes(self):
        return 0, 0

    def kill(self):
        self.proc.kill()

    def rebind(self, fresh):
        self.proc = fresh.proc
        self.restarts += 1


def failover_run(pkg, tmp_path):
    """Replica 1 died (SIGKILL) with one request completed and two in
    flight in its journal: one supervision pass, then the relaunch."""
    base = tmp_path / pkg / "journal.jsonl"
    base.parent.mkdir()
    journal = RequestJournal(base.with_name("journal_r1.jsonl"))
    for r in (3, 4, 5):
        journal.record_submit(Request(req_id=r, prompt=[r, r + 1], max_new_tokens=3))
    journal.record_tokens(3, [7, 8])
    journal.record_finish(3, "completed", tokens=[9])
    journal.record_tokens(4, [1])
    handles = [SupHandle(pkg, 0), SupHandle(pkg, 1, rc=-9)]
    router = PKG[pkg]["router"].FleetRouter(handles=handles)
    spawned = []

    def spawn(rid):
        spawned.append(rid)
        return SupHandle(pkg, rid)

    sup = PKG[pkg]["rp"].FleetSupervisor(router, spawn, base, restart_budget=1,
                                         restart_backoff_s=0.5)
    sup.tick(now=100.0)
    first = (dict(sup.recovered), handles[0].submits, sup.redispatched,
             sup.pending_recovery(), handles[1].alive, spawned[:])
    sup.tick(now=100.6)  # the relaunch is due
    second = (sup.restarts, handles[1].alive, handles[1].restarts, spawned[:],
              sup.pending_recovery(), base.with_name("journal_r1.jsonl").exists())
    handles[1].proc.rc = -9  # dies again: the budget of 1 is spent
    sup.tick(now=101.0)
    return first, second, sup.gave_up, router.stats()["live_replicas"]


def test_failover_equals_jax(tmp_path):
    got = {pkg: failover_run(pkg, tmp_path) for pkg in PKG}
    assert got["port"] == got["jax"]
    (recovered, submits, redispatched, pending, alive, spawned), second, gave_up, live = \
        got["port"]
    assert recovered == {3: [7, 8, 9]} and redispatched == 2 and alive is False
    # the incomplete requests went to the survivor under their own ids, forced
    assert submits == [(4, [4, 5], True), (5, [5, 6], True)]
    assert pending and spawned == []
    assert second == (1, True, 1, [1], False, False)
    assert gave_up == [1] and live == 1


def test_proc_handle_banks_a_dead_incarnations_counts():
    h = port_rp.ProcReplicaHandle(0, FakeProc(), port_rp.ReplicaProcClient("127.0.0.1:1"), 4)
    h.last_stats = {"tick": 7, "kernel_launches": {"rms_norm": 5},
                    "plain_launches": {"paged_attention": 2}}
    fresh = port_rp.ProcReplicaHandle(0, FakeProc(), port_rp.ReplicaProcClient("127.0.0.1:2"), 4)
    h.rebind(fresh)
    h.last_stats = {"tick": 3, "kernel_launches": {"rms_norm": 1}}
    h.rebind(fresh)
    assert h.ticks_banked == 10 and h.restarts == 2
    assert h.launches_banked["kernel"] == {"rms_norm": 6}
    assert h.launches_banked["plain"] == {"paged_attention": 2}


def test_proc_handle_counts_an_admission_into_its_cached_load():
    """Between two heartbeats the cached queue depth counts the requests
    admitted since (a duplicate answer adds nothing), so a burst spreads
    over the replicas by load."""

    class Client:
        replies = [{"ok": True, "admitted": True, "req": 0},
                   {"ok": True, "admitted": True, "req": 0, "dup": True}]
        retries = 0

        def request(self, req, attempts=3):
            return self.replies.pop(0)

    h = port_rp.ProcReplicaHandle(0, FakeProc(), Client(), 4)
    h.last_stats = {"queue_depth": 2, "waiting": 1}
    assert h.load() == (2, 0.0)
    h.submit([1, 2], 2, req_id=0)
    assert h.load() == (3, 0.0) and h.has_work
    h.submit([1, 2], 2, req_id=0)
    assert h.queue_sizes() == (0, 2) and h.load() == (3, 0.0)
