"""The port's fleet router against the JAX package's: the same scripted
calls over fake replica handles (submits, Backpressure answers, replicas
unreachable before and after the request left, failure, restore,
autoscale registration, drain, in-doubt parks and their resolution) give
the same dispatch choices, ``ReplicaStats``, parks and ``stats()``; the
prefix-chain hashes are the same integers, also in a process with another
``PYTHONHASHSEED``; ``AutoscalePolicy.decide`` gives the same decisions
on literal-timestamp scripts."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

pytest.importorskip("jax")

import scaling_tpu.serve.router as jax_router  # noqa: E402
import scaling_tpu.serve.scheduler as jax_scheduler  # noqa: E402
import scaling_tpu_torch.serve.router as port_router  # noqa: E402
import scaling_tpu_torch.serve.scheduler as port_scheduler  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PACKAGES = {"jax": (jax_router, jax_scheduler), "port": (port_router, port_scheduler)}


class FakeHandle:
    """The router's handle surface with a settable load and scripted
    ``submit`` answers: 'admit', 'bp' (shed), 'drain' (draining), 'lost'
    (unreachable after the send) or 'refused' (unreachable before it)."""

    def __init__(self, pkg, rid, block_size=4):
        self.router_mod, self.sched_mod = PACKAGES[pkg]
        self.replica_id = rid
        self.alive = True
        self.block_size = block_size
        self.stats = self.router_mod.ReplicaStats()
        self.depth = 0
        self.pressure = 0.0
        self.script = []
        self.submits = []
        self.drained = False

    def load(self):
        return self.depth, self.pressure

    def submit(self, prompt, max_new_tokens, **kw):
        self.submits.append((kw.get("req_id"), tuple(prompt), kw.get("force", False)))
        action = self.script.pop(0) if self.script else "admit"
        if action == "admit":
            self.depth += 1
            return ("seq", self.replica_id, kw.get("req_id"))
        if action in ("bp", "drain"):
            return self.sched_mod.Backpressure(reason="pool-pressure" if action == "bp"
                                               else "draining", pool_pressure=self.pressure,
                                               waiting=self.depth, draining=action == "drain")
        err = self.router_mod.ReplicaUnreachable(action)
        err.maybe_admitted = action == "lost"
        raise err

    def begin_drain(self):
        self.drained = True

    @property
    def has_work(self):
        return self.depth > 0

    def next_req_id(self):
        return 0

    def queue_sizes(self):
        return 0, self.depth


def outcome(res, pkg):
    router_mod, sched_mod = PACKAGES[pkg]
    if isinstance(res, sched_mod.Backpressure):
        return ("bp", res.reason, res.draining)
    if isinstance(res, router_mod.InDoubtAdmit):
        return ("doubt", res.req_id, res.replica_id)
    return res


FAMILIES = [[7] * 8, [9] * 8, [11] * 8]


def prompt(i):
    return FAMILIES[i % len(FAMILIES)] + [100 + i, 200 + i, 300 + i]


def script_run(pkg):
    """One script of router calls; returns every observable result."""
    router_mod, _ = PACKAGES[pkg]
    handles = [FakeHandle(pkg, r) for r in range(3)]
    router = router_mod.FleetRouter(handles=handles)
    out = []

    def submit(i, fresh=False, **kw):
        p = [13] * 8 + [i] if fresh else prompt(i)  # fresh: a prompt no replica has seen
        out.append(("submit", i, outcome(router.submit(p, 4, **kw), pkg)))

    for i in range(6):  # least loaded, then the families' affinity
        submit(i)
    handles[0].pressure, handles[1].depth = 0.9, 0  # reorder the load
    submit(6)
    handles[1].script = ["bp"]  # a shed retried elsewhere
    submit(7)
    for h in handles:
        h.script = ["bp"]
    submit(8)  # every replica shed: rejected
    handles[2].script = ["refused"]  # unambiguous: retried elsewhere
    submit(9)
    handles[0].script = ["lost"]
    handles[0].depth = -1  # first in load order
    submit(10, temperature=0.5)  # parked in doubt on replica 0
    out.append(("has_work", router.has_work))
    handles[0].script = ["refused"]
    router.resolve_in_doubt()  # still unreachable: stays parked
    out.append(("pending", router.stats()["in_doubt_pending"]))
    handles[0].script = ["bp"]  # not admitted: forced through dispatch
    router.resolve_in_doubt()
    handles[1].script = ["lost"]
    handles[1].depth = -5
    submit(11, fresh=True)  # least loaded, no affinity: parked on replica 1
    router.fail_replica(1)
    out.append(("taken", [(r["req"], r["replica"], r["prompt"], r["temperature"])
                          for r in router.take_in_doubt(1)]))
    submit(12)  # replica 1 is out of dispatch
    router.restore_replica(1)
    router.add_replica(FakeHandle(pkg, 5))
    submit(13, req_id=40)  # a pinned id moves the counter past it
    submit(14)
    router.begin_drain()
    out.append(("drained", [h.drained for h in router.replicas]))
    out.append(("submits", [h.submits for h in router.replicas]))
    out.append(("replica_stats", [h.stats.to_dict() for h in router.replicas]))
    out.append(("stats", router.stats()))
    out.append(("affinity", [router.affinity_replica(prompt(i)) for i in range(3)]))
    return out


def test_scripted_dispatch_equals_jax():
    jax_out, port_out = script_run("jax"), script_run("port")
    assert port_out == jax_out
    stats = next(entry[1] for entry in port_out if entry[0] == "stats")
    # the script reached every branch it means to
    assert stats["rejected"] == 1 and stats["in_doubt_parks"] == 2
    assert stats["retries_elsewhere"] >= 2 and stats["affinity_dispatches"] > 0


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_router_refusals_equal(pkg):
    router_mod, _ = PACKAGES[pkg]
    with pytest.raises(ValueError, match="duplicate replica ids"):
        router_mod.FleetRouter(handles=[FakeHandle(pkg, 0), FakeHandle(pkg, 0)])
    with pytest.raises(ValueError, match="disagree on block_size"):
        router_mod.FleetRouter(handles=[FakeHandle(pkg, 0), FakeHandle(pkg, 1, block_size=8)])
    router = router_mod.FleetRouter(handles=[FakeHandle(pkg, 0)])
    with pytest.raises(ValueError, match="already registered"):
        router.add_replica(FakeHandle(pkg, 0))
    with pytest.raises(ValueError, match="block_size"):
        router.add_replica(FakeHandle(pkg, 1, block_size=8))
    with pytest.raises(ValueError, match="still live"):
        router.restore_replica(0)
    router.fail_replica(0)
    with pytest.raises(RuntimeError, match="no live replicas"):
        router.submit([1, 2, 3], 2)


def routers(block_size):
    return [PACKAGES[pkg][0].FleetRouter(handles=[FakeHandle(pkg, 0, block_size)])
            for pkg in ("jax", "port")]


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 2 ** 31 - 1), max_size=80), st.integers(1, 16))
def test_chain_hashes_equal_jax(tokens, block_size):
    theirs, ours = routers(block_size)
    assert ours._chain_hashes(tokens) == theirs._chain_hashes(tokens)
    assert len(ours._chain_hashes(tokens)) == max(0, (len(tokens) - 1) // block_size)


HASHES = r"""
import json, sys
from scaling_tpu_torch.serve.router import FleetRouter
class H:
    replica_id, alive, block_size = 0, True, 4
router = FleetRouter(handles=[H()])
print(json.dumps([router._chain_hashes(p) for p in json.loads(sys.argv[1])]))
"""


def test_chain_hashes_do_not_depend_on_the_hash_seed():
    prompts = [list(range(1, 30)), [5] * 17, [3, 1, 4, 1, 5, 9, 2, 6, 5]]
    _, ours = routers(4)
    here = [ours._chain_hashes(p) for p in prompts]
    for seed in ("0", "12345"):
        env = dict(os.environ, PYTHONHASHSEED=seed, PYTHONPATH=str(REPO))
        proc = subprocess.run([sys.executable, "-c", HASHES, json.dumps(prompts)], cwd=REPO,
                              env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert json.loads(proc.stdout) == here


def snapshot(depths, pressures=None, in_flight=None, dead=()):
    return [{"replica": r, "queue_depth": d,
             "pool_pressure": (pressures or [0.0] * len(depths))[r],
             "in_flight": (in_flight or depths)[r], "alive": r not in dead}
            for r, d in enumerate(depths)]


AUTOSCALE_SCRIPTS = {
    # sustained pressure spawns; a dip resets the clock
    "spawn": [(0.0, snapshot([9, 9])), (1.0, snapshot([9, 9])), (1.5, snapshot([0, 9])),
              (2.0, snapshot([9, 9])), (4.1, snapshot([9, 9])), (4.2, snapshot([9, 9]))],
    # one hot replica is imbalance, not capacity
    "imbalance": [(t, snapshot([9, 0])) for t in (0.0, 3.0, 6.0)],
    # idle drains the highest id, never below the floor, never with work
    "drain": [(0.0, snapshot([0, 0, 0])), (5.1, snapshot([0, 0, 0])),
              (6.0, snapshot([0, 0, 0], in_flight=[0, 1, 0])),
              (11.0, snapshot([0, 0, 0])), (16.2, snapshot([0, 0, 0])),
              (30.0, snapshot([0, 0, 0])), (40.0, snapshot([0, 0, 0]))],
    # pressure by the pool watermark, dead replicas invisible, the ceiling
    "pressure": [(0.0, snapshot([0, 0, 0], pressures=[0.85, 0.9, 0.1], dead=(2,))),
                 (2.5, snapshot([0, 0, 0], pressures=[0.85, 0.9, 0.1], dead=(2,))),
                 (9.0, snapshot([0, 0, 0, 0], pressures=[0.9] * 4)),
                 (12.0, snapshot([0, 0, 0, 0], pressures=[0.9] * 4))],
}


@pytest.mark.parametrize("name", sorted(AUTOSCALE_SCRIPTS))
@pytest.mark.parametrize("kw", [{}, {"min_replicas": 2, "max_replicas": 3, "sustain_s": 1.0,
                                     "idle_sustain_s": 2.0, "cooldown_s": 0.5,
                                     "spawn_budget": 1, "drain_budget": 1}],
                         ids=["defaults", "tight"])
def test_autoscale_decisions_equal_jax(name, kw):
    got = {}
    for pkg in ("jax", "port"):
        policy = PACKAGES[pkg][0].AutoscalePolicy(**kw)
        got[pkg] = ([policy.decide(t, rows) for t, rows in AUTOSCALE_SCRIPTS[name]],
                    policy.spawns, policy.drains)
    assert got["port"] == got["jax"]
    if name in ("spawn", "drain") and not kw:
        assert any(d is not None for d in got["port"][0])


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_autoscale_refuses_impossible_bounds(pkg):
    policy = PACKAGES[pkg][0].AutoscalePolicy
    with pytest.raises(ValueError, match="min_replicas"):
        policy(min_replicas=0)
    with pytest.raises(ValueError, match="max_replicas"):
        policy(min_replicas=3, max_replicas=2)


def test_fleet_drain_handler_drains_and_chains():
    import signal

    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        handles = [FakeHandle("port", r) for r in range(2)]
        port_router.install_fleet_drain_handler(port_router.FleetRouter(handles=handles))
        os.kill(os.getpid(), signal.SIGTERM)
        assert [h.drained for h in handles] == [True, True] and seen == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_router_imports_no_torch():
    """The router is host policy: its module imports no torch and names no
    CUDA call."""
    source = (REPO / "scaling_tpu_torch" / "serve" / "router.py").read_text()
    assert "import torch" not in source and "torch." not in source
