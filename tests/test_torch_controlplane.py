"""The port's supervision control plane against the JAX package's.

- The cases of ``tests/core/test_resilience/test_controlplane.py`` on the
  port, for the file and the TCP backend: heartbeats, flags, barriers
  (completion, arrival without a wait, pruning, timeout, abort, the
  heartbeat refresh while waiting), clock skew, the environment factory,
  the straggler table and the ``cp.set_flag`` span.
- Interop: a port ``FileControlPlane`` and a JAX one on one directory see
  each other's heartbeats, flags and barrier arrivals; a port client
  works against a JAX ``TcpControlPlaneServer`` and a JAX client against
  the port's, capacity records included.
- ``straggler_table(...).render()`` equal in both packages.

Host-side only: no model, no JAX computation.
"""

import os
import threading
import time

import pytest

import scaling_tpu.resilience.controlplane as jax_cp
import scaling_tpu_torch.resilience.controlplane as port_cp
from scaling_tpu_torch.resilience import (
    BarrierTimeout,
    FileControlPlane,
    JobAborted,
    TcpControlPlane,
    TcpControlPlaneServer,
    controlplane_from_env,
    straggler_table,
)
from scaling_tpu_torch.resilience.controlplane import (
    ABORT_FLAG,
    ENV_CONTROL_ADDR,
    ENV_CONTROL_DIR,
    ENV_HOST_ID,
    ENV_NUM_HOSTS,
    HostHeartbeat,
)

PACKAGES = {"port": port_cp, "jax": jax_cp}


@pytest.fixture(params=["file", "tcp"])
def plane_pair(request, tmp_path):
    """Two hosts on one control plane of the port, either backend."""
    if request.param == "file":
        yield FileControlPlane(tmp_path, 0, 2), FileControlPlane(tmp_path, 1, 2)
    else:
        srv = TcpControlPlaneServer()
        yield TcpControlPlane(srv.address, 0, 2), TcpControlPlane(srv.address, 1, 2)
        srv.close()


def test_heartbeats_roundtrip(plane_pair):
    a, b = plane_pair
    a.heartbeat(3)
    b.heartbeat(7, status="starting")
    for reader in (a, b):
        hb = reader.peer_heartbeats()
        assert (hb[0].step, hb[0].status) == (3, "running")
        assert (hb[1].step, hb[1].status) == (7, "starting")
        assert hb[0].age() < 5.0


def test_heartbeat_newest_wins(plane_pair):
    a, b = plane_pair
    for step, status in ((1, "running"), (2, "running"), (5, "done")):
        a.heartbeat(step, status=status)
    hb = b.peer_heartbeats()[0]
    assert (hb.step, hb.status) == (5, "done")


def test_flags_broadcast(plane_pair):
    a, b = plane_pair
    assert a.get_flag("preempt") is None
    b.set_flag("preempt", "3")
    assert a.get_flag("preempt") == "3" and b.get_flag("preempt") == "3"


def test_barrier_completes_when_all_arrive(plane_pair):
    a, b = plane_pair
    done = []
    t = threading.Thread(target=lambda: (b.barrier("step-1", timeout_s=10), done.append("b")))
    t.start()
    a.barrier("step-1", timeout_s=10)
    t.join(timeout=10)
    assert done == ["b"]
    # arrivals stay within an epoch: a completed barrier returns at once
    a.barrier("step-1", timeout_s=0.5)


def test_arrive_registers_without_waiting(plane_pair):
    a, b = plane_pair
    released = []
    t = threading.Thread(target=lambda: (a.barrier("step-5", timeout_s=10), released.append(1)))
    t.start()
    time.sleep(0.2)
    start = time.monotonic()
    b.arrive("step-5")
    assert time.monotonic() - start < 2.0
    t.join(timeout=10)
    assert released == [1]


def test_prune_barrier_drops_arrival_state(plane_pair):
    a, b = plane_pair
    a.arrive("step-0")
    b.arrive("step-0")
    a.barrier("step-0", timeout_s=2)
    a.prune_barrier("step-0")
    with pytest.raises(BarrierTimeout):
        a.barrier("step-0", timeout_s=0.3)


def test_heartbeat_age_ignores_publisher_clock_skew(plane_pair):
    a, b = plane_pair
    a._publish_heartbeat(HostHeartbeat(0, 3, "running", time.time() - 9999.0))
    assert b.peer_heartbeats()[0].age() < 30.0


def test_barrier_times_out_when_peer_missing(plane_pair):
    a, _ = plane_pair
    start = time.monotonic()
    with pytest.raises(BarrierTimeout, match="1/2 hosts arrived"):
        a.barrier("lonely", timeout_s=0.3)
    assert time.monotonic() - start < 5.0


def test_barrier_aborts_fast_on_abort_flag(plane_pair):
    a, b = plane_pair
    errs = []

    def waiter():
        try:
            a.barrier("never", timeout_s=60)
        except JobAborted as e:
            errs.append(e)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.2)
    b.set_flag(ABORT_FLAG, "host-dead")
    t.join(timeout=5)
    assert not t.is_alive() and len(errs) == 1


def test_barrier_wait_refreshes_heartbeat(plane_pair):
    a, b = plane_pair
    a.heartbeat(4)
    first = b.peer_heartbeats()[0]
    with pytest.raises(BarrierTimeout):
        a.barrier("parked", timeout_s=1.6)
    hb = b.peer_heartbeats()[0]
    assert hb.wall > first.wall and hb.status == "barrier:parked" and hb.step == 4


def test_controlplane_from_env(tmp_path, monkeypatch):
    monkeypatch.delenv(ENV_CONTROL_DIR, raising=False)
    monkeypatch.delenv(ENV_CONTROL_ADDR, raising=False)
    assert controlplane_from_env() is None
    monkeypatch.setenv(ENV_CONTROL_DIR, str(tmp_path))
    monkeypatch.setenv(ENV_HOST_ID, "1")
    monkeypatch.setenv(ENV_NUM_HOSTS, "3")
    cp = controlplane_from_env()
    assert isinstance(cp, FileControlPlane) and (cp.host_id, cp.num_hosts) == (1, 3)
    cp.heartbeat(2)
    assert FileControlPlane(tmp_path, 0, 3).peer_heartbeats()[1].step == 2


def test_tcp_from_env(monkeypatch):
    srv = TcpControlPlaneServer()
    try:
        monkeypatch.delenv(ENV_CONTROL_DIR, raising=False)
        monkeypatch.setenv(ENV_CONTROL_ADDR, srv.address)
        monkeypatch.setenv(ENV_HOST_ID, "0")
        monkeypatch.setenv(ENV_NUM_HOSTS, "2")
        cp = controlplane_from_env()
        assert isinstance(cp, TcpControlPlane)
        cp.set_flag("x", "y")
        assert cp.get_flag("x") == "y"
    finally:
        srv.close()


def test_straggler_table_classification():
    now = time.time()
    hbs = {0: HostHeartbeat(0, 10, "running", now - 1.0),
           1: HostHeartbeat(1, 9, "running", now - 120.0)}
    report = straggler_table(hbs, num_hosts=3, stale_after_s=30.0, now=now)
    assert report.dead_hosts == [1, 2]
    assert {h: s for h, _, _, s in report.rows} == {0: "running", 1: "dead",
                                                    2: "never-heartbeat"}
    assert report.render().splitlines()[0].split() == ["host", "step", "hb_age_s", "state"]


def test_set_flag_emits_span():
    from scaling_tpu_torch.obs.registry import get_registry

    key = "span_seconds{span=cp.set_flag}"
    srv = TcpControlPlaneServer()
    try:
        cp = TcpControlPlane(srv.address, 0, 1)
        before = get_registry().snapshot()["histograms"].get(key, {}).get("count", 0)
        cp.set_flag("drain")
        assert get_registry().snapshot()["histograms"][key]["count"] == before + 1
        assert cp.get_flag("drain") == "1"
    finally:
        srv.close()


# --------------------------------------------------------------- interop
@pytest.mark.parametrize("first", ["port", "jax"])
def test_file_planes_of_both_packages_share_one_directory(tmp_path, first):
    """Host 0 of one package and host 1 of the other on one directory:
    each reads the other's heartbeats and flags, and they meet at a
    barrier, either one arriving first."""
    second = "jax" if first == "port" else "port"
    a = PACKAGES[first].FileControlPlane(tmp_path, 0, 2)
    b = PACKAGES[second].FileControlPlane(tmp_path, 1, 2)
    a.heartbeat(3)
    b.heartbeat(5, status="starting")
    for reader in (a, b):
        hb = reader.peer_heartbeats()
        assert (hb[0].step, hb[0].status, hb[1].step, hb[1].status) == (
            3, "running", 5, "starting")
    b.set_flag("preempt", "5")
    assert a.get_flag("preempt") == "5"
    done = []
    t = threading.Thread(target=lambda: (b.barrier("commit:step-6", timeout_s=10),
                                         done.append(1)))
    t.start()
    time.sleep(0.2)
    a.barrier("commit:step-6", timeout_s=10)
    t.join(timeout=10)
    assert done == [1]
    assert sorted(os.listdir(tmp_path / "barrier" / "commit_step-6")) == ["host0", "host1"]
    a.prune_barrier("commit:step-6")
    assert not (tmp_path / "barrier" / "commit_step-6").exists()


@pytest.mark.parametrize("server,client", [("jax", "port"), ("port", "jax")])
def test_tcp_client_and_server_of_the_two_packages_speak_one_protocol(server, client):
    """A port client against the JAX server and a JAX client against the
    port's: heartbeats stamped on receipt, flags, barriers, pruning and
    the capacity records."""
    srv = PACKAGES[server].TcpControlPlaneServer()
    try:
        a = PACKAGES[client].TcpControlPlane(srv.address, 0, 2)
        b = PACKAGES[server].TcpControlPlane(srv.address, 1, 2)
        a._publish_heartbeat(PACKAGES[client].HostHeartbeat(0, 3, "running",
                                                             time.time() - 9999.0))
        b.heartbeat(7, status="starting")
        for reader in (a, b):
            hb = reader.peer_heartbeats()
            assert (hb[0].step, hb[1].status) == (3, "starting") and hb[0].age() < 30.0
        a.set_flag("stall", "7")
        assert b.get_flag("stall") == "7" and a.get_flag("abort") is None
        a.arrive("step-2")
        b.barrier("step-2", timeout_s=5)
        a.prune_barrier("step-2")
        with pytest.raises(PACKAGES[client].BarrierTimeout):
            a.barrier("step-2", timeout_s=0.3)
        a.capacity_set("announce", "standby-1", {"host": "standby-1", "slots": 4})
        listed = b.capacity_list("announce")
        assert [r["slots"] for r in listed["records"]] == [4] and listed["now"] > 0
        b.capacity_del("announce", "standby-1")
        assert a.capacity_list("announce")["records"] == []
    finally:
        srv.close()


def test_straggler_table_renders_as_in_jax():
    now = 1_700_000_000.0
    rows = [(0, 12, "running", 0.4), (1, 11, "barrier:step-12", 3.25), (3, 9, "done", 400.0),
            (4, 10, "preempted", 75.5)]
    port, jax = (mod.straggler_table({h: mod.HostHeartbeat(h, step, status, now - age)
                                      for h, step, status, age in rows}, 6, 60.0, now=now)
                 for mod in (port_cp, jax_cp))
    assert port.render() == jax.render() and port.rows == jax.rows
    assert port.dead_hosts == jax.dead_hosts == [2, 3, 4, 5]
