"""The port's runner and supervisor against the JAX package's, on the CPU.

- ``RunnerConfig``: the JAX defaults (the worker script aside), the keys
  of docker, elastic resizing, capacity and Determined refused by name,
  also through ``TransformerConfig.from_dict``; unknown keys and bad
  values raise as in JAX.
- ``get_resource_pool`` over the same hostsfiles, ``plan_workers``,
  ``worker_env`` and ``encode_payload`` equal to JAX's; the worker's
  command line and ``LaunchConfig`` reading the payload back.
- ``classify_workers`` and ``restart_backoff`` through both packages over
  the cases of ``tests/core/test_runner/test_supervisor.py`` and more.
- Real worker processes (``tests/test_torch_runner_worker.py``): the
  babysitting runner, teardown's SIGTERM -> SIGKILL escalation, the
  relay of a SIGTERM, a stall drain counted as a failure and the give-up
  after the restart budget, the last two with the events of the JAX
  supervisor; other hosts and several processes refused by name.
"""

import base64
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

import scaling_tpu.resilience.controlplane as jax_cp
import scaling_tpu.runner.runner as jax_runner
import scaling_tpu.runner.supervise as jax_supervise
from scaling_tpu.runner import RunnerConfig as JaxRunnerConfig
from scaling_tpu_torch.models.transformer import TransformerConfig
from scaling_tpu_torch.resilience import FaultPlan, FileControlPlane, InjectedFault, set_fault_plan
from scaling_tpu_torch.resilience.controlplane import HostHeartbeat
from scaling_tpu_torch.runner import (
    LaunchConfig,
    RunnerConfig,
    RunnerType,
    get_resource_pool,
    initialize_distributed,
    runner_main,
    supervise_main,
)
from scaling_tpu_torch.runner import runner as port_runner
from scaling_tpu_torch.runner import supervise as port_supervise
from scaling_tpu_torch.serve.bench import MODELS

REPO = Path(__file__).resolve().parent.parent
WORKER = "tests.test_torch_runner_worker"


@pytest.fixture(autouse=True)
def _in_repo(monkeypatch):
    """Workers run ``python -m tests...`` from the checkout's root; a
    supervisor's SIGTERM handler does not outlive its test."""
    monkeypatch.chdir(REPO)
    handler = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, handler)


# ---------------------------------------------------------------- config
def test_runner_config_defaults_equal_jax():
    port = {**dataclasses.asdict(RunnerConfig()), "runner_type": RunnerType.PDSH.value}
    jax = JaxRunnerConfig().model_dump(mode="json")
    assert port.pop("script") == "scaling_tpu_torch.models.transformer.train"
    assert jax.pop("script") == "scaling_tpu.models.transformer.train"
    assert port == jax


REFUSED = [
    ("runner_type", "pdsh_docker"), ("docker_config", {"docker_container": "img:1"}),
    ("downsize_after", 2), ("downsize_model", "0.5b"), ("upsize_after", 2), ("arbitrate", True),
    ("min_hosts", 2), ("capacity_stale_seconds", 5.0), ("capacity_poll_seconds", 1.0),
    ("min_train_hosts", 2), ("capacity_pressure_high", 0.9), ("capacity_sustain_seconds", 1.0),
    ("capacity_idle_seconds", 1.0), ("capacity_cooldown_seconds", 1.0),
    ("lease_timeout_seconds", 5.0), ("min_replicas", 0), ("use_determined", True),
]


def training_config(runner: dict) -> dict:
    return {"topology": {"micro_batch_size": 2, "gradient_accumulation_steps": 1},
            "transformer_architecture": dict(MODELS["toy"], sequence_length=64),
            "runner": runner}


@pytest.mark.parametrize("key,value", REFUSED, ids=[k for k, _ in REFUSED])
def test_runner_keys_not_ported_raise_by_name(key, value):
    JaxRunnerConfig.from_dict({key: value})  # a value the JAX package takes
    with pytest.raises(NotImplementedError, match=key if key != "runner_type" else "pdsh_docker"):
        RunnerConfig.from_dict({key: value})
    with pytest.raises(NotImplementedError, match=key if key != "runner_type" else "pdsh_docker"):
        TransformerConfig.from_dict(training_config({"supervise": True, key: value}))


def test_a_runner_section_is_read_and_bad_values_raise_as_in_jax():
    section = {"hosts": ["localhost"], "supervise": True, "control_dir": "/tmp/cp",
               "heartbeat_timeout_seconds": 90, "startup_grace_seconds": 120,
               "restart_budget": 2, "default_gpu_count": 1}
    config = TransformerConfig.from_dict(training_config(section))
    assert config.runner == RunnerConfig.from_dict(section)
    assert config.runner.heartbeat_timeout_seconds == 90 and config.to_dict()["runner"] == section
    assert TransformerConfig.from_dict(training_config(None)).runner is None
    for bad in ({"heartbeat_timeout_seconds": 0}, {"restart_budget": -1},
                {"worker_grace_seconds": 0}, {"hostz": ["a"]}):
        with pytest.raises(ValueError):
            JaxRunnerConfig.from_dict(bad)
        with pytest.raises(ValueError):
            RunnerConfig.from_dict(bad)


# --------------------------------------------------------- pool and plan
HOSTSFILES = {
    "slots": "# comment\nworker-0 slots=4\nworker-1 slots=2\n\n",
    "hygiene": "\n# leading\nworker-0 slots=4  # trailing\n   \n   # indented\nworker-1\n\n",
    "local": "localhost slots=2\n",
    "duplicate": "worker-0 slots=4\nworker-1 slots=2\nworker-0 slots=8\n",
}


def pool_or_error(fn, config):
    try:
        return fn(config)
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("name", list(HOSTSFILES))
def test_resource_pool_of_a_hostsfile_equals_jax(tmp_path, name):
    hostsfile = tmp_path / "hostsfile"
    hostsfile.write_text(HOSTSFILES[name])
    cfg = {"hostsfile": str(hostsfile), "default_gpu_count": 8}
    port = pool_or_error(get_resource_pool, RunnerConfig.from_dict(cfg))
    jax = pool_or_error(jax_runner.get_resource_pool, JaxRunnerConfig.from_dict(cfg))
    assert port == jax
    if name == "duplicate":
        assert port.startswith("ValueError: duplicate hostname 'worker-0' at line 3")


@pytest.mark.parametrize("hosts", [None, ["localhost"], ["h1", "h2"], ["h1", "h2", "h1"]])
def test_resource_pool_of_a_hosts_list_equals_jax(hosts):
    cfg = {"hosts": hosts, "default_gpu_count": 2}
    assert pool_or_error(get_resource_pool, RunnerConfig.from_dict(cfg)) == pool_or_error(
        jax_runner.get_resource_pool, JaxRunnerConfig.from_dict(cfg))


@pytest.mark.parametrize("pool", [{"localhost": 1}, {"localhost": 3},
                                  {"localhost": 2, "127.0.0.1": 1}, {"a": 4, "b": 2}])
def test_plan_workers_and_worker_env_equal_jax(pool):
    workers = port_runner.plan_workers(pool)
    assert workers == jax_runner.plan_workers(pool)
    assert port_runner.is_local_pool(pool) == jax_runner.is_local_pool(pool)
    for i in range(len(workers)):
        assert port_runner.worker_env(pool, workers, i, "127.0.0.1", 29511) == \
            jax_runner.worker_env(pool, workers, i, "127.0.0.1", 29511)


def test_payload_encodes_as_in_jax_and_reads_back():
    payload = {"workdir": "/data/runs/my run (v2)/ünïcodé—路径", "steps": 8,
               "note": 'quotes \' " and $VARS and `ticks`', "nested": {"hosts": ["a b", "c\td"]}}
    encoded = port_runner.encode_payload(payload)
    assert encoded == jax_runner.encode_payload(payload)
    cmd = port_runner.build_worker_command(RunnerConfig(), encoded)
    assert cmd == [sys.executable, "-u", "-m", "scaling_tpu_torch.models.transformer.train",
                   f"--payload={encoded}"]
    assert LaunchConfig.from_launcher_args(cmd[4:]).payload == payload
    assert json.loads(base64.urlsafe_b64decode(encoded)) == payload


# ------------------------------------------------------- detection policy
CLASSIFY = [  # exit codes, heartbeats {host: (step, status, age)}, timeout, grace, elapsed
    ([None, -9, 0, 1], {0: (5, "running", 0.1)}, 30, 300, 50),
    ([None, None], {0: (5, "running", 0.5), 1: (5, "running", 99.0)}, 30, 100, 200),
    ([None], {0: (0, "barrier:step-0", 120.0)}, 30, 300, 150),
    ([None], {0: (0, "barrier:step-0", 120.0)}, 30, 300, 400),
    ([None, None], {1: (0, "starting", 50.0)}, 5, 120, 60),
    ([None, None], {1: (0, "starting", 200.0)}, 5, 120, 200),
    ([None, None], {0: (8, "done", 500.0), 1: (3, "preempted", 500.0)}, 5, 60, 600),
    ([None], {0: (6, "barrier:commit:step-6", 1.0)}, 10, 60, 100),
    ([None, None, None], {0: (4, "running", 61.0), 2: (4, "running", 59.0)}, 60, 90, 91),
    ([0, 0], {}, 1, 1, 10),
    ([None, -15], {0: (2, "running", 500.0)}, 60, 90, 1000),
]


@pytest.mark.parametrize("rcs,hbs,timeout,grace,elapsed", CLASSIFY)
def test_classify_workers_as_the_jax_supervisor(rcs, hbs, timeout, grace, elapsed):
    now = 1_700_000_000.0
    verdicts = [
        sup.classify_workers(rcs, {h: cls(h, step, status, now - age)
                                   for h, (step, status, age) in hbs.items()},
                             heartbeat_timeout_s=timeout, startup_grace_s=grace,
                             epoch_elapsed_s=elapsed, now=now)
        for sup, cls in ((port_supervise, HostHeartbeat), (jax_supervise, jax_cp.HostHeartbeat))]
    assert verdicts[0] == verdicts[1]


@pytest.mark.parametrize("attempt,base,cap", [(0, 1.0, 60.0), (1, 1.0, 60.0), (2, 1.0, 60.0),
                                              (3, 0.5, 60.0), (7, 1.0, 60.0), (12, 2.0, 1e9),
                                              (4, 0.0, 60.0)])
def test_restart_backoff_as_in_jax(attempt, base, cap):
    assert port_supervise.restart_backoff(attempt, base, cap) == \
        jax_supervise.restart_backoff(attempt, base, cap)


# -------------------------------------------------------- refused launches
def test_other_hosts_and_several_processes_are_refused_by_name(tmp_path, monkeypatch):
    remote = RunnerConfig.from_dict({"hosts": ["tpu-a", "localhost"]})
    with pytest.raises(NotImplementedError, match=r"\['tpu-a'\].*ssh launch"):
        runner_main(remote, payload={})
    with pytest.raises(NotImplementedError, match="ssh launch"):
        supervise_main(RunnerConfig.from_dict({"hosts": ["tpu-a"], "supervise": True,
                                               "control_dir": str(tmp_path)}), payload={})
    with pytest.raises(NotImplementedError, match="ssh launch"):
        port_runner.spawn_worker(RunnerConfig(), "tpu-b", {}, "cGF5bG9hZA==")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    assert initialize_distributed() == "none"
    # several processes join one process group (test_torch_distributed_trainer.py);
    # without the launcher's environment the worker refuses by name
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="2 worker processes needs the launcher's environment"):
        initialize_distributed()


def test_supervise_requires_control_dir():
    with pytest.raises(ValueError, match="control_dir"):
        supervise_main(RunnerConfig.from_dict({"hosts": ["localhost"], "supervise": True}), {})


def test_spawn_worker_fault_point_fires():
    set_fault_plan(FaultPlan("runner.worker.spawn=fail@1"))
    try:
        with pytest.raises(InjectedFault):
            port_runner.spawn_worker(RunnerConfig(), "localhost", {}, "cGF5bG9hZA==")
    finally:
        set_fault_plan(FaultPlan(""))


# ------------------------------------------------------ the babysit loop
def test_runner_spawns_one_worker_a_slot_with_the_launch_contract(tmp_path):
    config = RunnerConfig.from_dict({"hosts": ["localhost"], "default_gpu_count": 2,
                                     "master_port": 29611, "script": WORKER})
    payload = {"case": "record", "dir": str(tmp_path)}
    assert runner_main(config, payload) == 0
    pool = get_resource_pool(config)
    workers = port_runner.plan_workers(pool)
    for rank in range(2):
        rec = json.loads((tmp_path / f"rank_{rank}.json").read_text())
        assert rec["payload"] == payload and rec["argv0"].endswith("test_torch_runner_worker.py")
        expected = port_runner.worker_env(pool, workers, rank, "localhost", 29611)
        assert {k: v for k, v in rec["env"].items() if k in expected} == expected


def test_runner_takes_the_others_down_when_a_worker_fails():
    """Rank 0 exits 3, the sleepers are terminated; both runners return the
    last non-zero code they saw (a terminated sleeper's -15)."""
    cfg = {"hosts": ["localhost"], "default_gpu_count": 3, "script": WORKER}
    start = time.monotonic()
    rcs = [runner_main(RunnerConfig.from_dict(cfg), {"case": "fail_rank0"}),
           jax_runner.runner_main(JaxRunnerConfig.from_dict(cfg), {"case": "fail_rank0"})]
    assert rcs[0] == rcs[1] != 0
    assert time.monotonic() - start < 30


# ------------------------------------------------------------- teardown
def test_teardown_escalates_sigterm_to_sigkill(tmp_path):
    """A worker that ignores SIGTERM (a thread stuck in a CUDA call runs no
    handler) is SIGKILLed after the grace, one that does not dies on
    SIGTERM; both are reaped, after the abort flag, and the
    ``teardown-complete`` event names the killed pid."""
    cp = FileControlPlane(tmp_path, 0, 2)
    config = RunnerConfig.from_dict({"hosts": ["localhost"], "supervise": True,
                                     "control_dir": str(tmp_path), "worker_grace_seconds": 1.0})
    stubborn = subprocess.Popen([sys.executable, "-c",
                                 "import signal, time\n"
                                 "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
                                 "print('armed', flush=True)\n"
                                 "time.sleep(600)\n"], stdout=subprocess.PIPE, text=True)
    meek = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
    assert stubborn.stdout.readline().strip() == "armed"
    events = tmp_path / "events.jsonl"
    os.environ["SCALING_TPU_EVENTS_PATH"] = str(events)
    try:
        start = time.monotonic()
        port_supervise._teardown(cp, [stubborn, meek], config)
    finally:
        del os.environ["SCALING_TPU_EVENTS_PATH"]
    assert stubborn.returncode == -9 and meek.returncode == -15
    assert cp.get_flag("abort") == "host-dead" and time.monotonic() - start < 30
    done = [json.loads(line) for line in events.read_text().splitlines()
            if '"teardown-complete"' in line]
    assert [(e["killed_pids"], e["remote_hosts"]) for e in done] == [([stubborn.pid], [])]


def test_relay_sigterm_signals_live_workers_not_a_flag():
    class FakeProc:
        def __init__(self, rc=None):
            self.rc, self.terminated = rc, False

        def poll(self):
            return self.rc

        def terminate(self):
            self.terminated = True

    live, done = FakeProc(), FakeProc(rc=0)
    port_supervise._relay_sigterm([live, done])
    assert live.terminated and not done.terminated


# ------------------------------------------- the epoch loop against JAX's
def lifecycle(events: Path) -> list:
    """The supervisor's events with the fields that differ run to run
    (time, pids) left out."""
    out = []
    for line in events.read_text().splitlines():
        e = json.loads(line)
        if e["event"] != "span":
            out.append({k: v for k, v in e.items() if k not in ("ts", "pids", "trace")})
    return out


def test_a_stall_drain_is_not_success_as_in_jax(tmp_path, monkeypatch):
    """Workers that all exit 0 end the run, unless the stall flag is up:
    then the epoch failed and both supervisors say so in one event."""
    class DoneProc:
        pid = 4242

        def poll(self):
            return 0

    seen = {}
    for name, sup, cfg_cls, plane in (("port", port_supervise, RunnerConfig, FileControlPlane),
                                      ("jax", jax_supervise, JaxRunnerConfig,
                                       jax_cp.FileControlPlane)):
        root = tmp_path / name
        monkeypatch.setenv("SCALING_TPU_EVENTS_PATH", str(root / "events.jsonl"))

        def stalled(config, host, env, encoded, root=root, plane=plane):
            plane(root / "cp" / "epoch-0", 0, 1).set_flag("stall", "7")
            return DoneProc()

        monkeypatch.setattr(sup, "spawn_worker", stalled)
        config = cfg_cls.from_dict({"hosts": ["localhost"], "supervise": True,
                                    "control_dir": str(root / "cp"),
                                    "supervisor_poll_seconds": 0.01})
        args = (config, {"localhost": 1}, [("localhost", 0)], "payload", "localhost", root / "cp")
        root.mkdir()
        assert sup._run_epoch(*args, 0, {"preempted": False}) == 1
        monkeypatch.setattr(sup, "spawn_worker", lambda *a, **k: DoneProc())
        assert sup._run_epoch(*args, 1, {"preempted": False}) == 0
        seen[name] = lifecycle(root / "events.jsonl")
    assert seen["port"] == seen["jax"]
    assert [e["event"] for e in seen["port"]] == ["epoch-start", "epoch-stalled", "epoch-start",
                                                  "epoch-clean-exit"]


def test_give_up_after_the_restart_budget_as_in_jax(tmp_path, monkeypatch):
    """A worker that always exits 3: both supervisors relaunch it
    ``restart_budget`` times, then give up with exit code 1, logging the
    same events in the same order."""
    seen = {}
    for name, main, cfg_cls in (("port", supervise_main, RunnerConfig),
                                ("jax", jax_supervise.supervise_main, JaxRunnerConfig)):
        events = tmp_path / f"{name}_events.jsonl"
        monkeypatch.setenv("SCALING_TPU_EVENTS_PATH", str(events))
        config = cfg_cls.from_dict({
            "hosts": ["localhost"], "default_gpu_count": 1, "script": WORKER, "supervise": True,
            "control_dir": str(tmp_path / name), "restart_budget": 2,
            "restart_backoff_seconds": 0.05, "supervisor_poll_seconds": 0.05,
            "worker_grace_seconds": 1.0})
        assert main(config, {"case": "fail"}) == 1
        seen[name] = lifecycle(events)
    assert seen["port"] == seen["jax"]
    assert [e["event"] for e in seen["port"]] == (
        ["epoch-start", "host-dead", "teardown-complete", "relaunch"] * 2
        + ["epoch-start", "host-dead", "teardown-complete", "give-up"])
    assert seen["port"][-1] == {"event": "give-up", "epoch": 2, "restarts": 2, "budget": 2}
