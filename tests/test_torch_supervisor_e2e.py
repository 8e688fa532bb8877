"""The supervised relaunch loop end to end on the CPU: ``runner_main``
with ``runner.supervise`` in a process of its own, under a hard time
limit, supervising a toy Trainer (2 layers, hidden 64) whose workers are
this file run as a script (``python -m tests.test_torch_supervisor_e2e
--payload=...``: the port's ``worker_main`` on the CPU, plus a record and
a pause after each step).

``SCALING_TPU_FAULTS="host.kill=kill@5@epoch=0,host.hang=hang@2@epoch=1"``: epoch 0
is SIGKILLed at the top of iteration 5 (after a save at 3), epoch 1
resumes at 3 and hangs at the top of iteration 5, its heartbeat goes
stale and teardown SIGKILLs it; epoch 2 resumes at 3 and the supervisor
gets a real SIGTERM after its step-5 record: the worker saves at its
boundary and the supervisor exits 0 with no relaunch. Every epoch's
losses are those of an unsupervised run of the same worker, bitwise; the
supervisor's events come in the JAX supervisor's order; ``obs report``
passes ``--assert-max-resizes 0``; the supervisor never initialises
CUDA.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SCRIPT = "tests.test_torch_supervisor_e2e"
PAUSE_S = 0.5  # after each step's record, so that a relayed SIGTERM lands before the next
ARCH = {"vocab_size": 96, "hidden_size": 64, "num_layers": 2, "num_attention_heads": 4,
        "attention_num_kv_heads": 2, "sequence_length": 32, "precision": "float32",
        "mlp_type": "swiglu", "mlp_factor": 2.0, "norm_type": "rms",
        "layernorm": {"optimization_type": "fused"}}


def worker() -> None:
    """A supervised worker: the stock worker entry on the CPU, with each
    step's (epoch, step, loss) appended to ``<save_dir>/../records.jsonl``."""
    from scaling_tpu_torch.logging.logger import append_jsonl_line
    from scaling_tpu_torch.models.transformer import train

    build = train.build_trainer

    def build_with_record(config, device=None, glue=None):
        trainer = build(config, device, glue=glue)
        records = Path(config.trainer.save_dir).parent / "records.jsonl"

        def record(metrics, step):
            append_jsonl_line(records, json.dumps({
                "epoch": int(os.environ.get("SCALING_TPU_COORD_EPOCH", -1)), "step": step,
                "loss": metrics["loss"]}))
            time.sleep(PAUSE_S)

        trainer.metrics_hooks.append(record)
        return trainer

    train.build_trainer = build_with_record
    train.worker_main(device="cpu")


if __name__ == "__main__":
    worker()
    sys.exit(0)


import numpy as np  # noqa: E402
import pytest  # noqa: E402

from scaling_tpu_torch.data import MemoryMapDatasetBuilder  # noqa: E402

# the supervisor: runner_main in a process whose CUDA initialisation raises
SUPERVISOR = r"""
import json, sys
import torch
def refuse():
    raise AssertionError("the supervisor initialised CUDA")
torch.cuda._lazy_init = refuse
from scaling_tpu_torch.runner import RunnerConfig, runner_main
spec = json.loads(open(sys.argv[1]).read())
rc = runner_main(RunnerConfig.from_dict(spec["runner"]), spec["payload"])
print(f"supervisor: rc={rc} cuda_initialized={torch.cuda.is_initialized()}")
sys.exit(rc)
"""
SUPERVISOR_EVENTS = ("epoch-start", "host-dead", "teardown-complete", "relaunch",
                     "preempt-relay", "epoch-clean-exit", "epoch-stalled", "give-up")


def payload(workdir: Path, prefix: str) -> dict:
    ckpt = str(workdir / "ckpt")
    return {
        "topology": {"micro_batch_size": 2, "gradient_accumulation_steps": 1},
        "transformer_architecture": ARCH,
        "optimizer": {"gradient_clipping": 1.0},
        "learning_rate_scheduler": {"learning_rate": 0.01, "learning_rate_warmup_steps": 2,
                                    "learning_rate_decay_iters": 50},
        "trainer": {"train_iterations": 6, "seed": 7, "save_dir": ckpt, "save_interval": 3,
                    "load_dir": ckpt, "assert_checkpoint_loaded": False,
                    "delete_past_optimizer_states": False},
        "data": {"data_prefixes": [prefix]},
        "logger": {"log_dir": str(workdir / "logs")},
    }


def runner_section(control_dir: Path, supervise: bool) -> dict:
    return {"hosts": ["localhost"], "default_gpu_count": 1, "script": SCRIPT,
            "supervise": supervise, "control_dir": str(control_dir),
            "heartbeat_timeout_seconds": 5.0, "startup_grace_seconds": 20.0,
            "restart_budget": 2, "restart_backoff_seconds": 0.2, "worker_grace_seconds": 1.0,
            "supervisor_poll_seconds": 0.05}


def records(workdir: Path) -> list:
    f = workdir / "records.jsonl"
    return [json.loads(line) for line in f.read_text().splitlines()] if f.is_file() else []


def start(tmp: Path, name: str, prefix: str, supervise: bool, faults: str = ""):
    workdir = tmp / name
    workdir.mkdir()
    spec = workdir / "spec.json"
    spec.write_text(json.dumps({"payload": payload(workdir, prefix),
                                "runner": runner_section(workdir / "control", supervise)}))
    env = {**os.environ, "SCALING_TPU_EVENTS_PATH": str(workdir / "events.jsonl"),
           "SCALING_TPU_FAULTS": faults, "OMP_NUM_THREADS": "1"}
    with open(workdir / "out.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", SUPERVISOR, str(spec)], cwd=REPO, env=env,
                                stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
    return proc, workdir


def finish(proc, workdir: Path, timeout: float) -> str:
    """The output of the supervisor and its workers once it exits; on the time
    limit, its whole process group is killed and the test fails."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        pytest.fail("the supervisor outlived its time limit:\n"
                    + (workdir / "out.log").read_text()[-4000:])
    return (workdir / "out.log").read_text()


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokens")
    rng = np.random.default_rng(11)
    with MemoryMapDatasetBuilder(root / "a", dtype=np.uint16) as builder:
        for _ in range(48):
            builder.add(np.append(rng.integers(1, 96, size=rng.integers(8, 80)), 0))
    return str(root / "a")


def test_crash_hang_and_drain_relaunch_to_the_unsupervised_losses(prefix, tmp_path):
    golden, gold_dir = start(tmp_path, "golden", prefix, supervise=False)
    supervised, workdir = start(tmp_path, "supervised", prefix, supervise=True,
                                faults="host.kill=kill@5@epoch=0,host.hang=hang@2@epoch=1")
    finish(golden, gold_dir, timeout=120)
    assert golden.returncode == 0, (gold_dir / "out.log").read_text()[-4000:]
    gold = {r["step"]: r["loss"] for r in records(gold_dir)}
    assert sorted(gold) == [1, 2, 3, 4, 5, 6]

    deadline = time.monotonic() + 150
    while not any(r["epoch"] == 2 and r["step"] == 5 for r in records(workdir)):
        assert supervised.poll() is None and time.monotonic() < deadline, finish(
            supervised, workdir, 1)[-4000:]
        time.sleep(0.02)
    supervised.send_signal(signal.SIGTERM)
    out = finish(supervised, workdir, timeout=60)
    assert supervised.returncode == 0, out[-4000:]
    assert "supervisor: rc=0 cuda_initialized=False" in out

    by_epoch = {}
    for r in records(workdir):
        by_epoch.setdefault(r["epoch"], []).append(r["step"])
        assert r["loss"] == gold[r["step"]], r  # bitwise: the uninterrupted run's
    assert by_epoch[0] == [1, 2, 3, 4] and by_epoch[1] == [4] and by_epoch[2][:2] == [4, 5]
    k = by_epoch[2][-1]
    assert k in (5, 6) and (workdir / "ckpt" / "latest").read_text() == f"global_step{k}"

    events = [json.loads(line) for line in (workdir / "events.jsonl").read_text().splitlines()]
    sup = [e for e in events if e["event"] in SUPERVISOR_EVENTS]
    assert [e["event"] for e in sup] == [
        "epoch-start", "host-dead", "teardown-complete", "relaunch",
        "epoch-start", "host-dead", "teardown-complete", "relaunch",
        "epoch-start", "preempt-relay", "epoch-clean-exit"]
    crash, hang = sup[1], sup[5]
    assert (crash["reason"], crash["exit_codes"], sup[2]["killed_pids"]) == (
        "exit", {"0": -9}, [])
    assert hang["reason"] == "heartbeat-stale" and sup[6]["killed_pids"] == sup[4]["pids"]
    assert [e["backoff_s"] for e in sup if e["event"] == "relaunch"] == [0.2, 0.4]
    assert sup[-1] == {**sup[-1], "epoch": 2, "preempted": True}
    # a worker that reached its last step ends the run without a broadcast
    assert [e["step"] for e in events if e["event"] == "preempt-broadcast"] == ([k] if k < 6 else [])
    spans = {e["span"] for e in events if e["event"] == "span"}
    assert {"supervisor.epoch", "supervisor.teardown", "supervisor.backoff"} <= spans

    report = subprocess.run([sys.executable, "-m", "scaling_tpu_torch.obs", "report",
                             str(workdir), "--assert-max-resizes", "0"], cwd=REPO,
                            capture_output=True, text=True, timeout=60)
    assert report.returncode == 0, report.stdout[-3000:] + report.stderr[-3000:]
    assert f"totals: restarts=2 preemptions={1 + (k < 6)} stalls=0" in report.stdout
