"""The port's Trainer at dp 2 x mp 2 with ZeRO-1 through its entry points
(``runner_main`` starting four ``train run`` workers over gloo on the
CPU) against the JAX package's Trainer at the same layout on the virtual
CPU devices, a toy rms/swiglu model (hidden 128, 2 layers, 4/2 heads,
vocab 96, seq 32, f32, micro-batch 2 a data rank, accumulation 2):

- the JAX trainer's initialisation goes to the port as a JAX checkpoint
  (step 0), which the four ranks load as their slices; their losses over
  steps 1-3 are within rtol 1e-4 of JAX's;
- the port's merged step-3 checkpoint loads in the JAX trainer (with
  verification), equal to the arrays on disk;
- dp 2 x mp 2 -> dp 1 x mp 1: one rank loads the step-3 checkpoint
  bitwise and trains steps 4-5 within 1e-4 of the four ranks'; and back:
  four ranks load the one rank's step-4 checkpoint bitwise (each rank its
  slices) and train step 5 within 1e-4 of it;
- a SIGTERM to rank 3 after its step-5 record stops every rank at step 6
  with one checkpoint that verifies, and every worker exits 0;
- under the supervisor, a rank killed mid-run takes the group down and the
  relaunched group resumes bitwise.

Each run has a time limit of its own; a rank that fails takes the others
down (the launcher's teardown)."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from scaling_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from scaling_tpu.ops.rms_norm import force_rms_interpret  # noqa: E402
from scaling_tpu_torch.checkpoint.checkpoint import _from_numpy  # noqa: E402
from scaling_tpu_torch.data import MemoryMapDatasetBuilder  # noqa: E402
from scaling_tpu_torch.models.transformer import TransformerConfig  # noqa: E402
from scaling_tpu_torch.models.transformer.train import build_trainer  # noqa: E402
from scaling_tpu_torch.resilience import read_mesh_meta, verify_checkpoint  # noqa: E402
from scaling_tpu_torch.runner import runner_main  # noqa: E402

from .test_torch_checkpoint import jax_trainer  # noqa: E402
from .test_torch_dist_helpers import free_port  # noqa: E402
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401

ARCH = {
    "vocab_size": 96, "hidden_size": 128, "num_layers": 2, "num_attention_heads": 4,
    "attention_num_kv_heads": 2, "attention_qkv_in_one": False, "sequence_length": 32,
    "precision": "float32", "mlp_type": "swiglu", "mlp_factor": 2.0, "norm_type": "rms",
    "layernorm": {"optimization_type": "fused"}, "weight_tying": False,
}
REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-4
TIMEOUT_S = 100


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokens")
    rng = np.random.default_rng(23)
    prefixes = []
    for name, docs in (("a", 60), ("b", 30)):
        with MemoryMapDatasetBuilder(root / name, dtype=np.uint16) as builder:
            for _ in range(docs):
                builder.add(np.append(rng.integers(1, 96, size=rng.integers(8, 80)), 0))
        prefixes.append(str(root / name))
    return prefixes


def config(data, root: Path, dp: int, mp: int, iterations: int, load_dir=None,
           save: bool = True) -> dict:
    return {
        "topology": {"model_parallel_size": mp, "pipe_parallel_size": 1,
                     "data_parallel_size": dp, "micro_batch_size": 4 // dp,
                     "gradient_accumulation_steps": 2},
        "transformer_architecture": ARCH,
        "optimizer": {"gradient_clipping": 1.0, "zero": dp > 1},
        "learning_rate_scheduler": {"learning_rate": 0.01, "learning_rate_warmup_steps": 2,
                                    "learning_rate_decay_iters": 50},
        "trainer": {"train_iterations": iterations, "seed": 42,
                    "save_dir": str(root / "ckpt") if save else None, "save_interval": 1,
                    "load_dir": None if load_dir is None else str(load_dir),
                    "assert_checkpoint_loaded": load_dir is not None,
                    "delete_past_optimizer_states": False},
        "data": {"data_prefixes": data},
        "logger": {"log_dir": str(root / "logs")},
        "runner": {"default_gpu_count": dp * mp, "script": "tests.test_torch_dist_helpers",
                   "master_port": free_port()},
    }


def launch(cfg: dict, on_records=None) -> int:
    """``runner_main`` over ``cfg`` on a thread, with ``on_records(log_dir)``
    polled while it runs; its exit code."""
    result = {}
    thread = threading.Thread(target=lambda: result.update(
        rc=runner_main(TransformerConfig.from_dict(cfg).runner, cfg)), daemon=True)
    thread.start()
    deadline = time.monotonic() + TIMEOUT_S
    while thread.is_alive() and time.monotonic() < deadline:
        if on_records is not None and on_records(Path(cfg["logger"]["log_dir"])):
            on_records = None
        time.sleep(0.05)
    thread.join(timeout=max(deadline - time.monotonic(), 1))
    assert not thread.is_alive(), f"the run outlived {TIMEOUT_S}s"
    return result["rc"]


def records(log_dir: Path, rank: int) -> dict:
    path = log_dir / f"rank{rank}.jsonl"
    recs = [json.loads(x) for x in path.read_text().splitlines()] if path.is_file() else []
    return {"start": next((r for r in recs if r["kind"] == "start"), None),
            "losses": {r["step"]: r["loss"] for r in recs if r["kind"] == "step"},
            "end": next((r for r in recs if r["kind"] == "end"), None)}


def stored(step_dir: Path) -> dict:
    """The checkpoint's model arrays by port name, in the port's layout."""
    from scaling_tpu_torch.models.transformer.model import TransformerModel
    from scaling_tpu_torch.parallel import ParallelModule

    arch = TransformerConfig.from_dict(config([], step_dir, 1, 1, 1)).transformer_architecture
    module = ParallelModule(TransformerModel(arch, device="meta"), None)
    keys = module.ckpt_keys()
    out = {}
    for f in step_dir.glob("model_state_layer_*.npz"):
        index, cls = f.stem[len("model_state_layer_"):].split("_", 1)
        with np.load(f) as z:
            for member in z.files:
                key = f"layer_{index}_{cls}.{member}"
                name = next(n for n, k in keys.items() if k == key)
                out[name] = _from_numpy(key, z[member]).numpy()
    return out


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    # JAX at dp 2 x mp 2 with ZeRO: its initialisation saved as step 0, then 3 steps
    jax_cfg = config(data, root / "jax", 2, 2, 3)
    jax_cfg.pop("runner")
    with force_rms_interpret():
        jax_run = jax_trainer(jax_cfg, load=False)
        jax_run.save_checkpoint()
        jax_losses = [float(jax_run.train_step().loss) for _ in range(3)]
    # the port's four ranks from JAX's step 0, 5 steps
    a = config(data, root / "a", 2, 2, 5, load_dir=root / "jax" / "ckpt" / "global_step0")
    a["trainer"]["load_optimizer_states"] = True
    assert launch(a) == 0
    # one rank from the four ranks' step 3, steps 4-5
    b_cfg = config(data, root / "b", 1, 1, 5, load_dir=root / "a" / "ckpt" / "global_step3")
    b = build_trainer(TransformerConfig.from_dict(b_cfg), device="cpu")
    b_loaded = {n: p.detach().numpy().copy() for n, p in b.module.model.named_parameters()}
    b.run_training()
    # four ranks from the one rank's step 4, with a SIGTERM to rank 3 after step 5
    c = config(data, root / "c", 2, 2, 8, load_dir=root / "b" / "ckpt" / "global_step4")
    sent = {}

    def sigterm(log_dir):
        rec = records(log_dir, 3)
        if 5 in rec["losses"]:
            os.kill(rec["start"]["pid"], signal.SIGTERM)
            sent["at"] = 5
            return True
        return False

    os.environ["WORKER_PAUSE_S"] = "0.3"
    try:
        c_rc = launch(c, sigterm)
    finally:
        os.environ.pop("WORKER_PAUSE_S")
    return {"root": root, "jax_losses": jax_losses, "jax_cfg": jax_cfg, "b_loaded": b_loaded,
            "b_log": root / "b" / "logs", "c_rc": c_rc, "sent": sent}


def test_four_ranks_match_the_jax_trainer_at_the_same_layout(runs):
    got = records(runs["root"] / "a" / "logs", 0)["losses"]
    np.testing.assert_allclose([got[s] for s in (1, 2, 3)], runs["jax_losses"], rtol=RTOL)
    mesh = read_mesh_meta(runs["root"] / "a" / "ckpt" / "global_step3")
    assert (mesh["topology"]["data_parallel_size"], mesh["topology"]["model_parallel_size"],
            mesh["topology"]["world_size"], mesh["optimizer"]["zero_stage"]) == (2, 2, 4, 1)
    # every rank wrote the same global losses; rank 0 alone wrote the step records
    for r in range(1, 4):
        assert records(runs["root"] / "a" / "logs", r)["losses"] == got
    assert sorted(p.name for p in (runs["root"] / "a" / "logs").glob("metrics_rank_*")) == [
        "metrics_rank_0.jsonl"]


def test_the_jax_trainer_loads_the_port_checkpoint(runs, data):
    step3 = runs["root"] / "a" / "ckpt" / "global_step3"
    assert verify_checkpoint(step3) == []
    cfg = dict(runs["jax_cfg"], trainer=dict(runs["jax_cfg"]["trainer"], load_dir=str(step3),
                                             save_dir=None, assert_checkpoint_loaded=True))
    with force_rms_interpret():
        ref = jax_trainer(cfg, load=True)
    assert ref.context.iterations == 3 and int(ref.opt_state.step) == 3
    assert ref.optimizer_states_loaded and ref.context.consumed_samples == 24
    from scaling_tpu_torch.models.transformer.convert import params_from_jax

    arch = TransformerConfig.from_dict(config(data, step3, 1, 1, 1)).transformer_architecture
    loaded = params_from_jax(jax.tree.map(np.asarray, ref.params), arch)
    for name, value in stored(step3).items():
        np.testing.assert_array_equal(loaded[name].numpy(), value, err_msg=name)


def test_resume_to_one_rank_and_back_is_bitwise_at_the_load(runs):
    a = records(runs["root"] / "a" / "logs", 0)["losses"]
    step3 = stored(runs["root"] / "a" / "ckpt" / "global_step3")
    for name, value in step3.items():
        np.testing.assert_array_equal(runs["b_loaded"][name], value, err_msg=name)
    b_recs = [json.loads(x) for x in (runs["b_log"] / "metrics_rank_0.jsonl").read_text()
              .splitlines()]
    b = {r["step"]: r["metrics"]["loss"] for r in b_recs if r["kind"] == "step"}
    np.testing.assert_allclose([b[4], b[5]], [a[4], a[5]], rtol=RTOL)
    # back: each of the four ranks holds its slices of the one rank's step 4
    step4 = stored(runs["root"] / "b" / "ckpt" / "global_step4")
    c_log = runs["root"] / "c" / "logs"
    for r in range(4):
        mp_rank = r % 2
        with np.load(c_log / f"loaded_rank{r}.npz") as z:
            for name, value in step4.items():
                got = z[name]
                dims = [d for d in range(value.ndim) if got.shape[d] != value.shape[d]]
                if dims:
                    n = got.shape[dims[0]]
                    value = np.take(value, range(mp_rank * n, (mp_rank + 1) * n), axis=dims[0])
                np.testing.assert_array_equal(got, value, err_msg=f"rank {r} {name}")
    c = records(c_log, 0)["losses"]
    np.testing.assert_allclose(c[5], b[5], rtol=RTOL)


def test_a_sigterm_to_one_rank_saves_every_rank_at_the_same_step(runs):
    assert runs["sent"] == {"at": 5} and runs["c_rc"] == 0
    c_log, ckpt = runs["root"] / "c" / "logs", runs["root"] / "c" / "ckpt"
    ends = [records(c_log, r)["end"] for r in range(4)]
    assert [e["iterations"] for e in ends] == [6] * 4 and all(e["preempted"] for e in ends)
    assert (ckpt / "latest").read_text().strip() == "global_step6"
    assert verify_checkpoint(ckpt / "global_step6") == []
    assert not (ckpt / "global_step7").exists()


SUPERVISE = """
import json, sys
from scaling_tpu_torch.models.transformer import TransformerConfig
from scaling_tpu_torch.runner import runner_main
cfg = json.load(open(sys.argv[1]))
sys.exit(runner_main(TransformerConfig.from_dict(cfg).runner, cfg))
"""


def test_the_supervisor_relaunches_every_rank_when_one_dies(data, tmp_path):
    """Two data ranks with ZeRO under ``runner.supervise``: rank 1 is
    SIGKILLed at its fourth iteration (``host.kill`` scoped to host 1 in
    epoch 0); the supervisor sees it dead, raises the abort flag (the
    survivor leaves its step barrier), relaunches both ranks, and the run
    resumes from the step-2 checkpoint to step 6 with step 3 replayed
    bitwise; exit 0."""
    cfg = config(data, tmp_path, 2, 1, 6, load_dir=tmp_path / "ckpt")
    cfg["topology"]["micro_batch_size"] = 2
    cfg["trainer"].update(save_interval=2, assert_checkpoint_loaded=False)
    cfg["runner"].update(hosts=["localhost"], supervise=True, control_dir=str(tmp_path / "ctl"),
                         startup_grace_seconds=60, heartbeat_timeout_seconds=30,
                         restart_budget=1, restart_backoff_seconds=0.1)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    # the supervisor installs signal handlers: a process of its own, with a time limit
    proc = subprocess.run(
        [sys.executable, "-c", SUPERVISE, str(tmp_path / "cfg.json")], cwd=REPO,
        env={**os.environ, "SCALING_TPU_FAULTS": "host.kill=kill@4@host=1@epoch=0",
             "SCALING_TPU_EVENTS_PATH": str(tmp_path / "events.jsonl")},
        capture_output=True, text=True, timeout=2 * TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    events = [json.loads(x)["event"] for x in (tmp_path / "events.jsonl").read_text()
              .splitlines()]
    assert "host-dead" in events and events.count("epoch-start") == 2
    assert (tmp_path / "ckpt" / "latest").read_text().strip() == "global_step6"
    recs = [json.loads(x) for x in (tmp_path / "logs" / "metrics_rank_0.jsonl").read_text()
            .splitlines()]
    losses = [(r["step"], r["metrics"]["loss"]) for r in recs if r["kind"] == "step"]
    steps = [s for s, _ in losses]
    assert steps == [1, 2, 3, 3, 4, 5, 6]
    assert losses[2][1] == losses[3][1]
