"""The port stands alone: it imports with JAX and the JAX package
blocked, serves, takes a training step, trains from a token dataset,
saves, resumes, serves, generates from and evaluates its checkpoint,
LoRA-finetunes it with dropout, merges and serves the finetune, takes
AtMan-controlled logits, a multimodal step under ``every_layer_save_dots``
with gradient norms and a local-window cached decode, packs Megatron data
with the C++ builder, exports its checkpoint to the reference's format and
imports and serves it, climbs the train bench's micro-batch ladder, on the
CPU when asked to, renders ``obs report``, supervises a worker (this file,
run as the runner's script, is that worker) and a serving bench through
a crash and its journal replay and a process fleet through a killed
replica's failover (its workers blocked too); without a card,
its entry points raise instead of moving to the CPU on their own."""

import json
import os
import pathlib
import re
import signal
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

BLOCKED_SERVE = r"""
import sys
sys.modules["jax"] = None
sys.modules["scaling_tpu"] = None
import pkgutil, importlib
import scaling_tpu_torch
for mod in pkgutil.walk_packages(scaling_tpu_torch.__path__, "scaling_tpu_torch."):
    if not mod.name.endswith("_triton"):  # these import triton, a card-side package
        importlib.import_module(mod.name)
from scaling_tpu_torch.serve.bench import main
rc = main(["--device", "cpu", "--model", "toy", "--requests", "3", "--rate", "100",
           "--prompt-len", "3", "9", "--output-len", "2", "4", "--num-slots", "2",
           "--block-size", "4", "--num-blocks", "16", "--max-blocks-per-seq", "8"])
from scaling_tpu_torch.train.bench import main as train_main
rc = rc or train_main(["--device", "cpu", "--model", "toy", "--seq-len", "128",
                       "--mbs", "1", "--steps", "1", "--warmup", "0"])

# the Trainer: token datasets -> train and save -> resume -> serve the checkpoint
import tempfile
from pathlib import Path
import numpy as np
from scaling_tpu_torch.data import MemoryMapDatasetBuilder
from scaling_tpu_torch.models.transformer import (TransformerArchitectureConfig,
                                                  TransformerConfig, TransformerInferenceModule)
from scaling_tpu_torch.models.transformer.train import main as trainer_main
from scaling_tpu_torch.serve import EngineConfig, ServeEngine
from scaling_tpu_torch.serve.bench import MODELS
root = Path(tempfile.mkdtemp())
rng = np.random.default_rng(0)
with MemoryMapDatasetBuilder(root / "tokens", dtype=np.uint16) as builder:
    for _ in range(40):
        builder.add(np.append(rng.integers(1, 512, size=rng.integers(16, 200)), 0))
def config(**trainer):
    return TransformerConfig.from_dict({
        "topology": {"micro_batch_size": 2, "gradient_accumulation_steps": 1},
        "transformer_architecture": dict(MODELS["toy"], sequence_length=64),
        "trainer": {"train_iterations": 4, "save_interval": 2, **trainer},
        "data": {"data_prefixes": [str(root / "tokens")]},
        "logger": {"log_dir": str(root / "logs")}})
trainer_main(config(save_dir=str(root / "ckpt")), device="cpu")
resumed = trainer_main(config(load_dir=str(root / "ckpt" / "global_step2")), device="cpu")
assert resumed.context.iterations == 4 and resumed.context.consumed_samples == 8
inf = TransformerInferenceModule.from_checkpoint(root / "ckpt", device="cpu")
engine = ServeEngine(inf, EngineConfig(num_slots=2, block_size=4, num_blocks=16,
                                       max_blocks_per_seq=8), device="cpu")
engine.submit([1, 2, 3, 4, 5], 3)
done = engine.run_until_done()
assert [len(s.generated) for s in done] == [3]
print("trainer: resumed at 2, served the checkpoint")

# generate (ragged, greedy) and evaluate the same checkpoint
from scaling_tpu_torch.models.transformer.evaluate import evaluate
outs = inf.generate([[1, 2, 3], [4, 5, 6, 7, 8]], max_tokens=4)
assert [len(o.completion_ids) for o in outs] == [4, 4] and outs[0].logits.shape[0] == 4
stats = evaluate(root / "ckpt", root / "tokens", batch_size=2, max_batches=2, device="cpu")
assert stats["batches"] == 2 and stats["tokens"] > 0 and np.isfinite(stats["loss"])
print("generate and evaluate: ok")

# Megatron data packed by the C++ builder; the checkpoint exported to the
# reference's format, imported back and served; the model-free leaf reader,
# the verified selection; the train bench's micro-batch ladder
import shutil
from scaling_tpu_torch.checkpoint.export_reference import export_reference_checkpoint
from scaling_tpu_torch.checkpoint.import_reference import convert_reference_checkpoint
from scaling_tpu_torch.data import LegacyMMapIndexWriter
from scaling_tpu_torch.models.transformer.data import TextDataset
from scaling_tpu_torch.native import build_pack_index_plain
from scaling_tpu_torch.resilience import iter_global_leaves, select_checkpoint
with LegacyMMapIndexWriter(root / "legacy") as writer:
    for _ in range(30):
        writer.add(np.append(rng.integers(1, 512, size=rng.integers(16, 200)), 0))
legacy = TextDataset(root / "legacy", 64, only_full_sequences=True, legacy_dataset=True)
starts, _ = build_pack_index_plain(legacy.memory_map.sizes(), 64, 0)
assert len(legacy) > 0 and (legacy._item_starts == starts).all()
step = root / "ckpt" / (root / "ckpt" / "latest").read_text()
export_reference_checkpoint(step, root / "ref")
convert_reference_checkpoint(root / "ref", root / "imported")
shutil.copy(step / "config.yml", root / "imported")
imported = TransformerInferenceModule.from_checkpoint(root / "imported", device="cpu")
assert (imported.generate([1, 2, 3], max_tokens=3).completion_ids
        == inf.generate([1, 2, 3], max_tokens=3).completion_ids)
assert select_checkpoint(root / "ckpt")[0] == step and len(list(iter_global_leaves(step))) > 0
rc = rc or train_main(["--device", "cpu", "--model", "toy", "--seq-len", "32",
                       "--mbs-plan", "1,2", "--steps", "1", "--warmup", "0"])
print("tooling: legacy data, reference checkpoint round trip, ladder")

# a LoRA finetune with dropout from that checkpoint, merged on load and served
d = config(load_dir=str(root / "ckpt"), load_optimizer_states=False, load_context=False,
           allowed_missing_keys_in_checkpoint=[".*_lora\\."],
           save_dir=str(root / "lora")).to_dict()
d["transformer_architecture"].update(lora_config={"name": "lora", "rank": 4, "dropout": 0.1},
                                     dropout_embedding=0.1, dropout_after_mlp=0.1)
d["training"] = {"finetune": True}
tuned = trainer_main(TransformerConfig.from_dict(d), device="cpu")
assert sorted(tuned.optimizer.optimized) == sorted(
    n for n, _ in tuned.module.model.named_parameters() if "_lora." in n)
d["trainer"].update(load_dir=str(root / "lora"), save_dir=None, train_iterations=0,
                    merge_lora_after_loading_checkpoint=True)
merged = trainer_main(TransformerConfig.from_dict(d), device="cpu")
assert not merged.module.model.layers["layer_1"].attention.query_lora.lora_b.any()
lora = TransformerInferenceModule.from_checkpoint(root / "lora", device="cpu")
assert len(lora.generate([1, 2, 3], max_tokens=3).completion_ids) == 3
print("finetune: LoRA with dropout trained, merged and served")

# AtMan logits in both variants; a multimodal train step (ViT image encoder,
# every_layer_save_dots remat, per-parameter gradient norms); local-window
# heads through the cached decode
import torch
from scaling_tpu_torch.models.transformer import init_model, init_optimizer, loss_function
from scaling_tpu_torch.models.transformer.attention_control import Control
for log_additive in (True, False):
    lg = inf.logits([[1, 2, 3, 4, 5, 6]], controls=[Control(2, 0.0), Control(4, 2.0)],
                    control_log_additive=log_additive)
    assert lg.shape == (1, 6, 512) and bool(torch.isfinite(lg).all())
mm = TransformerConfig.from_dict({
    "topology": {"micro_batch_size": 2, "gradient_accumulation_steps": 1,
                 "activation_checkpointing_type": "every_layer_save_dots"},
    "optimizer": {"debug_log": True},
    "transformer_architecture": dict(MODELS["toy"], sequence_length=16, image_encoder=True,
                                     image_encoder_width=32, image_encoder_layers=1,
                                     image_encoder_heads=4)})
module = init_model(mm, device="cpu")
step = module.build_train_step(init_optimizer(mm, module.model), loss_function)
tok = torch.randint(1, 512, (1, 2, 16))
batch = {"token_ids": tok, "target_token_ids": tok.roll(-1, -1),
         "input_images": torch.randn(1, 2, 1, 64, 64, 3),
         "input_image_locations": torch.tensor([[[2], [5]]]),
         "input_image_mask": torch.ones(1, 2, 1, dtype=torch.bool)}
loss, _, out = step(batch)
assert np.isfinite(float(loss)) and any(
    float(v) > 0 for k, v in out.debug_dict.items() if ".image_encoder." in k)
local = TransformerInferenceModule.random_init(TransformerArchitectureConfig.from_dict(dict(
    MODELS["toy"], num_local_attention_heads=2, local_attention_window_size=4)), device="cpu")
outs = local.generate([[1, 2, 3], [4, 5, 6, 7, 8, 9]], max_tokens=6)
assert [len(o.completion_ids) for o in outs] == [6, 6]
print("model features: atman, multimodal save_dots step, local-window decode")
sys.exit(rc)
"""


def test_port_imports_and_serves_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", BLOCKED_SERVE], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "completed=3" in proc.stdout
    assert "output tokens/s" in proc.stdout and "ttft: p50=" in proc.stdout
    assert "train bench: model=toy device=cpu" in proc.stdout
    assert "losses: first=" in proc.stdout and "mfu: not measured" in proc.stdout
    assert "trainer: resumed at 2, served the checkpoint" in proc.stdout
    assert "generate and evaluate: ok" in proc.stdout
    assert "finetune: LoRA with dropout trained, merged and served" in proc.stdout
    assert "model features: atman, multimodal save_dots step, local-window decode" in proc.stdout
    assert "tooling: legacy data, reference checkpoint round trip, ladder" in proc.stdout
    assert "ladder: mbs=1 " in proc.stdout


BLOCKED_TOOLS = r"""
import sys
sys.modules["jax"] = None
sys.modules["scaling_tpu"] = None
import scaling_tpu_torch.analysis, scaling_tpu_torch.determined, scaling_tpu_torch.tune
from scaling_tpu_torch.determined import DeterminedGlue
assert DeterminedGlue.detect() is None  # no SDK here, as on the card's machine
from scaling_tpu_torch.tune.cli import main as tune_main
assert tune_main(["--serve", "--devices", "1", "--check-golden"]) == 0
assert tune_main(["--devices", "1", "--mbs-ladder", "4,8,16,32", "--check-golden"]) == 0
from scaling_tpu_torch.analysis.cli import main as analysis_main
assert analysis_main(["protocol"]) == 0
assert analysis_main(["audit", "--device", "cpu", "--sections", "serve_decode"]) == 0
print("tools: tuner, analyzer and Determined glue ran")
"""


def test_tuner_analyzer_and_glue_run_with_jax_blocked():
    """``scaling_tpu_torch.tune``, ``.analysis`` and ``.determined`` import
    and run where JAX and the JAX package cannot be imported: both tuner
    goldens, the protocol inventory and a dispatch audit section hold."""
    proc = subprocess.run([sys.executable, "-c", BLOCKED_TOOLS], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "tools: tuner, analyzer and Determined glue ran" in proc.stdout


BLOCKED_REPORT = r"""
import runpy, sys
sys.modules["jax"] = None
sys.modules["scaling_tpu"] = None
sys.argv = ["scaling_tpu_torch.obs", "report", sys.argv[1], "--assert-mfu", "0.1"]
runpy.run_module("scaling_tpu_torch.obs", run_name="__main__")
"""


def test_obs_report_runs_with_jax_blocked():
    """``python -m scaling_tpu_torch.obs report`` over the JAX package's
    golden run directory in a process where JAX and the JAX package cannot
    be imported: the same report, its gate passing."""
    fixtures = REPO / "tests" / "core" / "test_obs" / "fixtures"
    proc = subprocess.run([sys.executable, "-c", BLOCKED_REPORT, str(fixtures / "rundir_single")],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    golden = (fixtures / "golden_single.txt").read_text()
    assert proc.stdout == golden.replace("RUNDIR", str(fixtures / "rundir_single")) + (
        "== gates ==\n  PASS\n")


BLOCKED_SERVE_SUPERVISOR = r"""
import sys
sys.modules["jax"] = None
sys.modules["scaling_tpu"] = None
import torch
def refuse():
    raise AssertionError("the supervisor initialised CUDA")
torch.cuda._lazy_init = refuse
from scaling_tpu_torch.serve.bench import main
sys.exit(main(sys.argv[1:]))
"""


def test_supervised_crash_replay_bench_with_jax_blocked(tmp_path):
    """``serve bench --restarts 2`` with ``serve.tick=kill@6``: the
    supervisor (JAX and the JAX package blocked, CUDA refused) relaunches
    the killed child with ``--resume``. The children run where ``jax`` and
    ``scaling_tpu`` resolve to packages that refuse to import, so a child
    that reached either would fail every launch."""
    blocked = tmp_path / "blocked"
    for name in ("jax", "scaling_tpu"):
        (blocked / name).mkdir(parents=True)
        (blocked / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked in this test')\n")
    run_dir = tmp_path / "run"
    env = {k: v for k, v in os.environ.items() if not k.startswith("SCALING_TPU_")}
    env.update(PYTHONPATH=str(REPO), SCALING_TPU_FAULTS="serve.tick=kill@6",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", BLOCKED_SERVE_SUPERVISOR, "--device", "cpu", "--model", "toy",
         "--requests", "6", "--rate", "50", "--prompt-len", "4", "16", "--output-len", "6",
         "12", "--num-slots", "4", "--block-size", "4", "--num-blocks", "64",
         "--max-blocks-per-seq", "16", "--prefill-chunk", "8", "--warmup", "0",
         "--run-dir", str(run_dir), "--restarts", "2"],
        cwd=blocked, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)  # a session of its own: the kill below ends its children too
    try:
        _, err = proc.communicate(timeout=240)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    assert proc.returncode == 0, err[-3000:]
    events = [json.loads(line) for line in (run_dir / "events.jsonl").read_text().splitlines()]
    assert [e["rc"] for e in events if e["event"] == "serve-restart"] == [-9]
    lines = [json.loads(line) for line in (run_dir / "journal.jsonl").read_text().splitlines()]
    done = [r["req"] for r in lines if r["kind"] == "serve-finish" and r["status"] == "completed"]
    assert sorted(done) == list(range(6))


def test_process_fleet_with_jax_blocked_in_host_and_workers(tmp_path):
    """``serve bench --replicas-proc 2`` with ``serve.replica.kill=kill@3@host=1``:
    the host runs with JAX and the JAX package blocked and CUDA refused; its
    workers (and the relaunch) start where ``jax`` and ``scaling_tpu``
    resolve to packages that refuse to import. Every request completes, one
    replica is relaunched, and the host never initialised CUDA."""
    blocked = tmp_path / "blocked"
    for name in ("jax", "scaling_tpu"):
        (blocked / name).mkdir(parents=True)
        (blocked / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked in this test')\n")
    run_dir = tmp_path / "run"
    env = {k: v for k, v in os.environ.items() if not k.startswith("SCALING_TPU_")}
    env.update(PYTHONPATH=str(REPO), SCALING_TPU_FAULTS="serve.replica.kill=kill@3@host=1",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", BLOCKED_SERVE_SUPERVISOR, "--device", "cpu", "--model", "toy",
         "--requests", "8", "--rate", "50", "--seed", "7", "--prompt-len", "4", "16",
         "--output-len", "6", "12", "--num-slots", "2", "--block-size", "4", "--num-blocks",
         "96", "--max-blocks-per-seq", "16", "--prefill-chunk", "4", "--replicas-proc", "2",
         "--run-dir", str(run_dir), "--json", str(run_dir / "stats.json")],
        cwd=blocked, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        _, err = proc.communicate(timeout=240)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    assert proc.returncode == 0, err[-3000:]
    stats = json.loads((run_dir / "stats.json").read_text())
    assert stats["requests"] == 8 and stats["replica_restarts"] == 1
    assert stats["host_cuda_initialized"] is False
    ready = [e for e in map(json.loads, (run_dir / "events.jsonl").read_text().splitlines())
             if e["event"] == "serve-replica-ready"]
    assert sorted(e["replica"] for e in ready) == [0, 1, 1]  # both, and the relaunch


BLOCKED_SUPERVISE = r"""
import json, sys, tempfile
sys.modules["jax"] = None
sys.modules["scaling_tpu"] = None
from pathlib import Path
import numpy as np
import torch
def refuse():
    raise AssertionError("the supervisor initialised CUDA")
torch.cuda._lazy_init = refuse
from scaling_tpu_torch.data import MemoryMapDatasetBuilder
from scaling_tpu_torch.runner import RunnerConfig, runner_main
from scaling_tpu_torch.serve.bench import MODELS
root = Path(tempfile.mkdtemp())
rng = np.random.default_rng(0)
with MemoryMapDatasetBuilder(root / "tokens", dtype=np.uint16) as builder:
    for _ in range(40):
        builder.add(np.append(rng.integers(1, 512, size=rng.integers(16, 200)), 0))
payload = {
    "topology": {"micro_batch_size": 2, "gradient_accumulation_steps": 1},
    "transformer_architecture": dict(MODELS["toy"], sequence_length=64),
    "trainer": {"train_iterations": 3, "save_interval": 3, "save_dir": str(root / "ckpt")},
    "data": {"data_prefixes": [str(root / "tokens")]},
    "logger": {"log_dir": str(root / "logs"), "events_path": str(root / "events.jsonl")}}
config = RunnerConfig.from_dict({
    "hosts": ["localhost"], "default_gpu_count": 1, "script": "tests.test_torch_isolation",
    "supervise": True, "control_dir": str(root / "control"), "startup_grace_seconds": 120})
rc = runner_main(config, payload)
beat = json.loads((root / "control" / "epoch-0" / "heartbeat" / "host0.json").read_text())
print(f"supervised: rc={rc} latest={(root / 'ckpt' / 'latest').read_text()} "
      f"heartbeat={beat['step']}:{beat['status']}")
sys.exit(rc)
"""


def test_runner_supervises_a_worker_with_jax_blocked():
    """``runner_main`` under ``supervise`` in a process where JAX and the
    JAX package cannot be imported and CUDA's initialisation raises,
    supervising one CPU worker that blocks both too: 3 steps, a checkpoint,
    a ``done`` heartbeat, exit 0."""
    proc = subprocess.run([sys.executable, "-c", BLOCKED_SUPERVISE], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "supervised: rc=0 latest=global_step3 heartbeat=3:done" in proc.stdout


BLOCKED_TWO_RANKS = r"""
import json, sys, tempfile
sys.modules["jax"] = None
sys.modules["scaling_tpu"] = None
from pathlib import Path
import numpy as np
from scaling_tpu_torch.data import MemoryMapDatasetBuilder
from scaling_tpu_torch.resilience import read_mesh_meta, verify_checkpoint
from scaling_tpu_torch.runner import RunnerConfig, runner_main
from scaling_tpu_torch.serve.bench import MODELS
root = Path(tempfile.mkdtemp())
rng = np.random.default_rng(0)
with MemoryMapDatasetBuilder(root / "tokens", dtype=np.uint16) as builder:
    for _ in range(40):
        builder.add(np.append(rng.integers(1, 512, size=rng.integers(16, 200)), 0))
topology = {"model_parallel_size": 2, "data_parallel_size": 1, "pipe_parallel_size": 1,
            "micro_batch_size": 2, "gradient_accumulation_steps": 1}
topology.update(json.loads(sys.argv[2]) if len(sys.argv) > 2 else {})
payload = {
    "topology": topology,
    "transformer_architecture": dict(MODELS["toy"], sequence_length=64),
    "trainer": {"train_iterations": 2, "save_interval": 2, "save_dir": str(root / "ckpt")},
    "data": {"data_prefixes": [str(root / "tokens")]},
    "logger": {"log_dir": str(root / "logs")}}
config = RunnerConfig.from_dict({"hosts": ["localhost"], "default_gpu_count": 2,
                                 "script": "tests.test_torch_isolation", "master_port": int(sys.argv[1])})
rc = runner_main(config, payload)
step = root / "ckpt" / "global_step2"
mesh = read_mesh_meta(step)["topology"]
print(f"two ranks: rc={rc} latest={(root / 'ckpt' / 'latest').read_text()} "
      f"mp={mesh['model_parallel_size']} verify={verify_checkpoint(step)} "
      f"pp={mesh['pipe_parallel_size']}")
sys.exit(rc)
"""


def test_two_ranks_train_a_step_with_jax_blocked():
    """``runner_main`` with two local slots in a process where JAX and the
    JAX package cannot be imported: two gloo workers that block both too
    train 2 steps at model-parallel size 2 and save a merged checkpoint."""
    from .test_torch_dist_helpers import free_port

    proc = subprocess.run([sys.executable, "-c", BLOCKED_TWO_RANKS, str(free_port())],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "two ranks: rc=0 latest=global_step2 mp=2 verify=[]" in proc.stdout


def test_two_pipe_ranks_train_a_step_with_jax_blocked():
    """The same with two pipe stages (1F1B, accumulation 2, ``every_pipe_stage``):
    each worker builds its stage, the activations and gradients cross by the
    stage transport, and rank 0 writes every stage's leaves."""
    from .test_torch_dist_helpers import free_port

    topology = {"model_parallel_size": 1, "pipe_parallel_size": 2,
                "gradient_accumulation_steps": 2,
                "activation_checkpointing_type": "every_pipe_stage"}
    proc = subprocess.run([sys.executable, "-c", BLOCKED_TWO_RANKS, str(free_port()),
                           json.dumps(topology)],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "two ranks: rc=0 latest=global_step2 mp=1 verify=[] pp=2" in proc.stdout


def test_no_source_of_the_port_imports_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import jax\b|from jax\b|import scaling_tpu\.|import scaling_tpu\s*$|"
        r"from scaling_tpu[ .])", re.M)
    files = list((REPO / "scaling_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_entry_points_refuse_to_drift_onto_the_cpu():
    from scaling_tpu_torch import resolve_device
    from scaling_tpu_torch.models.transformer import (
        TransformerArchitectureConfig,
        TransformerInferenceModule,
    )
    from scaling_tpu_torch.serve import EngineConfig, ServeEngine
    from scaling_tpu_torch.serve.bench import MODELS

    arch = TransformerArchitectureConfig.from_dict(MODELS["toy"])
    cpu_model = TransformerInferenceModule.random_init(arch, seed=0, device="cpu")
    # an engine built without device= wants the card: no card -> raises,
    # a card -> the CPU model does not match it -> raises
    with pytest.raises((RuntimeError, ValueError)):
        ServeEngine(cpu_model, EngineConfig(num_blocks=16))
    assert ServeEngine(cpu_model, EngineConfig(num_blocks=16), device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerInferenceModule.random_init(arch, seed=0)


def test_train_bench_refuses_to_drift_onto_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    proc = subprocess.run(
        [sys.executable, "-m", "scaling_tpu_torch.train", "bench", "--model", "toy"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "CUDA" in proc.stderr
    assert "train bench:" not in proc.stdout


def test_config_raises_on_keys_it_does_not_support():
    from scaling_tpu_torch.models.transformer import TransformerArchitectureConfig
    from scaling_tpu_torch.serve.bench import MODELS

    base = MODELS["toy"]
    with pytest.raises(ValueError, match="unknown"):
        TransformerArchitectureConfig.from_dict({**base, "hidden_sizee": 3})
    with pytest.raises(ValueError, match="unknown"):
        TransformerArchitectureConfig.from_dict({**base, "layernorm": {"foo": 1}})
    # the image encoder is read now (its parity: test_torch_image_encoder.py)
    assert TransformerArchitectureConfig.from_dict({**base, "image_encoder": True}).image_encoder
    # the JAX default architecture's keys are ported
    for key, value in (("weight_tying", True), ("norm_type", "layernorm"),
                       ("mlp_type", "default"), ("key_query_norm", True),
                       ("relative_position_embedding_type", "rotary_complex"),
                       ("relative_position_embedding_type", "none")):
        assert getattr(TransformerArchitectureConfig.from_dict({**base, key: value}),
                       key) == value
    # and MoE and muP (their parity with JAX: test_torch_moe.py, test_torch_mup.py)
    moe = TransformerArchitectureConfig.from_dict({**base, "mlp_type": "moe", "mlp_bias": False})
    assert moe.is_moe and moe.moe_num_experts == 8
    mup = TransformerArchitectureConfig.from_dict({**base, "mup": {"base_hidden_size": 64}})
    assert mup.mup_width_mult == base["hidden_size"] / 64


if __name__ == "__main__":
    # the worker of test_runner_supervises_a_worker_with_jax_blocked,
    # test_two_ranks_train_a_step_with_jax_blocked and
    # test_two_pipe_ranks_train_a_step_with_jax_blocked
    sys.modules["jax"] = None
    sys.modules["scaling_tpu"] = None
    from scaling_tpu_torch.models.transformer.train import worker_main

    worker_main(device="cpu")
