"""The port stands alone: it imports with JAX and the JAX package
blocked, serves, takes a training step, trains from a token dataset,
saves, resumes, serves, generates from and evaluates its checkpoint on
the CPU when asked to; without a card, its entry points raise instead of
moving to the CPU on their own."""

import pathlib
import re
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
from scaling_tpu_torch.models.transformer import TransformerConfig, TransformerInferenceModule
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
    for key, value in (("lora_config", {"name": "x"}), ("mlp_type", "moe"),
                       ("mup", {"base_hidden_size": 64})):
        with pytest.raises(NotImplementedError, match=key):
            TransformerArchitectureConfig.from_dict({**base, key: value})
    # the JAX default architecture's keys are ported
    for key, value in (("weight_tying", True), ("norm_type", "layernorm"),
                       ("mlp_type", "default"), ("key_query_norm", True),
                       ("relative_position_embedding_type", "rotary_complex"),
                       ("relative_position_embedding_type", "none")):
        assert getattr(TransformerArchitectureConfig.from_dict({**base, key: value}),
                       key) == value
