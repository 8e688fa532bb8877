"""The port stands alone: it imports with JAX and the JAX package
blocked, serves and takes a training step on the CPU when asked to;
without a card, its entry points raise instead of moving to the CPU on
their own."""

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
sys.exit(rc or train_main(["--device", "cpu", "--model", "toy", "--seq-len", "128",
                           "--mbs", "1", "--steps", "1", "--warmup", "0"]))
"""


def test_port_imports_and_serves_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", BLOCKED_SERVE], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "completed=3" in proc.stdout
    assert "output tokens/s" in proc.stdout and "ttft: p50=" in proc.stdout
    assert "train bench: model=toy device=cpu" in proc.stdout
    assert "losses: first=" in proc.stdout and "mfu: not measured" in proc.stdout


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
    for key, value in (("weight_tying", True), ("lora_config", {"name": "x"}),
                       ("norm_type", "layernorm"), ("mlp_type", "default"),
                       ("relative_position_embedding_type", "rotary_complex")):
        with pytest.raises(NotImplementedError):
            TransformerArchitectureConfig.from_dict({**base, key: value})
