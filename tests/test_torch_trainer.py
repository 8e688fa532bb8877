"""The port's Trainer on the CPU: resume, checkpoint verification, metric
records, the ``train run`` entry point and the config keys it refuses.

A toy rms/swiglu model (hidden 64, 2 layers, 4/2 heads, vocab 96, seq 32)
trains from two blended token datasets with an evaluation set.
- Resume: 6 steps saving at 3, a relaunch from step 3, and the losses
  and grad norms of steps 4-6 bitwise equal (the JAX package's
  ``test_training_resume_loss_exact``); the resumed step-4 batch equals
  the first run's.
- Verification: one flipped byte in the newest checkpoint skips it for
  the previous one; ``strict_checkpoint_load`` makes that an error.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from scaling_tpu_torch.data import MemoryMapDatasetBuilder
from scaling_tpu_torch.models.transformer import TransformerConfig
from scaling_tpu_torch.models.transformer.train import build_trainer, main
from scaling_tpu_torch.resilience import CheckpointCorruptionError, verify_checkpoint

REPO = Path(__file__).resolve().parent.parent
ARCH = {
    "vocab_size": 96, "hidden_size": 64, "num_layers": 2, "num_attention_heads": 4,
    "attention_num_kv_heads": 2, "attention_qkv_in_one": False, "sequence_length": 32,
    "precision": "float32", "mlp_type": "swiglu", "mlp_factor": 2.0, "norm_type": "rms",
    "layernorm": {"optimization_type": "fused"},
    "masked_softmax": {"kernel": "flash_attention"}, "weight_tying": False,
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokens")
    rng = np.random.default_rng(5)
    out = {}
    for name, docs in (("a", 40), ("b", 30), ("valid", 12)):
        with MemoryMapDatasetBuilder(root / name, dtype=np.uint16) as builder:
            for _ in range(docs):
                builder.add(np.append(rng.integers(1, 96, size=rng.integers(8, 80)), 0))
        out[name] = str(root / name)
    return out


def config_dict(data, tmp, save=True, load_dir=None, **trainer):
    return {
        "topology": {"micro_batch_size": 2, "gradient_accumulation_steps": 2},
        "transformer_architecture": ARCH,
        "optimizer": {"gradient_clipping": 1.0},
        "learning_rate_scheduler": {"learning_rate": 0.01, "learning_rate_warmup_steps": 2,
                                    "learning_rate_decay_iters": 50},
        "trainer": {"train_iterations": 6, "seed": 7,
                    "save_dir": str(tmp / "ckpt") if save else None, "save_interval": 3,
                    "load_dir": None if load_dir is None else str(load_dir),
                    "eval_interval": 3, "eval_iterations": 2,
                    "delete_past_optimizer_states": False, **trainer},
        "data": {"data_prefixes": [data["a"], data["b"]],
                 "validation_data_prefixes": [data["valid"]]},
        "logger": {"log_dir": str(tmp / "logs")},
    }


def records(log_dir: Path):
    return [json.loads(line) for line in (log_dir / "metrics_rank_0.jsonl").read_text().splitlines()]


def losses_by_step(recs, key="loss"):
    return {r["step"]: r["metrics"][key] for r in recs if key in r["metrics"]}


def test_resume_from_step_3_repeats_steps_4_to_6_bitwise(data, tmp_path):
    first = main(TransformerConfig.from_dict(config_dict(data, tmp_path / "run")), device="cpu")
    assert first.context.iterations == 6 and first.context.consumed_samples == 24
    assert first.context.consumed_eval_samples == 8
    step3 = tmp_path / "run" / "ckpt" / "global_step3"
    assert (tmp_path / "run" / "ckpt" / "latest").read_text() == "global_step6"
    assert verify_checkpoint(step3) == []
    resumed = build_trainer(TransformerConfig.from_dict(
        config_dict(data, tmp_path / "resume", save=False, load_dir=step3)), device="cpu")
    assert resumed.context.iterations == 3 and resumed.context.consumed_samples == 12
    # the save at step 3 comes before that step's evaluation, as in JAX
    assert resumed.context.consumed_eval_samples == 0 and resumed.optimizer.state.step == 3
    # the resumed run's first batch is the first run's fourth
    replay = build_trainer(TransformerConfig.from_dict(
        config_dict(data, tmp_path / "replay", save=False)), device="cpu")
    for _ in range(3):
        replay._assemble_micro_batches()
    want, got = replay._assemble_micro_batches(), resumed._assemble_micro_batches()
    assert got.token_ids.shape == (2, 2, 32)
    np.testing.assert_array_equal(got.token_ids, want.token_ids)
    np.testing.assert_array_equal(got.loss_weights, want.loss_weights)

    resumed = main(TransformerConfig.from_dict(
        config_dict(data, tmp_path / "resume", save=False, load_dir=step3)), device="cpu")
    full = records(tmp_path / "run" / "logs")
    again = records(tmp_path / "resume" / "logs")
    for key in ("loss", "global_grad_norm"):
        want, got = losses_by_step(full, key), losses_by_step(again, key)
        assert got and all(step > 3 for step in got)
        assert got == {s: v for s, v in want.items() if s > 3}, key  # bitwise: floats compare ==


def test_step_records_carry_the_jax_trainers_fields(data, tmp_path):
    main(TransformerConfig.from_dict(config_dict(data, tmp_path, save=False, log_interval=4)),
         device="cpu")
    recs = records(tmp_path / "logs")
    steps = [r for r in recs if "loss" in r["metrics"]]
    # log_interval 4 fetches step 4 and the run's last, step 6
    assert [r["step"] for r in steps] == [4, 6]
    for r in steps:
        assert r["kind"] == "step" and r["host"] == 0 and isinstance(r["ts"], float)
        assert {"loss", "accuracy", "weight_decay_params", "no_weight_decay_params",
                "global_grad_norm", "step_duration", "tokens_per_second", "tflops_megatron",
                "tflops_bloom", "tflops_electra", "tflops_aleph_alpha"} <= set(r["metrics"])
        assert "palm_mfu" not in r["metrics"]  # a rate of the card's peak: not from a CPU run
    assert [r["step"] for r in recs if "eval_loss" in r["metrics"]] == [3, 6]


def flip_one_byte(path: Path) -> None:
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))


@pytest.fixture(scope="module")
def two_checkpoints(data, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two")
    main(TransformerConfig.from_dict(config_dict(data, tmp)), device="cpu")
    return tmp / "ckpt"


@pytest.mark.parametrize("strict", [False, True], ids=["fallback", "strict"])
def test_a_corrupted_checkpoint_is_skipped_or_refused(data, two_checkpoints, tmp_path, strict):
    import shutil

    ckpt = tmp_path / "ckpt"
    shutil.copytree(two_checkpoints, ckpt)
    flip_one_byte(ckpt / "global_step6" / "model_state_layer_1_TransformerLayer.npz")
    assert any("crc32" in p for p in verify_checkpoint(ckpt / "global_step6"))
    cfg = TransformerConfig.from_dict(config_dict(data, tmp_path, save=False, load_dir=ckpt,
                                                  strict_checkpoint_load=strict))
    if strict:
        with pytest.raises(CheckpointCorruptionError, match="global_step6"):
            build_trainer(cfg, device="cpu")
        return
    trainer = build_trainer(cfg, device="cpu")
    assert trainer.context.iterations == 3 and trainer.optimizer_states_loaded


def test_past_optimizer_states_are_pruned_and_the_checkpoint_still_loads(data, tmp_path):
    main(TransformerConfig.from_dict(config_dict(data, tmp_path,
                                                 delete_past_optimizer_states=True)),
         device="cpu")
    old = tmp_path / "ckpt" / "global_step3"
    assert not list(old.glob("optimizer_state_layer_*"))
    assert list((tmp_path / "ckpt" / "global_step6").glob("optimizer_state*"))
    assert verify_checkpoint(old) == []
    trainer = build_trainer(TransformerConfig.from_dict(
        config_dict(data, tmp_path / "r", save=False, load_dir=old)), device="cpu")
    assert trainer.context.iterations == 3 and not trainer.optimizer_states_loaded
    # the masters come from the loaded weights, the moments start at zero
    model = dict(trainer.module.model.named_parameters())
    for name, master in trainer.optimizer.state.master.items():
        assert torch.equal(master, model[name].detach().float())
        assert not trainer.optimizer.state.exp_avg[name].any()


def test_train_run_entry_point(data, tmp_path):
    """``python -m scaling_tpu_torch.train run <config.yml> --device cpu``
    trains in a subprocess; without ``--device cpu`` and without a card
    it raises instead of moving onto the CPU."""
    cfg = config_dict(data, tmp_path)
    cfg["trainer"].update(train_iterations=3, eval_interval=None)
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    proc = subprocess.run([sys.executable, "-m", "scaling_tpu_torch.train", "run", str(path),
                           "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "train run: device=cpu iterations=3 consumed_samples=12" in proc.stdout
    assert (tmp_path / "ckpt" / "global_step3" / "MANIFEST.json").is_file()
    if torch.cuda.is_available():
        return
    proc = subprocess.run([sys.executable, "-m", "scaling_tpu_torch.train", "run", str(path)],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "CUDA" in proc.stderr
    assert "train run:" not in proc.stdout


REFUSED = [
    ("trainer", "checkpoint_backend", "orbax"),
    ("trainer", "save_checkpoint_async", True),
    ("trainer", "multihost_shared_save_dir", True),
    ("trainer", "merge_lora_after_loading_checkpoint", True),
    ("trainer", "dataloader_prefetch_factor", 2),
    ("trainer", "max_consecutive_nonfinite", 3),
    ("trainer", "step_timeout_seconds", 30.0),
    ("data", "legacy_dataset", True),
    ("data", "finetuning_dataset", True),
    ("data", "finetuning_chat_dataset", True),
    ("data", "finetuning_dataset_memory_map", True),
    ("logger", "use_wandb", True),
    ("logger", "use_tensorboard", True),
    ("logger", "events_path", "events.jsonl"),
    ("profiler", "profile_steps", 2),
]


@pytest.mark.parametrize("section,key,value", REFUSED, ids=[f"{s}.{k}" for s, k, _ in REFUSED])
def test_keys_not_ported_raise_by_name(data, tmp_path, section, key, value):
    cfg = config_dict(data, tmp_path)
    cfg[section] = {**cfg.get(section, {}), key: value}
    with pytest.raises(NotImplementedError, match=key if section != "profiler" else "profiler"):
        TransformerConfig.from_dict(cfg)


@pytest.mark.parametrize("section", ["trainer", "data", "logger", "profiler"])
def test_unknown_keys_raise(data, tmp_path, section):
    cfg = config_dict(data, tmp_path)
    cfg[section] = {**cfg.get(section, {}), "surprise": 1}
    with pytest.raises(ValueError, match="surprise"):
        TransformerConfig.from_dict(cfg)


def test_sections_are_read_under_the_jax_names(data, tmp_path):
    cfg = config_dict(data, tmp_path)
    cfg["data"]["blended_dataset"] = {"weight_by_num_documents": False, "weights": [1.0, 3.0]}
    cfg["trainer"].update(dataloader_num_workers=4, dataloader_pin_memory=False)
    cfg["logger"].update(metrics_path=str(tmp_path / "m.jsonl"), wandb_project="x")
    config = TransformerConfig.from_dict(cfg)
    assert config.trainer.save_dir == str(tmp_path / "ckpt") and config.trainer.seed == 7
    assert config.seed == 7 and config.trainer.eval_iterations == 2
    assert config.data.data_prefixes == (data["a"], data["b"])
    assert config.data.blended_dataset.weights == [1.0, 3.0]
    assert config.logger.metrics_path == str(tmp_path / "m.jsonl")
    assert config.to_dict() == json.loads(json.dumps(cfg))


def test_serve_bench_serves_a_checkpoint(two_checkpoints, capsys):
    """``serve bench --checkpoint DIR`` serves the checkpoint ``latest``
    names, here step 6 of a trained toy model."""
    from scaling_tpu_torch.serve.bench import main as serve_main

    rc = serve_main(["--device", "cpu", "--checkpoint", str(two_checkpoints), "--requests", "3",
                     "--rate", "100", "--prompt-len", "3", "9", "--output-len", "2", "4",
                     "--num-slots", "2", "--block-size", "4", "--num-blocks", "32",
                     "--max-blocks-per-seq", "8"])
    out = capsys.readouterr().out
    assert rc == 0 and "completed=3" in out and f"model={two_checkpoints}" in out


@pytest.mark.parametrize("what", ["load_context", "load_optimizer_states"])
def test_load_switches_leave_their_part_fresh(data, two_checkpoints, tmp_path, what):
    """``load_context: false`` restarts the counters at 0 and
    ``load_optimizer_states: false`` starts the optimizer anew (masters
    from the loaded weights), each loading the rest as usual."""
    trainer = build_trainer(TransformerConfig.from_dict(config_dict(
        data, tmp_path, save=False, load_dir=two_checkpoints / "global_step3",
        **{what: False})), device="cpu")
    ctx, opt = trainer.context, trainer.optimizer.state
    if what == "load_context":
        assert (ctx.iterations, ctx.consumed_samples) == (0, 0) and opt.step == 3
    else:
        assert ctx.iterations == 3 and opt.step == 0 and not trainer.optimizer_states_loaded
        assert not any(t.any() for t in opt.exp_avg.values())


def test_a_missing_checkpoint_is_an_error_unless_allowed(data, tmp_path):
    cfg = config_dict(data, tmp_path, save=False, load_dir=tmp_path / "nothing")
    with pytest.raises(RuntimeError, match="could not load checkpoint"):
        build_trainer(TransformerConfig.from_dict(cfg), device="cpu")
    cfg["trainer"]["assert_checkpoint_loaded"] = False
    assert build_trainer(TransformerConfig.from_dict(cfg), device="cpu").context.iterations == 0
