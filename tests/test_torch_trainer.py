"""The port's Trainer on the CPU: resume, checkpoint verification, metric
records, the ``train run`` entry point, the config keys it refuses and the
observability keys it takes.

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
import signal
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

from .test_torch_parity_helpers import one_torch_thread  # noqa: F401

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
    """The step records of the run's metrics JSONL (the registry's
    snapshots share the file)."""
    lines = (log_dir / "metrics_rank_0.jsonl").read_text().splitlines()
    return [r for r in map(json.loads, lines) if r["kind"] == "step"]


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
    ("logger", "use_wandb", True),
]


@pytest.mark.parametrize("section,key,value", REFUSED, ids=[f"{s}.{k}" for s, k, _ in REFUSED])
def test_keys_not_ported_raise_by_name(data, tmp_path, section, key, value):
    cfg = config_dict(data, tmp_path)
    cfg[section] = {**cfg.get(section, {}), key: value}
    with pytest.raises(NotImplementedError, match=key if section != "profiler" else "profiler"):
        TransformerConfig.from_dict(cfg)


# refused until observability, then the supervisor's control plane, was
# ported; each now takes effect in a run
ACCEPTED = [
    ("logger", "use_tensorboard", True),
    ("logger", "events_path", "events.jsonl"),
    ("profiler", "profile_steps", 2),
    ("trainer", "multihost_shared_save_dir", True),
]


@pytest.mark.parametrize("section,key,value", ACCEPTED, ids=[f"{s}.{k}" for s, k, _ in ACCEPTED])
def test_observability_keys_are_accepted_and_take_effect(data, tmp_path, monkeypatch, section,
                                                        key, value):
    cfg = config_dict(data, tmp_path, save=False)
    cfg["trainer"]["train_iterations"] = 4
    if key == "events_path":
        value = str(tmp_path / value)
    cfg[section] = {**cfg.get(section, {}), key: value}
    if section == "profiler":
        cfg["profiler"].update(profile_start_at_step=1, profiler_output=str(tmp_path / "p.json"))
    config = TransformerConfig.from_dict(cfg)
    assert getattr(getattr(config, section), key) == value
    if key == "multihost_shared_save_dir":
        # a supervisor's environment: the trainer joins its control plane
        # and, host 0 of a shared tree, moves ``latest``
        for var, v in (("SCALING_TPU_CONTROL_DIR", str(tmp_path / "cp")),
                       ("SCALING_TPU_HOST_ID", "0"), ("SCALING_TPU_NUM_HOSTS", "1")):
            monkeypatch.setenv(var, v)
        cfg["trainer"].update(save_dir=str(tmp_path / "ckpt"), save_interval=2)
        config = TransformerConfig.from_dict(cfg)
        handler = signal.getsignal(signal.SIGTERM)
        try:
            trainer = main(config, device="cpu")
        finally:
            signal.signal(signal.SIGTERM, handler)
        assert trainer._cp_latest_leader and trainer._control_plane.num_hosts == 1
        assert (tmp_path / "ckpt" / "latest").read_text() == "global_step4"
        beat = json.loads((tmp_path / "cp" / "heartbeat" / "host0.json").read_text())
        assert (beat["step"], beat["status"]) == (4, "done")
        return
    main(config, device="cpu")
    if key == "use_tensorboard":
        assert list((tmp_path / "logs" / "tensorboard").glob("events.out.tfevents.*"))
    elif key == "events_path":
        spans = [json.loads(line) for line in Path(value).read_text().splitlines()]
        assert {"step.data", "step.fwdbwd", "step.sync", "trainer.eval"} <= {
            e.get("span") for e in spans}
    else:
        assert [o["step"] for o in json.loads((tmp_path / "p.json").read_text())] == [1, 2]


# refused until the finetuning slice was ported; each now takes effect in a run
FINETUNE_ACCEPTED = [
    ("trainer", "merge_lora_after_loading_checkpoint", True),
    ("data", "finetuning_dataset", True),
    ("data", "finetuning_chat_dataset", True),
    ("data", "finetuning_dataset_memory_map", True),
]
LORA = {"name": "lora", "rank": 4, "alpha": 8}


def finetuning_files(root: Path) -> dict:
    """The byte-level tokenizer's vocab, a prompt/completion jsonl, its
    memory map (``[len_prompt, prompt..., completion...]`` records) and a
    chat jsonl, from seed 0."""
    from scaling_tpu_torch.models.transformer.tokenizer import Tokenizer

    tok = Tokenizer.default()
    vocab = root / "vocab.json"
    vocab.write_text(tok.tokenizer.to_str())
    rng = np.random.default_rng(0)
    words = ["sky", "blue", "grass", "green", "cat", "four", "bee", "honey"]
    pairs = [(" ".join(rng.choice(words, 3)), " " + str(rng.choice(words))) for _ in range(12)]
    (root / "text.jsonl").write_text("\n".join(
        json.dumps({"prompt": p, "completion": c}) for p, c in pairs))
    with MemoryMapDatasetBuilder(root / "text_mmap", dtype=np.uint16) as builder:
        for p, c in pairs:
            ids = tok.encode(p)
            builder.add(np.array([len(ids)] + ids + tok.encode(c), dtype=np.uint16))
    (root / "chat.jsonl").write_text("\n".join(json.dumps([
        {"type": "text", "content": f"Q: {p}\nA:", "has_loss": False},
        {"type": "text", "content": f"{c}<|endoftext|>", "has_loss": True}]) for p, c in pairs))
    return {"vocab": str(vocab), "text": str(root / "text.jsonl"),
            "text_mmap": str(root / "text_mmap"), "chat": str(root / "chat.jsonl")}


@pytest.mark.parametrize("section,key,value", FINETUNE_ACCEPTED,
                         ids=[f"{s}.{k}" for s, k, _ in FINETUNE_ACCEPTED])
def test_finetuning_keys_are_accepted_and_take_effect(data, tmp_path, section, key, value):
    """The finetuning datasets feed a LoRA finetune (the trainer reads the
    dataset the key names, its loss weights mask the prompt); the LoRA
    merge folds a trained LoRA checkpoint into the base weights on load:
    ``B`` zero, the logits those of the unmerged model (atol 1e-5, f32),
    the optimizer fresh from the merged weights."""
    from scaling_tpu_torch.models.transformer.data import (
        FinetuningChatDataset,
        FinetuningTextDataset,
    )

    cfg = config_dict(data, tmp_path, train_iterations=3)
    cfg["transformer_architecture"] = dict(ARCH, lora_config=LORA)
    cfg["training"] = {"finetune": True}
    if section == "data":
        files = finetuning_files(tmp_path)
        cfg["transformer_architecture"].update(vocab_size=257, vocab_file=files["vocab"])
        prefix = {"finetuning_dataset": "text", "finetuning_chat_dataset": "chat",
                  "finetuning_dataset_memory_map": "text_mmap"}[key]
        cfg["data"] = {key: value, "data_prefixes": [files[prefix]]}
        if key == "finetuning_dataset_memory_map":
            cfg["data"]["finetuning_dataset"] = True
        cfg["trainer"].update(eval_interval=None, save_dir=None)
    trainer = main(TransformerConfig.from_dict(cfg), device="cpu")
    losses = list(losses_by_step(records(tmp_path / "logs")).values())
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    if section == "data":
        assert getattr(trainer.context.config.data, key) == value
        expected = FinetuningChatDataset if key == "finetuning_chat_dataset" else \
            FinetuningTextDataset
        assert isinstance(trainer.dataset, expected)
        assert trainer.dataset.memory_map_dataset == (key == "finetuning_dataset_memory_map") \
            if expected is FinetuningTextDataset else True
        item = trainer.dataset[0]
        assert item.loss_weights[0] == 0 and item.loss_weights.sum() > 0
        return
    model = trainer.module.model
    lora_b = model.layers["layer_1"].attention.query_lora.lora_b
    assert lora_b.abs().sum() > 0  # the finetune moved B
    tokens = torch.from_numpy(np.random.default_rng(1).integers(1, 96, size=(2, 16)))
    model.eval()
    with torch.no_grad():
        unmerged = model.layers["layer_4"](model.layers["layer_3"](model.layers["layer_2"](
            model.layers["layer_1"](model.embedding(tokens), torch.arange(16)[None]),
            torch.arange(16)[None])))
    cfg["trainer"].update(load_dir=cfg["trainer"]["save_dir"], save_dir=None, **{key: value})
    merged = build_trainer(TransformerConfig.from_dict(cfg), device="cpu")
    assert merged.config.merge_lora_after_loading_checkpoint
    assert not merged.optimizer_states_loaded
    m = merged.module.model
    for layer in m.transformer_layers:
        for name in ("query_lora", "key_lora", "value_lora", "dense_lora"):
            assert not getattr(layer.attention, name).lora_b.any()
    assert not torch.equal(m.layers["layer_1"].attention.query.weight,
                           model.layers["layer_1"].attention.query.weight)
    for n, t in merged.optimizer.state.master.items():
        assert torch.equal(t, dict(m.named_parameters())[n].float()), n
    m.eval()
    with torch.no_grad():
        out = m.layers["layer_4"](m.layers["layer_3"](m.layers["layer_2"](
            m.layers["layer_1"](m.embedding(tokens), torch.arange(16)[None]),
            torch.arange(16)[None])))
    np.testing.assert_allclose(out.numpy(), unmerged.numpy(), atol=1e-5)


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
