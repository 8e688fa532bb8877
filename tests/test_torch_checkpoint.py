"""Checkpoints cross between the packages.

The same token datasets (numpy documents from a seed) feed a toy
rms/swiglu model (hidden 64, 2 layers, 4 query / 2 KV heads, vocab 96,
seq 32, f32) in both packages, through each package's own training
entry (``main``, the trainer, its checkpoints):

- JAX -> port: the JAX trainer trains 3 steps and saves; the port's
  trainer loads that checkpoint (parameters and f32 optimizer state equal
  the JAX ones exactly, after the transpose; step and context too), then
  both train 3 more steps on the same batches: losses and grad norms
  within rtol 1e-4, the tolerance of ``test_torch_train.py``;
- port -> JAX: the port trains 3 steps and saves; the JAX trainer loads it
  with manifest verification on and no allowed missing keys, and its
  parameters and optimizer state equal the port's; a frozen parameter's
  ``(0,)`` placeholders load on both sides; the JAX inference module
  reads the port's ``config.yml`` and its weights;
- the JAX engine and the port's engine serve the port's checkpoint with
  the same greedy tokens.
"""

import numpy as np
import pytest
import yaml

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from scaling_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from scaling_tpu.models.transformer.context import TransformerContext as JaxContext  # noqa: E402
from scaling_tpu.models.transformer.inference import (  # noqa: E402
    TransformerInferenceModule as JaxInference,
)
from scaling_tpu.models.transformer.model import init_model as jax_init_model  # noqa: E402
from scaling_tpu.models.transformer.model import init_optimizer as jax_init_optimizer  # noqa: E402
from scaling_tpu.models.transformer.model import loss_function as jax_loss  # noqa: E402
from scaling_tpu.models.transformer.train import TransformerTrainer as JaxTrainer  # noqa: E402
from scaling_tpu.models.transformer.train import _read_dataset as jax_read_dataset  # noqa: E402
from scaling_tpu.models.transformer.train import batch_to_model_input as jax_to_input  # noqa: E402
from scaling_tpu.models.transformer.train import main as jax_main  # noqa: E402
from scaling_tpu.ops.rms_norm import force_rms_interpret  # noqa: E402
from scaling_tpu.serve.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from scaling_tpu.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from scaling_tpu.topology import Topology  # noqa: E402
from scaling_tpu.checkpoint.checkpoint import enforce_allow_lists as jax_enforce  # noqa: E402
from scaling_tpu_torch.checkpoint import enforce_allow_lists, load_model_checkpoint  # noqa: E402
from scaling_tpu_torch.data import MemoryMapDatasetBuilder  # noqa: E402
from scaling_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig,
    TransformerInferenceModule,
)
from scaling_tpu_torch.models.transformer.convert import params_from_jax  # noqa: E402
from scaling_tpu_torch.models.transformer.train import build_trainer  # noqa: E402
from scaling_tpu_torch.models.transformer.train import main as port_main  # noqa: E402
from scaling_tpu_torch.serve import EngineConfig, ServeEngine  # noqa: E402

ARCH = {
    "vocab_size": 96, "hidden_size": 64, "num_layers": 2, "num_attention_heads": 4,
    "attention_num_kv_heads": 2, "attention_qkv_in_one": False, "sequence_length": 32,
    "precision": "float32", "mlp_type": "swiglu", "mlp_factor": 2.0, "norm_type": "rms",
    "layernorm": {"optimization_type": "fused"}, "weight_tying": False,
}
RTOL = 1e-4


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokens")
    rng = np.random.default_rng(17)
    prefixes = []
    for name, docs in (("a", 48), ("b", 24)):
        with MemoryMapDatasetBuilder(root / name, dtype=np.uint16) as builder:
            for _ in range(docs):
                builder.add(np.append(rng.integers(1, 96, size=rng.integers(8, 80)), 0))
        prefixes.append(str(root / name))
    return prefixes


def config_dict(data, save_dir=None, load_dir=None, iterations=3, **trainer):
    return {
        "topology": {"model_parallel_size": 1, "pipe_parallel_size": 1,
                     "data_parallel_size": 1, "micro_batch_size": 2,
                     "gradient_accumulation_steps": 2},
        "transformer_architecture": ARCH,
        "optimizer": {"gradient_clipping": 1.0},
        "learning_rate_scheduler": {"learning_rate": 0.01, "learning_rate_warmup_steps": 2,
                                    "learning_rate_decay_iters": 50},
        "trainer": {"train_iterations": iterations, "seed": 42,
                    "save_dir": None if save_dir is None else str(save_dir),
                    "save_interval": 3, "load_dir": None if load_dir is None else str(load_dir),
                    "assert_checkpoint_loaded": load_dir is not None,
                    "delete_past_optimizer_states": False, **trainer},
        "data": {"data_prefixes": data},
        "logger": {"log_dir": None},
    }


def jax_trainer(cfg: dict, load: bool):
    """The JAX ``main``'s trainer, initialised, without its training run."""
    config = JaxConfig.from_dict(cfg)
    topology = Topology(config.topology)
    module = jax_init_model(config, topology)
    trainer = JaxTrainer(config=config.trainer, context=JaxContext(config=config, topology=topology),
                         parallel_module=module,
                         optimizer=jax_init_optimizer(config, module, topology),
                         loss_function=jax_loss, dataset=jax_read_dataset(
                             config, config.data.data_prefixes),
                         batch_to_model_input=jax_to_input)
    trainer.initialize(load_checkpoint=load)
    return trainer


def port_state(trainer):
    """The port trainer's parameters and optimizer fields, as numpy."""
    opt = trainer.optimizer.state
    return ({n: p.detach().numpy().copy() for n, p in trainer.module.model.named_parameters()},
            {f: {n: t.numpy().copy() for n, t in getattr(opt, f).items()}
             for f in ("master", "exp_avg", "exp_avg_sq")})


def jax_state(trainer, arch):
    """The JAX trainer's parameters and optimizer fields under the port's
    names and layouts (frozen parameters' (0,) placeholders dropped)."""
    def port_layout(tree):
        return {n: t.numpy() for n, t in params_from_jax(jax.tree.map(np.asarray, tree),
                                                          arch).items() if t.numel()}

    params = port_layout(trainer.params)
    opt = {f: port_layout(getattr(trainer.opt_state, f))
           for f in ("master", "exp_avg", "exp_avg_sq")}
    return params, opt


def assert_states_equal(port, ref):
    port_params, port_opt = port
    ref_params, ref_opt = ref
    assert port_params.keys() == ref_params.keys()
    for name, value in ref_params.items():
        np.testing.assert_array_equal(port_params[name], value, err_msg=name)
    for field, tensors in ref_opt.items():
        assert port_opt[field].keys() == tensors.keys(), field
        for name, value in tensors.items():
            np.testing.assert_array_equal(port_opt[field][name], value, err_msg=f"{field} {name}")


def continue_jax(trainer, steps):
    outs = [trainer.train_step() for _ in range(steps)]
    return [o.loss for o in outs], [o.global_grad_norm for o in outs]


def continue_port(trainer, steps):
    outs = [trainer.train_step() for _ in range(steps)]
    return [o.loss for o in outs], [o.global_grad_norm for o in outs]


def test_jax_checkpoint_resumes_in_the_port(data, tmp_path):
    with force_rms_interpret():
        jax_run = jax_main(JaxConfig.from_dict(config_dict(data, tmp_path / "jax")))
    assert (tmp_path / "jax" / "latest").read_text() == "global_step3"
    # the config.yml the JAX trainer dumps: every key, at its value
    dumped = yaml.safe_load((tmp_path / "jax" / "global_step3" / "config.yml").read_text())
    assert "profiler" in dumped and "checkpoint_backend" in dumped["trainer"]
    config = TransformerConfig.from_dict(dumped)
    assert config.trainer.save_interval == 3 and config.data.data_prefixes == tuple(data)
    served = TransformerInferenceModule.from_checkpoint(tmp_path / "jax", device="cpu")
    cfg = config_dict(data, load_dir=tmp_path / "jax", iterations=6)
    port = build_trainer(TransformerConfig.from_dict(cfg), device="cpu")
    arch = port.context.config.transformer_architecture
    assert port.context.iterations == 3 and port.context.consumed_samples == 12
    assert port.optimizer.state.step == int(jax_run.opt_state.step) == 3
    assert port.optimizer_states_loaded
    assert_states_equal(port_state(port), jax_state(jax_run, arch))
    for name, p in served.model.named_parameters():
        assert torch.equal(p, dict(port.module.model.named_parameters())[name]), name
    with force_rms_interpret():
        ref_losses, ref_norms = continue_jax(jax_run, 3)
    losses, norms = continue_port(port, 3)
    np.testing.assert_allclose(losses, ref_losses, rtol=RTOL)
    np.testing.assert_allclose(norms, ref_norms, rtol=RTOL)


@pytest.mark.parametrize("frozen", [False, True], ids=["all_trained", "head_frozen"])
def test_port_checkpoint_loads_in_jax(data, tmp_path, frozen):
    """With ``training.parameters_exclude`` the head is frozen: no
    optimizer state in either package, (0,) placeholders on disk."""
    cfg = config_dict(data, tmp_path / "port")
    if frozen:
        cfg["training"] = {"parameters_exclude": ["TransformerLMHead"]}
    port = port_main(TransformerConfig.from_dict(cfg), device="cpu")
    step_dir = tmp_path / "port" / "global_step3"
    assert sorted(p.name for p in step_dir.glob("model_state_layer_*")) == [
        "model_state_layer_0_EmbeddingInput.npz", "model_state_layer_1_TransformerLayer.npz",
        "model_state_layer_2_TransformerLayer.npz", "model_state_layer_3_LayerNormWrapper.npz",
        "model_state_layer_4_TransformerLMHead.npz"]
    with np.load(step_dir / "optimizer_state_layer_4.npz") as z:
        assert (z["master.linear.weight"].shape == (0,)) == frozen
    jax_cfg = config_dict(data, load_dir=tmp_path / "port")
    if frozen:
        jax_cfg["training"] = cfg["training"]
    with force_rms_interpret():
        ref = jax_trainer(jax_cfg, load=True)
    assert ref.context.iterations == 3 and ref.context.consumed_samples == 12
    assert int(ref.opt_state.step) == 3 and ref.optimizer_states_loaded
    arch = port.context.config.transformer_architecture
    assert_states_equal(port_state(port), jax_state(ref, arch))
    inf = JaxInference.from_checkpoint(tmp_path / "port")
    assert inf.architecture.hidden_size == ARCH["hidden_size"]
    params = params_from_jax(jax.tree.map(np.asarray, inf.params), arch)
    for name, p in port.module.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), params[name].numpy(), err_msg=name)


def test_port_config_yml_reads_back_in_both_packages(data, tmp_path):
    port_main(TransformerConfig.from_dict(config_dict(data, tmp_path / "port")), device="cpu")
    loaded = yaml.safe_load((tmp_path / "port" / "global_step3" / "config.yml").read_text())
    jax_cfg = JaxConfig.from_dict(loaded)
    assert jax_cfg.trainer.save_interval == 3 and jax_cfg.optimizer.gradient_clipping == 1.0
    assert TransformerConfig.from_dict(loaded).to_dict() == loaded


def test_checkpoint_serves_the_same_greedy_tokens_in_both_engines(data, tmp_path):
    port_main(TransformerConfig.from_dict(config_dict(data, tmp_path / "port")), device="cpu")
    port_inf = TransformerInferenceModule.from_checkpoint(tmp_path / "port", device="cpu")
    jax_inf = JaxInference.from_checkpoint(tmp_path / "port")
    rng = np.random.default_rng(3)
    work = [(rng.integers(1, 96, size=int(rng.integers(3, 21))).tolist(), 6) for _ in range(5)]
    engine_cfg = dict(num_slots=4, block_size=4, num_blocks=64, max_blocks_per_seq=16,
                      token_budget=64, prefill_chunk=8)
    port_engine = ServeEngine(port_inf, EngineConfig(**engine_cfg), device="cpu")
    with force_rms_interpret():
        jax_engine = JaxEngine(jax_inf, JaxEngineConfig(**engine_cfg))
        for prompt, n in work:
            jax_engine.submit(prompt, n)
        ref = {s.request.req_id: list(s.generated) for s in jax_engine.run_until_done()}
    for prompt, n in work:
        port_engine.submit(prompt, n)
    got = {s.request.req_id: list(s.generated) for s in port_engine.run_until_done()}
    assert got == ref and all(len(t) == 6 for t in got.values())
    assert port_inf.model.lm_head.linear.weight.dtype == torch.float32


def test_port_weights_round_trip_in_bf16(data, tmp_path):
    """bf16 weights go to disk as f32 and come back exactly."""
    arch = dict(ARCH, precision="bfloat16")
    cfg = config_dict(data, tmp_path / "bf16")
    cfg["transformer_architecture"] = arch
    trainer = port_main(TransformerConfig.from_dict(cfg), device="cpu")
    with np.load(tmp_path / "bf16" / "global_step3" /
                 "model_state_layer_1_TransformerLayer.npz") as z:
        assert all(z[k].dtype == np.float32 for k in z.files)
    inf = TransformerInferenceModule.from_checkpoint(tmp_path / "bf16", device="cpu")
    for (name, p), (_, q) in zip(trainer.module.model.named_parameters(),
                                 inf.model.named_parameters()):
        assert q.dtype == torch.bfloat16 and torch.equal(p, q), name


ALLOW_CASES = {  # model keys, checkpoint keys, allowed missing, allowed unexpected
    "equal": ({"a.w", "b.w"}, {"a.w", "b.w"}, [], []),
    "missing": ({"a.w", "lora.w"}, {"a.w"}, [], []),
    "missing_allowed": ({"a.w", "lora.w"}, {"a.w"}, [r"lora\."], []),
    "unexpected": ({"a.w"}, {"a.w", "old.w"}, [], []),
    "unexpected_allowed": ({"a.w"}, {"a.w", "old.w"}, [], [r"^old"]),
}


@pytest.mark.parametrize("case", list(ALLOW_CASES))
def test_allow_lists_decide_as_the_jax_package_does(case):
    import re

    model, available, missing, unexpected = ALLOW_CASES[case]
    outcomes = []
    for fn in (enforce_allow_lists, jax_enforce):
        try:
            fn(model, available, [re.compile(p) for p in missing],
               [re.compile(p) for p in unexpected])
            outcomes.append("ok")
        except KeyError as e:
            outcomes.append(str(e).split(":")[0])
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] == "ok") == (case in ("equal", "missing_allowed", "unexpected_allowed"))


def test_ignore_keys_keep_the_current_values(data, tmp_path):
    """``ignore_keys_in_checkpoint`` re-initialises what it matches; an
    extra model key needs ``allowed_missing_keys_in_checkpoint``."""
    trainer = port_main(TransformerConfig.from_dict(config_dict(data, tmp_path / "port")),
                        device="cpu")
    keys = trainer.module.ckpt_keys()
    params = {keys[n]: p.detach().clone() for n, p in trainer.module.model.named_parameters()}
    fresh = {k: torch.zeros_like(v) for k, v in params.items()}
    restored = set()
    load_model_checkpoint(tmp_path / "port" / "global_step3", fresh,
                          ignore_keys=["TransformerLMHead"], restored_keys=restored)
    for key, value in fresh.items():
        ignored = "TransformerLMHead" in key
        assert (key in restored) != ignored
        assert torch.equal(value, torch.zeros_like(value) if ignored else params[key]), key
    extra = {**fresh, "layer_9_Adapter.w": torch.zeros(2)}
    with pytest.raises(KeyError, match="missing"):
        load_model_checkpoint(tmp_path / "port" / "global_step3", extra)
    load_model_checkpoint(tmp_path / "port" / "global_step3", extra,
                          allowed_missing_keys=["Adapter"])


# the JAX default architecture with a tied head and key/query norm
TIED_ARCH = {"vocab_size": 96, "hidden_size": 64, "num_layers": 2, "num_attention_heads": 4,
             "sequence_length": 32, "precision": "float32", "weight_tying": True,
             "key_query_norm": True}


def test_tied_checkpoint_crosses_both_ways(data, tmp_path):
    """A tied, layernorm, GELU-MLP model: the port writes the table once,
    under ``layer_0_EmbeddingInput`` (no head layer file), and the JAX
    trainer loads it with verification on, state for state; a JAX
    checkpoint of the same model resumes in the port the same way."""
    cfg = config_dict(data, tmp_path / "port")
    cfg["transformer_architecture"] = TIED_ARCH
    port = port_main(TransformerConfig.from_dict(cfg), device="cpu")
    step_dir = tmp_path / "port" / "global_step3"
    assert sorted(p.name for p in step_dir.glob("model_state_layer_*")) == [
        "model_state_layer_0_EmbeddingInput.npz", "model_state_layer_1_TransformerLayer.npz",
        "model_state_layer_2_TransformerLayer.npz", "model_state_layer_3_LayerNormWrapper.npz"]
    jax_cfg = config_dict(data, load_dir=tmp_path / "port")
    jax_cfg["transformer_architecture"] = TIED_ARCH
    ref = jax_trainer(jax_cfg, load=True)
    assert int(ref.opt_state.step) == 3 and ref.optimizer_states_loaded
    arch = port.context.config.transformer_architecture
    assert_states_equal(port_state(port), jax_state(ref, arch))

    jax_main(JaxConfig.from_dict({**jax_cfg, "trainer": {
        **jax_cfg["trainer"], "load_dir": None, "assert_checkpoint_loaded": False,
        "save_dir": str(tmp_path / "jax")}}))
    resumed = build_trainer(TransformerConfig.from_dict({**cfg, "trainer": {
        **cfg["trainer"], "save_dir": None, "load_dir": str(tmp_path / "jax"),
        "assert_checkpoint_loaded": True}}), device="cpu")
    assert resumed.optimizer_states_loaded and resumed.context.iterations == 3


def test_port_stamps_the_jax_config_digest_or_none(tmp_path):
    """Fault 3: for the example config the manifest's fingerprint is JAX's
    digest (sha256 of its full config dump) or none, never a digest of
    something else, which would make a JAX resume warn for no reason."""
    import hashlib
    import json
    from pathlib import Path

    example = Path(__file__).resolve().parent.parent / "examples" / "transformer_example"
    d = yaml.safe_load((example / "config.yml").read_text())
    d["data"]["data_prefixes"] = [str(example / "data" / "example")]
    d["trainer"].update(save_dir=str(tmp_path / "ckpt"), train_iterations=1, save_interval=1)
    port_main(TransformerConfig.from_dict(d), device="cpu")
    manifest = json.loads((tmp_path / "ckpt" / "global_step1" / "MANIFEST.json").read_text())
    dump = JaxConfig.from_dict(d).model_dump(mode="json")
    jax_digest = hashlib.sha256(json.dumps(dump, sort_keys=True, default=str)
                                .encode()).hexdigest()[:16]
    assert manifest["config_fingerprint"] in (None, jax_digest)


def test_a_port_resume_under_a_changed_config_warns(data, tmp_path, monkeypatch):
    """Fault 3: where the JAX trainer warns that the config fingerprint
    changed since the save, the port warns too (here a new learning rate);
    the config the checkpoint was saved with loads silently."""
    from scaling_tpu_torch.logging import Logger

    warnings = []
    monkeypatch.setattr(Logger, "warning", lambda self, msg: warnings.append(str(msg)))
    port_main(TransformerConfig.from_dict(config_dict(data, tmp_path / "ckpt")), device="cpu")
    step_dir = tmp_path / "ckpt" / "global_step3"
    saved = yaml.safe_load((step_dir / "config.yml").read_text())
    build_trainer(TransformerConfig.from_dict(saved), device="cpu").load_checkpoint(step_dir)
    assert not [w for w in warnings if "config changed" in w], warnings
    saved["learning_rate_scheduler"]["learning_rate"] = 0.02
    build_trainer(TransformerConfig.from_dict(saved), device="cpu").load_checkpoint(step_dir)
    assert any("config changed since global_step3" in w for w in warnings), warnings


def test_legacy_per_field_optimizer_files_resume_with_their_moments(data, tmp_path):
    """Fault 4: a checkpoint in the older layout, one
    ``optimizer_state_layer_{i}_{field}.npz`` per layer and field keyed by
    the bare parameter name (written here from a fresh port checkpoint,
    without a manifest, as such checkpoints predate it), resumes with its
    masters and Adam moments bitwise, as the JAX loader reads it."""
    import shutil

    port_main(TransformerConfig.from_dict(config_dict(data, tmp_path / "ckpt")), device="cpu")
    src = tmp_path / "ckpt" / "global_step3"
    legacy = tmp_path / "legacy" / "global_step3"
    shutil.copytree(src, legacy)
    (legacy / "MANIFEST.json").unlink()
    (legacy.parent / "latest").write_text("global_step3")
    for f in sorted(legacy.glob("optimizer_state_layer_*.npz")):
        with np.load(f) as z:
            fields = {field: {k.split(".", 1)[1]: z[k] for k in z.files
                              if k.startswith(field + ".")}
                      for field in ("master", "exp_avg", "exp_avg_sq")}
        f.unlink()
        for field, arrays in fields.items():
            np.savez(legacy / f"{f.stem}_{field}.npz", **arrays)
    reference = build_trainer(TransformerConfig.from_dict(
        config_dict(data, load_dir=tmp_path / "ckpt")), device="cpu")
    resumed = build_trainer(TransformerConfig.from_dict(
        config_dict(data, load_dir=tmp_path / "legacy")), device="cpu")
    assert resumed.optimizer_states_loaded and resumed.optimizer.state.step == 3
    assert_states_equal(port_state(resumed), port_state(reference))
    assert any(t.abs().sum() > 0 for t in resumed.optimizer.state.exp_avg.values())
