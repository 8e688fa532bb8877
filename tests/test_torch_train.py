"""The training slice end to end: the JAX ``build_train_step`` and the
port's train step on the same weights and batches.

The JAX model (f32, flash attention, fused RMSNorm, GQA with head dim 64)
gets random weights drawn with numpy; ``params_from_jax`` carries them
into the port. JAX runs its Pallas kernels as its own tests do on the CPU
(splash inside ``force_flash_interpret``, the norm inside
``force_rms_interpret``, both spanning the gradient tracing); the port
runs on the CPU, i.e. through the kernels' plain versions, behind the
same autograd Functions the card runs. The flash gate sends f32 layers
unfused (K4/K5 take bf16 only); these tests hold the flash path itself in
f32, so the gate routes here by shape alone (``route_flash_as_bf16``).

Checked, with these tolerances:
- the first step's gradient of every parameter against ``jax.grad`` of
  ``loss_function`` after ``module.forward``: atol 5e-4 (the JAX
  package's flash-grad tolerance);
- the losses and global grad norms of 3 steps: rtol 1e-4;
- the parameters after 3 steps: Adam's first steps move a parameter by
  about ``lr * sign(g)``, so an f32 rounding difference in a gradient
  near 0 can flip a sign and move it by up to ``2 * lr`` a step. Every
  element stays within twice the sum of the steps' learning rates, and
  99.9 % of them within 1e-6;
- the same with ``gradient_accumulation_steps`` 2 and with
  ``activation_checkpointing_type: every_layer``, which must also give
  the plain run's loss (rtol 1e-5: the same tokens in a different split,
  the same arithmetic recomputed).
One of the batches packs three documents per row (segment ids).

A second model has head dim 96, which K4/K5 are not built for: its layer
takes the unfused path (as the JAX package does off the TPU at every
head dim), and 2 steps of it match JAX ``build_train_step`` on carried
weights, losses and grad norms at rtol 1e-4.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from scaling_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from scaling_tpu.models.transformer.model import init_model as jax_init_model  # noqa: E402
from scaling_tpu.models.transformer.model import init_optimizer as jax_init_optimizer  # noqa: E402
from scaling_tpu.models.transformer.model import loss_function as jax_loss  # noqa: E402
from scaling_tpu.ops.flash_attention import force_flash_interpret  # noqa: E402
from scaling_tpu.ops.rms_norm import force_rms_interpret  # noqa: E402
from scaling_tpu.topology import Topology  # noqa: E402
from scaling_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig,
    TransformerModel,
    init_optimizer,
    loss_function,
)
from scaling_tpu_torch.models.transformer.convert import params_from_jax  # noqa: E402
from scaling_tpu_torch.ops import launches  # noqa: E402
from scaling_tpu_torch.parallel import ParallelModule  # noqa: E402

from .test_torch_parity_helpers import route_flash_as_bf16  # noqa: E402
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401

ARCH = {
    "vocab_size": 128, "hidden_size": 256, "num_layers": 2, "num_attention_heads": 4,
    "attention_num_kv_heads": 2, "attention_qkv_in_one": False, "sequence_length": 128,
    "precision": "float32", "mlp_type": "swiglu", "mlp_factor": 2.75, "norm_type": "rms",
    "layernorm": {"optimization_type": "fused"},
    "masked_softmax": {"kernel": "flash_attention"}, "weight_tying": False,
}
ARCH_D96 = dict(ARCH, hidden_size=384)  # 4 heads of dim 96
SEQ, STEPS, LR_PEAK, WARMUP = 128, 3, 3e-3, 10
RUNS = {  # micro-batch size, gas, activation checkpointing
    "plain": (4, 1, "disabled"),
    "gas2": (2, 2, "disabled"),
    "every_layer": (4, 1, "every_layer"),
}


def config_dict(mbs, gas, ckpt, arch=ARCH):
    return {
        "topology": {"model_parallel_size": 1, "pipe_parallel_size": 1,
                     "data_parallel_size": 1, "micro_batch_size": mbs,
                     "gradient_accumulation_steps": gas,
                     "activation_checkpointing_type": ckpt},
        "transformer_architecture": arch,
        "optimizer": {"gradient_clipping": 1.0, "loss_scaler": {"enable": False}},
        "learning_rate_scheduler": {"learning_rate": LR_PEAK,
                                    "learning_rate_warmup_steps": WARMUP,
                                    "learning_rate_decay_iters": 1000},
        "trainer": {"seed": 0},
    }


@pytest.fixture(autouse=True)
def flash_route_in_f32(monkeypatch):
    route_flash_as_bf16(monkeypatch)


def random_params(template, rng):
    """Numpy weights shaped like the JAX tree: xavier-scaled matrices,
    small nonzero biases, norm gains near 1."""
    def draw(path, leaf):
        shape = leaf.shape
        if len(shape) == 2:
            return (rng.normal(size=shape) * np.sqrt(2.0 / sum(shape))).astype(np.float32)
        if "norm" in jax.tree_util.keystr(path):
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.02 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, template)


def batches(mbs, gas):
    """STEPS batches of gas x mbs rows (bench.py:synth_batch), the second
    with three packed documents per row."""
    rng = np.random.default_rng(7)
    out = []
    for i in range(STEPS):
        tokens = rng.integers(1, ARCH["vocab_size"], size=(gas * mbs, SEQ))
        seg = np.zeros((gas * mbs, SEQ), np.int32)
        if i == 1:
            seg[:, 40:] = 1
            seg[:, 97:] = 2
        b = {"token_ids": tokens, "target_token_ids": np.roll(tokens, -1, axis=-1),
             "position_ids": np.broadcast_to(np.arange(SEQ), (gas * mbs, SEQ)),
             "segment_ids": seg,
             # weights vary along the sequence, alike in every row: each
             # micro-batch has the same total weight, so the mean over
             # micro-batches is the mean over the whole batch
             "loss_weights": np.broadcast_to(rng.uniform(0.5, 1.5, size=SEQ),
                                             (gas * mbs, SEQ))}
        out.append({k: v.reshape(gas, mbs, SEQ) for k, v in b.items()})
    return out


def jax_batch(b):
    dtypes = {"loss_weights": jnp.float32}
    return {k: jnp.asarray(v, dtypes.get(k, jnp.int32)) for k, v in b.items()}


def torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        torch.float32 if k == "loss_weights" else
        torch.int64 if "token" in k else torch.int32) for k, v in b.items()}


def draw_weights(arch):
    config = JaxConfig.from_dict(config_dict(*RUNS["plain"], arch=arch))
    module = jax_init_model(config, None)
    return random_params(jax.tree.map(np.asarray, module.init_params(jax.random.PRNGKey(0))),
                         np.random.default_rng(0))


@pytest.fixture(scope="module")
def weights():
    return draw_weights(ARCH)


def port_module(np_params, run, arch=ARCH):
    config = TransformerConfig.from_dict(config_dict(*RUNS[run], arch=arch))
    model = TransformerModel(config.transformer_architecture)
    model.load_state_dict(params_from_jax(np_params, config.transformer_architecture))
    return config, ParallelModule(model, config.topology)


def jax_train(np_params, run, arch=ARCH, steps=STEPS):
    config = JaxConfig.from_dict(config_dict(*RUNS[run], arch=arch))
    topology = Topology(config.topology)
    module = jax_init_model(config, topology)
    optimizer = jax_init_optimizer(config, module, topology)
    params = jax.tree.map(jnp.asarray, np_params)
    losses, norms = [], []
    with force_flash_interpret(), force_rms_interpret():
        state = optimizer.init_state(params)
        step = module.build_train_step(optimizer, jax_loss, donate=False)
        for b in batches(*RUNS[run][:2])[:steps]:
            params, state, loss, _, out = step(params, state, jax_batch(b),
                                               jax.random.PRNGKey(0))
            losses.append(float(loss))
            norms.append(float(out.global_grad_norm))
    return losses, norms, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_runs(weights):
    return {run: jax_train(weights, run) for run in RUNS}


def test_first_step_gradients_match_jax(weights):
    config = JaxConfig.from_dict(config_dict(*RUNS["plain"]))
    module = jax_init_model(config, None)
    b = {k: v[0] for k, v in batches(4, 1)[1].items()}  # the packed batch

    def loss(params):
        ctx = module._make_ctx(deterministic=False, dropout_key=jax.random.PRNGKey(0))
        return jax_loss(module.forward(params, jax_batch(b), ctx), jax_batch(b))[0]

    with force_flash_interpret(), force_rms_interpret():
        ref = jax.grad(loss)(jax.tree.map(jnp.asarray, weights))
    port_cfg, module_t = port_module(weights, "plain")
    launches.reset()
    module_t.model.train()
    tb = torch_batch(b)
    loss_function(module_t.forward(tb), tb)[0].backward()
    assert launches.PLAIN["flash_attention_bwd"] == ARCH["num_layers"]
    assert launches.PLAIN["rms_norm_bwd"] == 2 * ARCH["num_layers"] + 1
    ref_grads = params_from_jax(jax.tree.map(np.asarray, ref), port_cfg.transformer_architecture)
    grads = dict(module_t.model.named_parameters())
    assert set(ref_grads) == set(grads)
    for name, g in ref_grads.items():
        np.testing.assert_allclose(grads[name].grad.numpy(), g.numpy(), atol=5e-4, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("run", list(RUNS))
def test_train_steps_match_jax(weights, jax_runs, run):
    config, module = port_module(weights, run)
    optimizer = init_optimizer(config, module.model)
    step = module.build_train_step(optimizer, loss_function)
    losses, norms, lrs = [], [], []
    for b in batches(*RUNS[run][:2]):
        loss, metrics, out = step(torch_batch(b))
        losses.append(float(loss))
        norms.append(float(out.global_grad_norm))
        lrs.append(out.learning_rates["weight_decay_params"])
        assert 0.0 <= float(metrics["accuracy"]) <= 1.0
    ref_losses, ref_norms, ref_params = jax_runs[run]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    np.testing.assert_allclose(norms, ref_norms, rtol=1e-4)
    np.testing.assert_allclose(losses, jax_runs["plain"][0], rtol=1e-5)  # same as plain
    bound = 2 * sum(lrs)
    ref = params_from_jax(ref_params, config.transformer_architecture)
    close, total = 0, 0
    for name, p in module.model.named_parameters():
        diff = (p.detach() - ref[name]).abs()
        assert float(diff.max()) <= bound, (name, float(diff.max()), bound)
        close += int((diff <= 1e-6).sum())
        total += diff.numel()
    assert close >= 0.999 * total, close / total


def test_head_dim_96_trains_unfused_and_matches_jax():
    """Head dim 96 (hidden 384, 4 heads): the port's layer takes the
    unfused path, since K4/K5 are built for 64 and 128 only; the JAX
    package's splash gate would take it in interpret mode, so JAX runs here
    without ``force_flash_interpret``, on its XLA attention, as it does on
    the CPU. 2 steps: losses and grad norms within rtol 1e-4."""
    np_params = draw_weights(ARCH_D96)
    config = JaxConfig.from_dict(config_dict(*RUNS["plain"], arch=ARCH_D96))
    topology = Topology(config.topology)
    module = jax_init_model(config, topology)
    optimizer = jax_init_optimizer(config, module, topology)
    params = jax.tree.map(jnp.asarray, np_params)
    ref_losses, ref_norms = [], []
    with force_rms_interpret():
        state = optimizer.init_state(params)
        step = module.build_train_step(optimizer, jax_loss, donate=False)
        for b in batches(4, 1)[:2]:
            params, state, loss, _, out = step(params, state, jax_batch(b),
                                               jax.random.PRNGKey(0))
            ref_losses.append(float(loss))
            ref_norms.append(float(out.global_grad_norm))

    config_t, module_t = port_module(np_params, "plain", arch=ARCH_D96)
    step_t = module_t.build_train_step(init_optimizer(config_t, module_t.model), loss_function)
    launches.reset()
    losses, norms = [], []
    for b in batches(4, 1)[:2]:
        loss, _, out = step_t(torch_batch(b))
        losses.append(float(loss))
        norms.append(float(out.global_grad_norm))
    assert launches.PLAIN["flash_attention_fwd"] == 0 and launches.PLAIN["flash_attention_bwd"] == 0
    assert launches.PLAIN["rms_norm_bwd"] > 0
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    np.testing.assert_allclose(norms, ref_norms, rtol=1e-4)


def test_dropout_raises_in_training_and_still_serves():
    """A dropout rate above 0 trains: the step without its dropout key
    raises (a model with dropout never trains without masks), with it the
    loss differs from the deterministic forward's and the same key gives
    the same loss again; serving stays deterministic (two eval forwards
    equal)."""
    from scaling_tpu_torch.models.transformer import TransformerArchitectureConfig
    from scaling_tpu_torch.models.transformer.inference import TransformerInferenceModule
    from scaling_tpu_torch.nn.base_layer import dropout_key

    cfg = config_dict(*RUNS["plain"])
    cfg["transformer_architecture"] = dict(ARCH, dropout_after_mlp=0.1)
    config = TransformerConfig.from_dict(cfg)
    batch = torch_batch(batches(4, 1)[0])
    mb = {k: v[0] for k, v in batch.items()}
    losses = []
    for _ in range(2):
        model = TransformerModel(config.transformer_architecture).init_random_(0)
        module = ParallelModule(model, config.topology)
        step = module.build_train_step(init_optimizer(config, model), loss_function)
        if not losses:
            with pytest.raises(ValueError, match="dropout key"):
                step(batch)
            model.eval()
            with torch.no_grad():
                clean = float(loss_function(module.forward(mb), mb)[0])
        losses.append(float(step(batch, dropout_key(0, 0))[0]))
    assert losses[0] == losses[1] and losses[0] != clean
    arch = TransformerArchitectureConfig.from_dict(cfg["transformer_architecture"])
    inf = TransformerInferenceModule.random_init(arch, seed=0, device="cpu")
    assert inf.architecture.dropout_after_mlp == 0.1
    tokens = mb["token_ids"][:2]
    assert torch.equal(inf.logits(tokens), inf.logits(tokens))


def test_config_reads_training_sections_and_refuses_what_is_not_ported():
    config = TransformerConfig.from_dict({**config_dict(2, 3, "every_layer"),
                                          "training": {"weight_decay": 0.05}})
    assert config.topology.global_batch_size == 6 and config.seed == 0
    assert config.training.weight_decay == 0.05
    assert config.optimizer.gradient_clipping == 1.0
    bad = [
        ({"topology": {"micro_batch_size": 2, "gradient_accumulation_steps": 1,
                       "pipe_parallel_size": 1, "pipe_token_slices": 2}},
         ValueError),  # JAX's check: token slices pipeline through the stages
        ({"topology": {"micro_batch_size": 2, "gradient_accumulation_steps": 1,
                       "sequence_parallel": True}}, NotImplementedError),
        ({"optimizer": {"zero": True, "zero_stage": 3}}, NotImplementedError),
        ({"training": {"use_separate_lr_on_embedding": True}}, ValueError),
        ({"trainer": {"seed": 0, "checkpoint_backend": "orbax"}}, NotImplementedError),
        ({"optimizer": {"betaa": 0.9}}, ValueError),
        ({"surprise": {}}, ValueError),
    ]
    for patch, exc in bad:
        with pytest.raises(exc):
            TransformerConfig.from_dict({**config_dict(2, 1, "disabled"), **patch})
    # the finetuning keys are read (the misspelled alias too), LoRA builds,
    # muP and the image encoder are read
    config = TransformerConfig.from_dict({
        **config_dict(2, 1, "disabled"),
        "training": {"finetune": True, "finetunable_parameters": ["norm"],
                     "use_seperate_lr_on_embeddings": True},
        "transformer_architecture": dict(ARCH, lora_config={"name": "lo", "rank": 4})})
    assert config.training.finetune and config.training.finetunable_parameters == ("norm",)
    assert config.training.use_separate_lr_on_embeddings
    assert config.transformer_architecture.lora_config.rank == 4
    config = TransformerConfig.from_dict({**config_dict(2, 1, "disabled"),
                                          "transformer_architecture":
                                          dict(ARCH, mup={"base_hidden_size": 64})})
    assert config.transformer_architecture.mup_width_mult == ARCH["hidden_size"] / 64
    config = TransformerConfig.from_dict({**config_dict(2, 1, "disabled"),
                                          "transformer_architecture":
                                          dict(ARCH, image_encoder=True)})
    assert config.transformer_architecture.image_encoder
