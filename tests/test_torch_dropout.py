"""Dropout in the port against the JAX package, with JAX's masks replayed.

A torch generator cannot draw threefry's bits, so the parity tests do
not compare draws: the JAX step runs eagerly (``jax.disable_jit``) with
``ForwardContext.dropout`` recording each mask it draws, in call order
(per micro-batch: the embedding; then per layer LoRA query, key and
value, the attention probabilities, LoRA dense, after the attention,
after the MLP), and the port's step takes those masks through its mask
source, keyed by the static site ids the same calls carry there. Each
site alone and all of them together then give the JAX losses and
gradient norms: rtol 1e-5 for one step (the same f32 operations), 1e-4
over three steps (the JAX package's resume tolerance).

Beside them: the identity at rate 0 and without a context; the mask a
pure function of (seed, step, micro-batch, site); a resume under dropout
bitwise; ``every_layer`` remat against no remat under dropout (the loss
bitwise, the update within atol 1e-6); and the flash gate routing a
probability-dropout step unfused, as JAX's does.
"""

import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from scaling_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from scaling_tpu.models.transformer.model import init_model as jax_init_model  # noqa: E402
from scaling_tpu.models.transformer.model import init_optimizer as jax_init_optimizer  # noqa: E402
from scaling_tpu.models.transformer.model import loss_function as jax_loss  # noqa: E402
from scaling_tpu.nn.attention import flash_path_active as jax_flash_gate  # noqa: E402
from scaling_tpu.nn.base_layer import ForwardContext  # noqa: E402
from scaling_tpu.topology import Topology  # noqa: E402
from scaling_tpu_torch.data import MemoryMapDatasetBuilder  # noqa: E402
from scaling_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig,
    TransformerModel,
    init_optimizer,
    loss_function,
)
from scaling_tpu_torch.models.transformer.convert import params_from_jax  # noqa: E402
from scaling_tpu_torch.models.transformer.train import main  # noqa: E402
from scaling_tpu_torch.nn import flash_path_active  # noqa: E402
from scaling_tpu_torch.nn.base_layer import (  # noqa: E402
    DropoutContext,
    draw_mask,
    dropout,
    dropout_key,
)
from scaling_tpu_torch.ops import launches  # noqa: E402
from scaling_tpu_torch.parallel import ParallelModule  # noqa: E402

from .test_torch_parity_helpers import config_dict, random_params  # noqa: E402
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401

ARCH = {
    "vocab_size": 96, "hidden_size": 64, "num_layers": 2, "num_attention_heads": 4,
    "attention_num_kv_heads": 2, "attention_qkv_in_one": False, "sequence_length": 32,
    "precision": "float32", "norm_type": "rms", "mlp_type": "swiglu", "mlp_factor": 2.0,
    "lora_config": {"name": "lora", "rank": 4, "alpha": 8},
}
RATES = {  # each site's config key and rate
    "embedding": {"dropout_embedding": 0.2},
    "lora": {"lora_config": dict(ARCH["lora_config"], dropout=0.25)},
    "attention_probs": {"dropout_attention_probs": 0.15},
    "after_attention": {"dropout_after_attention": 0.3},
    "after_mlp": {"dropout_after_mlp": 0.1},
}
ALL = {k: v for rates in RATES.values() for k, v in rates.items()}
MBS, SEQ = 2, 32


def jax_sites(arch: dict) -> list:
    """The port's site ids in the JAX package's call order."""
    lora = arch["lora_config"].get("dropout", 0.0) > 0
    sites = ["layer_0.embedding"] if arch.get("dropout_embedding", 0) > 0 else []
    for i in range(1, arch["num_layers"] + 1):
        at = f"layer_{i}.attention"
        sites += [f"{at}.{t}_lora" for t in ("query", "key", "value")] if lora else []
        sites += [f"{at}.attention_probs"] if arch.get("dropout_attention_probs", 0) > 0 else []
        sites += [f"{at}.dense_lora"] if lora else []
        sites += [f"layer_{i}.{k}" for k in ("after_attention", "after_mlp")
                  if arch.get(f"dropout_{k}", 0) > 0]
    return sites


@contextlib.contextmanager
def recording_jax_masks(out: list):
    """``ForwardContext.dropout`` as the JAX package draws it, each concrete
    mask appended to ``out`` (the step's shape probe draws tracers, which
    are left out)."""
    original = ForwardContext.dropout

    def record(self, x, rate):
        if rate == 0.0 or self.deterministic:
            return x
        key = self.next_key()
        if key is None:
            return x
        keep = 1.0 - rate
        mask = jax.random.bernoulli(key, p=keep, shape=x.shape)
        if not isinstance(mask, jax.core.Tracer):
            out.append(np.asarray(mask))
        return jnp.where(mask, x / keep, 0).astype(x.dtype)

    ForwardContext.dropout = record
    try:
        with jax.disable_jit():
            yield
    finally:
        ForwardContext.dropout = original


def batches(steps: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        tokens = rng.integers(1, 96, size=(1, MBS, SEQ + 1))
        seg = np.zeros((1, MBS, SEQ), np.int32)
        seg[:, 1, 20:] = 1
        pos = np.where(seg == 0, np.arange(SEQ), np.arange(SEQ) - 20).astype(np.int32)
        out.append({"token_ids": tokens[..., :-1].astype(np.int32),
                    "target_token_ids": tokens[..., 1:].astype(np.int32),
                    "segment_ids": seg, "position_ids": pos,
                    "loss_weights": np.ones((1, MBS, SEQ), np.float32)})
    return out


def to_torch(b: dict) -> dict:
    return {k: torch.from_numpy(v).long() if "token" in k else torch.from_numpy(v)
            for k, v in b.items()}


def jax_run(arch: dict, np_params, steps: int):
    """JAX ``build_train_step`` over ``steps`` batches with its masks
    recorded: (losses, grad norms, masks of each step)."""
    config = JaxConfig.from_dict(config_dict(arch, mbs=MBS))
    topology = Topology(config.topology)
    module = jax_init_model(config, topology)
    optimizer = jax_init_optimizer(config, module, topology)
    params = jax.tree.map(jnp.asarray, np_params)
    opt_state = optimizer.init_state(params)
    step = module.build_train_step(optimizer, jax_loss, donate=False)
    losses, norms, masks = [], [], []
    for i, b in enumerate(batches(steps)):
        recorded = []
        with recording_jax_masks(recorded):
            params, opt_state, loss, _, out = step(
                params, opt_state, jax.tree.map(jnp.asarray, b),
                jax.random.fold_in(jax.random.PRNGKey(11), i))
        losses.append(float(loss))
        norms.append(float(out.global_grad_norm))
        masks.append(recorded)
    return losses, norms, masks


def port_run(arch: dict, np_params, jax_masks: list, remat: bool = False):
    """The port's step over the same batches, each step's masks JAX's, by
    site in the JAX call order."""
    sites = jax_sites(arch)
    current: dict = {}

    def replay(key, site, shape, keep, device):
        mask = current[site]
        assert tuple(mask.shape) == tuple(shape), (site, mask.shape, shape)
        return torch.from_numpy(mask.copy())

    ckpt = "every_layer" if remat else "disabled"
    cfg = config_dict(arch, mbs=MBS)
    cfg["topology"]["activation_checkpointing_type"] = ckpt
    config = TransformerConfig.from_dict(cfg)
    model = TransformerModel(config.transformer_architecture)
    model.load_state_dict(params_from_jax(np_params, config.transformer_architecture))
    module = ParallelModule(model, config.topology)
    step = module.build_train_step(init_optimizer(config, model), loss_function,
                                   mask_source=replay)
    losses, norms = [], []
    for i, (b, masks) in enumerate(zip(batches(len(jax_masks)), jax_masks)):
        assert len(masks) == len(sites), (len(masks), sites)
        current.clear()
        current.update(zip(sites, masks))
        loss, _, out = step(to_torch(b), dropout_key(0, i))
        losses.append(float(loss))
        norms.append(float(out.global_grad_norm))
    return losses, norms, model


def draw_np_params(arch: dict, seed: int = 0):
    module = jax_init_model(JaxConfig.from_dict(config_dict(arch)), None)
    template = jax.tree.map(np.asarray, module.init_params(jax.random.PRNGKey(0)))
    return random_params(template, np.random.default_rng(seed))


@pytest.mark.parametrize("site", list(RATES))
def test_each_dropout_site_matches_jax_with_its_masks_replayed(site):
    arch = {**ARCH, **RATES[site]}
    np_params = draw_np_params(arch)
    ref_losses, ref_norms, masks = jax_run(arch, np_params, 1)
    assert len(masks[0]) == len(jax_sites(arch)) > 0
    losses, norms, _ = port_run(arch, np_params, masks)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    np.testing.assert_allclose(norms, ref_norms, rtol=1e-5)


def test_training_steps_with_every_dropout_site_match_jax():
    arch = {**ARCH, **ALL}
    np_params = draw_np_params(arch, seed=1)
    ref_losses, ref_norms, masks = jax_run(arch, np_params, 3)
    losses, norms, _ = port_run(arch, np_params, masks)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    np.testing.assert_allclose(norms, ref_norms, rtol=1e-4)


def test_remat_draws_the_forwards_masks_again():
    """Under ``every_layer`` the backward recomputes each layer: its masks
    must be the forward's, or the gradients would be silently wrong. With
    the default draw (no replay) the loss is bitwise the plain run's and
    the updated parameters within atol 1e-6."""
    arch = {**ARCH, **ALL}
    cfg = config_dict(arch, mbs=MBS)
    states, losses = [], []
    for ckpt in ("disabled", "every_layer"):
        cfg["topology"]["activation_checkpointing_type"] = ckpt
        config = TransformerConfig.from_dict(cfg)
        model = TransformerModel(config.transformer_architecture).init_random_(3)
        step = ParallelModule(model, config.topology).build_train_step(
            init_optimizer(config, model), loss_function)
        losses.append(float(step(to_torch(batches(1)[0]), dropout_key(3, 7))[0]))
        states.append({k: v.clone() for k, v in model.state_dict().items()})
    assert losses[0] == losses[1]
    for k, v in states[0].items():
        np.testing.assert_allclose(states[1][k].numpy(), v.numpy(), atol=1e-6, err_msg=k)


def test_identity_at_rate_zero_and_without_a_context():
    x = torch.randn(2, 5, 8)
    ctx = DropoutContext(dropout_key(0, 1)).for_micro_batch(0)
    assert dropout(x, 0.0, ctx, "s") is x and dropout(x, 0.5, None, "s") is x
    config = TransformerConfig.from_dict(config_dict({**ARCH, **ALL}, mbs=MBS))
    model = TransformerModel(config.transformer_architecture).init_random_(0)
    module = ParallelModule(model, config.topology)
    mb = {k: v[0] for k, v in to_torch(batches(1)[0]).items()}
    model.eval()
    with torch.no_grad():
        clean = module.forward(mb)["activations"]
        assert torch.equal(clean, module.forward(mb)["activations"])
        assert not torch.equal(clean, module.forward(mb, ctx)["activations"])
    zero = TransformerConfig.from_dict(config_dict(ARCH, mbs=MBS))
    model0 = TransformerModel(zero.transformer_architecture)
    model0.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert torch.equal(ParallelModule(model0, zero.topology).forward(mb, ctx)["activations"],
                           clean)


def test_a_mask_is_a_function_of_seed_step_micro_batch_and_site():
    shape, keep = (4, 64, 32), 0.9

    def mask(seed, step, mb, site):
        key = DropoutContext(dropout_key(seed, step)).for_micro_batch(mb).key
        return draw_mask(key, site, shape, keep, torch.device("cpu"))

    ref = mask(0, 5, 1, "layer_2.after_mlp")
    assert torch.equal(ref, mask(0, 5, 1, "layer_2.after_mlp"))
    for other in (mask(1, 5, 1, "layer_2.after_mlp"), mask(0, 6, 1, "layer_2.after_mlp"),
                  mask(0, 5, 0, "layer_2.after_mlp"), mask(0, 5, 1, "layer_1.after_mlp")):
        assert not torch.equal(ref, other)
    n = ref.numel()  # the kept share within 5 sigma of keep
    assert abs(ref.float().mean().item() - keep) < 5 * (keep * (1 - keep) / n) ** 0.5


@pytest.fixture(scope="module")
def tokens(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokens")
    rng = np.random.default_rng(5)
    with MemoryMapDatasetBuilder(root / "a", dtype=np.uint16) as builder:
        for _ in range(40):
            builder.add(np.append(rng.integers(1, 96, size=rng.integers(8, 80)), 0))
    return str(root / "a")


def _trainer_cfg(tokens: str, log_dir: Path, **trainer) -> dict:
    cfg = config_dict({**ARCH, **ALL}, mbs=2, gas=2,
                      data={"data_prefixes": [tokens]}, logger={"log_dir": str(log_dir)})
    cfg["trainer"].update(train_iterations=4, save_interval=2, seed=9,
                          delete_past_optimizer_states=False, **trainer)
    return cfg


def _losses(log_dir: Path) -> dict:
    import json

    lines = (log_dir / "metrics_rank_0.jsonl").read_text().splitlines()
    return {r["step"]: (r["metrics"]["loss"], r["metrics"]["global_grad_norm"])
            for r in map(json.loads, lines) if r["kind"] == "step"}


def test_a_resume_under_dropout_is_bitwise(tokens, tmp_path):
    """4 steps saving at 2, then a relaunch from step 2: steps 3-4 redraw
    the first run's masks, so losses, norms and the final parameters are
    bitwise the first run's."""
    first = main(TransformerConfig.from_dict(_trainer_cfg(
        tokens, tmp_path / "logs1", save_dir=str(tmp_path / "ckpt"))), device="cpu")
    again = main(TransformerConfig.from_dict(_trainer_cfg(
        tokens, tmp_path / "logs2", load_dir=str(tmp_path / "ckpt" / "global_step2"))),
        device="cpu")
    assert again.context.iterations == 4
    ref, got = _losses(tmp_path / "logs1"), _losses(tmp_path / "logs2")
    assert sorted(got) == [3, 4] and got == {s: ref[s] for s in (3, 4)}
    for name, p in first.module.model.named_parameters():
        assert torch.equal(p, dict(again.module.model.named_parameters())[name]), name


@pytest.mark.parametrize("rate,training", [(0.0, True), (0.1, True), (0.1, False)])
def test_flash_gate_routes_probability_dropout_unfused_as_jax(rate, training):
    """The gate against JAX's for the same arguments (its TPU check set
    aside), and a bf16 flash model's forward: with probability dropout in
    a training pass no flash kernel (plain version here) runs."""
    common = dict(kernel_is_flash=True, causal=True, dropout_attention_probs=rate,
                  deterministic=not training, context_parallel_size=1, seq_len=128,
                  head_dim=64)
    from scaling_tpu.ops import flash_attention as jax_flash

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_flash, "flash_attention_supported", lambda s, d: True)
        ref = jax_flash_gate(**common)
    assert flash_path_active(**common, dtype=torch.bfloat16) == ref
    arch = {**ARCH, "hidden_size": 256, "precision": "bfloat16",  # head dim 64: K4's
            "masked_softmax": {"kernel": "flash_attention"}, "sequence_length": 128,
            "dropout_attention_probs": rate}
    config = TransformerConfig.from_dict(config_dict(arch, mbs=1))
    model = TransformerModel(config.transformer_architecture).init_random_(0)
    tokens = torch.randint(1, 96, (1, 128))
    launches.reset()
    with torch.no_grad():
        ctx = DropoutContext(dropout_key(0, 0)).for_micro_batch(0) if training else None
        ParallelModule(model, config.topology).forward({"token_ids": tokens}, ctx)
    assert (launches.PLAIN["flash_attention_fwd"] > 0) == ref
