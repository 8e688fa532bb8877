"""muP in the port against the JAX package: the parameter groups and their
``lr_scale`` by parameter name, the attention scale, the zero readout and
``output_mult``, the ``weight_tying`` refusal, training steps, and the
coordinate check of ``tests/transformer/test_mup.py`` on the port.

Weights come from numpy draws in the JAX tree's shapes (``params_from_jax``)
or from the port's own seeded init; batches from numpy seeds; both packages
on the CPU in f32. Tolerances: logits atol 1e-4 (f32 through two layers),
losses within rtol 1e-4 a step (the JAX package's resume tolerance).
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from scaling_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from scaling_tpu.models.transformer.model import get_parameter_groups as jax_groups  # noqa: E402
from scaling_tpu.models.transformer.model import init_model as jax_init_model  # noqa: E402
from scaling_tpu_torch.models.transformer import (  # noqa: E402
    TransformerArchitectureConfig,
    TransformerConfig,
    TransformerModel,
    init_model,
    init_optimizer,
    loss_function,
)
from scaling_tpu_torch.models.transformer.model import get_parameter_groups  # noqa: E402
from scaling_tpu_torch.parallel.parallel_module import jax_param_key  # noqa: E402

from .test_torch_moe import ARCH as MOE_ARCH  # noqa: E402
from .test_torch_moe import train_both  # noqa: E402
from .test_torch_parity_helpers import config_dict, inference_pair  # noqa: E402
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401

BASE, WIDE = 32, 128
DENSE = {"vocab_size": 96, "hidden_size": WIDE, "num_layers": 2, "num_attention_heads": 4,
         "sequence_length": 32, "precision": "float32", "norm_type": "rms",
         "mlp_type": "swiglu", "mlp_factor": 2.0, "weight_tying": False,
         "mup": {"base_hidden_size": BASE}}
PEFT = {"lora_config": {"name": "lo", "rank": 2, "alpha": 4},
        "adapter_config": {"name": "ad", "attention_downsampling_factor": 0.25,
                           "mlp_downsampling_factor": 0.5},
        "embedding_head_config": {"name": "eh", "proj_layers": [16, 8]}}
GROUP_CASES = {
    "moe_peft": ({**MOE_ARCH, "hidden_size": WIDE, "mup": {"base_hidden_size": BASE},
                  **PEFT}, {}),
    "separate_embedding_lr": ({**DENSE, **PEFT}, {"use_separate_lr_on_embeddings": True}),
    "finetune_peft": ({**DENSE, **PEFT}, {"finetune": True,
                                          "finetunable_parameters": ["embedding"]}),
    "no_mup": ({**{k: v for k, v in DENSE.items() if k != "mup"}, **PEFT}, {}),
}


@pytest.mark.parametrize("case", list(GROUP_CASES))
def test_parameter_groups_equal_jax_by_name(case):
    """Group names, members (by JAX key), ``lr_scale`` and weight decay
    equal to JAX ``get_parameter_groups``: embedding, soft prompt, adapter
    ``up``, ``lora_b`` and later projections keep the base rate."""
    arch, training = GROUP_CASES[case]
    cfg = config_dict(arch, training=training)
    ref = {g.name: g for g in jax_groups(JaxConfig.from_dict(cfg),
                                         jax_init_model(JaxConfig.from_dict(cfg), None))}
    config = TransformerConfig.from_dict(cfg)
    model = TransformerModel(config.transformer_architecture)
    groups = {g.name: g for g in get_parameter_groups(config, model)}
    assert groups.keys() == ref.keys()
    for name, g in groups.items():
        assert {jax_param_key(model, k) for k in g.keys} == set(ref[name].keys), name
        assert g.lr_scale == ref[name].lr_scale and g.weight_decay == ref[name].weight_decay
    if case == "moe_peft":
        scaled = groups["weight_decay_params"].keys
        assert groups["weight_decay_params"].lr_scale == BASE / WIDE
        assert {"layers.layer_1.mlp.w_in", "layers.layer_1.mlp.router.weight"} <= scaled
        fixed = groups["weight_decay_params_fixed_width"].keys
        assert any(k.endswith(".up") for k in fixed) and any("proj_1_" in k for k in fixed)


@pytest.mark.parametrize("base_heads", [None, 16], ids=["base_head_dim", "added_heads"])
def test_attention_scale_equals_jax(base_heads):
    """``sqrt(base_head_dim) / head_dim``: 1/m of the way past the base when
    width grows by head dim; ``1/sqrt(head_dim)`` when it grows by heads."""
    mup = {"base_hidden_size": BASE}
    if base_heads:
        mup["base_num_attention_heads"] = base_heads // 4
    arch = {**DENSE, "num_attention_heads": 16 if base_heads else 4, "mup": mup}
    ref = jax_init_model(JaxConfig.from_dict(config_dict(arch)), None).layers[1]
    model = TransformerModel(TransformerArchitectureConfig.from_dict(arch))
    scale = model.transformer_layers[0].attention.scaling_factor
    assert math.isclose(scale, ref.attention.scaling_factor, rel_tol=1e-12)
    head_dim = WIDE // arch["num_attention_heads"]
    expected = 1 / math.sqrt(head_dim) if base_heads else math.sqrt(BASE / 4) / head_dim
    assert math.isclose(scale, expected, rel_tol=1e-12)


def test_readout_zero_init_and_output_mult():
    model = init_model(TransformerConfig.from_dict(config_dict(DENSE)), device="cpu").model
    assert model.lm_head.linear.weight.abs().max().item() == 0.0
    assert model.lm_head.logit_mult == 1.0
    assert model.transformer_layers[0].attention.dense.weight.abs().max().item() > 0
    drawn = TransformerConfig.from_dict(config_dict(
        {**DENSE, "mup": {"base_hidden_size": BASE, "readout_zero_init": False}}))
    assert init_model(drawn, device="cpu").model.lm_head.linear.weight.abs().max().item() > 0


@pytest.mark.parametrize("output_mult", [2.0, 0.3])
def test_logits_with_output_mult_equal_jax(output_mult):
    arch = {**DENSE, "hidden_size": 64, "mup": {"base_hidden_size": 16,
                                                  "output_mult": output_mult}}
    jax_inf, port_inf = inference_pair(arch, seed=2)
    tokens = np.random.default_rng(3).integers(1, 96, size=(2, 16))
    ref = np.asarray(jax_inf.logits(tokens))
    np.testing.assert_allclose(port_inf.logits(tokens).numpy(), ref, atol=1e-4)
    plain = {**arch, "mup": {"base_hidden_size": 16}}
    _, port_plain = inference_pair(plain, seed=2)
    # the same weights without the multiplier (and the same attention scale)
    np.testing.assert_allclose(port_inf.logits(tokens).numpy(),
                               output_mult * port_plain.logits(tokens).numpy(), rtol=1e-5,
                               atol=1e-6)


def test_weight_tying_is_refused_as_in_jax():
    arch = {**DENSE, "weight_tying": True}
    with pytest.raises(ValueError, match="weight_tying"):
        TransformerArchitectureConfig.from_dict(arch)
    with pytest.raises(ValueError, match="weight_tying"):
        JaxConfig.from_dict(config_dict(arch))
    with pytest.raises(ValueError, match="unknown mup keys"):
        TransformerArchitectureConfig.from_dict({**DENSE, "mup": {"base_hidden_size": 8,
                                                                  "scale": 2}})


@pytest.mark.parametrize("mlp", ["swiglu", "moe"])
def test_mup_train_steps_match_jax(mlp):
    """4 steps at gas 2: each group's ``1/m`` rate and the decoupled decay
    ``wd / lr_scale`` act as in JAX; losses within rtol 1e-4."""
    arch = ({**DENSE, "hidden_size": 64, "mup": {"base_hidden_size": 16, "output_mult": 2.0}}
            if mlp == "swiglu" else {**MOE_ARCH, "mup": {"base_hidden_size": 16}})
    ref_losses, ref_metrics, losses, metrics = train_both(arch, 4, seq=16)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    if mlp == "moe":
        np.testing.assert_allclose([m["moe_aux_loss"] for m in metrics],
                                   [m["moe_aux_loss"] for m in ref_metrics], rtol=1e-4)


def _logit_update_rms(hidden: int, mup: bool) -> float:
    """RMS of (logits after 3 steps - logits at init) on a fixed probe, the
    port's model from its seeded init (``tests/transformer/test_mup.py``'s
    configuration: vocab 96, 2 layers, 4 heads, rms, untied, LR 0.01)."""
    arch = {"vocab_size": 96, "hidden_size": hidden, "num_layers": 2, "num_attention_heads": 4,
            "sequence_length": 24, "norm_type": "rms", "weight_tying": False}
    if mup:
        arch["mup"] = {"base_hidden_size": BASE}
    cfg = config_dict(arch, lr=0.01)
    cfg["learning_rate_scheduler"]["learning_rate_warmup_steps"] = 2
    config = TransformerConfig.from_dict(cfg)
    module = init_model(config, device="cpu")
    step = module.build_train_step(init_optimizer(config, module.model), loss_function)
    probe = {"token_ids": torch.arange(24)[None] % 60 + 1}

    def probe_logits():
        with torch.no_grad():
            return module.forward(probe)["activations"].clone()

    before = probe_logits()
    rng = np.random.default_rng(17)
    for _ in range(3):
        tokens = torch.from_numpy(rng.integers(1, 96, size=(1, 2, 24)))
        loss, _, _ = step({"token_ids": tokens, "target_token_ids": tokens.roll(-1, -1)})
        assert math.isfinite(float(loss))
    return float((probe_logits() - before).pow(2).mean().sqrt())


def test_mup_logit_updates_width_independent():
    """The same LR at the base width and 4x: muP keeps the logit update's
    order, standard parametrisation's grows with width (the JAX test's
    band and its discriminating comparison)."""
    upd = {(mup, hidden): _logit_update_rms(hidden, mup)
           for mup in (True, False) for hidden in (BASE, WIDE)}
    mup_ratio = upd[(True, WIDE)] / upd[(True, BASE)]
    sp_ratio = upd[(False, WIDE)] / upd[(False, BASE)]
    assert 0.2 < mup_ratio < 3.0, (upd, mup_ratio)
    assert mup_ratio < sp_ratio, (upd, mup_ratio, sp_ratio)
