"""The optimizer slice: the port's LR schedule, loss scaler, AdamW step
and parameter groups against the JAX classes on the same numpy inputs.

Tolerances: the LR schedule rtol 1e-6 (the JAX schedule is f32, the
port's f64 host math). AdamW in f32: rtol 1e-5, atol 1e-7 after three
steps (the same f32 formulas, fused differently by ``_foreach`` ops);
with bf16 compute parameters the cast parameters may differ by one bf16
rounding (atol 4e-3 of values of order 0.1).
"""

import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from scaling_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from scaling_tpu.models.transformer.model import get_parameter_groups as jax_groups  # noqa: E402
from scaling_tpu.models.transformer.model import init_model as jax_init_model  # noqa: E402
from scaling_tpu.nn import ParamMeta  # noqa: E402
from scaling_tpu.optimizer import LearningRateScheduler as JaxScheduler  # noqa: E402
from scaling_tpu.optimizer import LearningRateSchedulerConfig as JaxLRConfig  # noqa: E402
from scaling_tpu.optimizer import LossScalerConfig as JaxScalerConfig  # noqa: E402
from scaling_tpu.optimizer import Optimizer as JaxOptimizer  # noqa: E402
from scaling_tpu.optimizer import OptimizerConfig as JaxOptConfig  # noqa: E402
from scaling_tpu.optimizer import OptimizerParamGroup as JaxGroup  # noqa: E402
from scaling_tpu_torch.models.transformer import TransformerConfig, TransformerModel  # noqa: E402
from scaling_tpu_torch.models.transformer.model import get_parameter_groups  # noqa: E402
from scaling_tpu_torch.optimizer import (  # noqa: E402
    LearningRateScheduler,
    LearningRateSchedulerConfig,
    LossScalerConfig,
    Optimizer,
    OptimizerConfig,
    OptimizerParamGroup,
)

LR = dict(learning_rate=3e-3, learning_rate_minimum=1e-4, learning_rate_warmup_steps=10,
          learning_rate_decay_iters=100)
STEPS = [0, 1, 5, 10, 11, 37, 99, 100, 101, 1000]


@pytest.mark.parametrize("style", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup", [0, 10])
def test_lr_schedule_matches_jax(style, warmup):
    kw = dict(LR, learning_rate_decay_style=style, learning_rate_warmup_steps=warmup)
    port = LearningRateScheduler(LearningRateSchedulerConfig(**kw))
    ref = JaxScheduler(JaxLRConfig(**kw))
    for step in STEPS:
        np.testing.assert_allclose(port.get_lr(step), float(ref.get_lr(step)), rtol=1e-6,
                                   err_msg=f"step {step}")


SHAPES = {"w": (8, 4), "b": (4,), "e": (5, 3)}
GROUPS = [  # keys, weight decay, lr_scale
    ({"w", "e"}, 0.1, 0.5),
    ({"b"}, 0.0, 1.0),
]


def problem(seed, overflow_at=None, scale=1.0):
    rng = np.random.default_rng(seed)
    params = {k: (0.1 * rng.normal(size=s)).astype(np.float32) for k, s in SHAPES.items()}
    grads = []
    for i in range(3):
        g = {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in SHAPES.items()}
        if i == overflow_at:
            g["b"][1] = np.inf
        grads.append(g)
    return params, grads


def run_jax(params, grads, opt_kw, compute_dtype):
    metas = {k: ParamMeta(parameter_name=k, layer_index=0, layer_class_name="X") for k in SHAPES}
    groups = [JaxGroup(keys={metas[k].key for k in keys}, weight_decay=wd, lr_scale=scale,
                       learning_rate_scheduler=JaxLRConfig(**LR), name=f"g{i}")
              for i, (keys, wd, scale) in enumerate(GROUPS)]
    opt = JaxOptimizer(JaxOptConfig(**opt_kw), groups, metas)
    p = {k: jnp.asarray(v, compute_dtype) for k, v in params.items()}
    state = opt.init_state(p)
    outs = []
    for g in grads:
        p, state, out = opt.step(p, {k: jnp.asarray(v) for k, v in g.items()}, state,
                                 compute_dtype=compute_dtype)
        outs.append(out)
    return p, state, outs


def run_port(params, grads, opt_kw, compute_dtype):
    p = {k: torch.nn.Parameter(torch.from_numpy(v).to(compute_dtype)) for k, v in params.items()}
    groups = [OptimizerParamGroup(keys, weight_decay=wd, lr_scale=scale, name=f"g{i}",
                                  learning_rate_scheduler=LearningRateSchedulerConfig(**LR))
              for i, (keys, wd, scale) in enumerate(GROUPS)]
    opt = Optimizer(OptimizerConfig(**opt_kw), groups, p)
    outs = [opt.step({k: torch.from_numpy(v.copy()) for k, v in g.items()}) for g in grads]
    return p, opt.state, outs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_steps_match_jax(dtype):
    """Three steps with clipping active, decoupled weight decay and an
    ``lr_scale`` group: parameters, f32 masters, moments, grad norms."""
    params, grads = problem(0, scale=2.0)
    kw = dict(gradient_clipping=0.5)
    jp, jstate, jouts = run_jax(params, grads, dict(kw), getattr(jnp, dtype))
    tp, tstate, touts = run_port(params, grads, dict(kw), getattr(torch, dtype))
    assert tstate.step == int(jstate.step) == 3
    for k in SHAPES:
        np.testing.assert_allclose(tstate.master[k].numpy(), np.asarray(jstate.master[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(tstate.exp_avg[k].numpy(), np.asarray(jstate.exp_avg[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(tstate.exp_avg_sq[k].numpy(),
                                   np.asarray(jstate.exp_avg_sq[k]), rtol=1e-5, atol=1e-9)
        atol = 1e-7 if dtype == "float32" else 4e-3
        np.testing.assert_allclose(tp[k].detach().float().numpy(),
                                   np.asarray(jp[k].astype(jnp.float32)), rtol=1e-5, atol=atol)
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(float(t.global_grad_norm), float(j.global_grad_norm),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(t.global_grad_norm_clipped),
                                   float(j.global_grad_norm_clipped), rtol=1e-5)
        for name, lr in t.learning_rates.items():
            np.testing.assert_allclose(lr, float(j.learning_rates[name]), rtol=1e-6)


def test_overflow_skips_the_step_with_the_scaler_on():
    """An inf in the second step's (scaled) gradients: no update, the step
    counter holds, the hysteresis credit burns, as in the JAX step."""
    scaler = dict(enable=True, initial_scale=1024.0, hysteresis=2, window=2)
    params, grads = problem(1, overflow_at=1, scale=1024.0)
    jp, jstate, jouts = run_jax(params, grads,
                                dict(loss_scaler=JaxScalerConfig(**scaler)), jnp.float32)
    tp, tstate, touts = run_port(params, grads,
                                 dict(loss_scaler=LossScalerConfig(**scaler)), torch.float32)
    assert [o.overflow for o in touts] == [False, True, False]
    assert [bool(o.overflow) for o in jouts] == [False, True, False]
    assert tstate.step == int(jstate.step) == 2
    for t, j in zip(touts, jouts):
        assert t.current_loss_scale == float(j.current_loss_scale)
        assert t.no_overflow_steps == int(j.no_overflow_steps)
    assert tstate.loss_scaler.current_hysteresis == float(jstate.loss_scaler.current_hysteresis)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_a_nan_propagates_with_the_scaler_off():
    params, grads = problem(2, overflow_at=0)
    tp, tstate, touts = run_port(params, grads, {}, torch.float32)
    assert bool(touts[0].overflow) and tstate.step == 3  # reported, never skipped
    assert not torch.isfinite(tp["b"]).all()


ARCH = {
    "vocab_size": 128, "hidden_size": 256, "num_layers": 2, "num_attention_heads": 4,
    "attention_num_kv_heads": 2, "attention_qkv_in_one": False, "sequence_length": 128,
    "precision": "float32", "mlp_type": "swiglu", "mlp_factor": 2.75, "norm_type": "rms",
    "layernorm": {"optimization_type": "fused"}, "weight_tying": False,
}


@pytest.mark.parametrize("exclude", [[], ["layer_2_.*mlp"]], ids=["all", "exclude"])
def test_parameter_groups_match_jax(exclude):
    """Group names, weight decay and membership by converted name: the
    embedding table, norm gains and every bias decay not; the untied head
    and all other matrices do."""
    cfg = {"topology": {"micro_batch_size": 2, "gradient_accumulation_steps": 1,
                        "model_parallel_size": 1, "pipe_parallel_size": 1,
                        "data_parallel_size": 1},
           "transformer_architecture": ARCH,
           "training": {"weight_decay": 0.01, "parameters_exclude": exclude}}
    ref = jax_groups(JaxConfig.from_dict(cfg), jax_init_model(JaxConfig.from_dict(cfg)))
    port_cfg = TransformerConfig.from_dict(cfg)
    port = get_parameter_groups(port_cfg, TransformerModel(port_cfg.transformer_architecture))

    def convert(key):  # layer_3_TransformerLayer.x.y -> layers.layer_3.x.y
        return re.sub(r"^(layer_\d+)_[A-Za-z]+\.", r"layers.\1.", key)

    assert [(g.name, g.weight_decay) for g in port] == [(g.name, g.weight_decay) for g in ref]
    for p, r in zip(port, ref):
        assert p.keys == {convert(k) for k in r.keys}, p.name
    no_decay = next(g for g in port if g.name == "no_weight_decay_params").keys
    assert "layers.layer_0.embedding.weight" in no_decay
    assert "layers.layer_4.linear.weight" not in no_decay
