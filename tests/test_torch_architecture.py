"""The JAX default architecture in the port: LayerNorm, the GELU MLP,
``rotary_complex`` and no position embedding, key/query norm, the tied
head, and the two routing gates in front of kernels K2/K3 and K4/K5.

Inputs come from numpy with a seed; module weights are drawn with numpy in
the JAX parameter tree's shapes and carried into the port by
``params_from_jax``. The JAX package runs on the CPU as its own tests run
it (XLA; the fused RMSNorm's Pallas kernel inside ``force_rms_interpret``
where the gate is asked), the port on the CPU (the kernels' plain versions).

Tolerances, each stated where it is used:
- f32 modules: atol 1e-5 (the same f32 operations, summed in another order);
- bf16 LayerNorm: rtol 2**-7, one bf16 rounding of the same f32 result;
- whole-model f32 logits: atol 1e-4 (two layers of f32 products);
- training: losses and grad norms within rtol 1e-4 (the JAX package's own
  resume tolerance), a tied table's first gradient within atol 1e-5;
- the committed golden checkpoint: its ``resumed_losses`` within rtol 1e-4.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from scaling_tpu.models.transformer.model import init_model as jax_init_model  # noqa: E402
from scaling_tpu.models.transformer.model import init_optimizer as jax_init_optimizer  # noqa: E402
from scaling_tpu.models.transformer.model import loss_function as jax_loss  # noqa: E402
from scaling_tpu.nn import LayerNorm as JaxLayerNorm  # noqa: E402
from scaling_tpu.nn import LayerNormConfig, ParallelMLP as JaxMLP  # noqa: E402
from scaling_tpu.nn import ParallelSelfAttention as JaxAttention  # noqa: E402
from scaling_tpu.nn import RotaryConfig, RotaryEmbeddingComplex as JaxRotaryComplex  # noqa: E402
from scaling_tpu.nn.activation_function import ActivationFunction  # noqa: E402
from scaling_tpu.nn.base_layer import ForwardContext  # noqa: E402
from scaling_tpu.nn.norm import NormType  # noqa: E402
from scaling_tpu.ops.rms_norm import force_rms_interpret  # noqa: E402
from scaling_tpu.ops.rms_norm import rms_norm_fused_supported as jax_rms_gate  # noqa: E402
from scaling_tpu.topology import Topology  # noqa: E402
from scaling_tpu_torch.models.transformer import (  # noqa: E402
    TransformerArchitectureConfig,
    TransformerConfig,
    TransformerModel,
    init_optimizer,
    loss_function,
)
from scaling_tpu_torch.models.transformer.convert import params_from_jax  # noqa: E402
from scaling_tpu_torch.models.transformer.train import build_trainer  # noqa: E402
from scaling_tpu_torch.nn import flash_path_active  # noqa: E402
from scaling_tpu_torch.nn.attention import ParallelSelfAttention  # noqa: E402
from scaling_tpu_torch.nn.mlp import ParallelMLP  # noqa: E402
from scaling_tpu_torch.nn.norm import LayerNorm, rms_norm_fused_supported  # noqa: E402
from scaling_tpu_torch.nn.rotary import RotaryEmbedding, RotaryEmbeddingComplex  # noqa: E402
from scaling_tpu_torch.ops import launches  # noqa: E402
from scaling_tpu_torch.parallel import ParallelModule  # noqa: E402

from .test_torch_parity_helpers import (  # noqa: E402
    config_dict,
    draw,
    draw_weights,
    inference_pair,
    module_state,
)

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "transformer" / "files" / "backward_compatibility_checkpoint"
CTX = ForwardContext()
# the JAX defaults: layernorm, the GELU MLP, rotary, untied, qkv in one
BASE = {"vocab_size": 96, "hidden_size": 64, "num_layers": 2, "num_attention_heads": 4,
        "sequence_length": 32, "precision": "float32"}
VARIANTS = {
    "jax_defaults": {},
    "rotary_complex": {"relative_position_embedding_type": "rotary_complex"},
    "no_position_embedding": {"relative_position_embedding_type": "none"},
    "key_query_norm_layernorm": {"key_query_norm": True},
    "key_query_norm_rms": {"key_query_norm": True, "norm_type": "rms", "mlp_type": "swiglu"},
    "weight_tying": {"weight_tying": True},
    "all_keys_gqa": {"weight_tying": True, "key_query_norm": True,
                     "relative_position_embedding_type": "rotary_complex",
                     "attention_num_kv_heads": 2, "attention_qkv_in_one": False,
                     "activation_function": "relu", "mlp_bias": False},
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (3.0 * rng.normal(size=(4, 7, 96)) + 1.0).astype(np.float32)
    jax_norm = JaxLayerNorm(96, LayerNormConfig(), dtype=jnp.float32, bitfit_bias_name="bf")
    params = draw(jax_norm)
    assert sorted(params) == ["bias_bf", "weight"]
    ref = jax_norm(jax.tree.map(jnp.asarray, params), jnp.asarray(x, dtype), CTX)
    norm = LayerNorm(96, eps=1e-5, bitfit_bias_name="bf")
    norm.load_state_dict(module_state(params))
    out = norm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    # f32: atol 1e-5; bf16: one rounding of the same f32 value (rtol 2**-7)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=0.0, rtol=2 ** -7)
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_default_mlp_matches_jax(activation):
    x = np.random.default_rng(1).normal(size=(3, 5, 64)).astype(np.float32)
    jax_mlp = JaxMLP(64, 4.0, activation=ActivationFunction(activation), bias=True)
    params = draw(jax_mlp)
    ref = jax_mlp(jax.tree.map(jnp.asarray, params), jnp.asarray(x), CTX)
    mlp = ParallelMLP(64, 4.0, activation=activation, bias=True)
    mlp.load_state_dict(module_state(params))
    np.testing.assert_allclose(mlp(torch.from_numpy(x)).detach().numpy(), np.asarray(ref),
                               atol=1e-5)  # f32: atol 1e-5


def test_rotary_complex_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    pos = np.stack([np.arange(9), np.maximum(np.arange(9) - 4, 0)]).astype(np.int32)
    ref_q, ref_k = JaxRotaryComplex(RotaryConfig(dimensions=16, max_seq_length=64))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), jnp.asarray(pos))
    rot = RotaryEmbeddingComplex(16, 64)
    out_q, out_k = rot(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(pos))
    np.testing.assert_allclose(out_q.numpy(), np.asarray(ref_q), atol=1e-5)  # f32
    np.testing.assert_allclose(out_k.numpy(), np.asarray(ref_k), atol=1e-5)
    # adjacent pairs rotate, not halves: it differs from the NeoX rotation
    neox = RotaryEmbedding(16, 64)(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(pos))[0]
    assert not torch.allclose(neox, out_q, atol=1e-3)


@pytest.mark.parametrize("norm_type,hidden,fused", [
    ("layernorm", 64, False), ("rms", 64, False), ("rms", 256, True)],
    ids=["layernorm", "rms", "rms_fused_head_dim_64"])
def test_key_query_norm_attention_matches_jax(norm_type, hidden, fused):
    """Key/query norm over the head dim, before rotary. A fused RMS norm at
    head dim 64 takes the plain ops through the width gate: no kernel, and
    no plain version of K2 either, as JAX takes its XLA path there."""
    heads, seq = 4, 12
    head_dim = hidden // heads
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, seq, hidden)).astype(np.float32)
    seg = np.zeros((2, seq), np.int32)
    seg[1, 5:] = 1
    pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (2, seq)).copy()
    opt = "fused" if fused else "torch"
    jax_attn = JaxAttention(
        hidden, heads, rotary_config=RotaryConfig(dimensions=head_dim, max_seq_length=seq),
        norm_type=NormType(norm_type), key_query_norm=True,
        layernorm_config=LayerNormConfig(optimization_type=opt))
    params = draw(jax_attn)
    assert {"norm_query", "norm_key"} <= set(params)
    with force_rms_interpret():
        ref = jax_attn(jax.tree.map(jnp.asarray, params), jnp.asarray(x), CTX,
                       segment_ids=jnp.asarray(seg), position_ids=jnp.asarray(pos))
    attn = ParallelSelfAttention(hidden, heads, qkv_in_one=True,
                                 rotary=RotaryEmbedding(head_dim, seq), key_query_norm=True,
                                 norm_type=norm_type, fused_norm=fused)
    attn.load_state_dict(module_state(params))
    launches.reset()
    out = attn(torch.from_numpy(x), torch.from_numpy(pos), segment_ids=torch.from_numpy(seg))
    assert not launches.KERNEL and not launches.PLAIN
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)  # f32


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_model_logits_match_jax(variant):
    jax_inf, port_inf = inference_pair({**BASE, **VARIANTS[variant]})
    tokens = np.random.default_rng(4).integers(1, BASE["vocab_size"], size=(2, 20))
    ref = np.asarray(jax_inf.logits(tokens))
    out = port_inf.logits(tokens)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)  # f32 through two layers


def test_tied_head_shares_one_parameter_and_sums_both_gradients():
    """The table appears once (under layer_0), the head projects with it,
    its gradient is JAX's (both uses added), and AdamW keeps one state."""
    arch = {**BASE, "weight_tying": True}
    jax_config, jax_module, np_params = draw_weights(arch)
    assert not jax.tree.leaves(np_params[f"layer_{BASE['num_layers'] + 2}"])
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, BASE["vocab_size"], size=(2, 16))
    batch = {"token_ids": tokens, "target_token_ids": np.roll(tokens, -1, axis=-1),
             "position_ids": np.broadcast_to(np.arange(16), (2, 16)),
             "segment_ids": np.zeros((2, 16)), "loss_weights": np.ones((2, 16))}
    jb = {k: jnp.asarray(v, jnp.float32 if k == "loss_weights" else jnp.int32)
          for k, v in batch.items()}

    def loss(params):
        ctx = jax_module._make_ctx(deterministic=True, dropout_key=None)
        return jax_loss(jax_module.forward(params, jb, ctx), jb)[0]

    ref = jax.grad(loss)(jax.tree.map(jnp.asarray, np_params))
    config = TransformerConfig.from_dict(config_dict(arch))
    model = TransformerModel(config.transformer_architecture)
    model.load_state_dict(params_from_jax(np_params, config.transformer_architecture))
    names = [n for n, _ in model.named_parameters()]
    assert "layers.layer_0.embedding.weight" in names
    assert not any(n.startswith(f"layers.layer_{BASE['num_layers'] + 2}.") for n in names)
    module = ParallelModule(model, config.topology)
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        torch.float32 if k == "loss_weights" else torch.int64) for k, v in batch.items()}
    loss_function(module.forward(tb), tb)[0].backward()
    table = model.layers["layer_0"].embedding.weight
    np.testing.assert_allclose(table.grad.numpy(),
                               np.asarray(ref["layer_0"]["embedding"]["weight"]), atol=1e-5)
    optimizer = init_optimizer(config, model)
    assert sum(1 for n in optimizer.state.exp_avg if "embedding" in n) == 1


def _train(arch, steps, mbs=2, seq=32):
    """``steps`` steps of both packages' train steps on carried weights:
    (jax losses, jax grad norms, port losses, port grad norms)."""
    jax_config, _, np_params = draw_weights(arch)
    rng = np.random.default_rng(6)
    batches = []
    for _ in range(steps):
        tokens = rng.integers(1, arch["vocab_size"], size=(1, mbs, seq))
        batches.append({"token_ids": tokens, "target_token_ids": np.roll(tokens, -1, axis=-1),
                        "position_ids": np.broadcast_to(np.arange(seq), (1, mbs, seq)),
                        "segment_ids": np.zeros((1, mbs, seq)),
                        "loss_weights": np.ones((1, mbs, seq))})
    topology = Topology(jax_config.topology)
    module = jax_init_model(jax_config, topology)
    optimizer = jax_init_optimizer(jax_config, module, topology)
    params = jax.tree.map(jnp.asarray, np_params)
    state = optimizer.init_state(params)
    step = module.build_train_step(optimizer, jax_loss, donate=False)
    ref_losses, ref_norms = [], []
    for b in batches:
        jb = {k: jnp.asarray(v, jnp.float32 if k == "loss_weights" else jnp.int32)
              for k, v in b.items()}
        params, state, loss, _, out = step(params, state, jb, jax.random.PRNGKey(0))
        ref_losses.append(float(loss))
        ref_norms.append(float(out.global_grad_norm))
    config = TransformerConfig.from_dict(config_dict(arch))
    model = TransformerModel(config.transformer_architecture)
    model.load_state_dict(params_from_jax(np_params, config.transformer_architecture))
    port = ParallelModule(model, config.topology)
    port_step = port.build_train_step(init_optimizer(config, model), loss_function)
    losses, norms = [], []
    for b in batches:
        tb = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            torch.float32 if k == "loss_weights" else torch.int64) for k, v in b.items()}
        loss, _, out = port_step(tb)
        losses.append(float(loss))
        norms.append(float(out.global_grad_norm))
    return ref_losses, ref_norms, losses, norms


def test_train_steps_with_the_jax_default_architecture_match_jax():
    """3 steps with layernorm, the GELU MLP and a tied head: losses and grad
    norms within rtol 1e-4 of JAX ``build_train_step`` in f32."""
    ref_losses, ref_norms, losses, norms = _train({**BASE, "weight_tying": True}, 3)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    np.testing.assert_allclose(norms, ref_norms, rtol=1e-4)


@pytest.mark.parametrize("hidden,kernel_route", [(320, False), (384, True)])
def test_fused_rms_norm_routes_by_width_as_the_jax_gate(hidden, kernel_route):
    """Fault 1: a fused RMSNorm whose width is not a multiple of 128 takes
    the plain ops (no K2/K3 launch, no plain-version count) where JAX takes
    its XLA path; at 384 it reaches the kernel route (on the CPU: the
    kernels' plain versions), where the JAX gate in forced interpret mode
    takes its kernel. Logits agree with JAX in both cases (atol 1e-4)."""
    arch = {**BASE, "hidden_size": hidden, "num_attention_heads": hidden // 64,
            "norm_type": "rms", "mlp_type": "swiglu", "layernorm": {"optimization_type": "fused"}}
    with force_rms_interpret():
        assert jax_rms_gate(hidden) is kernel_route
    assert rms_norm_fused_supported(hidden) is kernel_route
    jax_inf, port_inf = inference_pair(arch)
    tokens = np.random.default_rng(7).integers(1, BASE["vocab_size"], size=(2, 16))
    with force_rms_interpret():
        ref = np.asarray(jax_inf.logits(tokens))
    model = port_inf.model.train().requires_grad_(True)
    launches.reset()
    module = ParallelModule(model, TransformerConfig.from_dict(config_dict(arch)).topology)
    out = module.forward({"token_ids": torch.from_numpy(tokens)})["activations"]
    out.sum().backward()
    assert not launches.KERNEL
    norms = 2 * BASE["num_layers"] + 1
    expected = {"rms_norm": norms, "rms_norm_bwd": norms} if kernel_route else {}
    assert dict(launches.PLAIN) == expected
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("precision", ["float32", "float16"])
def test_non_bf16_flash_model_trains_unfused_like_jax(precision):
    """Fault 2: K4/K5 take bf16 only, so a flash model in f32 or f16 at
    head dim 128 and seq % 128 == 0 routes unfused (no flash launch, no
    plain flash version), where JAX hands it to splash. 2 steps against
    JAX ``build_train_step`` on carried weights, which off the TPU attends
    through XLA: losses and grad norms within rtol 1e-4 in f32; in f16
    within rtol 2e-3 (two packages' f16 roundings of each product)."""
    arch = {"vocab_size": 128, "hidden_size": 256, "num_layers": 2, "num_attention_heads": 2,
            "sequence_length": 128, "precision": precision,
            "masked_softmax": {"kernel": "flash_attention"}}
    assert not flash_path_active(kernel_is_flash=True, causal=True, dropout_attention_probs=0.0,
                                 deterministic=False, context_parallel_size=1, seq_len=128,
                                 head_dim=128, dtype=getattr(torch, precision))
    assert flash_path_active(kernel_is_flash=True, causal=True, dropout_attention_probs=0.0,
                             deterministic=False, context_parallel_size=1, seq_len=128,
                             head_dim=128, dtype=torch.bfloat16)
    launches.reset()
    ref_losses, ref_norms, losses, norms = _train(arch, 2, seq=128)
    assert "flash_attention_fwd" not in launches.PLAIN and not launches.KERNEL
    rtol = 1e-4 if precision == "float32" else 2e-3
    np.testing.assert_allclose(losses, ref_losses, rtol=rtol)
    np.testing.assert_allclose(norms, ref_norms, rtol=rtol)


def test_golden_checkpoint_resumes_to_its_recorded_losses(tmp_path):
    """The committed JAX checkpoint (layernorm, GELU MLP, f32) from its own
    ``config.yml``, with the data prefix pointed at the fixture's data, the
    checkpoint to resume from and ``save_dir`` under ``tmp_path``; 2 steps
    give ``ground_truth.json``'s ``resumed_losses`` within rtol 1e-4 (the
    JAX test's tolerance). No JAX run is needed."""
    d = yaml.safe_load((GOLDEN / "ckpt" / "global_step3" / "config.yml").read_text())
    d["data"]["data_prefixes"] = [str(GOLDEN / "data")]
    d["trainer"]["load_dir"] = str(GOLDEN / "ckpt")
    d["trainer"]["save_dir"] = str(tmp_path / "ckpt")
    trainer = build_trainer(TransformerConfig.from_dict(d), device="cpu")
    assert trainer.context.iterations == 3 and trainer.optimizer_states_loaded
    losses = [trainer.train_step().loss for _ in range(2)]
    truth = yaml.safe_load((GOLDEN / "ground_truth.json").read_text())["resumed_losses"]
    np.testing.assert_allclose(losses, truth, rtol=1e-4)


def test_example_config_trains_through_train_run(tmp_path):
    """``examples/transformer_example/config.yml`` (layernorm, GELU MLP) on
    its committed data through ``python -m scaling_tpu_torch.train run``,
    4 iterations, saving under ``tmp_path``."""
    d = yaml.safe_load((REPO / "examples" / "transformer_example" / "config.yml").read_text())
    d["trainer"].update(save_dir=str(tmp_path / "ckpt"), train_iterations=4, save_interval=4)
    config = tmp_path / "config.yml"
    config.write_text(yaml.safe_dump(d))
    proc = subprocess.run([sys.executable, "-m", "scaling_tpu_torch.train", "run", str(config),
                           "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "train run: device=cpu iterations=4" in proc.stdout
    assert (tmp_path / "ckpt" / "global_step4" / "MANIFEST.json").is_file()


@pytest.mark.parametrize("key,value", [
    ("mlp_type", "moe"), ("mup", {"base_hidden_size": 64}), ("bitfit_bias_config", {"name": "b"}),
    ("adapter_config", {"name": "a"}), ("softprompt_config", {"name": "s"}),
    ("lora_config", {"name": "x"}), ("embedding_head_config", {"name": "e"}),
    ("finetunable_token_ids", [1]), ("image_encoder", True)])
def test_keys_still_not_ported_raise_by_name(key, value):
    with pytest.raises(NotImplementedError, match=key):
        TransformerArchitectureConfig.from_dict({**BASE, key: value})
