"""The routed expert MLP and the MoE transformer against the JAX package.

Inputs and weights come from numpy with a seed; the port's module is
loaded with the JAX tree through ``params_from_jax``. Both run on the CPU
(the JAX package's fused RMSNorm and paged kernel as its own tests run
them: ``force_rms_interpret``, the paged kernel in interpret mode).

Tolerances, each stated where it is used:
- the layer in f32: outputs, aux loss and gradients within atol 1e-5 (the
  same f32 products summed in another order);
- the layer in bf16: the routing equal, outputs within 2**-6 of max |y|
  (bf16 roundings of the up, gate, activation and expert outputs, each
  made from f32 sums taken in another order);
- whole-model f32 logits within atol 1e-4; greedy tokens equal;
- training: losses and ``moe_aux_loss`` within rtol 1e-4 a step (the
  JAX package's own resume tolerance); a resumed checkpoint's state exact.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from scaling_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from scaling_tpu.models.transformer.inference import (  # noqa: E402
    TransformerInferenceModule as JaxInference,
)
from scaling_tpu.models.transformer.model import init_model as jax_init_model  # noqa: E402
from scaling_tpu.models.transformer.model import init_optimizer as jax_init_optimizer  # noqa: E402
from scaling_tpu.models.transformer.model import loss_function as jax_loss  # noqa: E402
from scaling_tpu.models.transformer.train import main as jax_main  # noqa: E402
from scaling_tpu.nn.base_layer import ForwardContext  # noqa: E402
from scaling_tpu.nn.moe import ParallelMoEMLP as JaxMoE  # noqa: E402
from scaling_tpu.ops.rms_norm import force_rms_interpret  # noqa: E402
from scaling_tpu.topology import Topology  # noqa: E402
from scaling_tpu_torch.data import MemoryMapDatasetBuilder  # noqa: E402
from scaling_tpu_torch.models.transformer import (  # noqa: E402
    TransformerArchitectureConfig,
    TransformerConfig,
    TransformerInferenceModule,
    TransformerModel,
    init_optimizer,
    loss_function,
)
from scaling_tpu_torch.models.transformer.convert import params_from_jax  # noqa: E402
from scaling_tpu_torch.models.transformer.train import build_trainer  # noqa: E402
from scaling_tpu_torch.models.transformer.train import main as port_main  # noqa: E402
from scaling_tpu_torch.nn.moe import (  # noqa: E402
    ParallelMoEMLP,
    capacity,
    dense_dispatch_reference,
)
from scaling_tpu_torch.parallel import ParallelModule  # noqa: E402
from scaling_tpu_torch.parallel.parallel_module import jax_partition_spec  # noqa: E402

from .test_torch_checkpoint import (  # noqa: E402
    assert_states_equal,
    jax_state,
    jax_trainer,
    port_state,
)
from .test_torch_parity_helpers import config_dict, draw_weights, module_state  # noqa: E402
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401
from .test_torch_serve import serve_jax, serve_port, workload  # noqa: E402

CTX = ForwardContext()
H, FACTOR, E = 32, 2.0, 4
# a toy MoE transformer: GQA, fused RMSNorm, 4 experts top-2 at capacity 1.0,
# so that full experts drop tokens in every forward width
ARCH = {"vocab_size": 128, "hidden_size": 64, "num_layers": 2, "num_attention_heads": 4,
        "attention_num_kv_heads": 2, "attention_qkv_in_one": False, "sequence_length": 128,
        "precision": "float32", "norm_type": "rms", "layernorm": {"optimization_type": "fused"},
        "mlp_type": "moe", "mlp_factor": 2.0, "mlp_bias": False, "activation_function": "silu",
        "moe_num_experts": 4, "moe_top_k": 2, "moe_capacity_factor": 1.0}


def layer_weights(glu: bool, seed: int = 0, router_std: float = 0.5) -> dict:
    """Numpy weights of one MoE layer in the JAX tree: a router wide enough
    that routing is decisive, experts at their xavier scale."""
    rng = np.random.default_rng(seed)
    f = int(H * FACTOR)
    tree = {"router": {"weight": (router_std * rng.normal(size=(H, E))).astype(np.float32)},
            "w_in": (rng.normal(size=(E, H, f)) * np.sqrt(2 / (H + f))).astype(np.float32),
            "w_out": (rng.normal(size=(E, f, H)) * np.sqrt(2 / (H + f))).astype(np.float32)}
    if glu:
        tree["w_gate"] = (rng.normal(size=(E, H, f)) * np.sqrt(2 / (H + f))).astype(np.float32)
    return tree


def layer_pair(top_k=2, capacity_factor=1.25, glu=True, dtype=torch.float32, seed=0,
               router_std=0.5):
    kw = dict(top_k=top_k, capacity_factor=capacity_factor, glu=glu)
    params = layer_weights(glu, seed, router_std)
    jax_layer = JaxMoE(H, FACTOR, E, **kw)
    port = ParallelMoEMLP(H, FACTOR, E, **kw, dtype=dtype)
    port.load_state_dict(module_state(params))
    return jax_layer, params, port


def jax_routing(params, x, k):
    """The JAX layer's top-k experts and positions, from its own ops."""
    probs = jax.nn.softmax(jnp.einsum("bsh,he->bse", jnp.asarray(x, jnp.float32),
                                      jnp.asarray(params["router"]["weight"])), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    b, s, _ = x.shape
    flat = jax.nn.one_hot(idx, E).reshape(b, s * k, E)
    pos = jnp.einsum("bte,bte->bt", jnp.cumsum(flat, axis=1) - flat, flat).reshape(b, s, k)
    return np.asarray(idx), np.asarray(pos).astype(np.int64)


LAYER_CASES = {
    "ample_capacity": dict(capacity_factor=8.0),
    "capacity_1_drops": dict(capacity_factor=1.0),
    "top1": dict(top_k=1, capacity_factor=1.0),
    "no_glu": dict(glu=False, capacity_factor=1.0),
    "zero_router_ties": dict(router_std=0.0, capacity_factor=1.0),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_layer_matches_jax_in_f32(case):
    kw = LAYER_CASES[case]
    jax_layer, params, port = layer_pair(**kw)
    x = np.random.default_rng(1).normal(size=(3, 24, H)).astype(np.float32)
    ref_y, ref_aux = jax_layer(jax.tree.map(jnp.asarray, params), jnp.asarray(x), CTX)
    y, aux = port(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y), atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(ref_aux), atol=1e-5)
    plain_y, plain_aux = dense_dispatch_reference(port, torch.from_numpy(x))
    np.testing.assert_allclose(plain_y.detach().numpy(), np.asarray(ref_y), atol=1e-5)
    assert plain_aux.item() == aux.item()
    k = port.top_k
    _, experts, positions, _ = port.route(torch.from_numpy(x))
    ref_idx, ref_pos = jax_routing(params, x, k)
    np.testing.assert_array_equal(experts.numpy(), ref_idx)
    np.testing.assert_array_equal(positions.numpy(), ref_pos)
    C = capacity(port.capacity_factor, k, 24, E)
    dropped = (positions >= C).sum().item()
    assert (dropped > 0) == (case != "ample_capacity")
    if case == "zero_router_ties":  # every token ties: the lower experts win
        assert (experts == torch.arange(k)).all()


def test_layer_matches_jax_in_bf16_with_equal_routing():
    jax_layer, params, port = layer_pair(capacity_factor=1.0, dtype=torch.bfloat16)
    assert port.router.weight.dtype == torch.float32 and port.w_in.dtype == torch.bfloat16
    x = np.random.default_rng(2).normal(size=(2, 32, H)).astype(np.float32)
    jparams = {"router": {"weight": jnp.asarray(params["router"]["weight"])},
               **{k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items() if k != "router"}}
    ref_y, ref_aux = jax_layer(jparams, jnp.asarray(x, jnp.bfloat16), CTX)
    xb = torch.from_numpy(x).bfloat16()
    y, aux = port(xb)
    assert y.dtype == torch.bfloat16
    ref_idx, ref_pos = jax_routing(params, np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32), 2)
    _, experts, positions, _ = port.route(xb)
    np.testing.assert_array_equal(experts.numpy(), ref_idx)
    np.testing.assert_array_equal(positions.numpy(), ref_pos)
    ref = np.asarray(ref_y, np.float32)
    # bf16: a few roundings of equal f32 sums taken in another order
    np.testing.assert_allclose(y.detach().float().numpy(), ref, atol=2 ** -6 * np.abs(ref).max())
    np.testing.assert_allclose(aux.item(), float(ref_aux), atol=1e-6)


@pytest.mark.parametrize("glu", [True, False], ids=["glu", "no_glu"])
def test_layer_gradients_match_jax(glu):
    """d(sum(y * r) + aux) by x, the router and every expert weight against
    ``jax.grad`` (capacity 1.0: dropped pairs carry no gradient)."""
    jax_layer, params, port = layer_pair(capacity_factor=1.0, glu=glu)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, H)).astype(np.float32)
    r = rng.normal(size=(2, 16, H)).astype(np.float32)

    def objective(p, xx):
        y, aux = jax_layer(p, xx, CTX)
        return jnp.sum(y * r) + aux * 100.0

    ref_p, ref_x = jax.grad(objective, argnums=(0, 1))(jax.tree.map(jnp.asarray, params),
                                                       jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = port(xt)
    ((y * torch.from_numpy(r)).sum() + aux * 100.0).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_x), atol=1e-5)
    np.testing.assert_allclose(port.router.weight.grad.numpy(),
                               np.asarray(ref_p["router"]["weight"]).T, atol=1e-5)
    for name in ("w_in", "w_gate", "w_out") if glu else ("w_in", "w_out"):
        np.testing.assert_allclose(getattr(port, name).grad.numpy(), np.asarray(ref_p[name]),
                                   atol=1e-5, err_msg=name)


def test_third_token_routed_to_a_full_expert_is_dropped():
    """Capacity 2 (factor 1.0, top-1, 4 tokens, 2 experts): tokens 0, 1 and
    2 choose expert 0 and token 3 expert 1. Token 2 finds expert 0 full and
    is dropped (output 0, its residual alone) in both packages."""
    kw = dict(top_k=1, capacity_factor=1.0, glu=True)
    jax_layer, port = JaxMoE(H, FACTOR, 2, **kw), ParallelMoEMLP(H, FACTOR, 2, **kw)
    rng = np.random.default_rng(4)
    f = int(H * FACTOR)
    params = {"router": {"weight": np.zeros((H, 2), np.float32)},
              **{k: (0.2 * rng.normal(size=s)).astype(np.float32)
                 for k, s in (("w_in", (2, H, f)), ("w_gate", (2, H, f)), ("w_out", (2, f, H)))}}
    params["router"]["weight"][0] = [4.0, -4.0]  # feature 0's sign picks the expert
    port.load_state_dict(module_state(params))
    x = (0.1 * rng.normal(size=(1, 4, H))).astype(np.float32)
    x[0, :, 0] = [1.0, 1.0, 1.0, -1.0]
    assert capacity(1.0, 1, 4, 2) == 2
    ref, _ = jax_layer(jax.tree.map(jnp.asarray, params), jnp.asarray(x), CTX)
    y, _ = port(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), atol=1e-5)
    norms = np.abs(y.detach().numpy()[0]).max(axis=-1)
    assert norms[2] == 0.0 and (norms[[0, 1, 3]] > 0).all()
    np.testing.assert_array_equal(np.abs(np.asarray(ref)[0, 2]).max(), 0.0)


def test_layer_skips_its_aux_when_not_asked():
    _, _, port = layer_pair()
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 8, H)).astype(np.float32))
    y, aux = port(x, with_aux=False)
    assert aux is None
    torch.testing.assert_close(y, port(x)[0], rtol=0, atol=0)


def test_expert_leaves_cross_in_the_jax_layout_with_the_router_f32():
    """The state dict's keys and shapes are the JAX tree's (the router
    transposed), and a bf16 model keeps its router in f32."""
    config, _, np_params = draw_weights(ARCH)
    layer = np_params["layer_1"]["mlp"]
    assert sorted(layer) == ["router", "w_gate", "w_in", "w_out"]
    arch = TransformerArchitectureConfig.from_dict({**ARCH, "precision": "bfloat16"})
    state = params_from_jax(np_params, arch)
    assert state["layers.layer_1.mlp.router.weight"].dtype == torch.float32
    assert state["layers.layer_1.mlp.w_in"].dtype == torch.bfloat16
    assert tuple(state["layers.layer_1.mlp.router.weight"].shape) == (4, 64)
    model = TransformerModel(arch)
    model.load_state_dict(state)
    assert model.layers["layer_1"].mlp.router.weight.dtype == torch.float32
    for name in ("router.weight", "w_in", "w_gate", "w_out"):
        key = f"layer_1_TransformerLayer.mlp.{name}"
        expected = {"router.weight": (None, None), "w_in": ("data", None, "model"),
                    "w_gate": ("data", None, "model"), "w_out": ("data", "model", None)}[name]
        assert jax_partition_spec(key, 2 if name == "router.weight" else 3) == expected


def test_config_takes_moe_keys_with_the_jax_checks():
    arch = TransformerArchitectureConfig.from_dict(ARCH)
    assert arch.is_moe and (arch.moe_num_experts, arch.moe_top_k) == (4, 2)
    assert JaxConfig.from_dict(config_dict(ARCH)).transformer_architecture.moe_top_k == 2
    plain = {k: v for k, v in ARCH.items() if not k.startswith("moe_")}
    defaults = TransformerArchitectureConfig.from_dict(plain)
    jax_defaults = JaxConfig.from_dict(config_dict(plain)).transformer_architecture
    assert (defaults.moe_num_experts, defaults.moe_top_k, defaults.moe_capacity_factor,
            defaults.moe_aux_loss_coef) == (jax_defaults.moe_num_experts, jax_defaults.moe_top_k,
                                            jax_defaults.moe_capacity_factor,
                                            jax_defaults.moe_aux_loss_coef) == (8, 2, 1.25, 0.01)
    for bad in ({"moe_top_k": 5}, {"mlp_bias": True}):
        with pytest.raises(ValueError):
            TransformerArchitectureConfig.from_dict({**ARCH, **bad})
        with pytest.raises(ValueError):
            JaxConfig.from_dict(config_dict({**ARCH, **bad}))
    with pytest.raises(ValueError, match="natural number"):  # the JAX layer asserts it
        TransformerArchitectureConfig.from_dict({**ARCH, "mlp_factor": 2.01})
    # a dense model carries the moe_* keys inert, as in the JAX package
    dense = {**ARCH, "mlp_type": "swiglu", "moe_num_experts": 3, "moe_top_k": 3}
    assert not TransformerArchitectureConfig.from_dict(dense).is_moe
    JaxConfig.from_dict(config_dict(dense))


# ------------------------------------------------------------------ the model
def model_weights(seed=0):
    """(JAX config, module, numpy weights) of ``ARCH`` with experts at their
    xavier scale and a decisive router, so that routing moves tokens."""
    config, module, np_params = draw_weights(ARCH, seed)
    rng = np.random.default_rng(seed + 100)
    for i in range(1, ARCH["num_layers"] + 1):
        mlp = np_params[f"layer_{i}"]["mlp"]
        for name in ("w_in", "w_gate", "w_out"):
            _, a, b = mlp[name].shape
            mlp[name] = (rng.normal(size=mlp[name].shape) * np.sqrt(2 / (a + b))).astype(
                np.float32)
        mlp["router"]["weight"] = (rng.normal(size=mlp["router"]["weight"].shape)).astype(
            np.float32)
    return config, module, np_params


@pytest.fixture(scope="module")
def models():
    config, module, np_params = model_weights()
    jax_inf = JaxInference(config, module, jax.tree.map(jnp.asarray, np_params))
    arch = TransformerArchitectureConfig.from_dict(ARCH)
    port_inf = TransformerInferenceModule.from_state_dict(arch, params_from_jax(np_params, arch),
                                                          device="cpu")
    return jax_inf, port_inf


def test_model_logits_match_jax(models):
    jax_inf, port_inf = models
    tokens = np.random.default_rng(6).integers(1, 128, size=(2, 24))
    with force_rms_interpret():
        ref = np.asarray(jax_inf.logits(tokens))
    np.testing.assert_allclose(port_inf.logits(tokens).numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("use_cache", [True, False], ids=["cached", "uncached"])
def test_greedy_generate_matches_jax(models, use_cache):
    """A ragged batch (left padding: the pads take expert capacity in the
    prefill as in JAX's)."""
    jax_inf, port_inf = models
    rng = np.random.default_rng(7)
    batch = [rng.integers(1, 128, size=n).tolist() for n in (5, 13, 9)]
    with force_rms_interpret():
        ref = jax_inf.generate(batch, max_tokens=6, use_cache=use_cache)
    out = port_inf.generate(batch, max_tokens=6, use_cache=use_cache)
    assert [r.completion_ids for r in ref] == [o.completion_ids for o in out]
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.logits.numpy(), np.asarray(r.logits), rtol=1e-4, atol=1e-5)


ENGINE_MODES = {
    "chunked": {},
    "whole_prompt": dict(prefill_chunk=None),
    "separate_chunked": dict(fused_tick=False),
    "separate_whole_prompt": dict(prefill_chunk=None, fused_tick=False),
    "spec2": dict(spec_k=2),
}


@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_engine_gives_the_jax_engines_tokens(models, mode):
    """Greedy tokens equal to the JAX engine's in every forward the engine
    runs: the mixed tick, whole-prompt buckets, the separate decode and
    chunk forwards and the speculative verify."""
    jax_inf, port_inf = models
    cfg = ENGINE_MODES[mode]
    work = workload(seed=8)
    port_engine, port_tokens = serve_port(port_inf, work, **cfg)
    jax_engine, jax_tokens = serve_jax(jax_inf, work, **cfg)
    assert port_tokens == jax_tokens
    assert [len(port_tokens[i]) for i in range(len(work))] == [n for _, n in work]
    assert (port_engine.spec_drafted_tokens, port_engine.spec_accepted_tokens) == \
        (jax_engine.spec_drafted_tokens, jax_engine.spec_accepted_tokens)


# --------------------------------------------------------------- training
def train_both(arch, steps, remat=False, gas=2, mbs=2, seq=32, seed=0, weights=None):
    """``steps`` steps of both packages' train steps on carried weights:
    (JAX losses, JAX metrics, port losses, port metrics)."""
    topology_extra = {"activation_checkpointing_type": "every_layer"} if remat else {}
    cfg = config_dict(arch, mbs=mbs, gas=gas)
    cfg["topology"].update(topology_extra)
    jax_config = JaxConfig.from_dict(cfg)
    np_params = weights if weights is not None else draw_weights(arch, seed)[2]
    rng = np.random.default_rng(9)
    batches = []
    for _ in range(steps):
        tokens = rng.integers(1, arch["vocab_size"], size=(gas, mbs, seq))
        batches.append({"token_ids": tokens, "target_token_ids": np.roll(tokens, -1, axis=-1),
                        "position_ids": np.broadcast_to(np.arange(seq), (gas, mbs, seq)),
                        "segment_ids": np.zeros((gas, mbs, seq)),
                        "loss_weights": np.ones((gas, mbs, seq))})
    topology = Topology(jax_config.topology)
    module = jax_init_model(jax_config, topology)
    optimizer = jax_init_optimizer(jax_config, module, topology)
    params = jax.tree.map(jnp.asarray, np_params)
    state = optimizer.init_state(params)
    step = module.build_train_step(optimizer, jax_loss, donate=False)
    ref_losses, ref_metrics = [], []
    with force_rms_interpret():
        for b in batches:
            jb = {k: jnp.asarray(v, jnp.float32 if k == "loss_weights" else jnp.int32)
                  for k, v in b.items()}
            params, state, loss, metrics, _ = step(params, state, jb, jax.random.PRNGKey(0))
            ref_losses.append(float(loss))
            ref_metrics.append({k: float(v) for k, v in metrics.items()})
    config = TransformerConfig.from_dict(cfg)
    model = TransformerModel(config.transformer_architecture)
    model.load_state_dict(params_from_jax(np_params, config.transformer_architecture))
    port = ParallelModule(model, config.topology)
    assert port.remat == remat
    port_step = port.build_train_step(init_optimizer(config, model), loss_function)
    losses, port_metrics = [], []
    for b in batches:
        tb = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            torch.float32 if k == "loss_weights" else torch.int64) for k, v in b.items()}
        loss, metrics, _ = port_step(tb)
        losses.append(float(loss))
        port_metrics.append({k: float(v) for k, v in metrics.items()})
    return ref_losses, ref_metrics, losses, port_metrics


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "every_layer"])
def test_train_steps_and_aux_loss_match_jax(remat):
    """4 steps at gas 2: losses and ``moe_aux_loss`` within rtol 1e-4."""
    ref_losses, ref_metrics, losses, metrics = train_both(ARCH, 4, remat=remat,
                                                          weights=model_weights()[2])
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    aux = [m["moe_aux_loss"] for m in metrics]
    np.testing.assert_allclose(aux, [m["moe_aux_loss"] for m in ref_metrics], rtol=1e-4)
    assert all(a > 0 for a in aux)
    np.testing.assert_allclose([m["accuracy"] for m in metrics],
                               [m["accuracy"] for m in ref_metrics], atol=1e-6)


def test_eval_loss_carries_the_aux_loss_as_in_jax(models):
    """``loss_function`` over a forward adds the layers' summed aux loss
    (JAX's eval step does too); ``per_token_loss`` stays without it."""
    jax_inf, port_inf = models
    tokens = np.random.default_rng(10).integers(1, 128, size=(2, 16))
    batch = {"token_ids": torch.from_numpy(tokens),
             "target_token_ids": torch.from_numpy(np.roll(tokens, -1, axis=-1))}
    module = ParallelModule(port_inf.model, TransformerConfig.from_dict(
        config_dict(ARCH)).topology)
    with torch.no_grad():
        out = module.forward(batch)
    loss, metrics = loss_function(out, batch)
    plain, _ = loss_function({"activations": out["activations"]}, batch)
    torch.testing.assert_close(loss, plain + metrics["moe_aux_loss"])
    per_layer = []
    h = port_inf.model.embedding(batch["token_ids"])
    pos = torch.arange(16)[None].expand(2, 16)
    for layer in port_inf.model.transformer_layers:
        h, aux = layer(h, pos, return_aux=True)
        per_layer.append(aux)
    torch.testing.assert_close(out["aux_loss"], per_layer[0] + per_layer[1])


# ----------------------------------------------------- checkpoints and MESH.json
@pytest.fixture(scope="module")
def tokens(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe_tokens")
    rng = np.random.default_rng(11)
    with MemoryMapDatasetBuilder(root / "a", dtype=np.uint16) as builder:
        for _ in range(48):
            builder.add(np.append(rng.integers(1, 128, size=rng.integers(8, 80)), 0))
    return [str(root / "a")]


def trainer_config(prefixes, save_dir=None, load_dir=None, iterations=3, log_dir=None):
    cfg = config_dict(ARCH, mbs=2, gas=1, lr=0.01)
    cfg["trainer"] = {"train_iterations": iterations, "seed": 42, "save_interval": 3,
                      "save_dir": None if save_dir is None else str(save_dir),
                      "load_dir": None if load_dir is None else str(load_dir),
                      "assert_checkpoint_loaded": load_dir is not None,
                      "delete_past_optimizer_states": False}
    cfg["data"] = {"data_prefixes": prefixes}
    cfg["logger"] = {"log_dir": None if log_dir is None else str(log_dir)}
    return cfg


@pytest.fixture(scope="module")
def saved(tokens, tmp_path_factory):
    """A JAX and a port MoE checkpoint at step 3 of the same config."""
    root = tmp_path_factory.mktemp("moe_ckpt")
    with force_rms_interpret():
        jax_run = jax_main(JaxConfig.from_dict(trainer_config(
            tokens, root / "jax", log_dir=root / "jax_logs")))
    port_run = port_main(TransformerConfig.from_dict(trainer_config(
        tokens, root / "port", log_dir=root / "port_logs")), device="cpu")
    return root, jax_run, port_run


def test_jax_moe_checkpoint_resumes_in_the_port(tokens, saved):
    root, jax_run, _ = saved
    port = build_trainer(TransformerConfig.from_dict(
        trainer_config(tokens, load_dir=root / "jax", iterations=4)), device="cpu")
    arch = port.context.config.transformer_architecture
    assert port.context.iterations == 3 and port.optimizer_states_loaded
    assert_states_equal(port_state(port), jax_state(jax_run, arch))
    with force_rms_interpret():
        ref = jax_run.train_step()
    out = port.train_step()
    np.testing.assert_allclose(out.loss, ref.loss, rtol=1e-4)
    np.testing.assert_allclose(out.metrics["moe_aux_loss"], ref.metrics["moe_aux_loss"],
                               rtol=1e-4)


def test_port_moe_checkpoint_loads_in_jax(tokens, saved):
    root, _, port_run = saved
    with np.load(root / "port" / "global_step3" / "model_state_layer_1_TransformerLayer.npz") as z:
        assert {"mlp.router.weight", "mlp.w_in", "mlp.w_gate", "mlp.w_out"} <= set(z.files)
        assert z["mlp.router.weight"].shape == (64, 4) and z["mlp.w_out"].shape == (4, 128, 64)
    with force_rms_interpret():
        ref = jax_trainer(trainer_config(tokens, load_dir=root / "port"), load=True)
    assert int(ref.opt_state.step) == 3 and ref.optimizer_states_loaded
    arch = port_run.context.config.transformer_architecture
    assert_states_equal(port_state(port_run), jax_state(ref, arch))


def test_mesh_json_equals_the_jax_trainers_for_every_expert_leaf(saved):
    root, _, port_run = saved
    port = json.loads((root / "port" / "global_step3" / "MESH.json").read_text())
    ref = json.loads((root / "jax" / "global_step3" / "MESH.json").read_text())
    assert port.keys() == ref.keys()
    for key in ref:
        assert port[key] == ref[key], key
    experts = [k for k in port["params"] if ".mlp." in k]
    assert len(experts) == 4 * ARCH["num_layers"]


def test_moe_aux_loss_reaches_the_step_records_under_the_jax_name(saved):
    """Each step record of the metrics JSONL carries ``moe_aux_loss`` beside
    the loss, as the JAX trainer's records do."""
    root = saved[0]

    def step_metrics(log_dir):
        lines = (log_dir / "metrics_rank_0.jsonl").read_text().splitlines()
        return [r["metrics"] for r in map(json.loads, lines) if r["kind"] == "step"]

    port, ref = step_metrics(root / "port_logs"), step_metrics(root / "jax_logs")
    assert len(port) == len(ref) == 3
    for p, r in zip(port, ref):
        assert "moe_aux_loss" in r and p["moe_aux_loss"] > 0
        assert set(r) - set(p) <= set(r) - {"loss", "accuracy", "moe_aux_loss"}
