"""Parameter-efficient finetuning in the port against the JAX package:
LoRA (forward, ``get_delta_weights``, merge and its errors), BitFit
linears and MLPs, the bottleneck adapter, the soft-prompt splice, the
embedding head's pooled output, every PEFT leaf through ``params_from_jax``
and into ``MESH.json``, the partition spec and orientation rules against
the JAX metas and tree, and ``get_parameter_groups`` membership.

Inputs and weights come from numpy with a seed (weights in the JAX tree's
shapes, carried into the port by ``params_from_jax``); every module runs
in f32 on the CPU. Tolerances: modules atol 1e-5 (the same f32 operations
summed in another order), whole-model logits atol 1e-4 (two layers of f32
products)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from scaling_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from scaling_tpu.models.transformer.config import (  # noqa: E402
    EmbeddingHeadConfig as JaxEmbeddingHeadConfig,
)
from scaling_tpu.models.transformer.config import (  # noqa: E402
    TransformerArchitectureConfig as JaxArch,
)
from scaling_tpu.models.transformer.layers.embedding import (  # noqa: E402
    EmbeddingInput as JaxEmbeddingInput,
)
from scaling_tpu.models.transformer.layers.layer import Adapter as JaxAdapter  # noqa: E402
from scaling_tpu.models.transformer.layers.lm_head import (  # noqa: E402
    TransformerEmbeddingHead as JaxEmbeddingHead,
)
from scaling_tpu.models.transformer.model import (  # noqa: E402
    get_parameter_groups as jax_parameter_groups,
)
from scaling_tpu.models.transformer.model import init_model as jax_init_model  # noqa: E402
from scaling_tpu.nn import ParallelMLP as JaxMLP  # noqa: E402
from scaling_tpu.nn import ParallelSelfAttention as JaxAttention  # noqa: E402
from scaling_tpu.nn import ParallelSwiGLUMLP as JaxSwiGLU  # noqa: E402
from scaling_tpu.nn.base_layer import ForwardContext  # noqa: E402
from scaling_tpu.nn.lora import LoRaConfig as JaxLoRaConfig  # noqa: E402
from scaling_tpu.nn.lora import LoRAModuleType as JaxLoRAType  # noqa: E402
from scaling_tpu.nn.lora import ParallelLoRa as JaxLoRa  # noqa: E402
from scaling_tpu.nn.param import ParamMeta  # noqa: E402
from scaling_tpu_torch.models.transformer import (  # noqa: E402
    TransformerArchitectureConfig,
    TransformerConfig,
    TransformerModel,
    get_parameter_groups,
)
from scaling_tpu_torch.models.transformer.convert import params_from_jax  # noqa: E402
from scaling_tpu_torch.models.transformer.layers import (  # noqa: E402
    Adapter,
    EmbeddingInput,
    TransformerEmbeddingHead,
)
from scaling_tpu_torch.nn.attention import ParallelSelfAttention  # noqa: E402
from scaling_tpu_torch.nn.lora import LoRaConfig, LoRAModuleType, ParallelLoRa  # noqa: E402
from scaling_tpu_torch.nn.mlp import ParallelMLP, ParallelSwiGLUMLP  # noqa: E402
from scaling_tpu_torch.parallel.parallel_module import (  # noqa: E402
    jax_param_key,
    jax_partition_spec,
    transposed_in_jax,
)

from .test_torch_parity_helpers import (  # noqa: E402
    config_dict,
    draw,
    draw_weights,
    inference_pair,
    module_state,
)
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401

CTX = ForwardContext()
HIDDEN = 64
# every PEFT module at once, on two layouts of the base
PEFT = {
    "bitfit_bias_config": {"name": "bf"},
    "adapter_config": {"name": "ad", "attention_downsampling_factor": 0.25,
                       "mlp_downsampling_factor": 0.5},
    "softprompt_config": {"name": "sp", "n_tokens": 3},
    "lora_config": {"name": "lora", "rank": 4, "alpha": 8, "bias": True},
    "embedding_head_config": {"name": "eh", "proj_layers": [32, 16]},
}
ARCHS = {
    "gqa_layernorm_gelu": {
        "vocab_size": 96, "hidden_size": HIDDEN, "num_layers": 2, "num_attention_heads": 4,
        "attention_num_kv_heads": 2, "attention_qkv_in_one": False, "sequence_length": 32,
        "precision": "float32", "norm_type": "layernorm", "mlp_type": "default",
        "key_query_norm": True, **PEFT},
    "qkv_in_one_rms_swiglu": {
        "vocab_size": 96, "hidden_size": HIDDEN, "num_layers": 2, "num_attention_heads": 4,
        "sequence_length": 32, "precision": "float32", "norm_type": "rms",
        "mlp_type": "swiglu", "mlp_factor": 2.0, "weight_tying": True,
        **PEFT, "lora_config": {"name": "lo", "rank": 8, "alpha": 16}},
}


def x_of(seed: int, shape=(2, 7, HIDDEN)) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("rank", [4, 8])
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("module_type", ["query", "key", "dense"])
def test_lora_forward_and_delta_weights_match_jax(rank, bias, module_type):
    out = 32 if module_type == "key" else HIDDEN
    jax_lora = JaxLoRa(HIDDEN, out, rank, JaxLoRAType(module_type), alpha=16, bias=bias)
    params = draw(jax_lora, seed=rank)  # B drawn nonzero: the delta is not 0
    x = x_of(1)
    ref = jax_lora(jax.tree.map(jnp.asarray, params), jnp.asarray(x), CTX)
    lora = ParallelLoRa(HIDDEN, out, rank, LoRAModuleType(module_type), alpha=16, bias=bias)
    lora.load_state_dict(module_state(params))
    np.testing.assert_allclose(lora(torch.from_numpy(x)).detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    delta = np.asarray(jax_lora.get_delta_weights(jax.tree.map(jnp.asarray, params)))
    np.testing.assert_allclose(lora.get_delta_weights().detach().numpy().T, delta, atol=1e-5)


def test_lora_init_draws_kaiming_a_and_zero_b():
    lora = ParallelLoRa(HIDDEN, 48, 8, LoRAModuleType.QUERY, kaiming_a=5 ** 0.5)
    gen = torch.Generator().manual_seed(0)
    lora.init_(gen)
    bound = (2.0 / (1.0 + 5.0)) ** 0.5 * (3.0 / HIDDEN) ** 0.5  # fan_in = in_features
    assert lora.lora_a.abs().max() <= bound and lora.lora_a.abs().max() > 0.9 * bound
    assert not lora.lora_b.any()
    ref = JaxLoRa(HIDDEN, 48, 8, JaxLoRAType.QUERY).init(jax.random.PRNGKey(0))
    assert np.abs(np.asarray(ref["lora_a"])).max() <= bound and not np.any(ref["lora_b"])


def _attention_pair(qkv_in_one: bool, lora_bias: bool, attention_bias: bool = True):
    jax_cfg = JaxLoRaConfig(name="lora", rank=4, alpha=8, bias=lora_bias)
    jax_attn = JaxAttention(HIDDEN, 4, relative_position_embedding_type="none", bias=attention_bias,
                            qkv_in_one=qkv_in_one, lora_config=jax_cfg)
    params = draw(jax_attn, seed=7)
    attn = ParallelSelfAttention(HIDDEN, 4, qkv_in_one=qkv_in_one, bias=attention_bias,
                                 lora_config=LoRaConfig(name="lora", rank=4, alpha=8,
                                                        bias=lora_bias))
    attn.load_state_dict(module_state(params))
    return jax_attn, params, attn


@pytest.mark.parametrize("qkv_in_one,lora_bias", [(False, False), (False, True), (True, False)],
                         ids=["separate", "separate_lora_bias", "qkv_in_one"])
def test_attention_lora_and_merge_match_jax(qkv_in_one, lora_bias):
    """The deltas on q/k/v and the output projection, then the merge: the
    merged weights equal the JAX merge's, ``B`` and the LoRA bias are 0,
    and the merged module computes what the unmerged one did."""
    jax_attn, params, attn = _attention_pair(qkv_in_one, lora_bias)
    x = x_of(2)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7)).copy()
    jparams = jax.tree.map(jnp.asarray, params)
    ref = np.asarray(jax_attn(jparams, jnp.asarray(x), CTX, position_ids=jnp.asarray(pos)))
    out = attn(torch.from_numpy(x), torch.from_numpy(pos)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    merged = jax.tree.map(np.asarray, jax_attn.merge_lora_weights(jparams))
    attn.merge_lora_weights()
    want = module_state(merged)
    for name, value in attn.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-5, err_msg=name)
    assert not any(getattr(attn, f"{t}_lora").lora_b.any()
                   for t in ("query", "key", "value", "dense"))
    np.testing.assert_allclose(attn(torch.from_numpy(x), torch.from_numpy(pos)).detach().numpy(),
                               out, atol=1e-5)


@pytest.mark.parametrize("qkv_in_one,attention_bias,error", [
    (True, True, NotImplementedError), (False, False, ValueError)],
    ids=["fused_qkv_lora_bias", "lora_bias_without_host_bias"])
def test_merge_raises_where_jax_raises_and_changes_nothing(qkv_in_one, attention_bias, error):
    jax_attn, params, attn = _attention_pair(qkv_in_one, True, attention_bias)
    with pytest.raises(error):
        jax_attn.merge_lora_weights(jax.tree.map(jnp.asarray, params))
    before = {k: v.clone() for k, v in attn.state_dict().items()}
    with pytest.raises(error):
        attn.merge_lora_weights()
    assert all(torch.equal(before[k], v) for k, v in attn.state_dict().items())


@pytest.mark.parametrize("mlp", ["default", "swiglu"])
def test_bitfit_mlps_match_jax(mlp):
    x = x_of(3)
    if mlp == "default":
        jax_mlp = JaxMLP(HIDDEN, 2.0, bias=True, bitfit_bias_name="bf")
        port = ParallelMLP(HIDDEN, 2.0, bias=True, bitfit_bias_name="bf")
    else:
        jax_mlp = JaxSwiGLU(HIDDEN, 2.0, bias=True, bitfit_bias_name="bf")
        port = ParallelSwiGLUMLP(HIDDEN, 2.0, bias=True, bitfit_bias_name="bf")
    params = draw(jax_mlp, seed=3)
    port.load_state_dict(module_state(params))  # strict: every bias is bias_bf
    assert all(n.endswith((".weight", ".bias_bf")) for n, _ in port.named_parameters())
    ref = jax_mlp(jax.tree.map(jnp.asarray, params), jnp.asarray(x), CTX)
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), np.asarray(ref),
                               atol=1e-5)


def test_bitfit_attention_linears_match_jax():
    jax_attn = JaxAttention(HIDDEN, 4, relative_position_embedding_type="none",
                            qkv_in_one=False, bitfit_bias_name="bf")
    params = draw(jax_attn, seed=5)
    attn = ParallelSelfAttention(HIDDEN, 4, bitfit_bias_name="bf")
    attn.load_state_dict(module_state(params))
    assert attn.query.bias is None and attn.query.bias_bf is not None
    x = x_of(5)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7)).copy()
    ref = jax_attn(jax.tree.map(jnp.asarray, params), jnp.asarray(x), CTX,
                   position_ids=jnp.asarray(pos))
    np.testing.assert_allclose(attn(torch.from_numpy(x), torch.from_numpy(pos)).detach().numpy(),
                               np.asarray(ref), atol=1e-5)


def test_adapter_matches_jax():
    jax_adapter = JaxAdapter(HIDDEN, 0.25, 0.02, jnp.float32)
    params = draw(jax_adapter, seed=6)
    adapter = Adapter(HIDDEN, 0.25, 0.02)
    adapter.load_state_dict(module_state(params))
    assert tuple(adapter.down.shape) == (16, HIDDEN)
    x = x_of(6)
    ref = jax_adapter(jax.tree.map(jnp.asarray, params), jnp.asarray(x), CTX)
    np.testing.assert_allclose(adapter(torch.from_numpy(x)).detach().numpy(), np.asarray(ref),
                               atol=1e-5)


def _arch_pair(**keys):
    base = {"vocab_size": 96, "hidden_size": HIDDEN, "num_layers": 1,
            "num_attention_heads": 4, "precision": "float32", **keys}
    return JaxArch(**base), TransformerArchitectureConfig.from_dict(base)


def test_softprompt_splice_matches_jax():
    """The prompt overwrites the first ``n_tokens`` positions; the rest are
    the table's rows."""
    jax_arch, arch = _arch_pair(softprompt_config={"name": "sp", "n_tokens": 3})
    jax_emb = JaxEmbeddingInput(jax_arch)
    params = draw(jax_emb, seed=8)
    emb = EmbeddingInput(arch)
    emb.load_state_dict(module_state(params))
    assert tuple(emb.softprompt_sp.shape) == (3, HIDDEN)  # not transposed
    tokens = np.random.default_rng(8).integers(1, 96, size=(2, 9))
    ref = np.asarray(jax_emb(jax.tree.map(jnp.asarray, params),
                             {"token_ids": jnp.asarray(tokens)}, CTX)["activations"])
    out = emb(torch.from_numpy(tokens)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    np.testing.assert_array_equal(out[1, :3], params["softprompt_sp"])


def test_embedding_head_pooled_output_matches_jax():
    jax_arch, arch = _arch_pair(embedding_head_config={"name": "eh", "proj_layers": [32, 16]})
    assert isinstance(jax_arch.embedding_head_config, JaxEmbeddingHeadConfig)
    jax_head = JaxEmbeddingHead(jax_arch)
    params = draw(jax_head, seed=9)
    head = TransformerEmbeddingHead(arch)
    head.load_state_dict(module_state(params))
    h = x_of(9, (3, 11, HIDDEN))
    weights = (np.random.default_rng(9).random((3, 11)) > 0.4).astype(np.float32)
    weights[2] = 0.0  # a row with no weight: the denominator's floor of 1
    ref = jax_head(jax.tree.map(jnp.asarray, params),
                   {"embeddings": jnp.asarray(h), "loss_weights": jnp.asarray(weights)},
                   CTX)["embeddings"]
    out = head(torch.from_numpy(h), torch.from_numpy(weights)).detach().numpy()
    assert out.shape == (3, 16)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)


def _jax_metas(module) -> dict:
    return {m.key: m for m in jax.tree.leaves(module.param_metas(),
                                              is_leaf=lambda x: isinstance(x, ParamMeta))}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


@pytest.mark.parametrize("arch", list(ARCHS))
def test_every_peft_leaf_crosses_with_the_jax_spec_and_orientation(arch):
    """Each JAX leaf maps onto one port parameter by name (strict load);
    the port's shape is the JAX shape reversed exactly where
    ``transposed_in_jax`` says (not for the soft prompt), and the logits of
    the whole PEFT model agree, which a square matrix crossing the wrong
    way round would fail; ``jax_partition_spec`` gives the JAX meta's spec
    for every leaf."""
    _, module, np_params = draw_weights(ARCHS[arch], seed=2)
    metas = _jax_metas(module)
    port_arch = TransformerArchitectureConfig.from_dict(ARCHS[arch])
    model = TransformerModel(port_arch)
    model.load_state_dict(params_from_jax(np_params, port_arch))  # strict
    flat = {k: v for k, v in _flat(np_params).items() if np.asarray(v).size}
    params = dict(model.named_parameters())
    assert len(params) == len(flat) == len(metas)
    for name, p in params.items():
        key = jax_param_key(model, name)
        jax_shape = np.asarray(flat[name[len("layers."):]]).shape
        assert tuple(p.shape) == (jax_shape[::-1] if transposed_in_jax(key, p.ndim)
                                  else jax_shape), key
        assert jax_partition_spec(key, p.ndim) == tuple(metas[key].partition_spec), key
    jax_inf, port_inf = inference_pair(ARCHS[arch], seed=2)
    tokens = np.random.default_rng(2).integers(1, 96, size=(2, 12))
    np.testing.assert_allclose(port_inf.logits(tokens).numpy(),
                               np.asarray(jax_inf.logits(tokens)), atol=1e-4)


def test_mesh_json_records_equal_the_jax_trainers(tmp_path):
    """A LoRA-and-BitFit finetune's ``MESH.json`` parameter records (shape
    in the JAX layout, dtype, spec) from the port's save equal the JAX
    trainer's for the same config."""
    from scaling_tpu.resilience import read_mesh_meta as jax_read_mesh_meta
    from scaling_tpu_torch.models.transformer.train import build_trainer
    from scaling_tpu_torch.resilience import read_mesh_meta

    from .test_torch_checkpoint import jax_trainer

    arch = ARCHS["gqa_layernorm_gelu"]
    cfg = config_dict(arch, training={"finetune": True},
                      trainer={"seed": 0, "save_dir": str(tmp_path / "port")})
    port = build_trainer(TransformerConfig.from_dict(cfg), device="cpu")
    port.save_checkpoint()
    cfg["trainer"]["save_dir"] = str(tmp_path / "jax")
    jax_run = jax_trainer(cfg, load=False)
    jax_run.save_checkpoint()
    ref = jax_read_mesh_meta(tmp_path / "jax" / "global_step0")["params"]
    got = read_mesh_meta(tmp_path / "port" / "global_step0")["params"]
    assert got == ref


GROUP_CASES = {
    "finetune_lora": ("gqa_layernorm_gelu", {"finetune": True}),
    "finetunable_parameters": ("gqa_layernorm_gelu", {
        "finetune": True, "finetunable_parameters": ["norm", "layer_1_.*dense\\."]}),
    "exclude_under_finetune": ("qkv_in_one_rms_swiglu", {
        "finetune": True, "parameters_exclude": ["dense_lo"]}),
    "separate_lr_on_embeddings": ("qkv_in_one_rms_swiglu", {
        "use_separate_lr_on_embeddings": True}),
    "separate_lr_misspelled_under_finetune": ("gqa_layernorm_gelu", {
        "finetune": True, "use_seperate_lr_on_embeddings": True,
        "finetunable_parameters": ["embedding"]}),
}


@pytest.mark.parametrize("case", list(GROUP_CASES) + ["short_name_guard"])
def test_parameter_groups_match_jax_membership(case):
    if case == "short_name_guard":
        # an adapter named "ad" must not claim the head ("TransformerLMHead")
        arch = {**ARCHS["gqa_layernorm_gelu"], "adapter_config": {
            "name": "ad", "mlp_downsampling_factor": 0.5}, "lora_config": None}
        training = {"finetune": True}
    else:
        name, training = GROUP_CASES[case]
        arch = ARCHS[name]
    cfg = config_dict(arch, training=training,
                      embedding_learning_rate_scheduler={"learning_rate": 0.5})
    jax_config = JaxConfig.from_dict(cfg)
    ref = {g.name: set(g.keys) for g in jax_parameter_groups(jax_config,
                                                             jax_init_model(jax_config, None))}
    config = TransformerConfig.from_dict(cfg)
    model = TransformerModel(config.transformer_architecture)
    groups = get_parameter_groups(config, model)
    got = {g.name: {jax_param_key(model, n) for n in g.keys} for g in groups}
    assert got == ref
    if case == "short_name_guard":
        assert not any("TransformerLMHead" in k for keys in got.values() for k in keys)
    for g in groups:
        want = (config.embedding_learning_rate_scheduler if g.name == "embedding_params"
                else config.learning_rate_scheduler)
        assert g.lr_config == want
