"""The serving slice end to end: the JAX ServeEngine and the port's
ServeEngine serve the same requests with the same weights.

The JAX model (f32, fused RMSNorm, GQA) gets random weights drawn with
numpy; ``params_from_jax`` carries them into the port. The JAX engine
runs its Pallas kernels the way its own tests do on the CPU (the paged
kernel interprets off-TPU, the norm inside ``force_rms_interpret``); the
port runs on the CPU, i.e. through the kernels' plain versions.

Checked: the first mixed tick's logits (atol 1e-4: f32 through two
layers, different summation orders; with int8 KV 2e-3, because an f32
rounding difference in one K/V value can move it across a rounding
boundary of the quantiser, one int8 step, ~1e-3 in the logits), and
greedy tokens identical token for token in a plain run, under forced
preemption (tight pool), with prefix-cache hits (shared system prompt),
and with int8 KV.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from scaling_tpu.models.transformer import TransformerConfig  # noqa: E402
from scaling_tpu.models.transformer.inference import (  # noqa: E402
    TransformerInferenceModule as JaxInference,
)
from scaling_tpu.models.transformer.model import init_model  # noqa: E402
from scaling_tpu.ops.rms_norm import force_rms_interpret  # noqa: E402
from scaling_tpu.serve.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from scaling_tpu.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from scaling_tpu.serve.kvcache import build_layer_views, init_pools  # noqa: E402
from scaling_tpu_torch.models.transformer import (  # noqa: E402
    TransformerArchitectureConfig,
    TransformerInferenceModule,
)
from scaling_tpu_torch.models.transformer.convert import params_from_jax  # noqa: E402
from scaling_tpu_torch.ops import launches  # noqa: E402
from scaling_tpu_torch.serve import EngineConfig, ServeEngine  # noqa: E402

ARCH = {
    "vocab_size": 128,
    "hidden_size": 256,
    "num_layers": 2,
    "num_attention_heads": 4,
    "attention_num_kv_heads": 2,
    "attention_qkv_in_one": False,
    "sequence_length": 256,
    "precision": "float32",
    "mlp_type": "swiglu",
    "mlp_factor": 2.75,
    "norm_type": "rms",
    "layernorm": {"optimization_type": "fused"},
    "weight_tying": False,
}
ENGINE = dict(num_slots=4, block_size=4, num_blocks=64, max_blocks_per_seq=16,
              token_budget=64, prefill_chunk=8)
LOGIT_ATOL = {"native": 1e-4, "int8": 2e-3}


def random_params(template, rng):
    """Numpy weights shaped like the JAX tree: xavier-scaled matrices,
    small biases, norm gains near 1 (nonzero biases exercise the bias
    plumbing that a zero init would hide)."""
    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if len(shape) == 2:
            std = np.sqrt(2.0 / (shape[0] + shape[1]))
            return (rng.normal(size=shape) * std).astype(np.float32)
        if "norm" in name:
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.02 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, template)


@pytest.fixture(scope="module")
def models():
    config = TransformerConfig.from_dict({
        "topology": {"model_parallel_size": 1, "pipe_parallel_size": 1,
                     "data_parallel_size": 1, "micro_batch_size": 1,
                     "gradient_accumulation_steps": 1},
        "transformer_architecture": ARCH,
        "optimizer": {"gradient_clipping": 1.0},
        "learning_rate_scheduler": {"learning_rate": 3e-4,
                                    "learning_rate_warmup_steps": 1,
                                    "learning_rate_decay_iters": 10},
        "trainer": {"train_iterations": 1, "seed": 0},
        "data": {}, "logger": {"log_dir": None},
    })
    module = init_model(config, None)
    np_params = random_params(
        jax.tree.map(np.asarray, module.init_params(jax.random.PRNGKey(0))),
        np.random.default_rng(0),
    )
    jax_inf = JaxInference(config, module, jax.tree.map(jnp.asarray, np_params))
    arch = TransformerArchitectureConfig.from_dict(ARCH)
    port_inf = TransformerInferenceModule.from_state_dict(
        arch, params_from_jax(np_params, arch), device="cpu"
    )
    return jax_inf, port_inf


def workload(shared_prefix=0, seed=1):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, 128, size=shared_prefix).tolist()
    return [
        (prefix + rng.integers(1, 128, size=int(rng.integers(3, 21))).tolist(),
         int(rng.integers(4, 9)))
        for _ in range(7)
    ]


def serve_jax(inf, work, **cfg):
    with force_rms_interpret():
        engine = JaxEngine(inf, JaxEngineConfig(**{**ENGINE, **cfg}))
        for prompt, n in work:
            engine.submit(prompt, n)
        finished = engine.run_until_done()
    return engine, {s.request.req_id: list(s.generated) for s in finished}


def serve_port(inf, work, **cfg):
    engine = ServeEngine(inf, EngineConfig(**{**ENGINE, **cfg}), device="cpu")
    for prompt, n in work:
        engine.submit(prompt, n)
    finished = engine.run_until_done()
    return engine, {s.request.req_id: list(s.generated) for s in finished}


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_first_mixed_tick_logits_match(models, kv_dtype):
    jax_inf, port_inf = models
    engine = ServeEngine(port_inf, EngineConfig(**ENGINE, kv_dtype=kv_dtype),
                         device="cpu")
    for prompt, n in workload():
        engine.submit(prompt, n)
    inp = engine._mixed_inputs(engine.scheduler.schedule())
    assert len(inp.chunk_rows) == ENGINE["num_slots"]
    port_logits, _ = engine._forward_mixed(inp)

    pools = init_pools(jax_inf, ENGINE["num_blocks"], ENGINE["block_size"],
                       kv_dtype=kv_dtype)
    width = ENGINE["prefill_chunk"]
    pos = jnp.asarray(inp.ctx)[:, None] + jnp.arange(width, dtype=jnp.int32)[None]
    views = build_layer_views(
        (pools.pool_k, pools.pool_v, pools.scale_k, pools.scale_v),
        jnp.asarray(inp.tables), jnp.asarray(inp.ctx), jnp.asarray(inp.new_lens),
    )
    g0 = jnp.clip(jnp.asarray(inp.new_lens) - 1, 0, width - 1)
    with force_rms_interpret():
        jax_logits, jax_views = jax_inf._run_layers(
            jax_inf.params, jax_inf._make_batch(jnp.asarray(inp.tokens), pos),
            views, None, paged_kernel="pallas", gather_start=g0, gather_width=1,
        )
    np.testing.assert_allclose(port_logits.numpy(), np.asarray(jax_logits),
                               atol=LOGIT_ATOL[kv_dtype], rtol=0)
    # the pools the tick wrote agree (block 0, the trash block, excluded)
    for layer, view in enumerate(jax_views):
        for ours, theirs in ((engine.pools.pool_k[layer], view.pool_k),
                             (engine.pools.pool_v[layer], view.pool_v)):
            ours, theirs = ours[1:].float().numpy(), np.asarray(theirs)[1:]
            if kv_dtype == "native":
                np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)
            else:  # at most one int8 step apart, and rarely that
                assert np.abs(ours - theirs).max() <= 1
                assert (ours != theirs).mean() < 1e-3


@pytest.mark.parametrize("case", ["plain", "preemption", "prefix", "int8"])
def test_greedy_tokens_identical_to_jax_engine(models, case):
    jax_inf, port_inf = models
    cfg, work = {}, workload()
    if case == "preemption":
        cfg = dict(num_blocks=12)  # 11 usable blocks of 4 for 4 slots
    elif case == "prefix":
        work = workload(shared_prefix=12)
    elif case == "int8":
        cfg = dict(kv_dtype="int8")
    launches.reset()
    port_engine, port_tokens = serve_port(port_inf, work, **cfg)
    jax_engine, jax_tokens = serve_jax(jax_inf, work, **cfg)
    assert port_tokens == jax_tokens
    assert [len(port_tokens[i]) for i in range(len(work))] == [n for _, n in work]
    # the CPU ran the plain versions only, and both kernels' paths were taken
    assert sum(launches.KERNEL.values()) == 0
    assert launches.PLAIN["rms_norm"] > 0
    paged = "paged_attention_int8" if case == "int8" else "paged_attention"
    assert launches.PLAIN[paged] > 0
    sched, jax_sched = port_engine.scheduler, jax_engine.scheduler
    assert sched.preemption_count == jax_sched.preemption_count
    assert sched.prefix_hit_tokens == jax_sched.prefix_hit_tokens
    if case == "preemption":
        assert sched.preemption_count > 0
    if case == "prefix":
        assert sched.prefix_hit_tokens > 0


def test_sampled_tokens_reproducible_across_preemption(models):
    """temperature > 0 draws are keyed by (seed, request, position): the
    same requests give the same tokens with and without preemption."""
    _, port_inf = models

    def run(num_blocks):
        engine = ServeEngine(port_inf, EngineConfig(**{**ENGINE, "num_blocks": num_blocks}),
                             device="cpu")
        for i, (prompt, n) in enumerate(workload()):
            engine.submit(prompt, n, temperature=0.8, top_k=40 if i % 2 else None,
                          top_p=0.9 if i % 3 else None)
        done = engine.run_until_done()
        return engine, {s.request.req_id: list(s.generated) for s in done}

    roomy, a = run(64)
    tight, b = run(12)
    assert tight.scheduler.preemption_count > 0
    assert a == b
    greedy = serve_port(port_inf, workload())[1]
    assert a != greedy  # the sampler really sampled


def test_engine_rejects_what_is_not_ported(models):
    for kwargs in (dict(prefill_chunk=None), dict(fused_tick=False), dict(spec_k=2),
                   dict(default_deadline_ms=5.0), dict(shed_high_watermark=0.9),
                   dict(max_waiting=4), dict(replica_id=0)):
        with pytest.raises(NotImplementedError):
            EngineConfig(**kwargs)
    engine = ServeEngine(models[1], EngineConfig(**ENGINE), device="cpu")
    with pytest.raises(NotImplementedError):
        engine.submit([1, 2, 3], 2, deadline_ms=10.0)
    with pytest.raises(NotImplementedError):
        engine.attach_journal(None)
    with pytest.raises(NotImplementedError):
        engine.begin_drain()


def test_torch_rotary_table_dtype_matches_jax():
    """The cos/sin tables are f32 and applied in the activation dtype."""
    from scaling_tpu.nn.rotary import _cos_sin_tables
    from scaling_tpu_torch.nn.rotary import RotaryEmbedding, cos_sin_tables

    cos_j, sin_j = _cos_sin_tables(64, 128, 10000)
    cos_t, sin_t = cos_sin_tables(64, 128, 10000)
    np.testing.assert_array_equal(cos_j, cos_t)
    np.testing.assert_array_equal(sin_j, sin_t)
    rot = RotaryEmbedding(64, 128)
    assert rot.cos.dtype == torch.float32
    q = torch.randn(1, 3, 2, 64, dtype=torch.bfloat16)
    out, _ = rot(q, q, torch.arange(3)[None])
    assert out.dtype == torch.bfloat16
