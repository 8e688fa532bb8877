"""AtMan attention controls, the ``every_layer_save_dots`` remat mode,
local-window heads in cached decode and per-parameter gradient norms:
the port against the JAX package on the CPU, in f32.

Weights are drawn with numpy from a seed in the shapes of the JAX tree
and carried across by ``params_from_jax``; token ids come from numpy
seeds. Tolerances, each stated where it is used:

- logits (AtMan, decode): atol 1e-4 (f32 through 2 layers, products
  summed in another order);
- training steps: losses within rtol 1e-4 of JAX's (its own resume
  tolerance); ``every_layer_save_dots`` against ``every_layer``: losses,
  parameters and the plain versions' launch counts equal, bitwise;
  against ``disabled``: losses bitwise, parameters within 1e-6;
- gradient norms: rtol 1e-4, atol 1e-8; a frozen parameter's exactly 0.

The local-window decode is held to the uncached forward of either
package, not to JAX's cached decode: JAX's dense cache drops the window
(``test_jax_cached_decode_drops_the_window`` records by how much).
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.checkpoint import CheckpointPolicy  # noqa: E402

from scaling_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from scaling_tpu.models.transformer.attention_control import Control as JaxControl  # noqa: E402
from scaling_tpu.models.transformer.attention_control import (  # noqa: E402
    build_attention_scores_manipulation as jax_build_manipulation,
)
from scaling_tpu.models.transformer.model import init_model as jax_init_model  # noqa: E402
from scaling_tpu.models.transformer.model import init_optimizer as jax_init_optimizer  # noqa: E402
from scaling_tpu.models.transformer.model import loss_function as jax_loss  # noqa: E402
from scaling_tpu.ops.rms_norm import force_rms_interpret  # noqa: E402
from scaling_tpu.topology import Topology  # noqa: E402
from scaling_tpu_torch.models.transformer import (  # noqa: E402
    TransformerArchitectureConfig,
    TransformerConfig,
    TransformerInferenceModule,
    TransformerModel,
    init_optimizer,
    loss_function,
)
from scaling_tpu_torch.models.transformer.attention_control import (  # noqa: E402
    Control,
    build_attention_scores_manipulation,
)
from scaling_tpu_torch.models.transformer.convert import params_from_jax  # noqa: E402
from scaling_tpu_torch.nn.attention import PagedKVCacheView  # noqa: E402
from scaling_tpu_torch.ops import launches  # noqa: E402
from scaling_tpu_torch.parallel import ParallelModule  # noqa: E402
from scaling_tpu_torch.parallel.parallel_module import save_dots_policy  # noqa: E402
from scaling_tpu_torch.serve.engine import ServeEngine  # noqa: E402

from .test_torch_parity_helpers import (  # noqa: E402
    config_dict,
    draw_weights,
    inference_pair,
    route_flash_as_bf16,
)
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401

LOGIT_ATOL = 1e-4
STEP_RTOL = 1e-4
# GQA, fused RMSNorm (K2/K3's plain versions) and, at head dim 64, the flash
# path (K4/K5's, routed as bf16 is), so that controls and remat meet every
# kernel's path
ARCH = {"vocab_size": 128, "hidden_size": 256, "num_layers": 2, "num_attention_heads": 4,
        "attention_num_kv_heads": 2, "attention_qkv_in_one": False, "sequence_length": 128,
        "precision": "float32", "norm_type": "rms", "layernorm": {"optimization_type": "fused"},
        "mlp_type": "swiglu", "mlp_factor": 2.0, "mlp_bias": False,
        "masked_softmax": {"kernel": "flash_attention"}}
# 2 of 4 heads local with a window of 4 positions: short enough that the
# decode of 12 tokens after 6-13-token prompts leaves the window many times
LOCAL = dict(ARCH, num_local_attention_heads=2, local_attention_window_size=4)


@pytest.fixture(scope="module")
def models():
    return inference_pair(ARCH, seed=1)


# ------------------------------------------------------------------- AtMan
CONTROLS = [(3, 0.0), (5, 2.0), (5, 0.5), (10, 1.5), (0, 0.25)]  # 5 twice: last wins


def test_manipulation_matches_jax_builder():
    """Both variants' matrices equal the JAX builder's: -10000 for factor 0,
    log(factor) or the factor in the controlled columns, the duplicate's
    last value; none without controls; a position past the sequence raises."""
    for log_additive in (True, False):
        got = build_attention_scores_manipulation(
            [Control(i, f) for i, f in CONTROLS], 16, batch_size=2, log_additive=log_additive)
        want = jax_build_manipulation([JaxControl(token_index=i, factor=f) for i, f in CONTROLS],
                                      16, batch_size=2, log_additive=log_additive)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert build_attention_scores_manipulation([], 16) is None
    with pytest.raises(ValueError, match="sequence length"):
        build_attention_scores_manipulation([Control(16, 1.0)], 16)
    with pytest.raises(ValueError, match="factor"):
        Control(1, -0.5)


def _thread_the_flag(monkeypatch) -> None:
    """Carry ``attention_scores_manipulation_log_additive`` from the batch
    into the JAX layers' IO dict, as JAX ``logits`` means to: its
    ``EmbeddingInput`` builds that dict without the key, so every layer
    reads the default (log-additive) whatever ``control_log_additive`` says
    (``test_jax_logits_drop_the_multiplicative_flag``)."""
    from scaling_tpu.models.transformer.layers import embedding as jax_embedding

    call = jax_embedding.EmbeddingInput.__call__

    def threaded(self, params, batch, ctx):
        io = call(self, params, batch, ctx)
        key = "attention_scores_manipulation_log_additive"
        if key in batch:
            io[key] = batch[key]
        return io

    monkeypatch.setattr(jax_embedding.EmbeddingInput, "__call__", threaded)


def _jax_logits(jax_inf, tokens, controls=None, log_additive=True):
    jax_inf._logits_fn = None  # traced anew: the flag is static, the patch at trace time
    with force_rms_interpret():
        return np.asarray(jax_inf.logits(tokens, controls=controls,
                                         control_log_additive=log_additive))


@pytest.mark.parametrize("log_additive", [True, False], ids=["log_additive", "multiplicative"])
def test_atman_logits_match_jax(models, monkeypatch, log_additive):
    """``logits(controls=...)`` of a flash-configured model (the flash route
    taken as bf16 takes it) within LOGIT_ATOL of JAX's, in both variants
    (the multiplicative one with JAX's flag carried to its layers); the
    controls route to the unfused path (no K4 runs) and move the logits,
    and without controls the flash path gives JAX's logits too."""
    route_flash_as_bf16(monkeypatch)
    _thread_the_flag(monkeypatch)
    jax_inf, port_inf = models
    tokens = np.random.default_rng(2).integers(1, 128, size=(2, 128))
    want = _jax_logits(jax_inf, tokens, [JaxControl(token_index=i, factor=f)
                                         for i, f in CONTROLS], log_additive)
    plain_want = _jax_logits(jax_inf, tokens)
    launches.reset()
    got = port_inf.logits(tokens, controls=[Control(i, f) for i, f in CONTROLS],
                          control_log_additive=log_additive).numpy()
    assert launches.PLAIN.get("flash_attention_fwd", 0) == 0
    plain = port_inf.logits(tokens).numpy()
    assert launches.PLAIN["flash_attention_fwd"] > 0
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL)
    np.testing.assert_allclose(plain, plain_want, atol=LOGIT_ATOL)
    assert np.abs(got - plain).max() > 1e-2


def test_jax_logits_drop_the_multiplicative_flag(models):
    """Why the multiplicative variant is held to JAX with the flag carried
    to its layers: JAX ``logits(control_log_additive=False)`` adds the
    multiplicative matrix (ones, the factors in the controlled columns) to
    the scores, as its log-additive path would; the port multiplies it into
    the min-shifted scores, as JAX's ``multi_head_attention`` does."""
    jax_inf, port_inf = models
    tokens = np.random.default_rng(2).integers(1, 128, size=(1, 64))
    factors = [(5, 2.0)]
    as_jax = _jax_logits(jax_inf, tokens, [JaxControl(token_index=i, factor=f)
                                           for i, f in factors], False)
    added = port_inf.logits(tokens, [Control(i, math.exp(f - 1.0)) for i, f in factors]).numpy()
    np.testing.assert_allclose(as_jax, added, atol=LOGIT_ATOL)
    port = port_inf.logits(tokens, [Control(i, f) for i, f in factors], False).numpy()
    assert np.abs(port - as_jax).max() > 100 * LOGIT_ATOL


def test_multiplicative_attention_matches_jax_multi_head_attention():
    """The unfused attention's multiplicative variant against JAX's
    ``multi_head_attention``: rows shifted so that their least unmasked
    score is 0, then scaled, on random inputs with a causal mask and GQA
    (the port's grouped products, JAX's repeated K/V)."""
    from scaling_tpu.nn.attention import multi_head_attention as jax_mha
    from scaling_tpu.nn.masked_softmax import MaskedSoftmax as JaxSoftmax
    from scaling_tpu.nn.masked_softmax import MaskedSoftmaxConfig as JaxSoftmaxConfig
    from scaling_tpu_torch.nn.attention import multi_head_attention, repeat_kv
    from scaling_tpu_torch.nn.masked_softmax import MaskedSoftmax, MaskedSoftmaxConfig

    rng = np.random.default_rng(11)
    q = rng.normal(size=(2, 12, 4, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, 12, 2, 8)).astype(np.float32) for _ in range(2))
    mask = ~np.tril(np.ones((12, 12), bool))[None, None].repeat(2, 0)
    m = rng.uniform(0, 2, size=(2, 1, 12, 12)).astype(np.float32)
    got = multi_head_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(mask), 0.35, MaskedSoftmax(MaskedSoftmaxConfig()),
                               torch.from_numpy(m), log_additive=False)
    kr, vr = (repeat_kv(torch.from_numpy(t), 2).numpy() for t in (k, v))
    want = jax_mha(jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr), jnp.asarray(mask), 0.35,
                   JaxSoftmax(JaxSoftmaxConfig()), attention_scores_manipulation=jnp.asarray(m),
                   scores_manipulation_log_additive=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("log_additive", [True, False], ids=["log_additive", "multiplicative"])
def test_atman_factor_one_is_plain_and_factor_zero_keeps_earlier_rows(models, log_additive):
    """Factor 1 gives the uncontrolled unfused logits (bitwise under the
    log-additive variant, whose offset is 0; within LOGIT_ATOL under the
    multiplicative one, whose shift the softmax cancels in exact arithmetic);
    factor 0 on position j leaves every position before j bitwise as the
    factor-1 run has it (a causal query never sees j) and moves the later ones."""
    _, port_inf = models
    tokens = np.random.default_rng(3).integers(1, 128, size=(2, 64))  # unfused: s % 128 != 0
    j = 20
    plain = port_inf.logits(tokens)
    one = port_inf.logits(tokens, [Control(j, 1.0)], log_additive)
    zero = port_inf.logits(tokens, [Control(j, 0.0)], log_additive)
    if log_additive:
        assert torch.equal(one, plain)
    torch.testing.assert_close(one, plain, rtol=0, atol=LOGIT_ATOL)
    assert torch.equal(zero[:, :j], one[:, :j])
    assert (zero[:, j:] - one[:, j:]).abs().amax(dim=-1).min() > 0


def test_paged_path_refuses_controls_and_local_heads():
    """The serving path takes neither: the paged attention refuses a score
    manipulation by name, and ``ServeEngine`` a model with local-window
    heads when it is built."""
    arch = TransformerArchitectureConfig.from_dict(LOCAL)
    inf = TransformerInferenceModule.random_init(arch, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="local-window heads"):
        ServeEngine(inf, device="cpu")
    attention = TransformerInferenceModule.random_init(
        TransformerArchitectureConfig.from_dict(ARCH), seed=0,
        device="cpu").model.transformer_layers[0].attention
    pool = torch.zeros(4, 4, 2, 64)
    view = PagedKVCacheView(pool, pool.clone(), torch.zeros(1, 2, dtype=torch.int32),
                            torch.zeros(1, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="attention_scores_manipulation"):
        attention(torch.zeros(1, 1, 256), torch.zeros(1, 1, dtype=torch.int32), view,
                  scores_manipulation=torch.zeros(1, 1, 1, 1))


# ------------------------------------------------------------------ remat
def _steps(arch, remat: str, np_params, batches, seed_lr=3e-3):
    """Port losses and final parameters of ``len(batches)`` steps under the
    remat mode, with the plain versions' launch counts of the run."""
    cfg = config_dict(arch, gas=2)
    cfg["topology"]["activation_checkpointing_type"] = remat
    config = TransformerConfig.from_dict(cfg)
    model = TransformerModel(config.transformer_architecture)
    model.load_state_dict(params_from_jax(np_params, config.transformer_architecture))
    step = ParallelModule(model, config.topology).build_train_step(
        init_optimizer(config, model), loss_function)
    launches.reset()
    losses = [float(step(b)[0]) for b in batches]
    return losses, {n: p.detach().clone() for n, p in model.named_parameters()}, dict(
        launches.PLAIN)


def _batches(arch, steps, gas=2, mbs=2, seq=128, seed=9):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        tokens = rng.integers(1, arch["vocab_size"], size=(gas, mbs, seq))
        out.append({"token_ids": tokens, "target_token_ids": np.roll(tokens, -1, axis=-1),
                    "position_ids": np.broadcast_to(np.arange(seq), (gas, mbs, seq)),
                    "segment_ids": np.zeros((gas, mbs, seq)),
                    "loss_weights": np.ones((gas, mbs, seq))})
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        torch.float32 if k == "loss_weights" else torch.int64) for k, v in b.items()}


def test_save_dots_steps_equal_every_layer_disabled_and_jax(monkeypatch):
    """3 steps at gas 2 through K2-K5's plain versions: under
    ``every_layer_save_dots`` the losses, the parameters and the plain
    versions' launch counts equal ``every_layer``'s, bitwise (the recompute
    runs every kernel again, as JAX recomputes its ``pallas_call`` s); the
    losses equal ``disabled``'s bitwise and the parameters lie within 1e-6
    of them; the losses lie within STEP_RTOL of the JAX step's under
    ``every_layer_save_dots``."""
    route_flash_as_bf16(monkeypatch)
    _, _, np_params = draw_weights(ARCH, seed=4)
    batches = _batches(ARCH, 3)
    torch_batches = [_torch_batch(b) for b in batches]
    runs = {mode: _steps(ARCH, mode, np_params, torch_batches)
            for mode in ("disabled", "every_layer", "every_layer_save_dots")}
    dots_losses, dots_params, dots_launches = runs["every_layer_save_dots"]
    layer_losses, layer_params, layer_launches = runs["every_layer"]
    off_losses, off_params, off_launches = runs["disabled"]
    assert dots_losses == layer_losses == off_losses
    assert all(torch.equal(dots_params[n], layer_params[n]) for n in dots_params)
    for n in dots_params:
        torch.testing.assert_close(dots_params[n], off_params[n], rtol=0, atol=1e-6)
    assert dots_launches == layer_launches
    for kernel in ("rms_norm", "rms_norm_bwd", "flash_attention_fwd", "flash_attention_bwd"):
        assert dots_launches[kernel] > 0, kernel
    assert dots_launches["flash_attention_fwd"] > off_launches["flash_attention_fwd"]
    cfg = config_dict(ARCH, gas=2)
    cfg["topology"]["activation_checkpointing_type"] = "every_layer_save_dots"
    config = JaxConfig.from_dict(cfg)
    topology = Topology(config.topology)
    module = jax_init_model(config, topology)
    optimizer = jax_init_optimizer(config, module, topology)
    params = jax.tree.map(jnp.asarray, np_params)
    state = optimizer.init_state(params)
    step = module.build_train_step(optimizer, jax_loss, donate=False)
    ref = []
    with force_rms_interpret():
        for b in batches:
            jb = {k: jnp.asarray(v, jnp.float32 if k == "loss_weights" else jnp.int32)
                  for k, v in b.items()}
            params, state, loss, _, _ = step(params, state, jb, jax.random.PRNGKey(0))
            ref.append(float(loss))
    np.testing.assert_allclose(dots_losses, ref, rtol=STEP_RTOL)


class _OpCounter(TorchDispatchMode):
    """Counts the ``aten`` products run while it is active."""

    OPS = {torch.ops.aten.mm.default: "mm", torch.ops.aten.addmm.default: "addmm",
           torch.ops.aten.bmm.default: "bmm"}

    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "addmm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.OPS:
            self.counts[self.OPS[func]] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("bias", [True, False], ids=["addmm", "mm"])
def test_save_dots_policy_saves_mm_and_addmm_and_recomputes_bmm(bias):
    """The policy keeps the outputs of ``mm`` and ``addmm`` and recomputes
    the rest. On an unfused model (its attention products are ``bmm``) whose
    linears are ``addmm`` (with biases) or ``mm`` (without): the backward
    of ``every_layer_save_dots`` runs every ``bmm`` that ``every_layer``'s
    runs (the recompute's included, twice the forward's and more), and no
    linear of the layers again: no ``addmm`` at all, or as many ``mm`` fewer
    as ``every_layer``'s recompute runs (the products' gradients are ``mm``
    in both)."""
    assert save_dots_policy(None, torch.ops.aten.mm.default) == CheckpointPolicy.MUST_SAVE
    assert save_dots_policy(None, torch.ops.aten.addmm.default) == CheckpointPolicy.MUST_SAVE
    for op in (torch.ops.aten.bmm.default, torch.ops.aten.mul.Tensor,
               torch.ops.aten.baddbmm.default):
        assert save_dots_policy(None, op) == CheckpointPolicy.PREFER_RECOMPUTE
    arch = dict(ARCH, masked_softmax={"kernel": "torch"}, layernorm={"optimization_type": "torch"},
                attention_bias=bias, mlp_bias=bias)
    _, _, np_params = draw_weights(arch, seed=5)
    batch = {k: v[0] for k, v in _torch_batch(_batches(arch, 1, gas=1, seq=32)[0]).items()}
    counts = {}
    for mode in ("disabled", "every_layer", "every_layer_save_dots"):
        cfg = config_dict(arch)
        cfg["topology"]["activation_checkpointing_type"] = mode
        config = TransformerConfig.from_dict(cfg)
        model = TransformerModel(config.transformer_architecture)
        model.load_state_dict(params_from_jax(np_params, config.transformer_architecture))
        module = ParallelModule(model, config.topology)
        with _OpCounter() as fwd:
            loss, _ = loss_function(module.forward(batch), batch)
        with _OpCounter() as bwd:
            loss.backward()
        counts[mode] = (fwd.counts, bwd.counts)
    (fwd, off), (_, full), (_, dots) = (counts[m] for m in ("disabled", "every_layer",
                                                             "every_layer_save_dots"))
    linear = "addmm" if bias else "mm"
    assert fwd["bmm"] > 0 and fwd[linear] >= 14  # 7 linears a layer
    assert dots["bmm"] == full["bmm"] >= 2 * fwd["bmm"] + 1 and off["bmm"] == 2 * fwd["bmm"]
    assert full[linear] > off[linear]  # every_layer recomputes the linears
    assert dots[linear] == off[linear]  # save_dots does not


# ------------------------------------------------------ local-window decode
@pytest.fixture(scope="module")
def local_models():
    return inference_pair(LOCAL, seed=6)


PROMPT_LENS = (9, 13, 6)
NEW_TOKENS = 12


def _prompts(vocab=128, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).tolist() for n in PROMPT_LENS]


def test_local_window_decode_matches_the_uncached_forward(local_models):
    """Ragged (left-padded) prompts through the port's cached ``generate``:
    each row's per-step logits equal, within LOGIT_ATOL, the JAX package's
    uncached ``logits()`` of that row alone over prompt + output (teacher-
    forced), and the port's ``use_cache=False`` gives the same tokens and
    logits; a rectangular batch too."""
    jax_inf, port_inf = local_models
    prompts = _prompts()
    for batch in (prompts, [p[:6] for p in prompts]):
        cached = port_inf.generate(batch, max_tokens=NEW_TOKENS)
        uncached = port_inf.generate(batch, max_tokens=NEW_TOKENS, use_cache=False)
        for prompt, out, ref in zip(batch, cached, uncached):
            assert out.completion_ids == ref.completion_ids
            np.testing.assert_allclose(out.logits.numpy(), ref.logits.numpy(),
                                       atol=LOGIT_ATOL)
            full = prompt + out.completion_ids[:-1]
            want = np.asarray(jax_inf.logits(np.asarray([full])))[0, len(prompt) - 1:]
            np.testing.assert_allclose(out.logits.numpy(), want, atol=LOGIT_ATOL)


def test_jax_cached_decode_drops_the_window(local_models):
    """Why the decode is not held to JAX's cached ``generate``: its dense
    cache masks by slot alone, so once a row's context passes the window its
    local heads read the whole cache and its logits leave its own uncached
    forward's (here by more than 100x LOGIT_ATOL), while the port's stay
    within LOGIT_ATOL of that forward."""
    jax_inf, port_inf = local_models
    prompt = _prompts()[1]
    jax_out = jax_inf.generate([prompt], max_tokens=NEW_TOKENS)[0]
    port_out = port_inf.generate([prompt], max_tokens=NEW_TOKENS)[0]
    teacher = jax_out.completion_ids[:-1]
    want = np.asarray(jax_inf.logits(np.asarray([prompt + teacher])))[0, len(prompt) - 1:]
    assert np.abs(np.asarray(jax_out.logits) - want).max() > 100 * LOGIT_ATOL
    port_want = np.asarray(jax_inf.logits(np.asarray([prompt + port_out.completion_ids[:-1]])))
    np.testing.assert_allclose(port_out.logits.numpy(), port_want[0, len(prompt) - 1:],
                               atol=LOGIT_ATOL)


# ------------------------------------------------------ gradient norms
def test_debug_log_matches_jax_debug_dict():
    """``optimizer.debug_log`` in a LoRA finetune (a frozen base): each
    parameter's clipped gradient norm by its JAX key within rtol STEP_RTOL,
    atol 1e-8, of the JAX step's ``debug_dict`` over 2 steps, the frozen
    ones exactly 0, the same keys; nothing is read back to the host."""
    arch = dict(ARCH, masked_softmax={"kernel": "torch"}, lora_config={"name": "lo", "rank": 4})
    cfg = config_dict(arch, gas=2)
    cfg["optimizer"]["debug_log"] = True
    cfg["training"] = {"finetune": True}
    _, _, np_params = draw_weights(arch, seed=8)
    batches = _batches(arch, 2, seq=32)
    config = JaxConfig.from_dict(cfg)
    topology = Topology(config.topology)
    module = jax_init_model(config, topology)
    optimizer = jax_init_optimizer(config, module, topology)
    params = jax.tree.map(jnp.asarray, np_params)
    state = optimizer.init_state(params)
    step = module.build_train_step(optimizer, jax_loss, donate=False)
    port_config = TransformerConfig.from_dict(cfg)
    model = TransformerModel(port_config.transformer_architecture)
    model.load_state_dict(params_from_jax(np_params, port_config.transformer_architecture))
    port_step = ParallelModule(model, port_config.topology).build_train_step(
        init_optimizer(port_config, model), loss_function)
    for b in batches:
        with force_rms_interpret():
            jb = {k: jnp.asarray(v, jnp.float32 if k == "loss_weights" else jnp.int32)
                  for k, v in b.items()}
            params, state, _, _, out = step(params, state, jb, jax.random.PRNGKey(0))
        want = {k: float(v) for k, v in out.debug_dict.items()}
        _, _, port_out = port_step(_torch_batch(b))
        assert all(isinstance(v, torch.Tensor) for v in port_out.debug_dict.values())
        got = {k: float(v) for k, v in port_out.debug_dict.items()}
        assert got.keys() == want.keys()
        keys = sorted(want)
        np.testing.assert_allclose([got[k] for k in keys], [want[k] for k in keys],
                                   rtol=STEP_RTOL, atol=1e-8)
        frozen = [k for k in keys if "_lo." not in k]
        assert frozen and all(got[k] == 0.0 == want[k] for k in frozen)
        assert all(got[k] > 0 for k in keys if "lora_a" in k)
