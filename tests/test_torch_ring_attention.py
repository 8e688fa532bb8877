"""The port's ring attention over gloo CPU ranks against JAX's
``ring_attention`` on the virtual devices (as
``tests/core/test_nn/test_ring_attention.py`` runs it), on the same inputs
drawn from a seed with numpy: ``(2, 32, n, 8)`` f32 q/k/v, the context
ranks' contiguous slices of the sequence, the model ranks' of the heads.
Cases: cp 2 and 4, causal and not, packed segments crossing the slices'
bounds, GQA unrepeated (4 query heads over 2 and 1 kv heads), a partial
repeat under mp 2 (1 kv head repeated to 2 so that it splits over the model
group, as the layer's rule gives it), and a ``kv_chunk`` below the slice
(tiles of 4 of an 8-token slice). The forward within 1e-5, the q/k/v
gradients of ``sum(out * g)`` within 1e-4.

Beside them: ``_kv_chunk`` is JAX's divisor rule; the collective bytes of
a call are the count from the shapes; and a toy model's step at cp 2 and
cp 4 (ring) and cp 2 (Ulysses) gives the one-rank step's logits and
gradients (within 3e-6 of each leaf's largest gradient: the sums over the
context group reorder the f32 arithmetic, nothing else).
"""

import importlib
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from scaling_tpu.ops.ring_attention import ring_attention as jax_ring_attention  # noqa: E402
from scaling_tpu.ops.ulysses_attention import ulysses_attention as jax_ulysses  # noqa: E402
from scaling_tpu.topology import Topology as JaxTopology  # noqa: E402
from scaling_tpu.topology import TopologyConfig as JaxTopologyConfig  # noqa: E402

jax_ring = importlib.import_module("scaling_tpu.ops.ring_attention")
port_ring = importlib.import_module("scaling_tpu_torch.ops.ring_attention")

from .test_torch_dist_helpers import run_ranks  # noqa: E402
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401
from .test_torch_pipeline import _stack_worker, stack_batches, stack_config  # noqa: E402

B, S, D = 2, 32, 8
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
# name -> (variant, cp, mp, causal, packed, heads, kv heads, kv repeat, kv_chunk)
RING_CASES = {
    "cp2_causal": ("ring", 2, 1, True, False, 4, 2, 1, None),
    "cp2_bidir_packed": ("ring", 2, 1, False, True, 4, 4, 1, None),
    "cp4_causal_packed_gqa": ("ring", 4, 1, True, True, 4, 2, 1, None),
    "cp4_bidir_mqa": ("ring", 4, 1, False, False, 4, 1, 1, None),
    "cp2_mp2_partial_repeat": ("ring", 2, 2, True, True, 4, 1, 2, None),
    "cp4_kv_chunk_below_the_slice": ("ring", 4, 1, True, True, 4, 2, 1, 4),
}


def case_arrays(case: tuple, seed: int = 0) -> dict:
    """q, k, v (k/v repeated as the case says), the segment ids and the
    output's cotangent, f32 numpy from a seed."""
    _, _, _, _, packed, n, n_kv, rep, _ = case
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, S, n, D)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(B, S, n_kv, D)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(B, S, n_kv, D)) * 0.5).astype(np.float32)
    k, v = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)  # repeat_kv's layout
    seg = np.zeros((B, S), np.int32)
    if packed:  # documents of unequal length crossing the slices' bounds
        seg[:, 13:] = 1
        seg[:, 24:] = 2
    g = rng.normal(size=(B, S, n, D)).astype(np.float32)
    return {"q": q, "k": k, "v": v, "seg": seg, "g": g}


def jax_reference(case: tuple, arrays: dict) -> dict:
    """JAX's function and its vjp on the virtual devices at the case's
    context x model mesh."""
    variant, cp, mp, causal, _, _, _, _, chunk = case
    mesh = JaxTopology(JaxTopologyConfig(
        pipe_parallel_size=1, data_parallel_size=1, context_parallel_size=cp,
        model_parallel_size=mp, micro_batch_size=1, gradient_accumulation_steps=1)).mesh
    seg = jnp.asarray(arrays["seg"])
    scale = 1.0 / np.sqrt(D)

    def fn(q, k, v):
        if variant == "ring":
            return jax_ring_attention(q, k, v, seg, mesh, causal=causal, sm_scale=scale,
                                      kv_chunk=chunk)
        return jax_ulysses(q, k, v, seg, mesh, causal=causal, sm_scale=scale)

    out, vjp = jax.vjp(fn, *(jnp.asarray(arrays[x]) for x in "qkv"))
    dq, dk, dv = vjp(jnp.asarray(arrays["g"]))
    return {name: np.asarray(t) for name, t in zip(("out", "dq", "dk", "dv"),
                                                    (out, dq, dk, dv))}


def _slices(t: np.ndarray, c: int, cp: int, m: int, mp: int) -> torch.Tensor:
    """Context rank ``c``'s sequence slice and model rank ``m``'s heads."""
    s, n = t.shape[1] // cp, t.shape[2] // mp
    return torch.from_numpy(t[:, c * s:(c + 1) * s, m * n:(m + 1) * n].copy())


def port_worker(rank: int, world: int, cases: dict) -> dict:
    """Every case of this world size: a topology of its context x model
    layout, this rank's slices through the port's function, the backward of
    ``sum(out * g)`` (the bytes moved, forward and all); a ValueError's
    message instead where it refuses."""
    from scaling_tpu_torch.nn.base_layer import ContextShard
    from scaling_tpu_torch.ops.ring_attention import ring_attention
    from scaling_tpu_torch.ops.ulysses_attention import ulysses_attention
    from scaling_tpu_torch.parallel import collectives
    from scaling_tpu_torch.topology import Topology, TopologyConfig

    out = {}
    for name, (case, arrays) in cases.items():
        variant, cp, mp, causal, _, _, _, _, chunk = case
        topo = Topology(TopologyConfig.from_dict({
            "model_parallel_size": mp, "data_parallel_size": 1, "pipe_parallel_size": 1,
            "context_parallel_size": cp, "context_parallel_variant": variant,
            "micro_batch_size": 1, "gradient_accumulation_steps": 1}),
            device=torch.device("cpu"))
        c, m = topo.context_parallel_rank, topo.model_parallel_rank
        q, k, v = (_slices(arrays[x], c, cp, m, mp).requires_grad_() for x in "qkv")
        seg = torch.from_numpy(arrays["seg"][:, c * (S // cp):(c + 1) * (S // cp)].copy())
        context = ContextShard.of(topo)
        collectives.STATS.clear()
        try:
            if variant == "ring":
                y = ring_attention(q, k, v, seg, context, causal=causal,
                                   sm_scale=1.0 / np.sqrt(D), kv_chunk=chunk)
            else:
                y = ulysses_attention(q, k, v, seg, context, causal=causal,
                                      sm_scale=1.0 / np.sqrt(D))
        except ValueError as e:
            out[name] = {"refused": str(e)}
            continue
        fwd = dict(collectives.STATS)
        (y * _slices(arrays["g"], c, cp, m, mp)).sum().backward()
        out[name] = {"c": c, "m": m, "out": y.detach(), "dq": q.grad, "dk": k.grad,
                     "dv": v.grad, "fwd_stats": fwd,
                     "stats": dict(collectives.STATS)}
    return out


def assemble(ranks: list, name: str, key: str, cp: int, mp: int) -> np.ndarray:
    """The global tensor of ``key`` from every rank's slices."""
    rows = []
    for c in range(cp):
        by_m = {r[name]["m"]: r[name][key] for r in ranks if r[name]["c"] == c}
        assert len(by_m) == mp
        rows.append(np.concatenate([by_m[m] for m in range(mp)], axis=2))
    return np.concatenate(rows, axis=1)


def run_cases(cases: dict) -> dict:
    """The port's results of ``cases`` by world size (concurrent groups of
    ranks) and JAX's meanwhile: ``{name: (port ranks, jax result)}``."""
    arrays = {name: case_arrays(case, i) for i, (name, case) in enumerate(cases.items())}
    by_world: dict = {}
    for name, case in cases.items():
        by_world.setdefault(case[1] * case[2], {})[name] = (case, arrays[name])
    with ThreadPoolExecutor(len(by_world)) as pool:
        futures = {w: pool.submit(run_ranks, port_worker, w, group, timeout=120)
                   for w, group in by_world.items()}
        want = {}
        for name, case in cases.items():
            try:
                want[name] = jax_reference(case, arrays[name])
            except AssertionError as e:  # JAX asserts where the port raises ValueError
                want[name] = {"refused": str(e)}
        got = {w: f.result() for w, f in futures.items()}
    return {name: (got[case[1] * case[2]], want[name]) for name, case in cases.items()}


def check_case(results: dict, cases: dict, name: str) -> None:
    ranks, want = results[name]
    _, cp, mp = cases[name][:3]
    np.testing.assert_allclose(assemble(ranks, name, "out", cp, mp), want["out"],
                               rtol=FWD_TOL, atol=FWD_TOL)
    for key in ("dq", "dk", "dv"):
        np.testing.assert_allclose(assemble(ranks, name, key, cp, mp), want[key],
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=key)


@pytest.fixture(scope="module")
def ring_results():
    return run_cases(RING_CASES)


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_attention_matches_jax(ring_results, name):
    check_case(ring_results, RING_CASES, name)


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_moves_the_bytes_the_shapes_give(ring_results, name):
    """K and V in one tensor and the segment ids each of ``cp - 1`` hops
    forward and backward, the f32 dK/dV accumulators each of ``cp`` hops."""
    ranks, _ = ring_results[name]
    _, cp, mp, _, _, _, n_kv, rep, _ = RING_CASES[name]
    s_loc, kv_loc = S // cp, n_kv * rep // mp
    kv = 2 * B * s_loc * kv_loc * D * 4
    seg = B * s_loc * 4
    for r in ranks:
        assert r[name]["fwd_stats"]["ring_send_bytes"] == (cp - 1) * (kv + seg)
        assert r[name]["stats"]["ring_send_bytes"] == 2 * (cp - 1) * (kv + seg) + cp * kv
        assert r[name]["stats"]["ring_recv_bytes"] == r[name]["stats"]["ring_send_bytes"]


@pytest.mark.parametrize("s_loc,requested", [(8, None), (8, 4), (512, 128), (1024, None),
                                             (1536, None), (100, 64), (97, 64), (2048, 1024)])
def test_kv_chunk_is_jax_divisor_rule(s_loc, requested):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the prime slice's warning: the next test's
        assert port_ring._kv_chunk(s_loc, requested) == jax_ring._kv_chunk(s_loc, requested)


def test_a_prime_slice_falls_back_to_one_tile_with_jax_warning():
    with pytest.warns(UserWarning, match="no divisor"):
        assert port_ring._kv_chunk(97, 64) == 97


# ------------------------------------------------------------ a toy step
@pytest.fixture(scope="module")
def toy_steps():
    batch = stack_batches(1)[0]
    layouts = {"one": (1, "ring"), "cp2_ring": (2, "ring"), "cp4_ring": (4, "ring"),
               "cp2_ulysses": (2, "ulysses")}
    with ThreadPoolExecutor(len(layouts)) as pool:
        futures = {}
        for name, (cp, variant) in layouts.items():
            cfg = stack_config(1, 1, "disabled")
            cfg["topology"].update(context_parallel_size=cp, context_parallel_variant=variant)
            futures[name] = pool.submit(run_ranks, _stack_worker, cp, cfg, batch, timeout=120)
        return {name: f.result() for name, f in futures.items()}


@pytest.mark.parametrize("name", ["cp2_ring", "cp4_ring", "cp2_ulysses"])
def test_a_toy_step_at_cp_equals_one_rank(toy_steps, name):
    one = toy_steps["one"][0]
    for rank in toy_steps[name]:
        np.testing.assert_allclose(rank["logits"], one["logits"], rtol=1e-5, atol=1e-5)
        assert rank["loss"] == pytest.approx(one["loss"], rel=1e-6)
        assert set(rank["grads"]) == set(one["grads"])
        for n, g in rank["grads"].items():
            scale = np.abs(one["grads"][n]).max()
            assert np.abs(g - one["grads"][n]).max() <= 3e-6 * scale, n


def test_the_ring_keeps_its_inputs_output_and_lse_alone_for_the_backward():
    """The forward saves q, k, v, the segment ids, the output and the f32
    lse, and no tile: the score tiles of a step die with it (autograd through
    the loop of tiles would keep every ``(s_loc x chunk)`` tile)."""
    from scaling_tpu_torch.nn.base_layer import ContextShard

    b, s, n, n_kv = 2, 64, 4, 2
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(b, s, n, D, generator=gen, requires_grad=True)
    k, v = (torch.randn(b, s, n_kv, D, generator=gen, requires_grad=True) for _ in range(2))
    seg = torch.zeros(b, s, dtype=torch.int32)
    out = port_ring.ring_attention(q, k, v, seg, ContextShard(), kv_chunk=16)
    saved = out.grad_fn.saved_tensors
    lse = b * n * s
    assert sorted(t.numel() for t in saved) == sorted(
        [q.numel(), k.numel(), v.numel(), seg.numel(), out.numel(), lse])
    assert port_ring._kv_chunk(s, 16) == 16  # four tiles a step
    out.sum().backward()
    assert all(t.grad is not None for t in (q, k, v))


# --------------------------------------------- the layer's kv repeat under CP
# name -> (variant, cp, mp, heads, kv heads, the repeat JAX's rule gives)
LAYER_CASES = {
    "ring_cp2_mp2_shared_kv": ("ring", 2, 2, 4, 1, 2),        # 1 kv head over mp 2
    "ulysses_cp2_mp2_partial": ("ulysses", 2, 2, 8, 2, 2),    # 2 of the 4 copies
    "ulysses_cp4_repeat": ("ulysses", 4, 1, 4, 2, 2),
}


def _layer_worker(rank: int, world: int, case: tuple, state: dict, x, seg) -> dict:
    from scaling_tpu_torch.nn.attention import ParallelSelfAttention
    from scaling_tpu_torch.nn.base_layer import ContextShard
    from scaling_tpu_torch.nn.linear import ModelShard
    from scaling_tpu_torch.nn.rotary import RotaryEmbedding
    from scaling_tpu_torch.topology import Topology, TopologyConfig

    from .test_torch_dist_helpers import shard_state

    variant, cp, mp, n, n_kv, _ = case
    topo = Topology(TopologyConfig.from_dict({
        "model_parallel_size": mp, "data_parallel_size": 1, "pipe_parallel_size": 1,
        "context_parallel_size": cp, "context_parallel_variant": variant,
        "micro_batch_size": 1, "gradient_accumulation_steps": 1}), device=torch.device("cpu"))
    shard = ModelShard.of(topo)
    layer = ParallelSelfAttention(8 * n, n, num_kv_heads=n_kv, rotary=RotaryEmbedding(8, S),
                                  shard=shard, context=ContextShard.of(topo))
    layer.load_state_dict(shard_state(layer, state, shard.rank, shard.size))
    c, s_loc = topo.context_parallel_rank, S // cp
    xs = torch.from_numpy(x[:, c * s_loc:(c + 1) * s_loc].copy()).requires_grad_()
    pos = torch.arange(c * s_loc, (c + 1) * s_loc)[None].expand(B, s_loc)
    y = layer(xs, pos, segment_ids=torch.from_numpy(seg[:, c * s_loc:(c + 1) * s_loc].copy()))
    (y * y).sum().backward()
    rep = layer.kv_shared or layer.context_kv_rep
    return {"c": c, "y": y.detach(), "x_grad": xs.grad, "rep": rep}


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_the_attention_layer_repeats_kv_by_jax_rule_and_matches_one_rank(name):
    from scaling_tpu_torch.nn.attention import ParallelSelfAttention
    from scaling_tpu_torch.nn.rotary import RotaryEmbedding

    variant, cp, mp, n, n_kv, rep = LAYER_CASES[name]
    torch.manual_seed(0)
    ref = ParallelSelfAttention(8 * n, n, num_kv_heads=n_kv, rotary=RotaryEmbedding(8, S))
    for p in ref.parameters():
        torch.nn.init.normal_(p, std=0.2)
    state = {k: v.numpy() for k, v in ref.state_dict().items()}
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, S, 8 * n)).astype(np.float32)
    seg = np.zeros((B, S), np.int32)
    seg[:, 13:] = 1
    xt = torch.from_numpy(x).requires_grad_()
    y = ref(xt, torch.arange(S)[None].expand(B, S), segment_ids=torch.from_numpy(seg))
    (y * y).sum().backward()
    ranks = run_ranks(_layer_worker, cp * mp, LAYER_CASES[name], state, x, seg, timeout=90)
    assert {r["rep"] for r in ranks} == {rep}
    by_c = {r["c"]: r for r in ranks}
    got = np.concatenate([by_c[c]["y"] for c in range(cp)], axis=1)
    grad = np.concatenate([by_c[c]["x_grad"] for c in range(cp)], axis=1)
    np.testing.assert_allclose(got, y.detach().numpy(), rtol=1e-5, atol=1e-5)
    scale = np.abs(xt.grad.numpy()).max()
    assert np.abs(grad - xt.grad.numpy()).max() <= 1e-5 * scale


# ------------------------------------------------------------ the refusals
class _Layout:
    """The sizes ``TransformerModel`` reads of a layout, without its groups."""

    world_size, pipe_parallel_size, data_parallel_size, model_parallel_size = 2, 1, 1, 1
    context_parallel_size, pipe_token_slices = 2, 1


@pytest.mark.parametrize("feature,arch", [
    ("lora_config", {"lora_config": {"name": "lo", "rank": 4}}),
    ("moe", {"mlp_type": "moe", "mlp_bias": False, "moe_num_experts": 2}),
    ("image_encoder", {"image_encoder": True}),
    ("embedding head", {"embedding_head_config": {"name": "emb", "proj_layers": [16]}}),
])
def test_model_features_without_a_sharded_form_raise_by_name_under_cp(feature, arch):
    from scaling_tpu_torch.models.transformer.config import TransformerArchitectureConfig
    from scaling_tpu_torch.models.transformer.model import TransformerModel

    from .test_torch_dist_helpers import TOY_ARCH

    config = TransformerArchitectureConfig.from_dict(dict(TOY_ARCH, **arch))
    with pytest.raises(NotImplementedError, match=feature.split("_config")[0]):
        TransformerModel(config, device="meta", topology=_Layout())


@pytest.mark.parametrize("kwargs,name", [
    ({"num_local_attention_heads": 1, "local_attention_window_size": 4}, "local-window"),
    ({"dropout_attention_probs": 0.1}, "attention-probability dropout"),
])
def test_what_the_jax_layer_asserts_under_cp_raises_by_name(kwargs, name):
    from scaling_tpu_torch.nn.attention import ParallelSelfAttention
    from scaling_tpu_torch.nn.base_layer import ContextShard

    with pytest.raises(NotImplementedError, match=name):
        ParallelSelfAttention(32, 4, context=ContextShard(size=2), **kwargs)


def test_scores_manipulation_and_a_kv_cache_raise_by_name_under_cp():
    from scaling_tpu_torch.nn.attention import ParallelSelfAttention
    from scaling_tpu_torch.nn.base_layer import ContextShard

    layer = ParallelSelfAttention(32, 4, context=ContextShard(size=2))
    x, pos = torch.zeros(1, 8, 32), torch.arange(8)[None]
    with pytest.raises(NotImplementedError, match="AtMan"):
        layer(x, pos, scores_manipulation=torch.zeros(1, 4, 8, 8))
    with pytest.raises(NotImplementedError, match="KV cache"):
        layer(x, pos, kv_cache=(torch.zeros(1, 16, 4, 8), torch.zeros(1, 16, 4, 8)),
              cache_offset=0)
