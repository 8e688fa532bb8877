"""``generate``, ``logits`` and ``hidden_states`` of the port against the JAX
package's ``TransformerInferenceModule`` on carried weights (numpy draws in
the JAX tree's shapes, ``params_from_jax``), both on the CPU in f32.

Checked: greedy tokens identical and each emitted token's logits within
rtol 1e-4 (atol 1e-5 for logits near 0) for a rectangular batch, a ragged
batch (left padding), a 1-D prompt, ``eos_token_id`` with ``stop_tokens``,
``use_cache=False`` and ``fused_decode`` both ways; full-sequence logits
and every layer's hidden state within atol 1e-4. Sampled decoding is held
to its masks and to its seed, not to JAX's draws: the port draws from a
counter-based hash, JAX from threefry, so the sampled tokens differ.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from scaling_tpu_torch.models.transformer.inference import make_sampler  # noqa: E402
from scaling_tpu_torch.ops import launches  # noqa: E402

from .test_torch_parity_helpers import draw, inference_pair, module_state  # noqa: E402
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401

VOCAB = 96
ARCHS = {
    # the JAX defaults (layernorm, GELU MLP, rotary, qkv in one) with a tied head
    # and key/query norm
    "jax_defaults": {"vocab_size": VOCAB, "hidden_size": 64, "num_layers": 2,
                     "num_attention_heads": 4, "sequence_length": 64, "precision": "float32",
                     "weight_tying": True, "key_query_norm": True},
    # the bench family: rms, SwiGLU, GQA, untied
    "rms_swiglu_gqa": {"vocab_size": VOCAB, "hidden_size": 64, "num_layers": 2,
                       "num_attention_heads": 4, "attention_num_kv_heads": 2,
                       "attention_qkv_in_one": False, "sequence_length": 64,
                       "precision": "float32", "norm_type": "rms", "mlp_type": "swiglu",
                       "mlp_factor": 2.75},
}
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", params=list(ARCHS))
def pair(request):
    return inference_pair(ARCHS[request.param])


def prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=n).tolist() for n in lengths]


def assert_same(ref, out):
    ref = ref if isinstance(ref, list) else [ref]
    out = out if isinstance(out, list) else [out]
    assert [r.completion_ids for r in ref] == [o.completion_ids for o in out]
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.logits.numpy(), np.asarray(r.logits), **LOGIT_TOL)


@pytest.mark.parametrize("kind", ["rectangular", "ragged", "single"])
@pytest.mark.parametrize("fused_decode", [True, False], ids=["fused", "per_step"])
def test_greedy_generate_matches_jax(pair, kind, fused_decode):
    jax_inf, port_inf = pair
    batch = {"rectangular": np.asarray(prompts([10, 10, 10])),
             "ragged": prompts([4, 11, 7]), "single": prompts([9])[0]}[kind]
    ref = jax_inf.generate(batch, max_tokens=7, fused_decode=fused_decode)
    out = port_inf.generate(batch, max_tokens=7, fused_decode=fused_decode)
    assert isinstance(out, list) == (kind != "single")
    assert_same(ref, out)


@pytest.mark.parametrize("kind", ["rectangular", "ragged"])
def test_uncached_generate_matches_jax_and_the_cache(pair, kind):
    jax_inf, port_inf = pair
    batch = np.asarray(prompts([8, 8])) if kind == "rectangular" else prompts([3, 8])
    ref = jax_inf.generate(batch, max_tokens=5, use_cache=False)
    out = port_inf.generate(batch, max_tokens=5, use_cache=False)
    assert_same(ref, out)
    assert_same(out, port_inf.generate(batch, max_tokens=5))


@pytest.mark.parametrize("fused_decode", [True, False], ids=["fused", "per_step"])
def test_stop_tokens_and_eos_end_rows_as_jax(pair, fused_decode):
    jax_inf, port_inf = pair
    batch = prompts([5, 12, 8], seed=3)
    free = port_inf.generate(batch, max_tokens=8)
    eos = free[0].completion_ids[2]
    stops = [free[1].completion_ids[4]]
    ref = jax_inf.generate(batch, max_tokens=8, eos_token_id=eos, stop_tokens=stops,
                           fused_decode=fused_decode)
    out = port_inf.generate(batch, max_tokens=8, eos_token_id=eos, stop_tokens=stops,
                            fused_decode=fused_decode)
    assert_same(ref, out)
    assert len(out[0].completion_ids) <= 3 and len(out[1].completion_ids) <= 5
    assert all(o.completion_ids[-1] in {eos, *stops} for o in out
               if len(o.completion_ids) < 8)


def test_a_ragged_row_generates_what_it_generates_alone(pair):
    _, port_inf = pair
    batch = prompts([3, 13, 6], seed=4)
    together = port_inf.generate(batch, max_tokens=6)
    for p, row in zip(batch, together):
        alone = port_inf.generate(p, max_tokens=6)
        assert row.completion_ids == alone.completion_ids
        np.testing.assert_allclose(row.logits.numpy(), alone.logits.numpy(), **LOGIT_TOL)


def test_logits_and_hidden_states_match_jax(pair):
    jax_inf, port_inf = pair
    tokens = np.asarray(prompts([12, 12], seed=5))
    np.testing.assert_allclose(port_inf.logits(tokens).numpy(),
                               np.asarray(jax_inf.logits(tokens)), atol=1e-4)  # f32, 2 layers
    ref = jax_inf.hidden_states(tokens, exclude=[0])
    out = port_inf.hidden_states(tokens, exclude=[0])
    assert sorted(out) == sorted(ref)
    for name, value in ref.items():
        np.testing.assert_allclose(out[name].numpy(), np.asarray(value), atol=1e-4,
                                   err_msg=name)


def test_generate_runs_no_kernel_or_cache_path_it_should_not(pair):
    """On the CPU the f32 model runs no kernel; the prefill feeds only the
    sampled position to the head: one logits row a sequence a step."""
    _, port_inf = pair
    launches.reset()
    out = port_inf.generate(prompts([6, 6]), max_tokens=4)
    assert not launches.KERNEL
    assert all(o.logits.shape == (4, VOCAB) for o in out)


def test_sampled_decoding_respects_its_masks_and_repeats_under_a_seed(pair):
    """Top-k 3 keeps every draw among each step's 3 best logits; top-p 0.5
    keeps it in the step's nucleus; a seed repeats its draws and another
    seed changes them. The draws are the port's counter-based hash, not
    JAX's threefry, so they are not compared with JAX's."""
    _, port_inf = pair
    batch = prompts([7, 7, 7, 7], seed=6)

    def run(seed, **kw):
        return port_inf.generate(batch, max_tokens=12, sample_fn=make_sampler(**kw), seed=seed)

    out = run(1, temperature=2.0, top_k=3)
    for o in out:
        top3 = torch.topk(o.logits.float(), 3, dim=-1).indices
        assert all(t in top3[j].tolist() for j, t in enumerate(o.completion_ids))
    again = run(1, temperature=2.0, top_k=3)
    assert [o.completion_ids for o in out] == [o.completion_ids for o in again]
    hot = run(1, temperature=5.0)
    other = run(2, temperature=5.0)
    assert [o.completion_ids for o in hot] != [o.completion_ids for o in other]
    nucleus = run(3, temperature=1.0, top_p=0.5)
    for o in nucleus:
        probs = torch.softmax(o.logits.float(), dim=-1)
        for j, t in enumerate(o.completion_ids):
            p = probs[j]
            # in the nucleus: the mass strictly above the token's is below top_p
            assert float(p[p > p[t]].sum()) < 0.5
    cold = run(4, temperature=1e-4)  # temperature -> 0 is greedy
    greedy = port_inf.generate(batch, max_tokens=12)
    assert [o.completion_ids for o in cold] == [o.completion_ids for o in greedy]


def test_three_tuple_cache_keeps_packed_documents_apart():
    """A dense cache that carries each slot's segment id (the JAX layer's
    3-tuple cache): a packed sequence fed in two chunks through it gives
    the attention of the whole sequence at once, and JAX's, within atol
    1e-5 (f32)."""
    import jax.numpy as jnp

    from scaling_tpu.nn import ParallelSelfAttention as JaxAttention
    from scaling_tpu.nn import RotaryConfig
    from scaling_tpu.nn.base_layer import ForwardContext
    from scaling_tpu_torch.nn.attention import ParallelSelfAttention
    from scaling_tpu_torch.nn.rotary import RotaryEmbedding

    b, s, hidden, heads, cut = 2, 12, 64, 4, 5
    rng = np.random.default_rng(8)
    x = rng.normal(size=(b, s, hidden)).astype(np.float32)
    seg = np.zeros((b, s), np.int32)
    seg[:, 3:], seg[1, 9:] = 1, 2
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    jax_attn = JaxAttention(hidden, heads, rotary_config=RotaryConfig(dimensions=16,
                                                                      max_seq_length=s))
    params = draw(jax_attn)
    attn = ParallelSelfAttention(hidden, heads, qkv_in_one=True, rotary=RotaryEmbedding(16, s))
    attn.load_state_dict(module_state(params))
    whole = attn(torch.from_numpy(x), torch.from_numpy(pos),
                 segment_ids=torch.from_numpy(seg)).detach()
    cache = (torch.zeros(b, s, heads, 16), torch.zeros(b, s, heads, 16),
             torch.zeros(b, s, dtype=torch.int32))
    jax_cache = tuple(jnp.asarray(t.numpy()) for t in cache)
    parts, jax_parts = [], []
    for lo, hi in ((0, cut), (cut, s)):
        parts.append(attn(torch.from_numpy(x[:, lo:hi]), torch.from_numpy(pos[:, lo:hi]), cache,
                          torch.from_numpy(seg[:, lo:hi]), cache_offset=lo).detach())
        out, jax_cache = jax_attn(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x[:, lo:hi]), ForwardContext(),
            segment_ids=jnp.asarray(seg[:, lo:hi]), position_ids=jnp.asarray(pos[:, lo:hi]),
            kv_cache=jax_cache, cache_offset=lo)
        jax_parts.append(np.asarray(out))
    chunked = torch.cat(parts, dim=1)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-5)
    np.testing.assert_allclose(chunked.numpy(), np.concatenate(jax_parts, axis=1), atol=1e-5)
