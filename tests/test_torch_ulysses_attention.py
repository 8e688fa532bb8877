"""The port's Ulysses attention over gloo CPU ranks against JAX's
``ulysses_attention`` on the virtual devices (as
``tests/core/test_nn/test_ulysses_attention.py`` runs it), on the same
inputs drawn from a seed with numpy (``test_torch_ring_attention``'s
harness: ``(2, 32, n, 8)`` f32, the context ranks' sequence slices, the
model ranks' heads). Cases: cp 2 and 4, causal and not, packed segments,
GQA unrepeated (kv heads travel with their ``n_kv / cp`` shard), a partial
repeat under mp 2 (8 query heads over 2 kv heads repeated to 4: ``mp x cp``
must divide the kv heads, the layer's rule, and 2 copies a head do it where
the full repeat would take 4), and the refusal of query heads that do not
split over the context group (JAX asserts, the port raises ValueError,
both by the same words). Forward within 1e-5, q/k/v gradients within 1e-4.
In f32 the local attention is the grouped fallback in both packages (the
flash kernels take bf16 on the card: ``test_torch_kernels_gpu.py``). The
bytes of a call are the count from the shapes."""

import pytest

jax = pytest.importorskip("jax")

from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401
from .test_torch_ring_attention import B, D, S, check_case, run_cases  # noqa: E402

# name -> (variant, cp, mp, causal, packed, heads, kv heads, kv repeat, kv_chunk)
CASES = {
    "cp2_causal_gqa": ("ulysses", 2, 1, True, False, 4, 2, 1, None),
    "cp2_bidir_packed": ("ulysses", 2, 1, False, True, 4, 2, 1, None),
    "cp4_causal_packed": ("ulysses", 4, 1, True, True, 4, 4, 1, None),
    "cp4_bidir_gqa": ("ulysses", 4, 1, False, False, 8, 4, 1, None),
    "cp2_mp2_partial_repeat": ("ulysses", 2, 2, True, True, 8, 2, 2, None),
    "cp4_indivisible_heads": ("ulysses", 4, 1, True, False, 2, 2, 1, None),
}
SHAPED = [name for name in CASES if name != "cp4_indivisible_heads"]


@pytest.fixture(scope="module")
def results():
    return run_cases(CASES)


@pytest.mark.parametrize("name", SHAPED)
def test_ulysses_attention_matches_jax(results, name):
    check_case(results, CASES, name)


def test_heads_that_do_not_split_over_the_context_group_are_refused_as_in_jax(results):
    ranks, want = results["cp4_indivisible_heads"]
    assert "divisible by the context axis" in want["refused"]
    for rank in ranks:
        got = rank["cp4_indivisible_heads"]["refused"]
        assert got.startswith("ulysses needs local query heads (2) divisible by the context "
                              "axis (4)")


@pytest.mark.parametrize("name", SHAPED)
def test_ulysses_moves_the_bytes_the_shapes_give(results, name):
    """Forward: q, k, v and the output by all-to-all, the segment ids by
    all-gather; backward: the output's gradient, dq, dk and dv."""
    ranks, _ = results[name]
    _, cp, mp, _, _, n, n_kv, rep, _ = CASES[name]
    s_loc = S // cp
    q = B * s_loc * (n // mp) * D * 4
    kv = B * s_loc * (n_kv * rep // mp) * D * 4
    for r in ranks:
        fwd, both = r[name]["fwd_stats"], r[name]["stats"]
        assert fwd["all_to_all_bytes"] == 2 * q + 2 * kv
        assert fwd["all_gather_bytes"] == cp * B * s_loc * 4
        assert both["all_to_all_bytes"] == 4 * q + 4 * kv
        assert both["all_to_all_calls"] == 8
