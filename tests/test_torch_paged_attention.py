"""Kernel K1 (paged attention): the port's plain version against the JAX
Pallas kernel ``paged_decode_attention`` run in interpret mode (the CUDA
kernel against the plain version on the card is in
test_torch_kernels_gpu.py).

f32, atol 1e-5 (the same online softmax against a whole-window softmax:
summation order only). Covered: native and int8 pools (the same
``kv_quantize_int8`` scales on both sides), GQA n_rep 1 and 2, query
widths 1, 4 and 32, an all-trash row with ``valid_len`` 0, and causality
at the slot level. Then the cases the card kernel's tiling makes risky:
block sizes 8, 16 and 32; 32 tokens x 4 query heads (128 query vectors,
one block's worth) and n_rep 8; contexts that end on, just before and
just after a 64-slot KV tile or a 512-slot split; rows whose context
spans several splits. And the launcher's split plan: every visible slot
in exactly one split, splits past ``valid_len`` empty.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from scaling_tpu.nn.attention import kv_quantize_int8 as jax_quantize  # noqa: E402
from scaling_tpu.nn.paged_attention import paged_decode_attention  # noqa: E402
from scaling_tpu_torch.ops import launches, paged_attention  # noqa: E402
from scaling_tpu_torch.ops.paged_attention import (  # noqa: E402
    SPLIT_SLOTS,
    split_count,
    split_slots,
)

BS, MAXB, NB, H, N = 4, 12, 40, 16, 4
ATOL = 1e-5


def make_case(rng, n_kv, s, rows=4):
    """Pools, tables with distinct blocks per row, contexts including an
    idle row (all-trash table, nothing visible)."""
    pool_k = rng.normal(size=(NB, BS, n_kv, H)).astype(np.float32)
    pool_v = rng.normal(size=(NB, BS, n_kv, H)).astype(np.float32)
    q = rng.normal(size=(rows, s, N, H)).astype(np.float32)
    ctx = np.array([5, 0, 11, 2][:rows], np.int32)
    new = np.array([s, 0, s, min(s, 3)][:rows], np.int32)  # row 1 is idle
    valid = ctx + new
    tab = np.zeros((rows, MAXB), np.int32)
    perm = rng.permutation(np.arange(1, NB))
    used = 0
    for r in range(rows):
        if new[r] == 0:
            continue
        nblk = min(MAXB, -(-int(ctx[r] + s) // BS))
        tab[r, :nblk] = perm[used:used + nblk]
        used += nblk
    return q, pool_k, pool_v, tab, valid, ctx


def run_both(q, pool_k, pool_v, tab, valid, base, n_rep, quantized):
    sk = sv = None
    jsk = jsv = None
    if quantized:
        qk, jsk = jax_quantize(jnp.asarray(pool_k))
        qv, jsv = jax_quantize(jnp.asarray(pool_v))
        pool_k, pool_v = np.array(qk), np.array(qv)
        sk, sv = torch.from_numpy(np.array(jsk)), torch.from_numpy(np.array(jsv))
    ref = paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v), jnp.asarray(tab),
        jnp.asarray(valid), jnp.asarray(base), sm_scale=H ** -0.5,
        num_repeat_kv=n_rep, scale_k=jsk, scale_v=jsv, interpret=True,
    )
    out = paged_attention(
        torch.from_numpy(q), torch.from_numpy(pool_k), torch.from_numpy(pool_v),
        torch.from_numpy(tab), torch.from_numpy(valid), torch.from_numpy(base),
        sm_scale=H ** -0.5, num_repeat_kv=n_rep, scale_k=sk, scale_v=sv,
    )
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("quantized", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("n_rep", [1, 2])
@pytest.mark.parametrize("s", [1, 4, 32])
def test_plain_matches_pallas_kernel(quantized, n_rep, s):
    rng = np.random.default_rng(100 * s + 10 * n_rep + quantized)
    q, pool_k, pool_v, tab, valid, base = make_case(rng, N // n_rep, s)
    launches.reset()
    out, ref = run_both(q, pool_k, pool_v, tab, valid, base, n_rep, quantized)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    # on CPU tensors the wrapper ran the plain version, not the kernel
    name = "paged_attention_int8" if quantized else "paged_attention"
    assert launches.PLAIN[name] == 1 and sum(launches.KERNEL.values()) == 0


@pytest.mark.parametrize("quantized", [False, True], ids=["native", "int8"])
def test_all_trash_row_gives_zeros(quantized):
    rng = np.random.default_rng(7)
    q, pool_k, pool_v, _, _, _ = make_case(rng, 2, 4)
    tab = np.zeros((4, MAXB), np.int32)
    zero = np.zeros((4,), np.int32)
    out, ref = run_both(q, pool_k, pool_v, tab, zero, zero, 2, quantized)
    assert np.all(out == 0.0)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_slot_causality():
    """Token 0 of a 2-token row must not see token 1's slot: moving that
    slot's K/V leaves token 0's output where it was."""
    rng = np.random.default_rng(3)
    q, pool_k, pool_v, tab, valid, base = make_case(rng, 4, 2)
    out1, _ = run_both(q, pool_k, pool_v, tab, valid, base, 1, False)
    pk = pool_k.copy()
    for row in (0, 2):
        slot = int(base[row]) + 1
        pk[tab[row, slot // BS], slot % BS] += 100.0
    out2, ref2 = run_both(q, pk, pool_v, tab, valid, base, 1, False)
    np.testing.assert_allclose(out1[:, 0], out2[:, 0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(out2, ref2, atol=ATOL, rtol=0)
    assert not np.allclose(out1[0, 1], out2[0, 1])  # token 1 does see it


# block_size, n_kv, n_rep, s, max_blocks, each row's valid_len
TILING_CASES = {
    "bs8-tile-edges-128-vectors": (8, 1, 4, 32, 24, (64, 63, 65, 128)),
    "bs16-split-edges-nrep8": (16, 1, 8, 4, 48, (512, 511, 513, 0)),
    "bs32-several-splits": (32, 2, 2, 32, 48, (1024, 1023, 1025, 1536)),
    "bs16-long-row-nrep4": (16, 1, 4, 32, 96, (1500, 40, 1536, 700)),
}


def make_tiling_case(rng, bs, n_kv, n_rep, s, max_blocks, valid):
    """Rows of the given contexts, each ending in a chunk of up to ``s``
    new tokens, over distinct pool blocks (block 0 the trash block)."""
    rows = len(valid)
    valid = np.asarray(valid, np.int32)
    new = np.minimum(valid, s).astype(np.int32)
    ctx = valid - new
    nb = 1 + rows * max_blocks
    pool_k = rng.normal(size=(nb, bs, n_kv, H)).astype(np.float32)
    pool_v = rng.normal(size=(nb, bs, n_kv, H)).astype(np.float32)
    q = rng.normal(size=(rows, s, n_kv * n_rep, H)).astype(np.float32)
    perm = rng.permutation(np.arange(1, nb))
    tab = np.zeros((rows, max_blocks), np.int32)
    for r in range(rows):
        nblk = min(max_blocks, -(-int(valid[r]) // bs))
        tab[r, :nblk] = perm[r * max_blocks:r * max_blocks + nblk]
    return q, pool_k, pool_v, tab, valid, ctx.astype(np.int32)


@pytest.mark.parametrize("quantized", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("case", list(TILING_CASES))
def test_plain_matches_pallas_kernel_at_tile_and_split_edges(case, quantized):
    bs, n_kv, n_rep, s, max_blocks, valid = TILING_CASES[case]
    rng = np.random.default_rng(len(case) + quantized)
    q, pool_k, pool_v, tab, valid, base = make_tiling_case(rng, bs, n_kv, n_rep, s,
                                                           max_blocks, valid)
    assert split_count(max_blocks, bs) >= 1
    out, ref = run_both(q, pool_k, pool_v, tab, valid, base, n_rep, quantized)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_split_plan_covers_every_visible_slot_once():
    """The launcher's plan, as the kernel walks it: over a sweep of
    windows and contexts, the splits' slots are disjoint and together
    exactly the visible ones (``min(valid_len, window)``), each split stays
    inside its piece of the window, and every split at or past
    ``valid_len`` is empty."""
    for max_blocks in (1, 3, 31, 32, 33, 128, 200):
        for block_size in (1, 8, 16, 32, 48, 64):
            window = max_blocks * block_size
            n = split_count(max_blocks, block_size)
            assert n >= 1 and (n - 1) * SPLIT_SLOTS < window <= n * SPLIT_SLOTS
            for valid_len in sorted({0, 1, 63, 64, 65, 511, 512, 513, 1024, 1100,
                                     window - 1, window, window + 7}):
                if valid_len < 0:
                    continue
                seen = []
                for k in range(n):
                    got = split_slots(k, valid_len, max_blocks, block_size)
                    assert got.start == k * SPLIT_SLOTS and len(got) <= SPLIT_SLOTS
                    if k * SPLIT_SLOTS >= valid_len:
                        assert len(got) == 0, (max_blocks, block_size, valid_len, k)
                    seen.extend(got)
                assert seen == list(range(min(valid_len, window))), (
                    max_blocks, block_size, valid_len)
