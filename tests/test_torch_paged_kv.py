"""The paged KV pool's addressing and writer: ``paged_flat_slots`` and
``paged_scatter_kv`` of the port against the JAX package's, native and
int8. Pools are compared without block 0 (the trash block): the order of
duplicate writes into it is undefined on both sides. The port writes in
place; the JAX package returns new pools."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from scaling_tpu.nn import attention as jax_attn  # noqa: E402
from scaling_tpu_torch.models.transformer import TransformerArchitectureConfig  # noqa: E402
from scaling_tpu_torch.nn import attention as port_attn  # noqa: E402
from scaling_tpu_torch.serve.kvcache import init_pools  # noqa: E402

BS, MAXB, NB, NKV, H = 4, 3, 10, 2, 8
TABLE = np.array([[3, 1, 0], [2, 5, 7], [0, 0, 0]], np.int32)


@pytest.mark.parametrize("positions", [
    [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9], [0, 0, 0, 0, 0]],
    [[9, 10, 11, 12, 13], [0, 4, 8, 11, 12], [1, 2, 3, 4, 5]],  # past the table
])
def test_flat_slots_match_jax(positions):
    pos = np.array(positions, np.int32)
    ref = jax_attn.paged_flat_slots(jnp.asarray(TABLE), jnp.asarray(pos), BS)
    out = port_attn.paged_flat_slots(torch.from_numpy(TABLE), torch.from_numpy(pos), BS)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("quantized", [False, True], ids=["native", "int8"])
def test_scatter_matches_jax(quantized):
    rng = np.random.default_rng(int(quantized))
    pos = np.array([[0, 1, 2, 3, 4], [5, 6, 7, 8, 9], [0, 1, 2, 3, 4]], np.int32)
    flat = np.array(jax_attn.paged_flat_slots(jnp.asarray(TABLE), jnp.asarray(pos), BS))
    flat[0, 3:] = 0  # padding rows route to the trash block (duplicates)
    flat = flat.reshape(-1)
    k = rng.normal(size=(flat.size, NKV, H)).astype(np.float32)
    v = rng.normal(size=(flat.size, NKV, H)).astype(np.float32)
    pool = rng.normal(size=(NB, BS, NKV, H)).astype(np.float32)
    scale = rng.uniform(0.1, 1.0, size=(NB, BS, NKV)).astype(np.float32)
    if quantized:
        pk = (rng.integers(-127, 128, size=pool.shape)).astype(np.int8)
        jview = jax_attn.PagedKVCacheView(
            jnp.asarray(pk), jnp.asarray(pk), jnp.asarray(TABLE), jnp.zeros(3, jnp.int32),
            jnp.asarray(scale), jnp.asarray(scale))
        tview = port_attn.PagedKVCacheView(
            torch.from_numpy(pk.copy()), torch.from_numpy(pk.copy()),
            torch.from_numpy(TABLE), torch.zeros(3, dtype=torch.int32),
            torch.from_numpy(scale.copy()), torch.from_numpy(scale.copy()))
    else:
        jview = jax_attn.PagedKVCacheView(
            jnp.asarray(pool), jnp.asarray(pool), jnp.asarray(TABLE), jnp.zeros(3, jnp.int32))
        tview = port_attn.PagedKVCacheView(
            torch.from_numpy(pool.copy()), torch.from_numpy(pool.copy()),
            torch.from_numpy(TABLE), torch.zeros(3, dtype=torch.int32))
    new = jax_attn.paged_scatter_kv(jview, jnp.asarray(flat), jnp.asarray(k), jnp.asarray(v))
    port_attn.paged_scatter_kv(tview, torch.from_numpy(flat), torch.from_numpy(k),
                               torch.from_numpy(v))
    pairs = [(tview.pool_k, new.pool_k), (tview.pool_v, new.pool_v)]
    if quantized:
        pairs += [(tview.scale_k, new.scale_k), (tview.scale_v, new.scale_v)]
    for ours, theirs in pairs:
        np.testing.assert_array_equal(ours.numpy()[1:], np.asarray(theirs)[1:])


def test_int8_quantizer_matches_jax_bit_for_bit():
    x = np.random.default_rng(5).normal(size=(64, NKV, H)).astype(np.float32)
    x[0] = 0.0  # all-zero rows take the 1e-8 floor scale
    x[1, 0, :] = np.linspace(-1.0, 1.0, H)  # values on rounding ties
    qj, sj = jax_attn.kv_quantize_int8(jnp.asarray(x))
    qt, st = port_attn.kv_quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_pools_are_shaped_by_the_architecture(kv_dtype):
    arch = TransformerArchitectureConfig.from_dict({
        "vocab_size": 64, "hidden_size": 256, "num_layers": 3,
        "num_attention_heads": 4, "attention_num_kv_heads": 2,
        "precision": "bfloat16", "mlp_type": "swiglu", "norm_type": "rms",
    })
    pools = init_pools(arch, num_blocks=6, block_size=4, kv_dtype=kv_dtype, device="cpu")
    assert pools.num_layers == 3 and pools.num_blocks == 6
    assert tuple(pools.pool_k[0].shape) == (6, 4, 2, 64)
    want = torch.int8 if kv_dtype == "int8" else torch.bfloat16
    assert pools.pool_k[0].dtype == want
    assert pools.quantized == (kv_dtype == "int8")
    if pools.quantized:
        assert tuple(pools.scale_k[0].shape) == (6, 4, 2)
        assert pools.scale_k[0].dtype == torch.float32
    # copy-on-write fork copies one block in every layer and tensor
    for t in pools.tensors():
        t[2] = 1
    pools.copy_block(2, 5)
    assert all(bool((t[5] == t[2]).all()) for t in pools.tensors())


@pytest.mark.parametrize("n_rep", [1, 4])
def test_repeat_kv_matches_jax(n_rep):
    x = np.random.default_rng(n_rep).normal(size=(2, 3, NKV, H)).astype(np.float32)
    ref = jax_attn.repeat_kv(jnp.asarray(x), n_rep)
    np.testing.assert_array_equal(port_attn.repeat_kv(torch.from_numpy(x), n_rep).numpy(),
                                  np.asarray(ref))
