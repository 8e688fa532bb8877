"""Dropout under sequence parallelism against the JAX package, with JAX's
masks replayed (``test_torch_dropout.py``'s method): the JAX step runs
eagerly on one device and records each mask it draws; the port's step at
a layout with ``sequence_parallel`` takes those whole masks through its
mask source, and each rank keeps its slice (``nn.base_layer``). At mp 2 x
cp 2 ring the sites between the tensor-parallel regions (the embedding's,
after the attention, after the MLP) cut the sequence by the composed shard,
context rank x mp + model rank of cp x mp; at pp 2 x mp 2 x 2 token slices
by token slice x mp + model rank, and the attention probabilities' mask
(inside the region, probability dropout refused under context parallelism
as in JAX) by the model rank's heads and the slice's queries and keys. A
toy rms/swiglu model (hidden 64, 2 layers, 4/2 heads, vocab 96, seq 32,
f32, untied), micro-batch 2, 3 steps from the same weights: each rank's
losses and global gradient norms within rtol 1e-5 of JAX's.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from scaling_tpu_torch.models.transformer import TransformerConfig  # noqa: E402
from scaling_tpu_torch.models.transformer.convert import params_from_jax  # noqa: E402

from .test_torch_dist_helpers import dropout_replay_worker, run_ranks  # noqa: E402
from .test_torch_dropout import MBS, batches, draw_np_params, jax_run  # noqa: E402
from .test_torch_parity_helpers import config_dict, one_torch_thread  # noqa: E402,F401

ARCH = {
    "vocab_size": 96, "hidden_size": 64, "num_layers": 2, "num_attention_heads": 4,
    "attention_num_kv_heads": 2, "attention_qkv_in_one": False, "sequence_length": 32,
    "precision": "float32", "norm_type": "rms", "mlp_type": "swiglu", "mlp_factor": 2.0,
    "dropout_embedding": 0.2, "dropout_after_attention": 0.3, "dropout_after_mlp": 0.1,
}
LAYOUTS = {  # name -> (topology keys, rates added to ARCH)
    "mp2_cp2_ring": ({"model_parallel_size": 2, "context_parallel_size": 2,
                      "context_parallel_variant": "ring"}, {}),
    "pp2_mp2_s2": ({"model_parallel_size": 2, "pipe_parallel_size": 2,
                    "pipe_token_slices": 2}, {"dropout_attention_probs": 0.15}),
}
STEPS = 3
RTOL, ATOL = 1e-5, 1e-6


def sites(arch: dict) -> list:
    """The port's site ids in the JAX package's call order."""
    out = ["layer_0.embedding"]
    for i in range(1, arch["num_layers"] + 1):
        if arch.get("dropout_attention_probs", 0) > 0:
            out.append(f"layer_{i}.attention.attention_probs")
        out += [f"layer_{i}.after_attention", f"layer_{i}.after_mlp"]
    return out


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_sequence_parallel_dropout_matches_jax_with_its_masks_replayed(name):
    topo, rates = LAYOUTS[name]
    arch = dict(ARCH, **rates)
    np_params = draw_np_params(arch)
    losses, norms, masks = jax_run(arch, np_params, STEPS)
    order = sites(arch)
    assert all(len(m) == len(order) for m in masks), ([len(m) for m in masks], order)
    cfg = config_dict(arch, mbs=MBS)
    cfg["topology"].update(topo, sequence_parallel=True)
    config = TransformerConfig.from_dict(cfg)
    assert config.topology.sequence_parallel
    whole = {n: t.numpy() for n, t in
             params_from_jax(np_params, config.transformer_architecture).items()}
    world = config.topology.world_size
    ranks = run_ranks(dropout_replay_worker, world, cfg, whole, batches(STEPS),
                      [dict(zip(order, m)) for m in masks], timeout=120)
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], losses, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(rank["norms"], norms, rtol=RTOL, atol=ATOL)
