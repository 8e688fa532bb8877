"""Tensor parallelism of the port at dp 2 x mp 2 on the CPU (JAX's
``tests/core/test_nn/test_tensor_parallel.py``, its limits: f32, atol
1e-5): the column- and row-parallel linears, the fused column -> row
region, the vocab-parallel embedding, the LM head's vocab-sharded product
gathered to full logits, SwiGLU and the attention (GQA with ``n_kv % mp
== 0``, with ``n_kv % mp != 0``, and the fused head-major
``query_key_value``), each run by four gloo ranks on the same numpy
weights as JAX's layer on a (data 2, model 2) mesh of the virtual CPU
devices and on one device: the outputs put together from the ranks'
rows, and the gradients of ``sum(y * g)`` (the parameters' summed over
the data ranks and put together over the model ranks, the input's by
rows) against ``jax.grad``. Beside them: each parameter's split dim is
the one JAX's partition spec names, and a model rank's initialisation is
the slice of the one-rank initialisation from the same seed."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from scaling_tpu.nn import (  # noqa: E402
    ColumnParallelLinear as JaxColumn,
    ForwardContext,
    ParallelSelfAttention as JaxAttention,
    ParallelSwiGLUMLP as JaxSwiGLU,
    RotaryConfig,
    RowParallelLinear as JaxRow,
    VocabParallelEmbedding as JaxEmbedding,
)
from scaling_tpu.topology import Topology as JaxTopology, TopologyConfig as JaxTopologyConfig  # noqa: E402

from .test_torch_dist_helpers import layer_worker, run_ranks  # noqa: E402
from .test_torch_parity_helpers import draw, module_state, one_torch_thread  # noqa: E402,F401

MP, DP = 2, 2
B, S = 4, 8


@pytest.fixture(scope="module")
def mesh():
    return JaxTopology(JaxTopologyConfig(model_parallel_size=MP, pipe_parallel_size=1,
                                         data_parallel_size=DP, micro_batch_size=2,
                                         gradient_accumulation_steps=1)).mesh


class _Seq:
    """JAX column -> row, the fused region."""

    def __init__(self, col, row):
        self.col, self.row = col, row

    def init(self, key):
        k1, k2 = jax.random.split(key)
        return {"0": self.col.init(k1), "1": self.row.init(k2)}

    def param_metas(self):
        return {"0": self.col.param_metas(), "1": self.row.param_metas()}

    def __call__(self, params, x, ctx, **kw):
        return self.row(params["1"], self.col(params["0"], x, ctx), ctx)


def _jax_layer(kind, cfg):
    if kind == "column":
        return JaxColumn(cfg["d_in"], cfg["d_out"], parallel_output=True)
    if kind == "row":
        return JaxRow(cfg["d_in"], cfg["d_out"])
    if kind == "column_row":
        return _Seq(JaxColumn(cfg["d_in"], cfg["d_mid"], parallel_output=True),
                    JaxRow(cfg["d_mid"], cfg["d_in"], parallel_input=True))
    if kind == "embedding":
        return JaxEmbedding(cfg["vocab"], cfg["hidden"])
    if kind == "head":
        return JaxColumn(cfg["hidden"], cfg["vocab"], bias=False)
    if kind == "swiglu":
        return JaxSwiGLU(cfg["hidden"], cfg["factor"], bias=True)
    head_dim = cfg["hidden"] // cfg["heads"]
    return JaxAttention(cfg["hidden"], cfg["heads"], num_kv_heads=cfg["kv"],
                        qkv_in_one=cfg["qkv_in_one"],
                        rotary_config=RotaryConfig(dimensions=head_dim,
                                                   max_seq_length=cfg["seq"]))


CASES = {
    "column": ({"d_in": 32, "d_out": 64}, "float"),
    "row": ({"d_in": 64, "d_out": 32}, "float"),
    "column_row": ({"d_in": 32, "d_mid": 64}, "float"),
    "embedding": ({"vocab": 128, "hidden": 32}, "ids"),
    "head": ({"hidden": 32, "vocab": 128}, "float"),
    "swiglu": ({"hidden": 32, "factor": 2.0}, "float"),
    "attention_gqa": ({"hidden": 64, "heads": 4, "kv": 2, "qkv_in_one": False, "seq": S},
                      "float"),
    "attention_kv_not_split": ({"hidden": 64, "heads": 4, "kv": 1, "qkv_in_one": False,
                                "seq": S}, "float"),
    "attention_qkv_in_one": ({"hidden": 64, "heads": 4, "kv": None, "qkv_in_one": True,
                              "seq": S}, "float"),
}


def _inputs(case, cfg, rng):
    width = cfg.get("d_in", cfg.get("hidden"))
    if CASES[case][1] == "ids":
        return rng.integers(0, cfg["vocab"], size=(B, S)).astype(np.int64)
    return rng.normal(size=(B, S, width)).astype(np.float32)


def _state(kind, tree) -> dict:
    """The port's state dict of a JAX layer's tree (an embedding table is
    ``(vocab, hidden)`` on both sides)."""
    if kind == "embedding":
        return {k: np.asarray(v) for k, v in tree.items()}
    return {k: v.numpy() for k, v in module_state(jax.tree.map(np.asarray, tree)).items()}


@pytest.mark.parametrize("case", list(CASES))
def test_layer_at_dp2_mp2_matches_jax_mesh_and_one_device(mesh, case):
    cfg, _ = CASES[case]
    kind = "attention" if case.startswith("attention") else case
    layer = _jax_layer(kind, cfg)
    params = draw(layer, seed=3)
    rng = np.random.default_rng(4)
    x = _inputs(case, cfg, rng)
    extra, call_kw = {}, {}
    if kind == "attention":
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
        seg = np.zeros((B, S), np.int32)
        seg[1, 5:] = 1
        extra = {"position_ids": pos, "segment_ids": seg}
        call_kw = {"position_ids": jnp.asarray(pos), "segment_ids": jnp.asarray(seg)}
    jparams = jax.tree.map(jnp.asarray, params)
    plain = layer(jparams, jnp.asarray(x), ForwardContext(), **call_kw)
    g = rng.normal(size=plain.shape).astype(np.float32)

    # JAX on the (data 2, model 2) mesh
    metas = layer.param_metas()
    placed = jax.tree.map(lambda p, m: jax.device_put(p, NamedSharding(mesh, m.spec())),
                          jparams, metas, is_leaf=lambda v: hasattr(v, "partition_spec"))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data", *([None] * (x.ndim - 1)))))
    ctx = ForwardContext(mesh=mesh, model_parallel_size=MP)
    on_mesh = jax.jit(lambda p, xx: layer(p, xx, ctx, **call_kw))(placed, xs)
    np.testing.assert_allclose(np.asarray(on_mesh), np.asarray(plain), atol=1e-5)

    def loss(p, xx):
        return (layer(p, xx, ForwardContext(), **call_kw) * jnp.asarray(g)).sum()

    if CASES[case][1] == "ids":
        jax_grads, jax_xgrad = jax.grad(loss)(jparams, jnp.asarray(x)), None
    else:
        jax_grads, jax_xgrad = jax.grad(loss, argnums=(0, 1))(jparams, jnp.asarray(x))
    full = _state(kind, params)
    out = run_ranks(layer_worker, MP * DP, MP, DP, kind, cfg, full, x, g, extra)
    # rank = data_rank * mp + model_rank
    ranks = [[out[d * MP + m] for m in range(MP)] for d in range(DP)]
    y = np.concatenate([ranks[d][0]["y"] for d in range(DP)])
    for d in range(DP):
        for m in range(1, MP):
            np.testing.assert_allclose(ranks[d][m]["y"], ranks[d][0]["y"], atol=1e-6)
    np.testing.assert_allclose(y, np.asarray(on_mesh), atol=1e-5)
    want = _state(kind, jax_grads)
    for name, w in want.items():
        per_model = [sum(ranks[d][m]["grads"][name] for d in range(DP)) for m in range(MP)]
        if per_model[0].shape == w.shape:
            got = per_model[0]
            for m in range(1, MP):
                np.testing.assert_allclose(per_model[m], got, atol=1e-5, err_msg=name)
        else:
            dim = next(i for i in range(w.ndim) if per_model[0].shape[i] != w.shape[i])
            got = np.concatenate(per_model, axis=dim)
        np.testing.assert_allclose(got, w, atol=1e-5, err_msg=name)
    if jax_xgrad is not None:
        xg = np.concatenate([ranks[d][0]["x_grad"] if kind != "row" else np.concatenate(
            [ranks[d][m]["x_grad"] for m in range(MP)], axis=-1) for d in range(DP)])
        np.testing.assert_allclose(xg, np.asarray(jax_xgrad), atol=1e-5)


def test_split_dims_follow_the_jax_partition_specs_and_the_init_is_the_one_rank_slice():
    """Every parameter of a dp 2 x mp 2 model is split over the model group
    along the dim JAX's partition spec names (``leaf_layouts``), and its
    shard equals that slice of the one-rank model drawn from the same seed
    (the tied table included)."""
    from .test_torch_dist_helpers import model_layout_worker

    one = run_ranks(model_layout_worker, 1, 1, 1)[0]
    four = run_ranks(model_layout_worker, 4, 2, 2)
    for rank, got in enumerate(four):
        mp_rank = rank % MP
        for name, whole in one["params"].items():
            shard, dim = got["params"][name], got["model_dims"][name]
            if dim is None:
                assert shard.shape == whole.shape, name
                np.testing.assert_array_equal(shard, whole, err_msg=name)
            else:
                n = whole.shape[dim] // MP
                np.testing.assert_array_equal(
                    shard, np.take(whole, range(mp_rank * n, (mp_rank + 1) * n), axis=dim),
                    err_msg=name)
        assert got["sharded"] == {n for n, d in got["model_dims"].items() if d is not None}
