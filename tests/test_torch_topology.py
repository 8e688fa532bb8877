"""The port's topology against the JAX package's: the flat-rank math of
every (pp, dp, cp, mp) grid of up to 8 devices equal to JAX's
``Topology`` (``get_global_rank``, the ``*_rank_of`` accessors, the
first/last pipe stage and the io ranks), the config's derivation of the
sizes and of the batch split equal to JAX's ``TopologyConfig``, and the
parts that are not ported refused by name. The backend rule: NCCL where
each local rank has a card, gloo where ranks share one or run on the
CPU. A 4-rank gloo world builds the model and data groups JAX's mesh
axes give."""

import itertools

import pytest

jax = pytest.importorskip("jax")

from scaling_tpu.topology import Topology as JaxTopology  # noqa: E402
from scaling_tpu.topology import TopologyConfig as JaxTopologyConfig  # noqa: E402
from scaling_tpu_torch.topology import TopologyConfig, choose_backend  # noqa: E402
from scaling_tpu_torch.topology.topology import grid_rank, rank_coords  # noqa: E402

from .test_torch_dist_helpers import run_ranks, topology  # noqa: E402

GRIDS = [g for g in itertools.product((1, 2, 4, 8), repeat=4)
         if g[0] * g[1] * g[2] * g[3] <= 8 and not (g[0] > 1 and g[2] > 1)]


@pytest.mark.parametrize("pp,dp,cp,mp", GRIDS, ids=[f"pp{a}dp{b}cp{c}mp{d}" for a, b, c, d in GRIDS])
def test_rank_math_equals_jax(pp, dp, cp, mp):
    jax_topo = JaxTopology(JaxTopologyConfig(
        pipe_parallel_size=pp, data_parallel_size=dp, context_parallel_size=cp,
        model_parallel_size=mp, micro_batch_size=1, gradient_accumulation_steps=1))
    sizes = (pp, dp, cp, mp)
    seen = set()
    for p, d, c, m in itertools.product(range(pp), range(dp), range(cp), range(mp)):
        r = grid_rank(sizes, p, d, m, c)
        assert r == jax_topo.get_global_rank(p, d, m, c)
        assert rank_coords(sizes, r) == [p, d, c, m]
        assert rank_coords(sizes, r) == [jax_topo.pipe_parallel_rank_of(r),
                                         jax_topo.data_parallel_rank_of(r),
                                         jax_topo.context_parallel_rank_of(r),
                                         jax_topo.model_parallel_rank_of(r)]
        seen.add(r)
    assert seen == set(range(pp * dp * cp * mp))


def _jax_sizes(d: dict) -> tuple:
    c = JaxTopologyConfig(**d)
    return (c.world_size, c.model_parallel_size, c.data_parallel_size, c.global_batch_size,
            c.micro_batch_size, c.gradient_accumulation_steps, c.pipe_parallel_size,
            c.pipe_virtual_size)


def _port_sizes(d: dict) -> tuple:
    c = TopologyConfig.from_dict(d)
    return (c.world_size, c.model_parallel_size, c.data_parallel_size, c.global_batch_size,
            c.micro_batch_size, c.gradient_accumulation_steps, c.pipe_parallel_size,
            c.pipe_virtual_size)


DERIVED = [
    {"model_parallel_size": 2, "data_parallel_size": 2, "pipe_parallel_size": 1,
     "micro_batch_size": 2, "gradient_accumulation_steps": 3},
    {"world_size": 8, "model_parallel_size": 4, "pipe_parallel_size": 1,
     "global_batch_size": 16, "micro_batch_size": 4},
    {"world_size": 4, "data_parallel_size": 4, "pipe_parallel_size": 1,
     "global_batch_size": 32, "gradient_accumulation_steps": 2},
    {"world_size": 2, "model_parallel_size": 1, "data_parallel_size": 2,
     "global_batch_size": 8, "micro_batch_size": 2},
    {"model_parallel_size": 1, "pipe_parallel_size": 1, "data_parallel_size": 1,
     "micro_batch_size": 4, "gradient_accumulation_steps": 1},
    {"world_size": 8, "pipe_parallel_size": 2, "data_parallel_size": 2,
     "micro_batch_size": 2, "gradient_accumulation_steps": 4, "pipe_virtual_size": 2},
    {"world_size": 4, "model_parallel_size": 2, "data_parallel_size": 1,
     "global_batch_size": 8, "micro_batch_size": 2},
]


@pytest.mark.parametrize("d", DERIVED, ids=[str(i) for i in range(len(DERIVED))])
def test_the_config_derives_the_sizes_as_jax(d):
    assert _port_sizes(d) == _jax_sizes(d)


def test_one_device_configs_parse_as_before():
    c = TopologyConfig.from_dict({"micro_batch_size": 2, "gradient_accumulation_steps": 3})
    assert (c.world_size, c.data_parallel_size, c.model_parallel_size, c.global_batch_size) == (
        1, 1, 1, 6)
    with pytest.raises(ValueError, match="world_size 4 does not equal"):
        TopologyConfig.from_dict({"world_size": 4, "model_parallel_size": 2,
                                  "data_parallel_size": 1, "pipe_parallel_size": 1,
                                  "micro_batch_size": 1})
    with pytest.raises(ValueError, match="global_batch_size 5"):
        TopologyConfig.from_dict({"data_parallel_size": 2, "model_parallel_size": 1,
                                  "global_batch_size": 5, "micro_batch_size": 2,
                                  "gradient_accumulation_steps": 1})


# pipelining is ported: its keys' cases now check what stays refused beside
# them (token slices under pp 2, a partition method JAX lacks, a remat mode
# JAX lacks)
REFUSED = [
    ("pipe_parallel_size", {"pipe_parallel_size": 2, "pipe_token_slices": 2},
     "token slices"),
    ("context_parallel_size", {"context_parallel_size": 2}, "context parallelism"),
    ("pipe_virtual_size", {"pipe_parallel_size": 2, "pipe_virtual_size": 2,
                           "pipe_partition_method": "type:transformer"},
     "pipe_partition_method"),
    ("pipe_token_slices", {"pipe_token_slices": 2}, "token slices"),
    ("sequence_parallel", {"sequence_parallel": True}, "sequence parallelism"),
    ("activation_checkpointing_type", {"activation_checkpointing_type": "every_two_layers"},
     "every_two_layers"),
]


@pytest.mark.parametrize("key,extra,name", REFUSED, ids=[k for k, _, _ in REFUSED])
def test_what_is_not_ported_is_refused_by_name(key, extra, name):
    d = {"model_parallel_size": 2, "data_parallel_size": 2, "micro_batch_size": 1,
         "gradient_accumulation_steps": 2, **extra}
    with pytest.raises(NotImplementedError, match=name):
        TopologyConfig.from_dict(d)


def test_the_backend_rule():
    assert choose_backend("cuda", local_world_size=4, device_count=8) == "nccl"
    assert choose_backend("cuda", local_world_size=4, device_count=4) == "nccl"
    assert choose_backend("cuda", local_world_size=4, device_count=1) == "gloo"
    assert choose_backend("cpu", local_world_size=1, device_count=0) == "gloo"


def _groups(rank: int, world: int):
    topo = topology(2, 2)
    return {"model": topo.model_ranks, "data": topo.data_ranks,
            "coords": (topo.data_parallel_rank, topo.model_parallel_rank),
            "io": topo.is_io_rank(), "backend": topo.backend}


def test_groups_of_a_four_rank_world_follow_the_mesh_axes():
    jax_topo = JaxTopology(JaxTopologyConfig(pipe_parallel_size=1, data_parallel_size=2,
                                             model_parallel_size=2, micro_batch_size=1,
                                             gradient_accumulation_steps=1))
    out = run_ranks(_groups, 4)
    for rank, got in enumerate(out):
        d, m = jax_topo.data_parallel_rank_of(rank), jax_topo.model_parallel_rank_of(rank)
        assert got["coords"] == (d, m) and got["backend"] == "gloo"
        assert got["model"] == [jax_topo.get_global_rank(0, d, j) for j in range(2)]
        assert got["data"] == [jax_topo.get_global_rank(0, j, m) for j in range(2)]
        assert got["io"] == jax_topo.is_io_rank(rank)
