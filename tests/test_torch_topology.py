"""The port's topology against the JAX package's: the flat-rank math of
every (pp, dp, cp, mp) grid of up to 8 devices equal to JAX's
``Topology`` (``get_global_rank``, the ``*_rank_of`` accessors, the
first/last pipe stage and the io ranks), the config's derivation of the
sizes (context parallelism counted into the world) and of the batch split
equal to JAX's ``TopologyConfig``, JAX's checks of the knobs that combine
(context parallelism with a pipe, token slices without one or with virtual
stages, an unknown variant) refused as JAX refuses them, and the parts
that are not ported refused by name. The backend rule: NCCL where
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
            c.pipe_virtual_size, c.context_parallel_size, c.pipe_token_slices,
            c.context_parallel_variant.value)


def _port_sizes(d: dict) -> tuple:
    c = TopologyConfig.from_dict(d)
    return (c.world_size, c.model_parallel_size, c.data_parallel_size, c.global_batch_size,
            c.micro_batch_size, c.gradient_accumulation_steps, c.pipe_parallel_size,
            c.pipe_virtual_size, c.context_parallel_size, c.pipe_token_slices,
            c.context_parallel_variant)


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
    {"world_size": 8, "context_parallel_size": 2, "data_parallel_size": 2,
     "pipe_parallel_size": 1, "micro_batch_size": 2, "gradient_accumulation_steps": 3},
    {"model_parallel_size": 2, "data_parallel_size": 1, "pipe_parallel_size": 1,
     "context_parallel_size": 4, "context_parallel_variant": "ulysses",
     "global_batch_size": 4, "micro_batch_size": 2},
    {"world_size": 4, "pipe_parallel_size": 2, "model_parallel_size": 1,
     "micro_batch_size": 1, "gradient_accumulation_steps": 4, "pipe_token_slices": 4},
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


# pipelining, its token slices and context parallelism are ported: their
# keys' cases check JAX's own checks of the combinations (ValueError, with
# JAX's words, where JAX asserts) beside what stays refused by name
# (NotImplementedError: sequence parallelism, a partition method JAX lacks,
# a remat mode JAX lacks)
REFUSED = [
    ("pipe_parallel_size", {"pipe_parallel_size": 2, "context_parallel_size": 2},
     ValueError, "context_parallel_size > 1 requires pipe_parallel_size == 1"),
    ("context_parallel_size", {"context_parallel_size": 2,
                               "context_parallel_variant": "zigzag"},
     ValueError, "context_parallel_variant"),
    ("pipe_virtual_size", {"pipe_parallel_size": 2, "pipe_virtual_size": 2,
                           "pipe_partition_method": "type:transformer"},
     NotImplementedError, "pipe_partition_method"),
    ("pipe_token_slices", {"pipe_token_slices": 2}, ValueError,
     "pipe_token_slices > 1 requires pipe_parallel_size > 1"),
    ("pipe_virtual_size_with_token_slices", {"pipe_parallel_size": 2, "pipe_virtual_size": 2,
                                             "pipe_token_slices": 2},
     ValueError, "pipe_virtual_size and pipe_token_slices are mutually exclusive"),
    ("sequence_parallel", {"sequence_parallel": 2}, ValueError, "sequence_parallel"),
    ("activation_checkpointing_type", {"activation_checkpointing_type": "every_two_layers"},
     NotImplementedError, "every_two_layers"),
]


@pytest.mark.parametrize("key,extra,exc,name", REFUSED, ids=[k for k, *_ in REFUSED])
def test_what_is_not_ported_is_refused_by_name(key, extra, exc, name):
    d = {"model_parallel_size": 2, "data_parallel_size": 2, "micro_batch_size": 1,
         "gradient_accumulation_steps": 2, **extra}
    with pytest.raises(exc, match=name):
        TopologyConfig.from_dict(d)
    if exc is ValueError:  # JAX refuses the same config (its validator's error)
        with pytest.raises(Exception, match=name.split("(")[0][:40]):
            JaxTopologyConfig(**{"pipe_parallel_size": 1, **d})


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


def _cp_groups(rank: int, world: int):
    import torch
    import torch.distributed as dist

    from scaling_tpu_torch.topology import Topology

    topo = Topology(TopologyConfig.from_dict({
        "model_parallel_size": 1, "data_parallel_size": 2, "pipe_parallel_size": 1,
        "context_parallel_size": 2, "micro_batch_size": 1, "gradient_accumulation_steps": 1}),
        device=torch.device("cpu"))
    return {"coords": (topo.data_parallel_rank, topo.context_parallel_rank),
            "data": topo.data_ranks, "context": topo.context_ranks, "grad": topo.grad_ranks,
            "model": topo.model_ranks,
            "send": dist.get_process_group_ranks(topo.ring_send),
            "recv": dist.get_process_group_ranks(topo.ring_recv)}


def test_context_groups_and_ring_channels_follow_the_mesh_axes():
    """dp 2 x cp 2: the data group splits the batch at one context rank, the
    context group the sequence at one data rank, the gradient group is both;
    each ring hop is a two-rank group from a context rank to the next."""
    jax_topo = JaxTopology(JaxTopologyConfig(pipe_parallel_size=1, data_parallel_size=2,
                                             context_parallel_size=2, model_parallel_size=1,
                                             micro_batch_size=1, gradient_accumulation_steps=1))
    for rank, got in enumerate(run_ranks(_cp_groups, 4)):
        d, c = jax_topo.data_parallel_rank_of(rank), jax_topo.context_parallel_rank_of(rank)
        assert got["coords"] == (d, c)
        assert got["data"] == [jax_topo.get_global_rank(0, j, 0, c) for j in range(2)]
        assert got["context"] == [jax_topo.get_global_rank(0, d, 0, j) for j in range(2)]
        assert got["grad"] == [0, 1, 2, 3] and got["model"] == [rank]
        other = jax_topo.get_global_rank(0, d, 0, 1 - c)
        assert got["send"] == got["recv"] == sorted([rank, other])
