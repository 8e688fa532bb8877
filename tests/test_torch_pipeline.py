"""The port's pipeline parallelism on the CPU against the JAX package's:

- the partition functions and the executor's instruction streams equal
  JAX's ``pipeline.py`` and ``pipeline_schedule.py`` (1F1B without virtual
  stages, the interleaved stream with them) for pp 2 and 4, vpp 1 and 2,
  accumulation 1-8, and the port's copies of the other schedules equal
  JAX's too;
- each channel of the stage transport (one direction of one stage pair, a
  two-rank group whose transfers are broadcasts) is used by its two ends in
  one order: the sender's sends, in its stream's order, are the receiver's
  receives, in its stream's order, transfer for transfer (a broadcast is a
  collective, and a mismatch would pair the wrong tensors or hang);
- the pipe, data, model, channel and tied groups follow JAX's rank math;
- a toy untied stack's forward and its first step's reduced gradients at
  pp 2, pp 4, pp 2 x vpp 2 (with ``every_pipe_stage``) equal one rank's,
  rtol 1e-5, atol 1e-6 (JAX's ``test_pipeline.py`` cases), with the
  transport's bytes the schedule's count;
- the JAX default architecture (LayerNorm, GELU MLP, key/query norm, a tied
  head) at pp 2: 3 steps' losses against JAX ``build_train_step`` on the
  same carried weights, rtol 1e-5, atol 1e-6; the tied table's two copies
  equal bitwise after every step (one reduced gradient, one update);
- dropout at pp 2 against pp 1: the masks are a function of the step's
  key, the micro-batch and the site, so every micro-batch's arithmetic is
  the one rank's. Not bitwise: the clipping norm's squares are summed on
  each stage, then over the stages, which rounds the clip coefficient in
  its last bit; the losses within rtol 1e-6, the parameters within atol
  1e-5 after 3 steps (a wrong mask moves a loss by 1e-2).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from scaling_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from scaling_tpu.models.transformer.model import init_model as jax_init_model  # noqa: E402
from scaling_tpu.models.transformer.model import init_optimizer as jax_init_optimizer  # noqa: E402
from scaling_tpu.models.transformer.model import loss_function as jax_loss  # noqa: E402
from scaling_tpu.parallel import pipeline as jax_pipeline  # noqa: E402
from scaling_tpu.parallel import pipeline_schedule as jax_schedule  # noqa: E402
from scaling_tpu.topology import Topology as JaxTopology  # noqa: E402
from scaling_tpu.topology import TopologyConfig as JaxTopologyConfig  # noqa: E402
from scaling_tpu_torch.parallel import pipeline, pipeline_schedule  # noqa: E402
from scaling_tpu_torch.topology import TopologyConfig  # noqa: E402
from scaling_tpu_torch.topology.topology import channel_pairs  # noqa: E402

from .test_torch_dist_helpers import TOY_ARCH, run_ranks, to_numpy, topology  # noqa: E402
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401

STREAMS = [(pp, vpp, gas) for pp in (2, 4) for vpp in (1, 2) for gas in range(1, 9)]
STREAM_IDS = [f"pp{pp}_vpp{vpp}_gas{gas}" for pp, vpp, gas in STREAMS]


# ---------------------------------------------------------------- partitions
PARTITIONS = [
    ("uniform", (8, 4)), ("uniform", (10, 4)), ("uniform", (3, 4)), ("uniform", (24, 6)),
    ("balanced", ([100, 1, 1, 1], 2)), ("balanced", ([1] * 6, 3)),
    ("balanced", ([3, 1, 4, 1, 5, 9, 2, 6], 3)), ("balanced", ([1] * 8, 8)),
    ("from_indices", ([0, 2, 4], 4, 2)), ("from_indices", ([0, 1, 1, 5], 5, 3)),
]


@pytest.mark.parametrize("method,args", PARTITIONS,
                         ids=[f"{m}{i}" for i, (m, _) in enumerate(PARTITIONS)])
def test_partitions_equal_jax(method, args):
    name = f"pipe_partition_{method}"
    assert getattr(pipeline, name)(*args) == getattr(jax_pipeline, name)(*args)


def test_a_bad_partition_and_an_indivisible_stack_are_refused():
    with pytest.raises(AssertionError):
        pipeline.pipe_partition_from_indices([0, 3], 4, 2)
    topo = TopologyConfig.from_dict({"pipe_parallel_size": 2, "pipe_virtual_size": 2,
                                     "micro_batch_size": 1, "gradient_accumulation_steps": 2})
    with pytest.raises(ValueError, match="divisible by pipe_parallel_size"):
        pipeline.stage_plan(topo, 6, 0)


def test_stages_hold_the_round_robin_chunks():
    topo = TopologyConfig.from_dict({"pipe_parallel_size": 2, "pipe_virtual_size": 2,
                                     "micro_batch_size": 1, "gradient_accumulation_steps": 2})
    plans = [pipeline.stage_plan(topo, 8, s) for s in range(2)]
    # JAX's (pp, vpp, lpv) stacking: stage s, virtual index r holds chunk r * pp + s
    assert [p.chunks for p in plans] == [((0, 1), (4, 5)), ((2, 3), (6, 7))]
    # JAX's executor stacks the layers uniformly whatever the method says; an
    # overwrite must name those bounds, an uneven one is refused by name
    def plan(**keys):
        topo = TopologyConfig.from_dict({"pipe_parallel_size": 2, "micro_batch_size": 1,
                                         "gradient_accumulation_steps": 2, **keys})
        return [pipeline.stage_plan(topo, 4, s).layers for s in range(2)]

    assert plan(pipe_partition_method="balanced") == [(0, 1), (2, 3)]
    assert plan(pipe_partition_overwrite=[0, 2, 4]) == [(0, 1), (2, 3)]
    with pytest.raises(NotImplementedError, match="pipe_partition_overwrite"):
        plan(pipe_partition_overwrite=[0, 1, 4])


# ------------------------------------------------------------------ streams
def _jax_stream(pp, rank, gas, vpp):
    if vpp > 1:
        return jax_schedule.PipelineScheduleInterleaved(pp, rank, gas, virtual_size=vpp)
    return jax_schedule.PipelineScheduleTrain(pp, rank, gas)


@pytest.mark.parametrize("pp,vpp,gas", STREAMS, ids=STREAM_IDS)
def test_instruction_streams_equal_jax(pp, vpp, gas):
    for rank in range(pp):
        port = pipeline_schedule.executor_schedule(pp, rank, gas, vpp)
        ref = _jax_stream(pp, rank, gas, vpp)
        assert [tuple(i) for i in port.instructions()] == [tuple(i) for i in ref.instructions()]
        for name, cls in (("PipelineScheduleFillDrain", {}), ("PipelineScheduleInference", {}),
                          ("PipelineScheduleTokenSlice", {"token_slices": 2})):
            mine = getattr(pipeline_schedule, name)(pp, rank, gas, **cls).instructions()
            theirs = getattr(jax_schedule, name)(pp, rank, gas, **cls).instructions()
            assert [tuple(i) for i in mine] == [tuple(i) for i in theirs], name


_DEFAULT_PEER = {"send_activation": 1, "recv_grad": 1, "recv_activation": -1, "send_grad": -1}


def transfers(pp: int, vpp: int, gas: int) -> dict:
    """(source stage, destination stage) -> the sender's sends and the
    receiver's receives over that channel, each (kind, micro-batch, tag) in
    stream order; the executor's work item of each is the instruction's
    micro-batch."""
    out = {}
    for rank in range(pp):
        items = pipeline_schedule.work_items(gas, pp, vpp)
        backwards = items if vpp == 1 else list(reversed(items))
        fi = bi = 0
        for ins in pipeline_schedule.executor_schedule(pp, rank, gas, vpp).instructions():
            if ins.name == "forward_pass":
                fi += 1
            if ins.name == "backward_pass":
                bi += 1
            if ins.name not in _DEFAULT_PEER:
                continue
            peer = rank + _DEFAULT_PEER[ins.name] if ins.peer is None else ins.peer
            kind = "act" if "activation" in ins.name else "grad"
            sending = ins.name.startswith("send")
            # the executor's item: a send's the one just computed, a receive's the next
            item = (items[fi - 1] if kind == "act" else backwards[bi - 1]) if sending else (
                items[fi] if kind == "act" else backwards[bi])
            assert item[0] == ins.micro_batch_id, (rank, ins)
            key = (rank, peer) if sending else (peer, rank)
            out.setdefault(key, {"sent": [], "received": []})[
                "sent" if sending else "received"].append((kind, ins.micro_batch_id, ins.tag))
    return out


@pytest.mark.parametrize("pp,vpp,gas", STREAMS, ids=STREAM_IDS)
def test_both_ends_of_each_channel_see_one_transfer_order(pp, vpp, gas):
    channels = transfers(pp, vpp, gas)
    assert set(channels) <= set(channel_pairs(pp, vpp))
    for pair, seen in channels.items():
        assert seen["sent"] == seen["received"], pair
        assert seen["sent"], pair
    # sends post and go on, a receive waits for its send: the simulator
    # replays the streams to their end
    sim = pipeline_schedule.SimulationEngine(pp, gas).simulate(
        lambda **kw: pipeline_schedule.executor_schedule(
            kw["pipe_parallel_size"], kw["pipe_parallel_rank"],
            kw["gradient_accumulation_steps"], vpp))
    assert not sim["deadlocked"]


def test_the_simulator_helpers_follow_jax():
    durations = {"forward_pass": 1.0, "backward_pass": 2.0}
    for vpp in (1, 2):
        mine = pipeline_schedule.simulate_layout(2, 4, durations, virtual_size=vpp)
        theirs = jax_schedule.simulate_layout(2, 4, durations, virtual_size=vpp)
        assert mine["bubble_fraction"] == pytest.approx(theirs["bubble_fraction"], abs=1e-12)
        assert mine["schedule"] == theirs["schedule"]
    assert pipeline_schedule.illustrate(2, 4) == jax_schedule.illustrate(2, 4)
    obs = [{"step_time": 1.6}, {"step_time": 1.6}]
    assert pipeline_schedule.durations_from_profile(obs, 4) == pytest.approx(
        jax_schedule.durations_from_profile(obs, 4))
    with pytest.raises(NotImplementedError, match="visualize"):
        pipeline_schedule.visualize(2, 4, "timeline.png")


# ------------------------------------------------------------------- groups
def _groups(rank: int, world: int, pp: int, dp: int, vpp: int) -> dict:
    import torch.distributed as dist

    topo = topology(1, dp, gas=4, pp=pp, vpp=vpp)
    return {"pipe": topo.pipe_ranks, "data": topo.data_ranks, "model": topo.model_ranks,
            "stage": topo.pipe_parallel_rank,
            "channels": {pair: dist.get_process_group_ranks(g)
                         for pair, g in topo.channels.items()},
            "tied": None if topo.tied_group is None else dist.get_process_group_ranks(
                topo.tied_group)}


@pytest.mark.parametrize("pp,dp,vpp", [(2, 2, 1), (4, 1, 2)], ids=["pp2_dp2", "pp4_vpp2"])
def test_pipe_groups_follow_the_mesh_axes(pp, dp, vpp):
    jax_topo = JaxTopology(JaxTopologyConfig(pipe_parallel_size=pp, data_parallel_size=dp,
                                             model_parallel_size=1, micro_batch_size=1,
                                             gradient_accumulation_steps=4,
                                             pipe_virtual_size=vpp))
    for rank, got in enumerate(run_ranks(_groups, pp * dp, pp, dp, vpp)):
        p, d = jax_topo.pipe_parallel_rank_of(rank), jax_topo.data_parallel_rank_of(rank)
        assert got["stage"] == p
        assert got["pipe"] == [jax_topo.get_global_rank(s, d, 0) for s in range(pp)]
        assert got["data"] == [jax_topo.get_global_rank(p, j, 0) for j in range(dp)]
        assert got["model"] == [rank]
        want = {(a, b): sorted([jax_topo.get_global_rank(a, d, 0),
                                jax_topo.get_global_rank(b, d, 0)])
                for a, b in channel_pairs(pp, vpp) if p in (a, b)}
        assert got["channels"] == want
        ends = [jax_topo.get_global_rank(0, d, 0), jax_topo.get_global_rank(pp - 1, d, 0)]
        assert got["tied"] == (ends if p in (0, pp - 1) else None)
    assert channel_pairs(4, 2)[-2:] == [(3, 0), (0, 3)]  # the wrap


# --------------------------------------------------------- toy stack parity
GAS, MBS, SEQ = 4, 2, 16
STACK = dict(TOY_ARCH, precision="float32", sequence_length=SEQ, num_layers=4,
             weight_tying=False)
LAYOUTS = {"pp2": (2, 1, "disabled"), "pp4": (4, 1, "disabled"),
           "pp2_vpp2": (2, 2, "every_pipe_stage")}


def stack_config(pp: int, vpp: int, remat: str, arch=STACK) -> dict:
    return {"topology": {"pipe_parallel_size": pp, "pipe_virtual_size": vpp,
                         "model_parallel_size": 1, "data_parallel_size": 1,
                         "micro_batch_size": MBS, "gradient_accumulation_steps": GAS,
                         "activation_checkpointing_type": remat},
            "transformer_architecture": arch,
            "optimizer": {"gradient_clipping": 1.0, "loss_scaler": {"enable": False}},
            "learning_rate_scheduler": {"learning_rate": 0.01, "learning_rate_warmup_steps": 1,
                                        "learning_rate_decay_iters": 50},
            "trainer": {"seed": 5}}


def stack_batches(steps: int, vocab: int = 128) -> list:
    rng = np.random.default_rng(4)
    out = []
    for _ in range(steps):
        tokens = rng.integers(1, vocab, size=(GAS, MBS, SEQ + 1))
        seg = np.zeros((GAS, MBS, SEQ), np.int32)
        seg[:, :, 9:] = 1  # two packed documents a row
        out.append({"token_ids": tokens[..., :-1].astype(np.int32),
                    "target_token_ids": tokens[..., 1:].astype(np.int64),
                    "loss_weights": (rng.random((GAS, MBS, SEQ)) < 0.8).astype(np.float32),
                    "position_ids": np.broadcast_to(np.arange(SEQ, dtype=np.int32),
                                                    (GAS, MBS, SEQ)).copy(),
                    "segment_ids": seg})
    return out


def _module(cfg: dict, world: int, state=None):
    from scaling_tpu_torch.models.transformer import TransformerConfig
    from scaling_tpu_torch.models.transformer.model import init_model, init_optimizer
    from scaling_tpu_torch.topology import Topology

    c = TransformerConfig.from_dict(cfg)
    topo = Topology(c.topology, device=torch.device("cpu")) if world > 1 else None
    module = init_model(c, device="cpu", topology=topo)
    if state is not None:  # this stage's parameters of a whole state dict
        module.model.load_state_dict({n: torch.from_numpy(np.asarray(state[n]))
                                      for n in module.model.state_dict()})
    return module, init_optimizer(c, module.model, module)


def _stack_worker(rank: int, world: int, cfg: dict, batch: dict) -> dict:
    from scaling_tpu_torch.models.transformer.model import loss_function
    from scaling_tpu_torch.parallel import collectives

    module, optimizer = _module(cfg, world)
    module.model.eval()
    first = {k: torch.from_numpy(v[0]) for k, v in batch.items()}
    out = module.forward(first)
    grads = {}
    step_fn = optimizer.step

    def capture(g):
        grads.update({n: t.clone() for n, t in g.items()})
        return step_fn(g)

    optimizer.step = capture
    collectives.STATS.clear()
    step = module.build_train_step(optimizer, loss_function)
    loss, _, _ = step({k: torch.from_numpy(v) for k, v in batch.items()})
    return {"logits": None if out is None else out["activations"], "grads": grads,
            "loss": float(loss), "stats": dict(collectives.STATS)}


@pytest.fixture(scope="module")
def stack_runs():
    batch = stack_batches(1)[0]
    layouts = dict(LAYOUTS, one=(1, 1, "disabled"))
    with ThreadPoolExecutor(len(layouts)) as pool:  # each layout's ranks are processes
        futures = {name: pool.submit(run_ranks, _stack_worker, pp,
                                     stack_config(pp, vpp, remat), batch, timeout=180)
                   for name, (pp, vpp, remat) in layouts.items()}
        return {name: f.result() for name, f in futures.items()}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_a_toy_stack_forward_and_gradients_equal_one_rank(stack_runs, name):
    one = stack_runs["one"][0]
    ranks = stack_runs[name]
    np.testing.assert_allclose(ranks[-1]["logits"], one["logits"], rtol=1e-5, atol=1e-6)
    assert all(r["logits"] is None for r in ranks[:-1])
    seen = set()
    for rank in ranks:
        assert rank["loss"] == pytest.approx(one["loss"], rel=1e-6)
        for n, g in rank["grads"].items():
            np.testing.assert_allclose(g, one["grads"][n], rtol=1e-5, atol=1e-6, err_msg=n)
            seen.add(n)
    assert seen == set(one["grads"])


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_the_transport_moves_what_the_schedule_sends(stack_runs, name):
    pp, vpp, _ = LAYOUTS[name]
    act = MBS * SEQ * STACK["hidden_size"] * 4  # f32 activations
    for rank, got in enumerate(stack_runs[name]):
        stream = pipeline_schedule.executor_schedule(pp, rank, GAS, vpp).instructions()
        sends = sum(i.name in ("send_activation", "send_grad") for i in stream)
        recvs = sum(i.name in ("recv_activation", "recv_grad") for i in stream)
        assert got["stats"].get("p2p_send_bytes", 0) == sends * act
        assert got["stats"].get("p2p_recv_bytes", 0) == recvs * act
        assert got["stats"].get("p2p_send_calls", 0) == sends


# --------------------------------------------- tied head against JAX, dropout
DEFAULT = dict(vocab_size=128, hidden_size=64, num_layers=4, num_attention_heads=4,
               sequence_length=SEQ, precision="float32", norm_type="layernorm",
               layernorm={"optimization_type": "torch"}, mlp_type="default", mlp_factor=4.0,
               activation_function="gelu", weight_tying=True, key_query_norm=True)
STEPS = 3


def _train_worker(rank: int, world: int, cfg: dict, state: dict, batches: list,
                  dropout: bool) -> dict:
    from scaling_tpu_torch.models.transformer.model import loss_function
    from scaling_tpu_torch.nn.base_layer import dropout_key

    module, optimizer = _module(cfg, world, state)
    step = module.build_train_step(optimizer, loss_function)
    losses, tables = [], []
    for i, b in enumerate(batches):
        loss, _, _ = step({k: torch.from_numpy(v) for k, v in b.items()},
                          dropout_key(0, i) if dropout else None)
        losses.append(float(loss))
        params = dict(module.model.named_parameters())
        tables.append(params.get("layers.layer_0.embedding.weight"))
    return {"losses": losses, "tables": [None if t is None else to_numpy(t.detach().clone())
                                         for t in tables],
            "params": {n: p.detach() for n, p in module.model.named_parameters()}}


def _jax_losses(arch: dict, np_params, batches: list) -> list:
    config = JaxConfig.from_dict(stack_config(1, 1, "disabled", arch))
    topo = JaxTopology(config.topology)
    module = jax_init_model(config, topo)
    optimizer = jax_init_optimizer(config, module, topo)
    params = jax.tree.map(jnp.asarray, np_params)
    state = optimizer.init_state(params)
    step = module.build_train_step(optimizer, jax_loss, donate=False)
    dtypes = {"loss_weights": jnp.float32}
    losses = []
    for b in batches:
        params, state, loss, _, _ = step(params, state, {
            k: jnp.asarray(v, dtypes.get(k, jnp.int32)) for k, v in b.items()},
            jax.random.PRNGKey(0))
        losses.append(float(loss))
    return losses


def test_a_tied_head_at_pp2_matches_jax_and_keeps_its_copies_equal():
    from scaling_tpu_torch.models.transformer import TransformerConfig
    from scaling_tpu_torch.models.transformer.convert import params_from_jax

    config = JaxConfig.from_dict(stack_config(1, 1, "disabled", DEFAULT))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        if leaf.ndim == 2:
            return (rng.normal(size=leaf.shape) * np.sqrt(2.0 / sum(leaf.shape))).astype(
                np.float32)
        if "norm" in jax.tree_util.keystr(path):
            return (1.0 + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        return (0.02 * rng.normal(size=leaf.shape)).astype(np.float32)

    np_params = jax.tree_util.tree_map_with_path(draw, jax.tree.map(
        np.asarray, jax_init_model(config, None).init_params(jax.random.PRNGKey(0))))
    batches = stack_batches(STEPS)
    arch = TransformerConfig.from_dict(stack_config(1, 1, "disabled", DEFAULT))
    state = {n: t.numpy() for n, t in params_from_jax(np_params,
                                                      arch.transformer_architecture).items()}
    with ThreadPoolExecutor(1) as pool:  # the port's ranks train while JAX does here
        port = pool.submit(run_ranks, _train_worker, 2, stack_config(2, 1, "disabled", DEFAULT),
                           state, batches, False, timeout=180)
        want = _jax_losses(DEFAULT, np_params, batches)
        ranks = port.result()
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], want, rtol=1e-5, atol=1e-6)
    first, last = ranks
    assert set(first["params"]) & set(last["params"]) == {"layers.layer_0.embedding.weight"}
    for a, b in zip(first["tables"], last["tables"]):
        np.testing.assert_array_equal(a, b)


def test_dropout_at_pp2_matches_the_one_rank_run():
    arch = dict(STACK, dropout_attention_probs=0.1, dropout_after_attention=0.1,
                dropout_after_mlp=0.1, dropout_embedding=0.1)
    batches = stack_batches(STEPS)
    one = to_numpy(_train_worker(0, 1, stack_config(1, 1, "disabled", arch), None, batches,
                                 True))
    without = _train_worker(0, 1, stack_config(1, 1, "disabled"), None, batches, False)
    assert all(a != b for a, b in zip(one["losses"], without["losses"]))  # dropout acts
    piped = run_ranks(_train_worker, 2, stack_config(2, 1, "disabled", arch), None,
                      batches, True, timeout=120)
    for rank in piped:
        np.testing.assert_allclose(rank["losses"], one["losses"], rtol=1e-6, atol=0)
        for n, p in rank["params"].items():
            np.testing.assert_allclose(p, one["params"][n], rtol=0, atol=1e-5, err_msg=n)
