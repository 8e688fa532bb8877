"""Helpers of the port's multi-rank CPU tests: ``run_ranks`` starts one
process a rank (spawned, one torch thread each), joins them into a gloo
process group over ``tcp://127.0.0.1:<free port>``, runs a module-level
function in each and returns what each returned, by rank. A rank that
raises, or a run past its ``timeout``, kills every rank and fails with
the first traceback, so that no test waits on a collective whose peer is
gone. Nothing here imports JAX: the ranks import the port alone."""

from __future__ import annotations

import multiprocessing
import queue as queue_mod
import socket
import traceback
from typing import Any, Callable, List

import numpy as np
import torch
import torch.distributed as dist


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def to_numpy(value: Any) -> Any:
    """``value`` with every tensor as a numpy array (f32 for bf16): tensors
    cross the process boundary by shared memory that dies with the rank."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(value, dict):
        return {k: to_numpy(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(to_numpy(v) for v in value)
    return value


def _entry(fn: Callable, rank: int, world: int, port: int, results, args) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
        results.put((rank, True, to_numpy(fn(rank, world, *args))))
    except BaseException:  # reported to the parent, which kills the others
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args, timeout: float = 90.0) -> List[Any]:
    """``fn(rank, world, *args)`` in ``world`` gloo ranks; their results
    (tensors as numpy arrays)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, port, results, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out: List[Any] = [None] * world
    try:
        for _ in range(world):
            try:
                rank, ok, value = results.get(timeout=timeout)
            except queue_mod.Empty:
                raise AssertionError(f"ranks did not finish within {timeout} s") from None
            if not ok:
                raise AssertionError(f"rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return out


def topology(mp: int, dp: int, mbs: int = 2, gas: int = 1, pp: int = 1, vpp: int = 1):
    """This rank's ``Topology`` of a pp x dp x mp layout (inside ``run_ranks``)."""
    from scaling_tpu_torch.topology import Topology, TopologyConfig

    return Topology(TopologyConfig.from_dict({
        "model_parallel_size": mp, "data_parallel_size": dp, "pipe_parallel_size": pp,
        "pipe_virtual_size": vpp, "micro_batch_size": mbs,
        "gradient_accumulation_steps": gas}), device=torch.device("cpu"))


def build_layer(kind: str, cfg: dict, shard):
    """The port's layer ``kind`` over the model group ``shard``."""
    from scaling_tpu_torch.nn.attention import ParallelSelfAttention
    from scaling_tpu_torch.nn.linear import (
        ColumnParallelLinear,
        RowParallelLinear,
        VocabParallelEmbedding,
    )
    from scaling_tpu_torch.nn.mlp import ParallelSwiGLUMLP
    from scaling_tpu_torch.nn.rotary import RotaryEmbedding

    if kind == "column":  # gathered to the full width, as the LM head's logits
        return ColumnParallelLinear(cfg["d_in"], cfg["d_out"], shard=shard, gather_output=True)
    if kind == "row":
        return RowParallelLinear(cfg["d_in"], cfg["d_out"], shard=shard)
    if kind == "column_row":
        col = ColumnParallelLinear(cfg["d_in"], cfg["d_mid"], shard=shard)
        return torch.nn.Sequential(col, RowParallelLinear(cfg["d_mid"], cfg["d_in"],
                                                          shard=shard))
    if kind == "embedding":
        return VocabParallelEmbedding(cfg["vocab"], cfg["hidden"], shard=shard)
    if kind == "head":
        return ColumnParallelLinear(cfg["hidden"], cfg["vocab"], bias=False, shard=shard,
                                    gather_output=True)
    if kind == "swiglu":
        return ParallelSwiGLUMLP(cfg["hidden"], cfg["factor"], bias=True, shard=shard)
    if kind == "attention":
        head_dim = cfg["hidden"] // cfg["heads"]
        return ParallelSelfAttention(cfg["hidden"], cfg["heads"], num_kv_heads=cfg["kv"],
                                     qkv_in_one=cfg["qkv_in_one"],
                                     rotary=RotaryEmbedding(head_dim, cfg["seq"]), shard=shard)
    raise ValueError(kind)


def shard_state(module: torch.nn.Module, full: dict, rank: int, size: int) -> dict:
    """This model rank's slices of the whole state ``full``: each tensor cut
    contiguously along the one dim where the module's shard is smaller."""
    from scaling_tpu_torch.parallel.parallel_module import slice_of

    out = {}
    for name, p in module.state_dict().items():
        t = torch.from_numpy(np.asarray(full[name]))
        dims = [d for d in range(t.ndim) if t.shape[d] != p.shape[d]]
        out[name] = slice_of(t, dims[0], rank, size) if dims else t
    return out


def layer_worker(rank: int, world: int, mp: int, dp: int, kind: str, cfg: dict, full: dict,
                 x, g, extra: dict):
    """One rank of a dp x mp layer check: this rank's shards of ``full``,
    its data rank's rows of ``x`` (the last dim's model slice for a
    row-parallel layer), the forward, and the backward of ``sum(y * g)``
    over its rows. Returns the output rows, the parameters' gradients (this
    rank's slices) and the input's gradient rows (float inputs)."""
    from scaling_tpu_torch.nn.linear import ModelShard

    topo = topology(mp, dp)
    shard = ModelShard.of(topo)
    module = build_layer(kind, cfg, shard)
    module.load_state_dict(shard_state(module, full, shard.rank, shard.size))
    d, n = topo.data_parallel_rank, x.shape[0] // dp
    xs = torch.from_numpy(np.asarray(x)[d * n:(d + 1) * n].copy())
    if kind == "row":
        xs = xs.chunk(mp, dim=-1)[shard.rank].contiguous()
    if xs.is_floating_point():
        xs.requires_grad_(True)
    kwargs = {k: torch.from_numpy(np.asarray(v)[d * n:(d + 1) * n].copy())
              for k, v in extra.items()}
    y = module(xs, **kwargs)
    (y * torch.from_numpy(np.asarray(g)[d * n:(d + 1) * n].copy())).sum().backward()
    return {"y": y.detach(), "grads": {k: p.grad for k, p in module.named_parameters()},
            "x_grad": xs.grad}


TOY_ARCH = {"vocab_size": 128, "hidden_size": 64, "num_layers": 2, "num_attention_heads": 4,
            "attention_num_kv_heads": 2, "sequence_length": 16, "mlp_type": "swiglu",
            "mlp_factor": 2.0, "norm_type": "rms", "key_query_norm": True,
            "weight_tying": True, "attention_qkv_in_one": False}


def model_layout_worker(rank: int, world: int, mp: int, dp: int):
    """A toy model of this rank at dp x mp from seed 0: its parameters,
    the model dim of each (``leaf_layouts``) and the names whose shape
    differs from the one-rank model's."""
    from scaling_tpu_torch.models.transformer.config import TransformerArchitectureConfig
    from scaling_tpu_torch.models.transformer.model import TransformerModel
    from scaling_tpu_torch.parallel import ParallelModule

    arch = TransformerArchitectureConfig.from_dict(TOY_ARCH)
    topo = topology(mp, dp)
    model = TransformerModel(arch, device="cpu", topology=topo).init_random_(0)
    module = ParallelModule(model, topo.config, topo)
    whole = TransformerModel(arch, device="meta")
    shapes = {n: p.shape for n, p in whole.named_parameters()}
    return {"params": {n: p.detach() for n, p in model.named_parameters()},
            "model_dims": {n: lay.model_dim for n, lay in module.leaf_layouts().items()},
            "sharded": {n for n, p in model.named_parameters() if p.shape != shapes[n]}}


def step_worker(rank: int, world: int, mp: int, dp: int, config: dict, batches: list):
    """A dp x mp training step of this rank (``ParallelModule.build_train_step``)
    over ``batches``, each a dict of global ``(gas, mbs * dp, ...)`` arrays
    of which this data rank takes its rows. Returns each step's loss and
    global grad norm, this rank's final parameters, and the optimizer's
    f32 master slices."""
    from scaling_tpu_torch.models.transformer import TransformerConfig
    from scaling_tpu_torch.models.transformer.model import (
        init_model,
        init_optimizer,
        loss_function,
    )

    cfg = TransformerConfig.from_dict(config)
    topo = topology(mp, dp, cfg.topology.micro_batch_size,
                    cfg.topology.gradient_accumulation_steps) if world > 1 else None
    module = init_model(cfg, device="cpu", topology=topo)
    optimizer = init_optimizer(cfg, module.model, module)
    step = module.build_train_step(optimizer, loss_function)
    d = 0 if topo is None else topo.data_parallel_rank
    losses, norms = [], []
    for batch in batches:
        n = batch["token_ids"].shape[1] // dp
        local = {k: torch.from_numpy(np.asarray(v)[:, d * n:(d + 1) * n].copy())
                 for k, v in batch.items()}
        loss, _, out = step(local)
        losses.append(float(loss))
        norms.append(float(out.global_grad_norm))
    return {"losses": losses, "norms": norms,
            "params": {k: p.detach() for k, p in module.model.named_parameters()},
            "masters": dict(optimizer.state.master), "zero_dims": dict(optimizer.zero_dims)}


def phase19_worker() -> None:
    """``chip_smoke.dist_worker`` on the CPU. There the wrappers run their
    plain versions, as often as the card launches the kernels, so they are
    counted as launches (into ``launches.KERNEL``) unless ``PHASE19_FAULT``
    is ``plain_rank_<r>`` on rank ``r``; ``skip_row_reduction`` leaves the
    row-parallel products unsummed; ``zero_send_grad`` sends zeros where a
    pipe stage sends the gradient of its input; ``ring_dkv_dropped`` zeroes
    ring attention's dK/dV; ``slice_kv_detached`` cuts the gradient of a
    token slice's cache (the earlier slices' K/V)."""
    import os
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    from scaling_tpu_torch.nn import linear
    from scaling_tpu_torch.ops import launches

    fault = os.environ.get("PHASE19_FAULT", "")
    if fault != f"plain_rank_{os.environ['RANK']}":
        add = launches.add
        launches.add = lambda counter, key: add(
            launches.KERNEL if counter is launches.PLAIN else counter, key)
    if fault == "skip_row_reduction":
        linear.reduce_from_model_region = lambda x, group: x
    if fault == "zero_send_grad":
        from scaling_tpu_torch.parallel import pipeline_engine

        send = pipeline_engine.PipelineEngine._send

        def zeros_for_grads(engine, t, peer, sends):
            # a training step's activation has a graph behind it, a gradient none
            if torch.is_grad_enabled() and t.grad_fn is None:
                t = torch.zeros_like(t)
            send(engine, t, peer, sends)

        pipeline_engine.PipelineEngine._send = zeros_for_grads
    if fault == "ring_dkv_dropped":
        from scaling_tpu_torch.ops import ring_attention

        backward = ring_attention._ring_backward

        def without_dkv(*args):
            dq, dk, dv = backward(*args)
            return dq, torch.zeros_like(dk), torch.zeros_like(dv)

        ring_attention._ring_backward = without_dkv
    if fault == "slice_kv_detached":
        from scaling_tpu_torch.nn import attention

        sliced = attention.ParallelSelfAttention._slice_cache_attention

        def detached(self, q, k, v, cache, *args):
            cache = attention.TokenSliceCache(tuple(t.detach() for t in cache.keys),
                                              tuple(t.detach() for t in cache.values),
                                              cache.segments)
            return sliced(self, q, k, v, cache, *args)

        attention.ParallelSelfAttention._slice_cache_attention = detached
    os.environ["CHIP_SMOKE_WORKER_DEVICE"] = "cpu"
    chip_smoke.dist_worker()


def trainer_worker() -> None:
    """A runner's worker on the CPU (``runner.script`` names this module):
    ``worker_main(device="cpu")``, recording into ``<log_dir>/rank{r}.jsonl``
    its pid and each step's loss (then a pause of ``WORKER_PAUSE_S``), into
    ``<log_dir>/loaded_rank{r}.npz`` its parameters as the trainer's
    initialisation left them (a load's), and at its end the iterations and
    whether it was preempted."""
    import json
    import os
    import time
    from pathlib import Path

    from scaling_tpu_torch.logging.logger import append_jsonl_line
    from scaling_tpu_torch.models.transformer import train
    from scaling_tpu_torch.runner import LaunchConfig

    launch = LaunchConfig.from_launcher_args()
    log_dir = Path(launch.payload["logger"]["log_dir"])
    log_dir.mkdir(parents=True, exist_ok=True)
    rank = launch.global_rank
    records = log_dir / f"rank{rank}.jsonl"
    pause = float(os.environ.get("WORKER_PAUSE_S", "0"))
    build = train.build_trainer

    def build_with_records(config, device=None, glue=None):
        trainer = build(config, device, glue=glue)
        np.savez(log_dir / f"loaded_rank{rank}.npz",
                 **{n: to_numpy(p) for n, p in trainer.module.model.named_parameters()})
        append_jsonl_line(records, json.dumps({"kind": "start", "pid": os.getpid(),
                                               "iterations": trainer.context.iterations}))

        def record(metrics, step):
            append_jsonl_line(records, json.dumps({"kind": "step", "step": step,
                                                   "loss": metrics["loss"]}))
            time.sleep(pause)

        trainer.metrics_hooks.append(record)
        return trainer

    train.build_trainer = build_with_records
    trainer = train.worker_main(device="cpu")
    append_jsonl_line(records, json.dumps({"kind": "end", "iterations": trainer.context.iterations,
                                           "preempted": trainer._preempted}))


if __name__ == "__main__":
    import os

    if "PHASE19_FAULT" in os.environ:
        phase19_worker()
    else:
        trainer_worker()
