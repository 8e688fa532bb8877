"""Supervision on one device, on the CPU, against the JAX package.

- Fault injection: the same ``SCALING_TPU_FAULTS`` specs give the same
  fire sequences and the same rejections in both packages' ``FaultPlan``
  (the specs of ``tests/core/test_resilience/test_faults.py``).
- Guards: ``NonFiniteGuard`` raises at the same step in both packages;
  the watchdog fires once per stall and resets on a beat; the async
  writer's backpressure defers a failure to ``wait()``; the preemption
  handler chains.
- The trainer: an asynchronous save writes the bytes of a synchronous
  one while steps 4-6 run on after it; a prefetching run and its resume
  repeat the losses of a synchronous one bitwise; ``MESH.json`` equals the
  JAX trainer's, restores in the JAX trainer at one and at two devices
  (its reshard pre-flight), and a disagreeing one is refused.
- The control-plane protocol: heartbeat statuses, the abort flag's
  ``JobAborted`` with ``latest`` unmoved, a peer's preempt flag saved at
  the same boundary, a stall's flag and verdict against the JAX
  trainer's, a checkin that releases a parked peer, and two hosts (one a
  thread) meeting at step barriers with ``latest`` held by the commit
  barrier, synchronously and on the writer's thread.
- In subprocesses (this file is its own child script), the outcomes of
  ``tests/core/test_resilience/test_crash_resume.py``: a SIGTERM at the
  top of iteration 4, a NaN burst past its budget, a SIGKILL in the
  middle of a save followed by ``run_with_resume``, corrupt and torn
  checkpoints skipped; and a real SIGTERM during a run, resumed bitwise.

Toy model: rms/swiglu, hidden 64, 2 layers, 4/2 heads, vocab 96, seq 32,
f32, two blended token datasets from a seed.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
ARCH = {
    "vocab_size": 96, "hidden_size": 64, "num_layers": 2, "num_attention_heads": 4,
    "attention_num_kv_heads": 2, "attention_qkv_in_one": False, "sequence_length": 32,
    "precision": "float32", "mlp_type": "swiglu", "mlp_factor": 2.0, "norm_type": "rms",
    "layernorm": {"optimization_type": "fused"}, "weight_tying": False,
}
# the JAX default architecture's keys (layernorm, GELU MLP, tied head, key/query norm)
DEFAULT_ARCH = dict(ARCH, norm_type="layernorm", layernorm={"optimization_type": "torch"},
                    mlp_type="default", mlp_factor=4.0, activation_function="gelu",
                    weight_tying=True, key_query_norm=True)
WRITES_PER_SAVE = 10  # 5 model and 5 optimizer npz files a save of the toy model


def config_dict(prefixes, workdir, iterations=6, save_interval=3, load=False, arch=ARCH,
                log=True, **trainer):
    workdir = Path(workdir)
    return {
        "topology": {"model_parallel_size": 1, "pipe_parallel_size": 1,
                     "data_parallel_size": 1, "micro_batch_size": 2,
                     "gradient_accumulation_steps": 2},
        "transformer_architecture": arch,
        "optimizer": {"gradient_clipping": 1.0},
        "learning_rate_scheduler": {"learning_rate": 0.01, "learning_rate_warmup_steps": 2,
                                    "learning_rate_decay_iters": 50},
        "trainer": {"train_iterations": iterations, "seed": 7,
                    "save_dir": str(workdir / "ckpt"), "save_interval": save_interval,
                    "load_dir": str(workdir / "ckpt") if load else None,
                    "assert_checkpoint_loaded": False,
                    "delete_past_optimizer_states": False, **trainer},
        "data": {"data_prefixes": list(prefixes)},
        "logger": {"log_dir": str(workdir / "logs") if log else None},
    }


def read_losses(workdir) -> dict:
    """Step -> loss from the run's metrics records, the last record of a
    step winning (a resumed run appends to the crashed run's file)."""
    f = Path(workdir) / "logs" / "metrics_rank_0.jsonl"
    out = {}
    for line in f.read_text().splitlines() if f.is_file() else []:
        rec = json.loads(line)
        if rec["kind"] == "step" and "loss" in rec["metrics"]:
            out[rec["step"]] = rec["metrics"]["loss"]
    return out


# ------------------------------------------------------------ the child
def child_main(spec_file: str) -> int:
    """One supervised training run, as a launcher would start it. Spec:
    ``config`` (a training config dict), ``result_path``, and optionally
    ``restart_budget`` (0), ``chain_marker`` (a file the SIGTERM handler
    installed before the trainer's writes) and ``step_sleep`` (seconds a
    metrics hook sleeps after each logged step). Exit 0 on a clean end or
    a preemption, 42 on ``NonFiniteLossError`` after its save."""
    from scaling_tpu_torch.models.transformer import TransformerConfig
    from scaling_tpu_torch.models.transformer.train import build_trainer
    from scaling_tpu_torch.resilience import NonFiniteLossError, run_with_resume

    spec = json.loads(Path(spec_file).read_text())
    resumed_from = []

    def factory():
        if spec.get("chain_marker"):
            signal.signal(signal.SIGTERM,
                          lambda s, f: Path(spec["chain_marker"]).write_text("1"))
        trainer = build_trainer(TransformerConfig.from_dict(spec["config"]), device="cpu")
        trainer.install_preemption_handler()
        if spec.get("step_sleep"):
            trainer.metrics_hooks.append(lambda m, step: time.sleep(spec["step_sleep"]))
        resumed_from.append(trainer.context.iterations)
        return trainer

    result = Path(spec["result_path"])
    try:
        trainer = run_with_resume(factory, restart_budget=spec.get("restart_budget", 0))
    except NonFiniteLossError as e:
        print(f"NONFINITE_ABORT: {e}")
        result.write_text(json.dumps({"exit": "nonfinite", "resumed_from": resumed_from}))
        return 42
    result.write_text(json.dumps({"exit": "ok", "iterations": trainer.context.iterations,
                                  "resumed_from": resumed_from}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(child_main(sys.argv[1]))


import pytest  # noqa: E402
import torch  # noqa: E402

from scaling_tpu_torch.checkpoint import AsyncCheckpointWriter  # noqa: E402
from scaling_tpu_torch.data import MemoryMapDatasetBuilder  # noqa: E402
from scaling_tpu_torch.models.transformer import TransformerConfig  # noqa: E402
from scaling_tpu_torch.models.transformer.train import build_trainer  # noqa: E402
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401
from scaling_tpu_torch.resilience import (  # noqa: E402
    FaultPlan,
    InjectedFault,
    NonFiniteGuard,
    NonFiniteLossError,
    ReshardError,
    StepStallWatchdog,
    dump_thread_stacks,
    read_manifest,
    set_fault_plan,
    verify_checkpoint,
)


@pytest.fixture(scope="module")
def prefixes(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokens")
    rng = np.random.default_rng(11)
    out = []
    for name, docs in (("a", 48), ("b", 30)):
        with MemoryMapDatasetBuilder(root / name, dtype=np.uint16) as builder:
            for _ in range(docs):
                builder.add(np.append(rng.integers(1, 96, size=rng.integers(8, 80)), 0))
        out.append(str(root / name))
    return out


@pytest.fixture(autouse=True)
def _no_fault_plan():
    yield
    set_fault_plan(None)


# ------------------------------------------------------------- FaultPlan
FIRE_CASES = [  # spec, environment, the points fired in order
    ("data.read=fail@3x2,ckpt.write=corrupt", {},
     ["data.read"] * 5 + ["ckpt.write", "ckpt.write", "never.armed"]),
    ("step.nan_grads=nan@2x*", {}, ["step.nan_grads"] * 6),
    ("", {}, ["ckpt.write", "ckpt.write"]),
    ("data.read=fail@2@host=1", {}, ["data.read"] * 4),
    ("data.read=fail@2@host=1", {"SCALING_TPU_HOST_ID": "0"}, ["data.read"] * 4),
    ("data.read=fail@2@host=1", {"SCALING_TPU_HOST_ID": "1"}, ["data.read"] * 4),
    ("data.read=fail@2@host=0,data.read=fail@3@host=1", {"SCALING_TPU_HOST_ID": "0"},
     ["data.read"] * 4),
    ("data.read=fail@2@host=0,data.read=fail@3@host=1", {"SCALING_TPU_HOST_ID": "1"},
     ["data.read"] * 4),
    ("host.kill=fail@1x*@host=1@epoch=2",
     {"SCALING_TPU_HOST_ID": "1", "SCALING_TPU_COORD_EPOCH": "0"}, ["host.kill"] * 2),
    ("host.kill=fail@1x*@host=1@epoch=2",
     {"SCALING_TPU_HOST_ID": "1", "SCALING_TPU_COORD_EPOCH": "2"}, ["host.kill"] * 2),
    ("ckpt.write=corrupt@3x2@host=0,host.hang=hang@4", {"SCALING_TPU_HOST_ID": "0"},
     ["ckpt.write"] * 5 + ["host.hang"]),
    ("serve.replica.rpc=delay@2,serve.replica.rpc=partition@3,serve.replica.rpc=drop@4x2",
     {}, ["serve.replica.rpc"] * 6),
]


def fire_sequence(plan_cls, fault_cls, spec, points):
    plan = plan_cls(spec)
    out = []
    for point in points:
        try:
            out.append(plan.fire(point))
        except fault_cls as e:
            out.append(f"raised {type(e).__name__}: {e}")
    return out, {p: plan.hits(p) for p in points}


@pytest.mark.parametrize("spec,env,points", FIRE_CASES,
                         ids=[f"{i}:{c[0] or 'empty'}" for i, c in enumerate(FIRE_CASES)])
def test_fault_plans_fire_as_the_jax_ones(monkeypatch, spec, env, points):
    from scaling_tpu.resilience import faults as jax_faults

    for var in ("SCALING_TPU_HOST_ID", "SCALING_TPU_COORD_EPOCH"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    got = fire_sequence(FaultPlan, InjectedFault, spec, points)
    want = fire_sequence(jax_faults.FaultPlan, jax_faults.InjectedFault, spec, points)
    assert got == want


@pytest.mark.parametrize("spec", [
    "host.kill=kill@5@host=1,ckpt.write=corrupt@3x2@host=0",
    "host.hang=hang@4", "data.read=fail@1x*@host=2@epoch=3", "a.b=sigterm@7x3",
])
def test_fault_plans_parse_as_the_jax_ones(spec):
    from scaling_tpu.resilience import faults as jax_faults

    def rules(plan):
        return {point: [(r.action, r.first, r.count, r.host, r.epoch) for r in rs]
                for point, rs in plan._rules.items()}

    assert rules(FaultPlan(spec)) == rules(jax_faults.FaultPlan(spec))


@pytest.mark.parametrize("spec", ["ckpt.write", "ckpt.write=explode", "Ckpt.write=fail",
                                  "ckpt.write=fail@x", "ckpt.write=fail@1@host=a",
                                  "ckpt.write=fail,data.read=boom@2"])
def test_bad_fault_specs_are_refused_as_in_jax(spec):
    from scaling_tpu.resilience import faults as jax_faults

    with pytest.raises(ValueError) as want:
        jax_faults.FaultPlan(spec)
    with pytest.raises(ValueError) as got:
        FaultPlan(spec)
    assert str(got.value) == str(want.value)


def test_corrupt_file_truncates_as_in_jax(tmp_path):
    from scaling_tpu.resilience import faults as jax_faults

    for cls, name in ((FaultPlan, "port"), (jax_faults.FaultPlan, "jax")):
        f = tmp_path / name
        f.write_bytes(b"a" * 101)
        cls.corrupt_file(f)
        assert f.stat().st_size == 50


# ---------------------------------------------------------------- guards
GUARD_CASES = [  # budget, (loss, overflow) observations
    (0, [(1.0, False), (float("nan"), False)]),
    (2, [(1.0, False)] + [(float("nan"), False)] * 4),
    (2, [(float("inf"), False), (1.0, False), (float("nan"), False), (2.0, True),
         (None, True), (1.0, False)]),
    (1, [(1.0, True), (float("-inf"), False)]),
    (3, [(None, None), (1.0, None), (float("nan"), None)] * 2),
]


def guard_outcomes(cls, error, budget, observations):
    guard, out = cls(budget), []
    for step, (loss, overflow) in enumerate(observations, start=1):
        try:
            out.append(guard.observe(step, loss, overflow, 1.0))
        except error:
            out.append(f"raised at {step}")
            break
    return out, guard.streak


@pytest.mark.parametrize("budget,observations", GUARD_CASES)
def test_nonfinite_guard_raises_where_the_jax_one_does(budget, observations):
    from scaling_tpu.resilience import guards as jax_guards

    assert guard_outcomes(NonFiniteGuard, NonFiniteLossError, budget, observations) == \
        guard_outcomes(jax_guards.NonFiniteGuard, jax_guards.NonFiniteLossError, budget,
                       observations)


def test_watchdog_fires_once_per_stall_and_resets_on_beat():
    stalls = []
    wd = StepStallWatchdog(timeout_s=0.15, on_stall=lambda step, el: stalls.append((step, el)),
                           poll_interval_s=0.02)
    wd.start()
    try:
        wd.beat(3)
        time.sleep(0.4)  # one stall, reported once despite many polls
        assert len(stalls) == 1 and stalls[0][0] == 3
        wd.beat(4)
        time.sleep(0.05)  # beat in time: no new stall yet
        assert len(stalls) == 1
        time.sleep(0.4)  # a second stall after the new beat
        assert len(stalls) == 2 and stalls[1][0] == 4 and wd.stall_count == 2
    finally:
        wd.stop()
    assert not wd._thread.is_alive()


def test_dump_thread_stacks_names_threads():
    out = dump_thread_stacks()
    assert "MainThread" in out and "test_dump_thread_stacks_names_threads" in out


def test_async_writer_backpressure_drain_defers_failure():
    """A failure re-raises from ``wait()``, not from a ``submit`` whose
    backpressure drains the failed task; later tasks of the save are
    skipped; the writer serves the next save."""
    ran = []

    def fail():
        raise IOError("disk gone")

    w = AsyncCheckpointWriter(max_queued=1)
    w.submit(fail)
    for i in range(4):
        w.submit(ran.append, i)
    with pytest.raises(IOError, match="disk gone"):
        w.wait()
    assert ran == []
    w.submit(ran.append, "after")
    w.wait()
    assert ran == ["after"]
    w.close()


def test_preemption_handler_chains_previous_handler():
    from scaling_tpu_torch.trainer import BaseTrainer

    t = BaseTrainer.__new__(BaseTrainer)  # the handler only touches _preempted
    seen = []
    original = signal.getsignal(signal.SIGTERM)
    try:
        signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
        t.install_preemption_handler()
        os.kill(os.getpid(), signal.SIGTERM)
        assert t._preempted is True and seen == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, original)


@pytest.mark.parametrize("key,value", [
    ("dataloader_prefetch_factor", 0), ("dataloader_prefetch_factor", 4),
    ("dataloader_prefetch_factor", -1), ("save_checkpoint_async", True),
    ("max_consecutive_nonfinite", 0), ("max_consecutive_nonfinite", 5),
    ("max_consecutive_nonfinite", -1), ("step_timeout_seconds", 30),
    ("step_timeout_seconds", 0.5), ("step_timeout_seconds", 0.0),
    ("step_timeout_seconds", -2.0),
])
def test_supervision_keys_take_the_values_jax_takes(prefixes, tmp_path, key, value):
    from scaling_tpu.models.transformer import TransformerConfig as JaxConfig

    cfg = config_dict(prefixes, tmp_path, **{key: value})
    try:
        JaxConfig.from_dict(cfg)
    except ValueError:
        with pytest.raises(ValueError, match=key):
            TransformerConfig.from_dict(cfg)
    else:
        assert getattr(TransformerConfig.from_dict(cfg).trainer, key) == value


# --------------------------------------------------- async save, prefetch
def npz_crcs(step_dir: Path) -> dict:
    files = read_manifest(step_dir)["files"]
    return {k: v["crc32"] for k, v in files.items() if k.endswith(".npz")}


def test_async_save_writes_the_bytes_of_a_sync_save_while_training_goes_on(
        prefixes, tmp_path, monkeypatch):
    """The step-3 save's files are written only after steps 4 and 5 have
    updated the parameters and the optimizer state in place: their crc32s
    must still be those of a synchronous save at step 3."""
    import scaling_tpu_torch.checkpoint.checkpoint as ckpt_module

    sync = build_trainer(TransformerConfig.from_dict(config_dict(prefixes, tmp_path / "sync")),
                         device="cpu")
    sync.run_training()
    opened, written_at = threading.Event(), []
    write = ckpt_module._write_npz

    def gated_write(path, arrays, recorder):
        assert opened.wait(60), "the loop never reached step 5"
        written_at.append(trainer.context.iterations)
        write(path, arrays, recorder)

    monkeypatch.setattr(ckpt_module, "_write_npz", gated_write)
    trainer = build_trainer(TransformerConfig.from_dict(config_dict(
        prefixes, tmp_path / "async", save_checkpoint_async=True)), device="cpu")
    trainer._ckpt_writer = AsyncCheckpointWriter(max_queued=64)  # no backpressure

    def open_at_step_5(metrics, step):
        if step == 5:
            opened.set()

    trainer.metrics_hooks.append(open_at_step_5)
    trainer.run_training()
    assert min(written_at) >= 5  # every step-3 file was written after step 5
    for step in (3, 6):
        a, s = tmp_path / "async/ckpt" / f"global_step{step}", tmp_path / "sync/ckpt" / \
            f"global_step{step}"
        assert verify_checkpoint(a) == [] and len(npz_crcs(a)) == WRITES_PER_SAVE
        assert npz_crcs(a) == npz_crcs(s), step
    assert (tmp_path / "async/ckpt/latest").read_text() == "global_step6"
    assert read_losses(tmp_path / "async") == read_losses(tmp_path / "sync")


def test_prefetch_repeats_the_synchronous_losses_and_resume(prefixes, tmp_path):
    """A 6-step run with ``dataloader_prefetch_factor: 2`` gives the losses
    of one without it, bitwise; a prefetching resume from step 3 repeats
    steps 4-6 bitwise, the stacks prefetched and not consumed rebuilt."""
    plain = build_trainer(TransformerConfig.from_dict(config_dict(prefixes, tmp_path / "plain")),
                          device="cpu")
    plain.run_training()
    runs = {}
    for name, load in (("prefetch", False), ("resumed", True)):
        workdir = tmp_path / ("prefetch" if name == "prefetch" else "resumed")
        if load:
            shutil.copytree(tmp_path / "plain/ckpt", workdir / "ckpt")
            (workdir / "ckpt/latest").write_text("global_step3")
        trainer = build_trainer(TransformerConfig.from_dict(config_dict(
            prefixes, workdir, load=load, dataloader_prefetch_factor=2)), device="cpu")
        assert trainer._prefetch_thread.is_alive()
        assert trainer.context.iterations == (3 if load else 0)
        trainer.run_training()
        assert trainer.context.consumed_samples == 24
        trainer.stop_prefetch()
        runs[name] = read_losses(workdir)
    want = read_losses(tmp_path / "plain")
    assert sorted(want) == [1, 2, 3, 4, 5, 6]
    assert runs["prefetch"] == want
    assert runs["resumed"] == {s: v for s, v in want.items() if s > 3}


def test_a_prefetch_error_raises_on_the_loop_thread(prefixes, tmp_path):
    set_fault_plan(FaultPlan("data.read=fail@5x*"))
    trainer = build_trainer(TransformerConfig.from_dict(config_dict(
        prefixes, tmp_path, dataloader_prefetch_factor=2, io_retry_backoff_seconds=0.0)),
        device="cpu")
    trainer.train_step()  # micro-batches 1-2
    trainer.train_step()  # 3-4
    with pytest.raises(InjectedFault, match="data.read"):
        trainer.train_step()
    assert trainer._prefetch_thread is None and trainer.context.iterations == 2


# --------------------------------------------------------------- MESH.json
def jax_main_run(cfg):
    from scaling_tpu.models.transformer import TransformerConfig as JaxConfig
    from scaling_tpu.models.transformer.train import main as jax_main
    from scaling_tpu.ops.rms_norm import force_rms_interpret

    with force_rms_interpret():
        return jax_main(JaxConfig.from_dict(cfg))


@pytest.mark.parametrize("arch", [ARCH, DEFAULT_ARCH], ids=["rms_swiglu", "default_tied"])
def test_mesh_json_equals_the_jax_trainers(prefixes, tmp_path, arch):
    port_trainer = build_trainer(TransformerConfig.from_dict(config_dict(
        prefixes, tmp_path / "port", iterations=3, arch=arch, log=False)), device="cpu")
    port_trainer.run_training()
    jax_main_run(config_dict(prefixes, tmp_path / "jax", iterations=3, arch=arch, log=False))
    port = json.loads((tmp_path / "port/ckpt/global_step3/MESH.json").read_text())
    ref = json.loads((tmp_path / "jax/ckpt/global_step3/MESH.json").read_text())
    assert port.keys() == ref.keys()
    for key in ref:
        assert port[key] == ref[key], key
    assert set(port["params"]) == set(port_trainer.module.ckpt_keys().values())
    manifest = read_manifest(tmp_path / "port/ckpt/global_step3")
    assert "MESH.json" in manifest["files"]


def jax_trainer(cfg):
    from scaling_tpu.models.transformer import TransformerConfig as JaxConfig
    from scaling_tpu.models.transformer.context import TransformerContext
    from scaling_tpu.models.transformer.model import init_model, init_optimizer, loss_function
    from scaling_tpu.models.transformer.train import TransformerTrainer, _read_dataset
    from scaling_tpu.models.transformer.train import batch_to_model_input
    from scaling_tpu.topology import Topology

    config = JaxConfig.from_dict(cfg)
    topology = Topology(config.topology)
    module = init_model(config, topology)
    trainer = TransformerTrainer(
        config=config.trainer, context=TransformerContext(config=config, topology=topology),
        parallel_module=module, optimizer=init_optimizer(config, module, topology),
        loss_function=loss_function, dataset=_read_dataset(config, config.data.data_prefixes),
        batch_to_model_input=batch_to_model_input)
    trainer.initialize(load_checkpoint=True)
    return trainer


def flat_jax_params(trainer) -> dict:
    import jax

    from scaling_tpu.nn.param import ParamMeta

    metas = jax.tree.leaves(trainer.module.ckpt_metas(),
                            is_leaf=lambda x: isinstance(x, ParamMeta))
    return {m.key: np.asarray(p) for m, p in zip(
        metas, jax.tree.leaves(trainer.module.ckpt_view(trainer.params)))}


@pytest.mark.parametrize("dp", [1, 2])
def test_jax_trainer_restores_a_port_checkpoint_through_its_reshard_preflight(
        prefixes, tmp_path, dp):
    """The port saves at step 3; the JAX trainer restores it at dp 1 (the
    same mesh) and at dp 2 on two of the virtual CPU devices, where its
    reshard path engages (``ckpt.reshard``); both carry the parameters
    exactly and train on."""
    from scaling_tpu.ops.rms_norm import force_rms_interpret
    from scaling_tpu.resilience import get_fault_plan as jax_fault_plan

    port = build_trainer(TransformerConfig.from_dict(config_dict(
        prefixes, tmp_path / "port", iterations=3, log=False)), device="cpu")
    port.run_training()
    cfg = config_dict(prefixes, tmp_path / "port", iterations=6, load=True, log=False)
    cfg["topology"].update(data_parallel_size=dp, gradient_accumulation_steps=2 // dp,
                           micro_batch_size=2)
    cfg["trainer"].update(save_dir=None, assert_checkpoint_loaded=True)
    before = jax_fault_plan().hits("ckpt.reshard")
    with force_rms_interpret():
        ref = jax_trainer(cfg)
        assert jax_fault_plan().hits("ckpt.reshard") == before + (dp == 2)
        assert ref.context.iterations == 3 and ref.context.consumed_samples == 12
        assert ref.optimizer_states_loaded
        params = flat_jax_params(ref)
        out = ref.train_step()
    for name, key in port.module.ckpt_keys().items():
        t = dict(port.module.model.named_parameters())[name].detach()
        want = t.t() if t.ndim == 2 and not key.endswith("embedding.weight") else t
        np.testing.assert_array_equal(params[key], want.numpy(), err_msg=key)
    assert np.isfinite(float(out.loss))


def test_port_restores_a_jax_checkpoint_of_two_devices(prefixes, tmp_path, capsys):
    """A JAX checkpoint saved at dp 2 restores in the port on one device:
    the ``ckpt-reshard`` event, the consumed samples carried; a batch grid
    that does not divide them is refused."""
    cfg = config_dict(prefixes, tmp_path / "jax", iterations=3, log=False)
    cfg["topology"].update(data_parallel_size=2, gradient_accumulation_steps=1)
    jax_main_run(cfg)
    mesh = json.loads((tmp_path / "jax/ckpt/global_step3/MESH.json").read_text())
    assert mesh["topology"]["data_parallel_size"] == 2
    port = build_trainer(TransformerConfig.from_dict(config_dict(
        prefixes, tmp_path / "jax", load=True, log=False)), device="cpu")
    assert port.context.iterations == 3 and port.context.consumed_samples == 12
    event = [line for line in capsys.readouterr().out.splitlines() if "ckpt-reshard" in line]
    assert len(event) == 1
    fields = json.loads(event[0].split("EVENT ", 1)[1])
    assert (fields["saved"], fields["restoring"], fields["step"]) == (
        "world2·pp1·dp2·cp1·mp1·hosts1", "world1·pp1·dp1·cp1·mp1·hosts1", 3)
    assert np.isfinite(port.train_step().loss)
    bad = config_dict(prefixes, tmp_path / "jax", load=True, log=False)
    bad["topology"].update(micro_batch_size=8, gradient_accumulation_steps=1)
    with pytest.raises(ReshardError, match="consumed_samples"):
        build_trainer(TransformerConfig.from_dict(bad), device="cpu")


def test_port_refuses_a_mesh_json_whose_global_shapes_disagree(prefixes, tmp_path):
    from scaling_tpu_torch.resilience.manifest import write_manifest

    build_trainer(TransformerConfig.from_dict(config_dict(
        prefixes, tmp_path, iterations=3, log=False)), device="cpu").run_training()
    step_dir = tmp_path / "ckpt/global_step3"
    mesh = json.loads((step_dir / "MESH.json").read_text())
    mesh["topology"].update(world_size=2, data_parallel_size=2)
    mesh["params"]["layer_1_TransformerLayer.mlp.up_proj.weight"]["shape"] = [64, 256]
    (step_dir / "MESH.json").write_text(json.dumps(mesh))
    write_manifest(step_dir, 3)  # the doctored file verifies: the pre-flight must refuse it
    with pytest.raises(ReshardError, match="up_proj.weight: global shape"):
        build_trainer(TransformerConfig.from_dict(config_dict(
            prefixes, tmp_path, load=True, log=False)), device="cpu")


# ----------------------------------------------------- in subprocesses
def run_child(tmp: Path, name: str, prefixes, faults: str = "", timeout: float = 300,
              wait=True, child_extra=None, **trainer):
    workdir = tmp / name
    workdir.mkdir(parents=True, exist_ok=True)
    trainer.setdefault("iterations", 10)
    spec = {"config": config_dict(prefixes, workdir, **trainer),
            "result_path": str(workdir / "result.json"),
            "chain_marker": str(workdir / "CHAINED"), **(child_extra or {})}
    spec_file = workdir / f"spec_{time.monotonic_ns()}.json"
    spec_file.write_text(json.dumps(spec))
    env = {k: v for k, v in os.environ.items() if k != "SCALING_TPU_FAULTS"}
    if faults:
        env["SCALING_TPU_FAULTS"] = faults
    cmd = [sys.executable, str(Path(__file__).resolve()), str(spec_file)]
    if not wait:
        with open(workdir / "child.log", "w") as log:
            return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                                    stderr=subprocess.STDOUT), workdir
    p = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    return p, workdir


def result(workdir: Path) -> dict:
    return json.loads((workdir / "result.json").read_text())


@pytest.fixture(scope="module")
def baseline(prefixes, tmp_path_factory):
    """One uninterrupted 10-step child run saving at 3, 6 and 9."""
    tmp = tmp_path_factory.mktemp("supervised")
    p, workdir = run_child(tmp, "baseline", prefixes)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    losses = read_losses(workdir)
    assert sorted(losses) == list(range(1, 11))
    return tmp, workdir, losses


def test_sigterm_at_the_top_of_iteration_4_exits_without_a_step(prefixes, tmp_path):
    p, workdir = run_child(tmp_path, "sigterm", prefixes, faults="signal.sigterm=sigterm@4")
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert result(workdir)["iterations"] == 3
    assert sorted(read_losses(workdir)) == [1, 2, 3]
    assert verify_checkpoint(workdir / "ckpt/global_step3") == []
    assert (workdir / "ckpt/latest").read_text() == "global_step3"
    assert (workdir / "CHAINED").is_file()  # the handler installed before still ran
    assert "boundary already checkpointed" in p.stdout


def test_nan_burst_past_its_budget_saves_and_exits_42(prefixes, tmp_path):
    p, workdir = run_child(tmp_path, "nan", prefixes, faults="step.nan_grads=nan@5x*",
                           max_consecutive_nonfinite=2)
    assert p.returncode == 42, p.stdout[-3000:] + p.stderr[-3000:]
    assert "NONFINITE_ABORT" in p.stdout and "consecutive non-finite" in p.stdout
    losses = read_losses(workdir)
    assert sorted(losses) == list(range(1, 8))  # aborted after step 7
    assert all(np.isfinite(losses[s]) for s in range(1, 5))
    assert all(losses[s] is None for s in range(5, 8))  # non-finite values are null
    assert verify_checkpoint(workdir / "ckpt/global_step7") == []
    assert (workdir / "ckpt/latest").read_text() == "global_step7"


def test_sigkill_mid_save_then_run_with_resume_matches_uninterrupted(baseline, prefixes):
    tmp, _, gold = baseline
    # SIGKILL at the 5th file write of the step-6 save
    p, workdir = run_child(tmp, "crash", prefixes,
                           faults=f"ckpt.write=kill@{WRITES_PER_SAVE + 5}")
    assert p.returncode == -signal.SIGKILL, p.stdout[-2000:] + p.stderr[-2000:]
    ckpt = workdir / "ckpt"
    assert verify_checkpoint(ckpt / "global_step3") == []
    assert not (ckpt / "global_step6").exists() and (ckpt / ".tmp-global_step6").is_dir()
    assert (ckpt / "latest").read_text() == "global_step3"
    assert all(loss == gold[s] for s, loss in read_losses(workdir).items())
    # the same directory, no cleanup, through run_with_resume
    p, workdir = run_child(tmp, "crash", prefixes, load=True, child_extra={"restart_budget": 1})
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert result(workdir)["resumed_from"] == [3] and result(workdir)["iterations"] == 10
    resumed = read_losses(workdir)
    assert [resumed[s] for s in range(4, 11)] == [gold[s] for s in range(4, 11)]
    assert not (ckpt / ".tmp-global_step6").exists()
    assert verify_checkpoint(ckpt / "global_step6") == []
    assert verify_checkpoint(ckpt / "global_step9") == []
    assert (ckpt / "latest").read_text() == "global_step9"


def test_run_with_resume_restarts_after_an_injected_write_failure(baseline, prefixes):
    """A persistent write failure at the step-6 save raises OSError out of
    the first trainer; ``run_with_resume`` builds a second one, which
    resumes from step 3 and repeats the uninterrupted losses."""
    tmp, _, gold = baseline
    p, workdir = run_child(tmp, "failwrite", prefixes, load=True,
                           faults=f"ckpt.write=fail@{WRITES_PER_SAVE + 1}x3",
                           child_extra={"restart_budget": 1})
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert result(workdir)["resumed_from"] == [0, 3]
    losses = read_losses(workdir)
    assert [losses[s] for s in range(1, 11)] == [gold[s] for s in range(1, 11)]
    assert (workdir / "ckpt/latest").read_text() == "global_step9"


def test_corrupt_and_torn_checkpoints_are_skipped(baseline, prefixes):
    tmp, golden_workdir, gold = baseline
    workdir = tmp / "fallback"
    shutil.copytree(golden_workdir / "ckpt", workdir / "ckpt")
    ckpt = workdir / "ckpt"
    f9 = ckpt / "global_step9" / "model_state_layer_0_EmbeddingInput.npz"
    f9.write_bytes(b"\x00" * f9.stat().st_size)  # bad digest under an intact manifest
    (ckpt / "global_step6" / "MANIFEST.json").unlink()  # legacy and truncated: torn
    f6 = ckpt / "global_step6" / "model_state_layer_0_EmbeddingInput.npz"
    f6.write_bytes(f6.read_bytes()[: f6.stat().st_size // 3])
    p, workdir = run_child(tmp, "fallback", prefixes, load=True)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert result(workdir)["resumed_from"] == [3] and result(workdir)["iterations"] == 10
    resumed = read_losses(workdir)
    assert [resumed[s] for s in range(4, 11)] == [gold[s] for s in range(4, 11)]
    assert "skipping invalid checkpoint global_step9" in p.stdout
    assert "skipping unreadable checkpoint global_step6" in p.stdout
    assert verify_checkpoint(ckpt / "global_step9") == []


def test_real_sigterm_saves_at_the_boundary_and_resumes_bitwise(baseline, prefixes):
    """SIGTERM from outside once step 4 is logged, to a run with the
    supervision keys on (prefetch, async saves, the watchdog, a non-finite
    budget): it saves at the boundary it reached and exits 0; the resumed
    run repeats the uninterrupted losses bitwise."""
    tmp, _, gold = baseline
    supervised = dict(dataloader_prefetch_factor=2, save_checkpoint_async=True,
                      step_timeout_seconds=120, max_consecutive_nonfinite=2)
    proc, workdir = run_child(tmp, "preempted", prefixes, wait=False,
                              child_extra={"step_sleep": 0.3}, **supervised)
    try:
        deadline = time.monotonic() + 240
        while 4 not in read_losses(workdir):
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=240)
    finally:
        proc.kill()
    assert proc.returncode == 0, (workdir / "child.log").read_text()[-3000:]
    k = result(workdir)["iterations"]
    assert k in (4, 5), k
    assert max(read_losses(workdir)) == k
    ckpt = workdir / "ckpt"
    assert (ckpt / "latest").read_text() == f"global_step{k}"
    for step in (3, k):
        assert verify_checkpoint(ckpt / f"global_step{step}") == []
        assert (ckpt / f"global_step{step}" / "MESH.json").is_file()
    p, workdir = run_child(tmp, "preempted", prefixes, load=True, **supervised)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert result(workdir)["resumed_from"] == [k]
    assert read_losses(workdir) == gold


def test_hooks_see_durable_checkpoints_and_an_external_preemption_saves(prefixes, tmp_path):
    """``checkpoint_hooks`` get each step directory once it is committed
    (an async save is drained first); ``external_preemption``, polled after
    each step, saves at that boundary and ends the run."""
    trainer = build_trainer(TransformerConfig.from_dict(config_dict(
        prefixes, tmp_path, iterations=10, save_checkpoint_async=True)), device="cpu")
    seen = []
    trainer.checkpoint_hooks.append(lambda step_dir, step: seen.append(
        (step_dir.name, step, (step_dir.parent / "latest").read_text(),
         verify_checkpoint(step_dir))))
    trainer.external_preemption = lambda: trainer.context.iterations == 5
    trainer.run_training()
    assert trainer.context.iterations == 5
    assert seen == [("global_step3", 3, "global_step3", []),
                    ("global_step5", 5, "global_step5", [])]
    assert sorted(read_losses(tmp_path)) == [1, 2, 3, 4, 5]


# ------------------------------------------------ the control-plane protocol
def supervised_trainer(prefixes, workdir, cp, iterations=4, save_interval=2, **trainer):
    """A toy trainer on the CPU joined to ``cp`` (barrier timeout 30 s), its
    heartbeats recorded as (step, status)."""
    t = build_trainer(TransformerConfig.from_dict(config_dict(
        prefixes, workdir, iterations=iterations, save_interval=save_interval, **trainer)),
        device="cpu")
    t.attach_control_plane(cp, barrier_timeout_s=30.0)
    beats, publish = [], cp.heartbeat
    cp.heartbeat = lambda step, status="running": (beats.append((step, status)),
                                                   publish(step, status))[1]
    t.beats = beats
    return t


def test_heartbeats_say_starting_running_then_done_or_preempted(prefixes, tmp_path):
    """A heartbeat at each loop top (``starting`` the first), one at the
    head of each save window, ``done`` at the end; a SIGTERM's drain
    refreshes before its save and ends ``preempted``."""
    from scaling_tpu_torch.resilience import FileControlPlane

    done = supervised_trainer(prefixes, tmp_path / "done", FileControlPlane(tmp_path / "cp1", 0, 1))
    done.run_training()
    assert done.beats == [(0, "starting"), (1, "running"), (2, "running"), (2, "running"),
                          (3, "running"), (4, "running"), (4, "done")]
    cp = FileControlPlane(tmp_path / "cp2", 0, 1)
    drained = supervised_trainer(prefixes, tmp_path / "drained", cp, iterations=6,
                                 save_interval=4)
    drained.metrics_hooks.append(lambda m, step: step == 3 and os.kill(os.getpid(),
                                                                       signal.SIGTERM))
    handler = signal.getsignal(signal.SIGTERM)
    try:
        drained.install_preemption_handler()
        drained.run_training()
    finally:
        signal.signal(signal.SIGTERM, handler)
    assert drained.context.iterations == 3
    assert drained.beats[-3:] == [(3, "running"), (3, "running"), (3, "preempted")]
    assert cp.get_flag("preempt") == "3"
    assert (tmp_path / "drained/ckpt/latest").read_text() == "global_step3"


def test_the_abort_flag_raises_job_aborted_without_a_save(prefixes, tmp_path):
    from scaling_tpu_torch.resilience import FileControlPlane, JobAborted

    cp = FileControlPlane(tmp_path / "cp", 0, 1)
    t = supervised_trainer(prefixes, tmp_path, cp, iterations=6)
    t.metrics_hooks.append(lambda m, step: step == 3 and cp.set_flag("abort", "host-dead"))
    with pytest.raises(JobAborted, match="abort flag"):
        t.run_training()
    assert t.context.iterations == 3
    assert (tmp_path / "ckpt/latest").read_text() == "global_step2"
    assert sorted(p.name for p in (tmp_path / "ckpt").glob("global_step*")) == ["global_step2"]


def test_a_peers_preempt_flag_saves_at_the_same_boundary(prefixes, tmp_path):
    from scaling_tpu_torch.resilience import FileControlPlane

    cp = FileControlPlane(tmp_path / "cp", 0, 1)
    t = supervised_trainer(prefixes, tmp_path, cp, iterations=6, save_interval=4)
    # a peer broadcasts its boundary 3 while this host logs step 3
    t.metrics_hooks.append(lambda m, step: step == 3 and cp.set_flag("preempt", "3"))
    t.run_training()
    assert t.context.iterations == 3 and t._preempted
    assert (tmp_path / "ckpt/latest").read_text() == "global_step3"
    assert t.beats[-1] == (3, "preempted")


@pytest.mark.parametrize("own_stale", [False, True], ids=["peer_dead", "own_heartbeat_stale"])
def test_a_stall_sets_the_stall_flag_with_the_jax_verdict(tmp_path, monkeypatch, own_stale):
    """The watchdog's callback with a 2-host plane, in both packages: peer 1
    never published (``peer-host-dead``), or this host's own heartbeat is
    stale while the peer's is fresh (``local-stall``): the same event, the
    stall flag set, a drain requested."""
    from scaling_tpu.resilience.controlplane import FileControlPlane as JaxPlane
    from scaling_tpu.trainer.trainer import BaseTrainer as JaxTrainer
    from scaling_tpu_torch.resilience import FileControlPlane
    from scaling_tpu_torch.trainer import BaseTrainer

    seen = {}
    for name, trainer_cls, plane in (("port", BaseTrainer, FileControlPlane),
                                     ("jax", JaxTrainer, JaxPlane)):
        events = tmp_path / f"{name}.jsonl"
        monkeypatch.setenv("SCALING_TPU_EVENTS_PATH", str(events))
        cp = plane(tmp_path / name, 0, 2)
        cp.heartbeat(5)
        if own_stale:
            old = time.time() - 120.0
            os.utime(tmp_path / name / "heartbeat" / "host0.json", (old, old))
            plane(tmp_path / name, 1, 2).heartbeat(5)
        t = object.__new__(trainer_cls)
        t._control_plane, t._cp_peer_stale, t._preempted = cp, 1.0, False
        t._on_step_stall(5, 33.0)
        assert t._preempted and cp.get_flag("stall") == "5"
        seen[name] = [{k: v for k, v in json.loads(line).items() if k != "ts"}
                      for line in events.read_text().splitlines()
                      if '"step-stall"' in line]
    assert seen["port"] == seen["jax"] == [{
        "event": "step-stall", "step": 5, "elapsed_s": 33.0, "host": 0,
        "verdict": "local-stall" if own_stale else "peer-host-dead",
        "dead_hosts": [] if own_stale else [1]}]


def test_checkin_exit_path_releases_a_parked_peer(tmp_path):
    """Host 1 decides to exit at boundary 3 while host 0 already waits in
    the step-3 barrier: its checkin sets the flag, then arrives without
    waiting, and host 0 is released to join the same boundary."""
    from types import SimpleNamespace

    from scaling_tpu_torch.resilience import FileControlPlane
    from scaling_tpu_torch.trainer import BaseTrainer

    a, b = FileControlPlane(tmp_path, 0, 2), FileControlPlane(tmp_path, 1, 2)
    trainer = object.__new__(BaseTrainer)
    trainer._control_plane, trainer._cp_first_checkin = b, False
    trainer._cp_step_barrier, trainer._cp_barrier_timeout = True, 10.0
    trainer._preempted = True
    trainer.context = SimpleNamespace(iterations=3)
    released = []
    t = threading.Thread(target=lambda: (a.barrier("step-3", timeout_s=10), released.append(1)))
    t.start()
    time.sleep(0.2)
    start = time.monotonic()
    assert trainer._control_plane_checkin() is True
    assert time.monotonic() - start < 2.0
    t.join(timeout=10)
    assert released == [1] and a.get_flag("preempt") == "3"


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_two_hosts_meet_at_step_barriers_and_latest_waits_for_the_commit_barrier(
        prefixes, tmp_path, async_save):
    """Host 0 trains on a 2-host plane whose host 1 is a thread: they meet at
    every ``step-N``; host 0's ``latest`` moves only after host 1 arrived at
    ``commit:step-2`` (a second after host 0's commit), on the writer's
    thread when the save is asynchronous, and the run's losses are those of
    an unsupervised run."""
    from scaling_tpu_torch.resilience import FileControlPlane

    plain = build_trainer(TransformerConfig.from_dict(config_dict(
        prefixes, tmp_path / "plain", iterations=4, save_interval=2)), device="cpu")
    plain.run_training()
    root, ckpt = tmp_path / "cp", tmp_path / "pod" / "ckpt"
    t = supervised_trainer(prefixes, tmp_path / "pod", FileControlPlane(root, 0, 2),
                           save_checkpoint_async=async_save)
    peer, seen = FileControlPlane(root, 1, 2), []

    def host1():
        for name in ("step-0", "step-1"):
            peer.barrier(name, timeout_s=30)
        deadline = time.monotonic() + 60
        while not (ckpt / "global_step2").is_dir() and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(1.0)  # host 0 committed global_step2 and waits for this host
        seen.append(((ckpt / "global_step2").is_dir(), (ckpt / "latest").exists()))
        for name in ("commit:step-2", "step-2", "step-3", "commit:step-4"):
            peer.barrier(name, timeout_s=30)

    thread = threading.Thread(target=host1)
    thread.start()
    t.run_training()
    thread.join(timeout=60)
    assert seen == [(True, False)]
    assert (ckpt / "latest").read_text() == "global_step4"
    assert read_losses(tmp_path / "pod") == read_losses(tmp_path / "plain")
    # host 0 pruned what no host can wait on again
    assert not (root / "barrier" / "step-0").exists() and (root / "barrier" / "step-3").is_dir()
