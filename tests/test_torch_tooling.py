"""The restore's fault points, the verified checkpoint selection, the
model-free leaf reader and the train bench's micro-batch ladder, against
the JAX package.

- ``restore.assemble`` fires once per npz the port's load opens; a
  transient failure there is retried by the Trainer's bounded retry and a
  persistent one demotes the checkpoint to the older step, as
  tests/core/test_resilience/test_reshard.py shows for JAX.
- ``ckpt.reshard`` fires exactly once when the port restores a JAX
  checkpoint saved on two devices, and not at the same topology.
- ``iter_global_leaves`` yields JAX's names and arrays over the same
  files; ``select_checkpoint`` picks JAX's step and skips JAX's steps on
  directories of valid, corrupt and half-written checkpoints.
- ``climb_mbs_ladder`` decides as ``bench.py``'s on faked measurements
  (tests/core/test_bench.py), absorbs only ``torch.cuda.OutOfMemoryError``
  and frees the failed rung first; ``train bench --mbs-plan`` prints each
  rung and the winner.

Toy model: rms/swiglu, hidden 64, 2 layers, 4/2 heads, vocab 96, seq 32,
f32, two blended token datasets from a seed.
"""

import gc
import json
import shutil
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from scaling_tpu.resilience import iter_global_leaves as jax_iter_global_leaves  # noqa: E402
from scaling_tpu.resilience import manifest as jax_manifest  # noqa: E402
from scaling_tpu.resilience.restore import select_checkpoint as jax_select  # noqa: E402
from scaling_tpu_torch.checkpoint import load_model_checkpoint  # noqa: E402
from scaling_tpu_torch.models.transformer import TransformerConfig  # noqa: E402
from scaling_tpu_torch.models.transformer.train import build_trainer  # noqa: E402
from scaling_tpu_torch.resilience import (  # noqa: E402
    CheckpointCorruptionError,
    FaultPlan,
    get_fault_plan,
    iter_global_leaves,
    scan_step_dirs,
    select_checkpoint,
    set_fault_plan,
)
from scaling_tpu_torch.train import bench as train_bench  # noqa: E402

from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401
from .test_torch_supervision import config_dict, jax_main_run, prefixes  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def no_fault_plan():
    set_fault_plan(FaultPlan(""))
    yield
    set_fault_plan(None)


@pytest.fixture(scope="module")
def two_steps(prefixes, tmp_path_factory):  # noqa: F811
    """A port run of 6 steps with committed checkpoints at 3 and 6."""
    work = tmp_path_factory.mktemp("two_steps")
    build_trainer(TransformerConfig.from_dict(config_dict(prefixes, work, log=False)),
                  device="cpu").run_training()
    return work / "ckpt"


def restore(prefixes, ckpt, work, faults: str = ""):  # noqa: F811
    set_fault_plan(FaultPlan(faults))
    cfg = config_dict(prefixes, work, iterations=9, log=False)
    cfg["trainer"].update(load_dir=str(ckpt), save_dir=None)
    return build_trainer(TransformerConfig.from_dict(cfg), device="cpu")


def test_restore_assemble_fires_once_per_artifact(prefixes, two_steps, tmp_path):  # noqa: F811
    step = two_steps / "global_step6"
    n_model = len(list(step.glob("model_state_layer_*.npz")))
    n_opt = len(list(step.glob("optimizer_state_layer_*.npz")))
    assert n_model == n_opt == 5
    trainer = restore(prefixes, two_steps, tmp_path)
    assert trainer.context.iterations == 6 and trainer.optimizer_states_loaded
    assert get_fault_plan().hits("restore.assemble") == n_model + n_opt
    set_fault_plan(FaultPlan(""))
    params = {trainer.module.ckpt_keys()[n]: p
              for n, p in trainer.module.model.named_parameters()}
    load_model_checkpoint(step, params)
    assert get_fault_plan().hits("restore.assemble") == n_model


def test_a_transient_restore_failure_is_retried(prefixes, two_steps, tmp_path):  # noqa: F811
    trainer = restore(prefixes, two_steps, tmp_path, "restore.assemble=fail@1")
    assert trainer.context.iterations == 6
    assert get_fault_plan().hits("restore.assemble") == 1 + 10  # the failed try, then all
    assert np.isfinite(float(trainer.train_step().loss))


def test_a_persistent_restore_failure_demotes_to_the_older_step(
        prefixes, two_steps, tmp_path):  # noqa: F811
    # one failure a try, io_retry_attempts 3: step 6 fails its three tries
    trainer = restore(prefixes, two_steps, tmp_path, "restore.assemble=fail@1x3")
    assert trainer.context.iterations == 3 and trainer.optimizer_states_loaded
    assert get_fault_plan().hits("restore.assemble") == 3 + 10


def test_ckpt_reshard_fires_once_for_a_jax_checkpoint_of_two_devices(
        prefixes, two_steps, tmp_path):  # noqa: F811
    cfg = config_dict(prefixes, tmp_path / "jax", iterations=3, log=False)
    cfg["topology"].update(data_parallel_size=2, gradient_accumulation_steps=1)
    jax_main_run(cfg)
    mesh = json.loads((tmp_path / "jax/ckpt/global_step3/MESH.json").read_text())
    assert mesh["topology"]["data_parallel_size"] == 2
    trainer = restore(prefixes, tmp_path / "jax/ckpt", tmp_path / "r")
    assert trainer.context.iterations == 3
    assert get_fault_plan().hits("ckpt.reshard") == 1
    restore(prefixes, two_steps, tmp_path / "same")  # saved at this topology
    assert get_fault_plan().hits("ckpt.reshard") == 0
    # an injected failure there is an OSError the bounded retry retries
    trainer = restore(prefixes, tmp_path / "jax/ckpt", tmp_path / "f", "ckpt.reshard=fail@1")
    assert trainer.context.iterations == 3 and get_fault_plan().hits("ckpt.reshard") == 2


def test_iter_global_leaves_yields_jaxs_leaves(two_steps):
    step = two_steps / "global_step6"
    set_fault_plan(FaultPlan("restore.assemble=fail@1"))  # retried inside
    port = list(iter_global_leaves(step, retry_backoff=0.0))
    assert get_fault_plan().hits("restore.assemble") == 11
    ref = list(jax_iter_global_leaves(step, retry_backoff=0.0))
    assert [(f, n) for f, n, _ in port] == [(f, n) for f, n, _ in ref]
    assert {f for f, _, _ in port} == {p.name for p in step.glob("*_state_layer_*.npz")}
    for (f, n, a), (_, _, b) in zip(port, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f"{f}:{n}")
    mesh = json.loads((step / "MESH.json").read_text())
    shapes = {tuple(a.shape) for _, _, a in port}
    assert all(tuple(rec["shape"]) in shapes for rec in mesh["params"].values())


def flip_one_byte(path: Path) -> None:
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))


SCENARIOS = {
    # latest names the corrupt newest step: the older one is taken
    "latest-corrupt": dict(corrupt=6, latest="global_step6"),
    # no latest; a half-written newer step (a listed file missing) and a corrupt one
    "half-written-newest": dict(corrupt=6, half=7, latest=None),
    # latest names an older valid step: honoured
    "latest-older": dict(latest="global_step3"),
    # latest names a directory that does not exist: a scan
    "latest-dangling": dict(half=7, latest="global_step9"),
    # nothing valid
    "none-valid": dict(corrupt=6, corrupt_too=3, latest="global_step6"),
}


def scenario_dir(two_steps, root: Path, corrupt=None, half=None, latest=None, corrupt_too=None):
    base = root / "ckpt"
    shutil.copytree(two_steps, base)
    for step in (corrupt, corrupt_too):
        if step is not None:
            flip_one_byte(base / f"global_step{step}" / "model_state_layer_1_TransformerLayer.npz")
    if half is not None:
        shutil.copytree(base / "global_step3", base / f"global_step{half}")
        (base / f"global_step{half}" / "model_state_layer_2_TransformerLayer.npz").unlink()
    if latest is None:
        (base / "latest").unlink()
    else:
        (base / "latest").write_text(latest)
    return base


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_select_checkpoint_agrees_with_jax(two_steps, tmp_path, scenario):
    base = scenario_dir(two_steps, tmp_path, **SCENARIOS[scenario])
    got, skipped = select_checkpoint(base)
    want, want_skipped = jax_select(base)
    assert got == want
    assert [s.split(":")[0] for s in skipped] == [s.split(":")[0] for s in want_skipped]
    assert scan_step_dirs(base) == [(s, base / f"global_step{s}") for s in sorted(
        int(p.name[len("global_step"):]) for p in base.glob("global_step*"))][::-1]
    if want_skipped:
        with pytest.raises(CheckpointCorruptionError, match=want_skipped[0].split(":")[0]):
            select_checkpoint(base, strict=True)
        with pytest.raises(jax_manifest.CheckpointCorruptionError):
            jax_select(base, strict=True)


# the micro-batch ladder ---------------------------------------------------------------
def jax_bench():
    sys.path.insert(0, str(REPO))
    import bench

    return bench


def fakes(step_seconds: dict, seq: int = 1):
    """measure(mbs) for both ladders: step seconds, None for out of memory."""
    calls = []

    def port(mbs):
        calls.append(mbs)
        if step_seconds[mbs] is None:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return {"mbs": mbs, "tokens_per_s": mbs * seq / step_seconds[mbs]}

    def jax_measure(mbs):
        if step_seconds[mbs] is None:
            raise RuntimeError("RESOURCE_EXHAUSTED")
        return f"arch{mbs}", step_seconds[mbs]

    return port, jax_measure, calls


LADDERS = {
    "8-wins-16-loses": ({4: 1.0, 8: 1.5, 16: 4.0, 32: 0.1}, [4, 8, 16, 32], 8, [4, 8, 16]),
    "8-out-of-memory": ({4: 1.0, 8: None, 16: 1.0}, [4, 8, 16], 4, [4, 8]),
    "monotone": ({4: 1.0, 8: 1.9, 16: 3.7}, [4, 8, 16], 16, [4, 8, 16]),
    "one-rung": ({4: 1.0}, [4], 4, [4]),
    "top-rung-out-of-memory": ({4: 1.0, 8: 1.9, 16: None}, [4, 8, 16], 8, [4, 8, 16]),
}


@pytest.mark.parametrize("ladder", list(LADDERS))
def test_mbs_ladder_decides_as_bench_py(ladder, capsys):
    seconds, plan, winner, measured = LADDERS[ladder]
    port, jax_measure, calls = fakes(seconds)
    best, rungs = train_bench.climb_mbs_ladder(port, plan)
    assert best["mbs"] == winner and calls == measured
    _, _, jax_winner = jax_bench().climb_mbs_ladder(jax_measure, plan, "arch4", seconds[plan[0]])
    assert jax_winner == winner
    assert [r["mbs"] for r in rungs] == measured
    oom = [r["mbs"] for r in rungs if r.get("oom")]
    assert oom == [m for m in measured if seconds[m] is None]
    if oom:
        assert f"mbs={oom[0]} rung out of memory" in capsys.readouterr().err


def test_a_rung_error_other_than_out_of_memory_propagates():
    def measure(mbs):
        if mbs == 8:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return {"mbs": mbs, "tokens_per_s": float(mbs)}

    with pytest.raises(RuntimeError, match="illegal memory access"):
        train_bench.climb_mbs_ladder(measure, [4, 8, 16])


def test_an_out_of_memory_rung_is_freed_before_the_ladder_reports(capsys):
    refs = []

    class Tensors:  # a rung's model, optimizer and batch, in a cycle as a module's are
        def __init__(self):
            self.me = self

    def measure(mbs):
        held = Tensors()
        refs.append(weakref.ref(held))
        if mbs == 8:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return {"mbs": mbs, "tokens_per_s": 1.0}

    gc.disable()  # only the ladder's own collection may free the cycle
    try:
        best, _ = train_bench.climb_mbs_ladder(measure, [4, 8])
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()
    assert best["mbs"] == 4 and "mbs=8 rung out of memory" in capsys.readouterr().err


def test_train_bench_climbs_its_plan_on_the_cpu(capsys):
    rc = train_bench.main(["--device", "cpu", "--model", "toy", "--seq-len", "32",
                           "--mbs-plan", "1,2", "--steps", "1", "--warmup", "0"])
    out = capsys.readouterr().out
    assert rc == 0
    ladder = [line for line in out.splitlines() if line.startswith("ladder: ")]
    assert len(ladder) == 1 and "mbs=1 " in ladder[0] and "winner mbs=" in ladder[0]
    winner = int(ladder[0].rsplit("winner mbs=", 1)[1])
    assert f"mbs={winner} " in out.splitlines()[0]
    with pytest.raises(SystemExit):
        train_bench.main(["--device", "cpu", "--mbs", "2", "--mbs-plan", "2,4"])
    with pytest.raises(SystemExit):
        train_bench.main(["--device", "cpu", "--mbs-plan", "0,4"])
