"""ZeRO stage 3 in the port's Trainer against the JAX package's Trainer at
``zero_stage: 3`` (``test_training.py``'s stage-3 case), a toy rms/swiglu
model (hidden 128, 2 layers, 4/2 heads, vocab 96, seq 32, f32, untied,
accumulation 2) on the CPU, the ranks gloo processes of ``run_ranks`` that
each run ``train.main``:

- the JAX trainer's initialisation is saved as a JAX checkpoint (step 0,
  one rank's files); the port at dp 2 with ZeRO-3 and with ZeRO-1, and JAX
  at dp 2 with ZeRO-3, load it and train 3 steps: the port's stage-3 losses
  are within rtol 1e-5 of JAX's and of the port's ZeRO-1 run;
- under ``every_layer_save_dots`` (the selective checkpoint's recompute
  gathers each sliced leaf again, in the backward's order on every rank;
  ``every_layer`` is in ``test_torch_sequence_parallel.py``) the port's
  stage-3 losses are within rtol 1e-5 of JAX's Trainer at stage 3 with the
  same remat;
- at least 4 leaves are stored on each rank as a slice smaller than the
  leaf, as JAX's test asserts of its placement, and the ranks' slices put
  together are the leaf;
- a resume from the run's own step-3 checkpoint gives steps 4-5 losses
  bitwise equal to the uninterrupted run's;
- checkpoints: JAX at ZeRO-1 and the port at one rank load the port's
  stage-3 checkpoint, equal to the arrays on disk; the port at stage 3
  loads JAX's stage-3 checkpoint and the port's ZeRO-1 one, the ranks'
  slices equal to the files; ``MESH.json`` names zero stage 3;
- a tied head at pp 2 x dp 2 with ZeRO-3 and ``every_pipe_stage`` (the
  table sliced on both end stages, its gradient summed over them) against
  one rank of the same tied model, rtol 1e-5;
- ``convert.params_from_jax(..., zero_stage3=True)`` gives each rank its
  data slice of its model slice, which put together are the model slice;
- ``optimizer.debug_log`` at dp 2 x mp 2 with ZeRO-3: each leaf's clipped
  gradient norm by its JAX key on every rank against the JAX trainer's
  ``debug_dict`` at the same layout, 3 steps: the first step's, from the
  same weights, within rtol 1e-5 (measured 3.1e-7); the later steps' within
  rtol 1e-4 (measured 1.6e-5 and 3.2e-5), since after a step the weights
  differ by the reordered f32 sums that Adam amplifies where a gradient is
  near its epsilon (``test_torch_context_parallel_training.py``).
"""

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from scaling_tpu.ops.rms_norm import force_rms_interpret  # noqa: E402
from scaling_tpu_torch.models.transformer import TransformerConfig  # noqa: E402
from scaling_tpu_torch.models.transformer.convert import params_from_jax  # noqa: E402
from scaling_tpu_torch.resilience import read_mesh_meta, verify_checkpoint  # noqa: E402

from .test_torch_checkpoint import jax_trainer  # noqa: E402
from .test_torch_context_parallel_training import ARCH, stored  # noqa: E402
from .test_torch_dist_helpers import debug_worker, load_worker, run_ranks, train_worker  # noqa: E402
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401
from .test_torch_pipeline_training import data  # noqa: E402,F401

STEPS, LONG = 3, 5
# name -> (dp, mp, zero stage (0: off), remat, steps)
LAYOUTS = {
    "z3": (2, 1, 3, "disabled", LONG),
    "z1": (2, 1, 1, "disabled", STEPS),
    "z3_save_dots": (2, 1, 3, "every_layer_save_dots", STEPS),
}
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6


def config(data, root: Path, dp: int, mp: int = 1, zero: int = 0, remat: str = "disabled",
           steps: int = STEPS, load_dir=None, debug: bool = False, pp: int = 1,
           arch=None) -> dict:
    return {
        "topology": {"model_parallel_size": mp, "pipe_parallel_size": pp,
                     "data_parallel_size": dp, "world_size": pp * dp * mp,
                     "micro_batch_size": 4 // dp, "gradient_accumulation_steps": 2,
                     "activation_checkpointing_type": remat},
        "transformer_architecture": arch or ARCH,
        "optimizer": {"gradient_clipping": 1.0, "zero": zero > 0, "zero_stage": max(zero, 1),
                      "debug_log": debug},
        "learning_rate_scheduler": {"learning_rate": 0.01, "learning_rate_warmup_steps": 2,
                                    "learning_rate_decay_iters": 50},
        "trainer": {"train_iterations": steps, "seed": 42, "save_dir": str(root / "ckpt"),
                    "save_interval": STEPS,
                    "load_dir": None if load_dir is None else str(load_dir),
                    "assert_checkpoint_loaded": load_dir is not None,
                    "load_optimizer_states": load_dir is not None,
                    "delete_past_optimizer_states": False},
        "data": {"data_prefixes": data},
        "logger": {"log_dir": str(root / "logs")},
    }


def jax_debug(cfg: dict) -> list:
    """The JAX trainer's ``debug_dict`` of each step at ``cfg``."""
    with force_rms_interpret():
        run = jax_trainer(cfg, load=True)
        dicts, inner = [], run._train_step

        def capture(*args):
            out = inner(*args)
            dicts.append({k: float(v) for k, v in out[4].debug_dict.items()})
            return out

        run._train_step = capture
        for _ in range(STEPS):
            run.train_step()
    return dicts


def joined(ranks: list, name: str, whole: np.ndarray) -> np.ndarray:
    """The data ranks' slices of ``name`` put back together along the dim
    where they are smaller than ``whole`` (the leaf itself if whole)."""
    parts = [r["params"][name] for r in ranks]
    for dim, (a, b) in enumerate(zip(parts[0].shape, whole.shape)):
        if a != b:
            return np.concatenate(parts, axis=dim)
    return parts[0]


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    root = tmp_path_factory.mktemp("zero3")
    with force_rms_interpret():
        jax_trainer(config(data, root / "seed", 1), load=False).save_checkpoint()
    step0 = root / "seed" / "ckpt" / "global_step0"
    debug_cfg = config(data, root / "debug", 2, 2, 3, load_dir=step0, debug=True)
    tied = dict(ARCH, weight_tying=True)  # from the port's own seed on both sides
    tied_cfgs = {"tied_pp2": config(data, root / "tied_pp2", 2, 1, 3, "every_pipe_stage",
                                    pp=2, arch=tied),
                 "tied_one": config(data, root / "tied_one", 1, arch=tied)}
    with ThreadPoolExecutor(len(LAYOUTS) + 3) as pool:
        futures = {name: pool.submit(run_ranks, train_worker, dp * mp,
                                     config(data, root / name, dp, mp, zero, remat, steps,
                                            step0), timeout=240)
                   for name, (dp, mp, zero, remat, steps) in LAYOUTS.items()}
        futures["debug"] = pool.submit(run_ranks, debug_worker, 4, debug_cfg, timeout=240)
        for name, cfg in tied_cfgs.items():
            futures[name] = pool.submit(run_ranks, train_worker,
                                        cfg["topology"]["world_size"], cfg, timeout=240)
        with force_rms_interpret():
            run = jax_trainer(config(data, root / "jax_z3", 2, 1, 3, load_dir=step0),
                              load=True)
            jax_losses = [float(run.train_step().loss) for _ in range(STEPS)]
            run.save_checkpoint()
            run = jax_trainer(config(data, root / "jax_z3_save_dots", 2, 1, 3,
                                     "every_layer_save_dots", load_dir=step0), load=True)
            jax_save_dots = [float(run.train_step().loss) for _ in range(STEPS)]
        futures["z3"].result()  # its step-3 checkpoint is written: resume from it
        resume = pool.submit(run_ranks, train_worker, 2, config(
            data, root / "resume", 2, 1, 3, steps=LONG,
            load_dir=root / "z3" / "ckpt" / f"global_step{STEPS}"), timeout=240)
        jax_dicts = jax_debug(config(data, root / "jax_debug", 2, 2, 3, load_dir=step0,
                                     debug=True))
        port = {name: f.result() for name, f in futures.items()}
    return {"root": root, "jax": jax_losses, "jax_save_dots": jax_save_dots,
            "jax_debug": jax_dicts, "port": port, "resume": resume.result()}


def test_zero3_losses_match_jax_at_stage3_and_the_port_at_zero1(runs):
    for rank in runs["port"]["z3"]:  # every rank reports the global loss
        losses = rank["losses"][:STEPS]
        np.testing.assert_allclose(losses, runs["jax"], rtol=LOSS_RTOL, atol=LOSS_ATOL)
        np.testing.assert_allclose(losses, runs["port"]["z1"][0]["losses"], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)


def test_zero3_under_save_dots_remat_matches_jax(runs):
    for rank in runs["port"]["z3_save_dots"]:
        np.testing.assert_allclose(rank["losses"], runs["jax_save_dots"], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)


def test_parameters_are_stored_as_data_slices(runs):
    whole = stored(runs["root"] / "z3" / "ckpt" / f"global_step{STEPS}")  # the shapes
    ranks = runs["port"]["z3"]
    for rank in ranks:
        assert set(rank["params"]) == set(whole)
        smaller = [n for n, p in rank["params"].items() if p.size < whole[n].size]
        assert len(smaller) >= 4, smaller
        for n in smaller:  # half of the leaf at dp 2
            assert 2 * rank["params"][n].size == whole[n].size, n
    for name, value in whole.items():
        assert joined(ranks, name, value).shape == value.shape, name


def test_a_resume_from_the_step3_checkpoint_is_bitwise(runs):
    want = runs["port"]["z3"][0]["losses"][STEPS:]
    for rank in runs["resume"]:
        assert rank["losses"] == want


def test_jax_at_zero1_and_one_rank_load_the_port_stage3_checkpoint(runs, data):
    from scaling_tpu_torch.models.transformer.train import build_trainer

    step = runs["root"] / "z3" / "ckpt" / f"global_step{STEPS}"
    assert verify_checkpoint(step) == []
    assert read_mesh_meta(step)["optimizer"]["zero_stage"] == 3
    files = stored(step)
    cfg = config(data, runs["root"] / "jax_reload", 2, 1, 1, load_dir=step)
    with force_rms_interpret():
        ref = jax_trainer(cfg, load=True)
    assert ref.context.iterations == STEPS and ref.optimizer_states_loaded
    arch = TransformerConfig.from_dict(cfg).transformer_architecture
    loaded = params_from_jax(jax.tree.map(np.asarray, ref.params), arch)
    assert set(files) == set(loaded)
    for name, value in files.items():
        np.testing.assert_array_equal(loaded[name].numpy(), value, err_msg=name)
    one = build_trainer(TransformerConfig.from_dict(
        config(data, runs["root"] / "one_reload", 1, load_dir=step)), device="cpu")
    for name, p in one.module.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), files[name], err_msg=name)


@pytest.mark.parametrize("source", ["jax_z3", "z1"])
def test_the_port_at_stage3_loads_a_checkpoint_of_jax_stage3_and_of_zero1(runs, data, source):
    step = runs["root"] / source / "ckpt" / f"global_step{STEPS}"
    files = stored(step)
    cfg = config(data, runs["root"] / f"z3_from_{source}", 2, 1, 3, load_dir=step)
    out = run_ranks(load_worker, 2, cfg, timeout=120)
    assert all(rank["iterations"] == STEPS for rank in out)
    assert set(out[0]["params"]) == set(files)
    for name, value in files.items():
        np.testing.assert_array_equal(joined(out, name, value), value, err_msg=name)


def test_debug_log_over_dp2_mp2_zero3_matches_jax_debug_dict(runs):
    want = runs["jax_debug"]
    assert len(want) == STEPS
    keys = sorted(want[0])
    for rank in runs["port"]["debug"]:
        assert len(rank["debug"]) == STEPS
        for i, (got, ref) in enumerate(zip(rank["debug"], want)):
            assert sorted(got) == keys
            np.testing.assert_allclose([got[k] for k in keys], [ref[k] for k in keys],
                                       rtol=1e-5 if i == 0 else 1e-4, atol=1e-8)


def test_a_tied_head_at_pp2_dp2_zero3_matches_one_rank(runs):
    one = runs["port"]["tied_one"][0]["losses"]
    ranks = runs["port"]["tied_pp2"]
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], one, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    # both end stages hold the table's data slice
    tables = [r["params"]["layers.layer_0.embedding.weight"] for r in ranks
              if "layers.layer_0.embedding.weight" in r["params"]]
    assert len(tables) == 4 and all(t.shape == (ARCH["vocab_size"], ARCH["hidden_size"] // 2)
                                     for t in tables)


def test_params_from_jax_gives_each_rank_its_data_slice_at_stage3():
    from scaling_tpu_torch.topology import TopologyConfig

    from .test_torch_parity_helpers import draw_weights

    arch = TransformerConfig.from_dict(config([], Path("."), 1)).transformer_architecture
    _, _, np_params = draw_weights(ARCH, seed=5)
    topo = TopologyConfig.from_dict({"data_parallel_size": 2, "model_parallel_size": 2,
                                     "pipe_parallel_size": 1, "micro_batch_size": 1,
                                     "gradient_accumulation_steps": 1})
    sliced = 0
    for model_rank in range(2):
        whole = params_from_jax(np_params, arch, topology=topo, rank=model_rank)
        ranks = [{"params": {n: t.numpy() for n, t in params_from_jax(
            np_params, arch, topology=topo, rank=2 * d + model_rank,
            zero_stage3=True).items()}} for d in range(2)]
        for name, value in whole.items():
            np.testing.assert_array_equal(joined(ranks, name, value.numpy()), value.numpy(),
                                          err_msg=name)
            sliced += ranks[0]["params"][name].size < value.numel()
    assert sliced >= 8  # at least 4 leaves sliced on each model rank
