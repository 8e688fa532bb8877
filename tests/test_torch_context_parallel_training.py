"""The port's Trainer under context parallelism against the JAX package's
Trainer at the same layout (``test_training_context_parallel.py``'s
contract), a toy rms/swiglu model (hidden 128, 2 layers, 4/2 heads, vocab
96, seq 32, f32, untied, accumulation 2) on the CPU, the ranks gloo
processes of ``run_ranks`` that each run ``train.main``:

- the JAX trainer's initialisation is saved as a JAX checkpoint (step 0);
  JAX and the port at cp 2 ring, cp 2 Ulysses, cp 2 x dp 2 ring with
  ZeRO-1, cp 2 x mp 2 Ulysses (the kv heads repeated as far as mp x cp
  needs: 2 kv heads become 4), cp 4 ring and cp 4 Ulysses load it and train
  3 steps; the port's losses are within rtol 1e-5, atol 1e-6 of JAX's (the
  bound of the pipeline's parity tests);
- the port's parameters after the 3 steps against the port's at the same
  data and model layout without context parallelism (one rank, dp 2, mp
  2), rank by rank: each leaf's difference within 1e-3 of its norm
  (``PARAM_RTOL``; measured at most 4.9e-4, a zero-initialised query bias,
  whose norm after 3 steps is small). The sums over the context group
  reorder the f32 arithmetic (a step's gradients agree within 3e-6 of their
  largest element: ``test_torch_ring_attention.py``'s toy step), and Adam's
  update of an element whose gradient is near its epsilon (1e-8) turns that
  into up to 6.7e-4 on single elements after 3 steps at learning rate 0.01
  (measured), so an element-wise bound would read Adam's epsilon, not the
  port (PR 18's data-parallel test meets the same effect with 5e-5). A
  wrong context step moves whole leaves by the learning rate;
- checkpoints: rank 0 writes the replicated leaves, so the step-3 files of
  cp 2 ring are the files one rank writes of that state (a one-rank
  Trainer loads them and saves again: byte-equal, model and optimizer);
  the JAX trainer at cp 1 loads the port's cp 2 checkpoint with
  verification, equal to the arrays on disk; the port at cp 2 loads JAX's
  cp 2 step-3 checkpoint, every rank equal to the files; ``MESH.json``
  carries ``context_parallel_size`` as JAX writes it.
"""

import filecmp
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from scaling_tpu.ops.rms_norm import force_rms_interpret  # noqa: E402
from scaling_tpu_torch.models.transformer import TransformerConfig  # noqa: E402
from scaling_tpu_torch.models.transformer.convert import params_from_jax  # noqa: E402
from scaling_tpu_torch.models.transformer.train import main  # noqa: E402
from scaling_tpu_torch.resilience import read_mesh_meta, verify_checkpoint  # noqa: E402

from .test_torch_checkpoint import jax_trainer  # noqa: E402
from .test_torch_dist_helpers import run_ranks  # noqa: E402
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401
from .test_torch_pipeline_training import _load_worker, data, train_worker  # noqa: E402,F401

ARCH = {
    "vocab_size": 96, "hidden_size": 128, "num_layers": 2, "num_attention_heads": 4,
    "attention_num_kv_heads": 2, "attention_qkv_in_one": False, "sequence_length": 32,
    "precision": "float32", "mlp_type": "swiglu", "mlp_factor": 2.0, "norm_type": "rms",
    "layernorm": {"optimization_type": "fused"}, "weight_tying": False,
}
STEPS = 3
# name -> (cp, variant, dp, mp)
LAYOUTS = {
    "cp2_ring": (2, "ring", 1, 1),
    "cp2_ulysses": (2, "ulysses", 1, 1),
    "cp2_dp2_zero": (2, "ring", 2, 1),
    "cp2_mp2_ulysses": (2, "ulysses", 1, 2),
    "cp4_ring": (4, "ring", 1, 1),
    "cp4_ulysses": (4, "ulysses", 1, 1),
}
# the same data x model layout without context parallelism
UNSPLIT = {"dp2_zero": (1, "ring", 2, 1), "mp2": (1, "ring", 1, 2)}
REFERENCE = {"cp2_dp2_zero": "dp2_zero", "cp2_mp2_ulysses": "mp2"}
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
PARAM_RTOL = 1e-3


def config(data, root: Path, layout: tuple, load_dir=None) -> dict:
    cp, variant, dp, mp = layout
    return {
        "topology": {"model_parallel_size": mp, "pipe_parallel_size": 1,
                     "data_parallel_size": dp, "context_parallel_size": cp,
                     "context_parallel_variant": variant, "world_size": cp * dp * mp,
                     "micro_batch_size": 4 // dp, "gradient_accumulation_steps": 2},
        "transformer_architecture": ARCH,
        "optimizer": {"gradient_clipping": 1.0, "zero": dp > 1},
        "learning_rate_scheduler": {"learning_rate": 0.01, "learning_rate_warmup_steps": 2,
                                    "learning_rate_decay_iters": 50},
        "trainer": {"train_iterations": STEPS, "seed": 42, "save_dir": str(root / "ckpt"),
                    "save_interval": STEPS, "load_dir": None if load_dir is None else str(load_dir),
                    "assert_checkpoint_loaded": load_dir is not None,
                    "load_optimizer_states": load_dir is not None,
                    "delete_past_optimizer_states": False},
        "data": {"data_prefixes": data},
        "logger": {"log_dir": str(root / "logs")},
    }


def stored(step_dir: Path) -> dict:
    """The checkpoint's model arrays by port name, in the port's layout."""
    from scaling_tpu_torch.checkpoint.checkpoint import _from_numpy
    from scaling_tpu_torch.models.transformer.model import TransformerModel
    from scaling_tpu_torch.parallel import ParallelModule

    arch = TransformerConfig.from_dict(config([], step_dir, (1, "ring", 1, 1))
                                       ).transformer_architecture
    names = {k: n for n, k in ParallelModule(TransformerModel(arch, device="meta"),
                                             None).ckpt_keys().items()}
    out = {}
    for f in step_dir.glob("model_state_layer_*.npz"):
        index, cls = f.stem[len("model_state_layer_"):].split("_", 1)
        with np.load(f) as z:
            for member in z.files:
                key = f"layer_{index}_{cls}.{member}"
                out[names[key]] = _from_numpy(key, z[member]).numpy()
    return out


def world(layout: tuple) -> int:
    return layout[0] * layout[2] * layout[3]


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    root = tmp_path_factory.mktemp("cp")
    one = (1, "ring", 1, 1)
    with force_rms_interpret():
        seed_run = jax_trainer(config(data, root / "seed", one), load=False)
        seed_run.save_checkpoint()
    step0 = root / "seed" / "ckpt" / "global_step0"
    # the port's layouts run in processes of their own while JAX trains here
    with ThreadPoolExecutor(len(LAYOUTS) + len(UNSPLIT)) as pool:
        futures = {name: pool.submit(run_ranks, train_worker, world(layout),
                                     config(data, root / name, layout, step0), timeout=240)
                   for name, layout in {**LAYOUTS, **UNSPLIT}.items()}
        jax_losses = {}
        with force_rms_interpret():
            for name, layout in LAYOUTS.items():
                run = jax_trainer(config(data, root / f"jax_{name}", layout, step0), load=True)
                jax_losses[name] = [float(run.train_step().loss) for _ in range(STEPS)]
                if name == "cp2_ring":
                    run.save_checkpoint()
        port = {name: f.result() for name, f in futures.items()}
    one_run = main(TransformerConfig.from_dict(config(data, root / "one", one, step0)),
                   device="cpu")
    port["one"] = [{"params": {n: p.detach().numpy()
                               for n, p in one_run.module.model.named_parameters()}}]
    return {"root": root, "jax": jax_losses, "port": port, "step0": step0}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_port_losses_match_jax_at_the_same_layout(runs, name):
    for rank in runs["port"][name]:  # every rank reports the global loss
        np.testing.assert_allclose(rank["losses"], runs["jax"][name], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_port_parameters_match_the_layout_without_context_parallelism(runs, name):
    cp, _, dp, mp = LAYOUTS[name]
    ref = runs["port"][REFERENCE.get(name, "one")]
    for r, rank in enumerate(runs["port"][name]):
        d, m = (r // (cp * mp)) % dp, r % mp  # its data and model rank
        want = ref[d * mp + m]["params"]
        assert set(rank["params"]) == set(want)
        for n, p in rank["params"].items():
            rel = np.linalg.norm(p - want[n]) / np.linalg.norm(want[n])
            assert rel <= PARAM_RTOL, (n, rel)


def _resave_worker(rank: int, world_size: int, cfg: dict) -> dict:
    from scaling_tpu_torch.models.transformer.train import build_trainer

    trainer = build_trainer(TransformerConfig.from_dict(cfg), device="cpu")
    return {"dir": str(trainer.save_checkpoint())}


def test_checkpoint_files_are_the_files_one_rank_writes(runs, data):
    step = runs["root"] / "cp2_ring" / "ckpt" / f"global_step{STEPS}"
    assert verify_checkpoint(step) == []
    cfg = config(data, runs["root"] / "resave", (1, "ring", 1, 1), step)
    again = Path(run_ranks(_resave_worker, 1, cfg, timeout=120)[0]["dir"])
    files = sorted(f.name for f in step.glob("*.npz"))
    assert len(files) == 2 * (ARCH["num_layers"] + 3)
    assert sorted(f.name for f in again.glob("*.npz")) == files
    for f in files:
        assert filecmp.cmp(step / f, again / f, shallow=False), f
    topo = read_mesh_meta(step)["topology"]
    assert (topo["context_parallel_size"], topo["world_size"]) == (2, 2)
    jax_meta = read_mesh_meta(runs["root"] / "jax_cp2_ring" / "ckpt" / f"global_step{STEPS}")
    assert set(jax_meta["topology"]) == set(topo)
    assert {k: jax_meta["topology"][k] for k in ("context_parallel_size", "world_size",
                                                 "pipe_token_slices")} == {
        k: topo[k] for k in ("context_parallel_size", "world_size", "pipe_token_slices")}
    assert jax_meta["params"] == read_mesh_meta(step)["params"]


def test_jax_at_cp1_loads_the_port_cp2_checkpoint(runs, data):
    step = runs["root"] / "cp2_ring" / "ckpt" / f"global_step{STEPS}"
    cfg = config(data, runs["root"] / "jax_reload", (1, "ring", 1, 1), step)
    with force_rms_interpret():
        ref = jax_trainer(cfg, load=True)
    assert ref.context.iterations == STEPS and ref.optimizer_states_loaded
    arch = TransformerConfig.from_dict(cfg).transformer_architecture
    loaded = params_from_jax(jax.tree.map(np.asarray, ref.params), arch)
    files = stored(step)
    assert set(files) == set(loaded)
    for name, value in files.items():
        np.testing.assert_array_equal(loaded[name].numpy(), value, err_msg=name)


def test_the_port_at_cp2_loads_jax_cp2_checkpoint(runs, data):
    step = runs["root"] / "jax_cp2_ring" / "ckpt" / f"global_step{STEPS}"
    assert read_mesh_meta(step)["topology"]["context_parallel_size"] == 2
    cfg = config(data, runs["root"] / "cp2_reload", LAYOUTS["cp2_ulysses"], step)
    out = run_ranks(_load_worker, 2, cfg, timeout=120)
    files = stored(step)
    for rank in out:
        assert rank["iterations"] == STEPS
        assert set(rank["params"]) == set(files)
        for name, value in rank["params"].items():
            np.testing.assert_array_equal(value, files[name], err_msg=name)
