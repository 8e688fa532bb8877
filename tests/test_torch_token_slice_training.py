"""The port's Trainer under pipeline token slices (TeraPipe) against the JAX
package's Trainer at the same layout (``test_training_pipeline.py``'s
``test_token_slice_loss_close_to_pp1`` contract), on
``test_torch_pipeline_training``'s toy model and packed documents (hidden
128, 4 layers, 4/2 heads, vocab 96, seq 32, f32, untied, accumulation 4),
the ranks gloo processes of ``run_ranks`` that each run ``train.main``:

- JAX and the port at pp 2 x S 2, pp 2 x S 2 x dp 2 (ZeRO-1,
  ``every_pipe_stage``: the stage's remat region gives back the slice's
  K/V) and pp 2 x S 4 x mp 2 load one JAX initialisation and train 3 steps;
  the port's losses are within rtol 1e-5, atol 1e-6 of JAX's;
- the port's parameters against the port's at the same data and model
  layout without a pipe (one rank, dp 2, mp 2), rank by rank: each leaf
  within 1e-3 of its norm (the slices reorder the sums over the attention's
  keys and the weights' gradients; Adam amplifies that where a gradient is
  near its epsilon, ``test_torch_context_parallel_training``);
- rank 0 writes the files one rank writes of the state (a one-rank Trainer
  loads pp 2 x S 2's step-3 checkpoint and saves again: byte-equal);
  ``MESH.json`` carries ``pipe_token_slices`` as JAX writes it; the
  ``pipeline-config`` event carries the slices, and ``obs report``'s
  pipeline section prices the token-slice schedule.
"""

import filecmp
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from scaling_tpu.ops.rms_norm import force_rms_interpret  # noqa: E402
from scaling_tpu_torch.models.transformer import TransformerConfig  # noqa: E402
from scaling_tpu_torch.resilience import read_mesh_meta, verify_checkpoint  # noqa: E402

from .test_torch_checkpoint import jax_trainer  # noqa: E402
from .test_torch_dist_helpers import run_ranks  # noqa: E402
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401
from .test_torch_pipeline_training import ARCH, STEPS, data, train_worker  # noqa: E402,F401
from .test_torch_pipeline_training import config as pipe_config  # noqa: E402

# name -> (pp, dp, mp, token slices, activation checkpointing)
LAYOUTS = {
    "pp2_ts2": (2, 1, 1, 2, "disabled"),
    "pp2_ts2_dp2_zero": (2, 2, 1, 2, "every_pipe_stage"),
    "pp2_ts4_mp2": (2, 1, 2, 4, "disabled"),
}
UNPIPED = {"one": (1, 1, 1, 1, "disabled"), "dp2_zero": (1, 2, 1, 1, "every_pipe_stage"),
           "mp2": (1, 1, 2, 1, "disabled")}
REFERENCE = {"pp2_ts2_dp2_zero": "dp2_zero", "pp2_ts4_mp2": "mp2"}
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
PARAM_RTOL = 1e-3


def config(data, root: Path, layout: tuple, load_dir=None) -> dict:
    pp, dp, mp, ts, remat = layout
    cfg = pipe_config(data, root, (pp, dp, mp, 1, remat), load_dir)
    cfg["topology"]["pipe_token_slices"] = ts
    return cfg


def world(layout: tuple) -> int:
    return layout[0] * layout[1] * layout[2]


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    root = tmp_path_factory.mktemp("ts")
    with force_rms_interpret():
        seed_run = jax_trainer(config(data, root / "seed", UNPIPED["one"]), load=False)
        seed_run.save_checkpoint()
    step0 = root / "seed" / "ckpt" / "global_step0"
    with ThreadPoolExecutor(len(LAYOUTS) + len(UNPIPED)) as pool:
        futures = {name: pool.submit(run_ranks, train_worker, world(layout),
                                     config(data, root / name, layout, step0), timeout=240)
                   for name, layout in {**LAYOUTS, **UNPIPED}.items()}
        jax_losses = {}
        with force_rms_interpret():
            for name, layout in LAYOUTS.items():
                run = jax_trainer(config(data, root / f"jax_{name}", layout, step0), load=True)
                jax_losses[name] = [float(run.train_step().loss) for _ in range(STEPS)]
                if name == "pp2_ts2":
                    run.save_checkpoint()
        port = {name: f.result() for name, f in futures.items()}
    return {"root": root, "jax": jax_losses, "port": port}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_port_losses_match_jax_at_the_same_layout(runs, name):
    for rank in runs["port"][name]:  # every rank reports the last stage's global loss
        np.testing.assert_allclose(rank["losses"], runs["jax"][name], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_port_parameters_match_the_unpiped_layout(runs, name):
    pp, dp, mp, _, _ = LAYOUTS[name]
    ref = runs["port"][REFERENCE.get(name, "one")]
    seen = set()
    for r, rank in enumerate(runs["port"][name]):
        want = ref[((r // mp) % dp) * mp + r % mp]["params"]  # its data and model rank's
        for n, p in rank["params"].items():
            rel = np.linalg.norm(p - want[n]) / np.linalg.norm(want[n])
            assert rel <= PARAM_RTOL, (n, rel)
            seen.add(n)
    assert seen == set(ref[0]["params"]), "a layer is on no stage"


def _resave_worker(rank: int, world_size: int, cfg: dict) -> dict:
    from scaling_tpu_torch.models.transformer.train import build_trainer

    trainer = build_trainer(TransformerConfig.from_dict(cfg), device="cpu")
    return {"dir": str(trainer.save_checkpoint())}


def test_checkpoint_files_are_the_files_one_rank_writes(runs, data):
    step = runs["root"] / "pp2_ts2" / "ckpt" / f"global_step{STEPS}"
    assert verify_checkpoint(step) == []
    cfg = config(data, runs["root"] / "resave", UNPIPED["one"], step)
    again = Path(run_ranks(_resave_worker, 1, cfg, timeout=120)[0]["dir"])
    files = sorted(f.name for f in step.glob("*.npz"))
    assert len(files) == 2 * (ARCH["num_layers"] + 3)
    assert sorted(f.name for f in again.glob("*.npz")) == files
    for f in files:
        assert filecmp.cmp(step / f, again / f, shallow=False), f
    topo = read_mesh_meta(step)["topology"]
    assert (topo["pipe_parallel_size"], topo["pipe_token_slices"]) == (2, 2)
    jax_meta = read_mesh_meta(runs["root"] / "jax_pp2_ts2" / "ckpt" / f"global_step{STEPS}")
    assert jax_meta["topology"]["pipe_token_slices"] == 2
    assert set(jax_meta["topology"]) == set(topo)
    assert jax_meta["params"] == read_mesh_meta(step)["params"]


def test_the_run_logs_the_token_slices_that_obs_report_reads(runs):
    from scaling_tpu_torch.obs.report import load_run_dir, pipeline_section

    run_dir = runs["root"] / "pp2_ts2"
    events = [json.loads(x) for x in (run_dir / "events.jsonl").read_text().splitlines()]
    config_events = [e for e in events if e["event"] == "pipeline-config"]
    assert config_events and {(e["pp"], e["virtual"], e["token_slices"], e["gas"])
                              for e in config_events} == {(2, 1, 2, 4)}
    section = "\n".join(pipeline_section(load_run_dir(run_dir)))
    assert "schedule: token-slice(S=2) pp=2 gas=4" in section

