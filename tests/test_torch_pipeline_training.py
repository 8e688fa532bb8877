"""The port's Trainer under pipeline parallelism against the JAX package's
Trainer at the same layout (``test_training_pipeline.py``'s contract), a
toy rms/swiglu model (hidden 128, 4 layers, 4/2 heads, vocab 96, seq 32,
f32, untied, accumulation 4) on the CPU, the ranks gloo processes of
``run_ranks`` that each run ``train.main``:

- the JAX trainer's initialisation is saved as a JAX checkpoint (step 0);
  JAX at pp 2, pp 2 x dp 2 (ZeRO-1, ``every_pipe_stage``), pp 2 x mp 2 and
  pp 2 x vpp 2 (``every_pipe_stage``) and the port at the same layouts
  (and pp 2 with ``every_pipe_stage``, vpp 2 without) load it and train 3
  steps; the port's losses are within rtol 1e-5, atol 1e-6 of JAX's (JAX's
  own pp 2 against pp 1 bound, ``test_training_pipeline.py:40``);
- the port's parameters after the 3 steps against the port's at the same
  data and model layout without a pipe (one rank, or dp 2 / mp 2 at pp 1),
  rank by rank: atol 1e-5 (PR 18's bound between runs of one reduction
  order: the pipe adds none, but a tied table, which this model lacks);
- checkpoints: the step-3 files of pp 2 and pp 2 x vpp 2 are byte-equal to
  one rank's, model and optimizer (the same arithmetic in the same order);
  the JAX trainer at pp 1 loads the port's pp 2 checkpoint with
  verification, equal to the arrays on disk; the port at pp 2 x vpp 2
  loads JAX's pp 2 step-3 checkpoint, each stage its layers equal to the
  files; ``MESH.json`` carries the pipe layout as JAX writes it.
"""

import filecmp
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from scaling_tpu.ops.rms_norm import force_rms_interpret  # noqa: E402
from scaling_tpu_torch.data import MemoryMapDatasetBuilder  # noqa: E402
from scaling_tpu_torch.models.transformer import TransformerConfig  # noqa: E402
from scaling_tpu_torch.checkpoint.checkpoint import _from_numpy  # noqa: E402
from scaling_tpu_torch.models.transformer.convert import params_from_jax  # noqa: E402
from scaling_tpu_torch.models.transformer.train import main  # noqa: E402
from scaling_tpu_torch.resilience import read_mesh_meta, verify_checkpoint  # noqa: E402

from .test_torch_checkpoint import jax_trainer  # noqa: E402
# the ranks' workers live in the JAX-free helper module: a spawned rank
# imports the module of the function it runs, and this one imports JAX
from .test_torch_dist_helpers import load_worker as _load_worker  # noqa: E402,F401
from .test_torch_dist_helpers import run_ranks, train_worker  # noqa: E402,F401
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401

ARCH = {
    "vocab_size": 96, "hidden_size": 128, "num_layers": 4, "num_attention_heads": 4,
    "attention_num_kv_heads": 2, "attention_qkv_in_one": False, "sequence_length": 32,
    "precision": "float32", "mlp_type": "swiglu", "mlp_factor": 2.0, "norm_type": "rms",
    "layernorm": {"optimization_type": "fused"}, "weight_tying": False,
}
STEPS = 3
# name -> (pp, dp, mp, vpp, activation checkpointing)
JAX_LAYOUTS = {
    "pp2": (2, 1, 1, 1, "disabled"),
    "pp2_dp2_zero": (2, 2, 1, 1, "every_pipe_stage"),
    "pp2_mp2": (2, 1, 2, 1, "disabled"),
    "pp2_vpp2": (2, 1, 1, 2, "every_pipe_stage"),
}
PORT_LAYOUTS = dict(JAX_LAYOUTS, pp2_every_pipe_stage=(2, 1, 1, 1, "every_pipe_stage"),
                    pp2_vpp2_no_remat=(2, 1, 1, 2, "disabled"))
SAME_AS = {"pp2_every_pipe_stage": "pp2", "pp2_vpp2_no_remat": "pp2_vpp2"}
# the same data x model layout at pp 1, run beside them
UNPIPED = {"dp2_zero": (1, 2, 1, 1, "every_pipe_stage"), "mp2": (1, 1, 2, 1, "disabled")}
REFERENCE = {"pp2_dp2_zero": "dp2_zero", "pp2_mp2": "mp2"}
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokens")
    rng = np.random.default_rng(23)
    prefixes = []
    for name, docs in (("a", 60), ("b", 30)):
        with MemoryMapDatasetBuilder(root / name, dtype=np.uint16) as builder:
            for _ in range(docs):
                builder.add(np.append(rng.integers(1, 96, size=rng.integers(8, 80)), 0))
        prefixes.append(str(root / name))
    return prefixes


def config(data, root: Path, layout: tuple, load_dir=None) -> dict:
    pp, dp, mp, vpp, remat = layout
    return {
        "topology": {"model_parallel_size": mp, "pipe_parallel_size": pp,
                     "data_parallel_size": dp, "pipe_virtual_size": vpp,
                     "micro_batch_size": 4 // dp, "gradient_accumulation_steps": 4,
                     "activation_checkpointing_type": remat},
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
        "logger": {"log_dir": str(root / "logs"), "events_path": str(root / "events.jsonl")},
    }


def stored(step_dir: Path) -> dict:
    """The checkpoint's model arrays by port name, in the port's layout."""
    from scaling_tpu_torch.models.transformer.model import TransformerModel
    from scaling_tpu_torch.parallel import ParallelModule

    arch = TransformerConfig.from_dict(config([], step_dir, (1, 1, 1, 1, "disabled"))
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
    return layout[0] * layout[1] * layout[2]


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    root = tmp_path_factory.mktemp("pipe")
    one = (1, 1, 1, 1, "disabled")
    with force_rms_interpret():
        seed_run = jax_trainer(config(data, root / "seed", one), load=False)
        seed_run.save_checkpoint()
    step0 = root / "seed" / "ckpt" / "global_step0"
    # the port's layouts run in processes of their own while JAX trains here
    with ThreadPoolExecutor(len(PORT_LAYOUTS) + len(UNPIPED)) as pool:
        futures = {name: pool.submit(run_ranks, train_worker, world(layout),
                                     config(data, root / name, layout, step0), timeout=240)
                   for name, layout in {**PORT_LAYOUTS, **UNPIPED}.items()}
        jax_losses = {}
        with force_rms_interpret():
            for name, layout in JAX_LAYOUTS.items():
                run = jax_trainer(config(data, root / f"jax_{name}", layout, step0), load=True)
                jax_losses[name] = [float(run.train_step().loss) for _ in range(STEPS)]
                if name == "pp2":
                    run.save_checkpoint()
        port = {name: f.result() for name, f in futures.items()}
    one_run = main(TransformerConfig.from_dict(config(data, root / "one", one, step0)),
                   device="cpu")
    port["one"] = [{"params": {n: p.detach().numpy()
                               for n, p in one_run.module.model.named_parameters()}}]
    return {"root": root, "jax": jax_losses, "port": port, "step0": step0}


@pytest.mark.parametrize("name", list(PORT_LAYOUTS))
def test_port_losses_match_jax_at_the_same_layout(runs, name):
    want = runs["jax"][SAME_AS.get(name, name)]
    for rank in runs["port"][name]:  # every rank reports the last stage's global loss
        np.testing.assert_allclose(rank["losses"], want, rtol=LOSS_RTOL, atol=LOSS_ATOL)


@pytest.mark.parametrize("name", list(PORT_LAYOUTS))
def test_port_parameters_match_the_unpiped_layout(runs, name):
    pp, dp, mp, vpp, _ = PORT_LAYOUTS[name]
    ref = runs["port"][REFERENCE.get(name, "one")]
    seen = set()
    for r, rank in enumerate(runs["port"][name]):
        want = ref[((r // mp) % dp) * mp + r % mp]["params"]  # its data and model rank's
        for n, p in rank["params"].items():
            np.testing.assert_allclose(p, want[n], rtol=1e-5, atol=1e-5, err_msg=n)
            seen.add(n)
    assert seen == set(ref[0]["params"]), "a layer is on no stage"


@pytest.mark.parametrize("name", ["pp2", "pp2_vpp2", "pp2_every_pipe_stage"])
def test_checkpoint_files_are_byte_equal_to_one_rank(runs, name):
    one = runs["root"] / "one" / "ckpt" / f"global_step{STEPS}"
    other = runs["root"] / name / "ckpt" / f"global_step{STEPS}"
    files = sorted(f.name for f in one.glob("*.npz"))
    assert len(files) == 2 * (ARCH["num_layers"] + 3)
    assert sorted(f.name for f in other.glob("*.npz")) == files
    for f in files:
        assert filecmp.cmp(one / f, other / f, shallow=False), f
    assert verify_checkpoint(other) == []
    topo = read_mesh_meta(other)["topology"]
    layout = PORT_LAYOUTS[name]
    assert (topo["pipe_parallel_size"], topo["pipe_virtual_size"], topo["world_size"]) == (
        layout[0], layout[3], world(layout))
    jax_topo = read_mesh_meta(runs["root"] / "jax_pp2" / "ckpt" / f"global_step{STEPS}")
    assert set(jax_topo["topology"]) == set(topo)
    assert jax_topo["params"] == read_mesh_meta(other)["params"]


def test_jax_at_one_stage_loads_the_port_pp2_checkpoint(runs, data):
    step = runs["root"] / "pp2" / "ckpt" / f"global_step{STEPS}"
    cfg = config(data, runs["root"] / "jax_reload", (1, 1, 1, 1, "disabled"), step)
    with force_rms_interpret():
        ref = jax_trainer(cfg, load=True)
    assert ref.context.iterations == STEPS and ref.optimizer_states_loaded
    arch = TransformerConfig.from_dict(cfg).transformer_architecture
    loaded = params_from_jax(jax.tree.map(np.asarray, ref.params), arch)
    files = stored(step)
    assert set(files) == set(loaded)
    for name, value in files.items():
        np.testing.assert_array_equal(loaded[name].numpy(), value, err_msg=name)


def test_the_port_at_vpp2_loads_jax_pp2_checkpoint(runs, data):
    step = runs["root"] / "jax_pp2" / "ckpt" / f"global_step{STEPS}"
    assert read_mesh_meta(step)["topology"]["pipe_parallel_size"] == 2
    cfg = config(data, runs["root"] / "vpp2_reload", PORT_LAYOUTS["pp2_vpp2"], step)
    out = run_ranks(_load_worker, 2, cfg, timeout=120)
    files = stored(step)
    held = {}
    for rank in out:
        assert rank["iterations"] == STEPS
        for name, value in rank["params"].items():
            np.testing.assert_array_equal(value, files[name], err_msg=name)
            held[name] = rank
    assert set(held) == set(files)
    # the stages hold the round-robin chunks: stage 0 layers 1 and 3, stage 1 layers 2 and 4
    assert {n.split(".")[1] for n in out[0]["params"]} == {"layer_0", "layer_1", "layer_3"}
    assert {n.split(".")[1] for n in out[1]["params"]} == {"layer_2", "layer_4", "layer_5",
                                                           "layer_6"}


def test_the_run_logs_the_pipeline_config_that_obs_report_reads(runs):
    from scaling_tpu_torch.obs.report import load_run_dir, pipeline_section

    run_dir = runs["root"] / "pp2_vpp2"
    events = [json.loads(x) for x in (run_dir / "events.jsonl").read_text().splitlines()]
    config_events = [e for e in events if e["event"] == "pipeline-config"]
    assert config_events and {(e["pp"], e["virtual"], e["token_slices"], e["gas"])
                              for e in config_events} == {(2, 2, 1, 4)}
    section = "\n".join(pipeline_section(load_run_dir(run_dir)))
    assert "schedule: interleaved(v=2) pp=2 gas=4" in section
    log = run_dir / "logs"
    recs = [json.loads(x) for x in (log / "metrics_rank_0.jsonl").read_text().splitlines()]
    steps = [r for r in recs if r.get("kind") == "step"]
    assert [r["step"] for r in steps] == list(range(1, STEPS + 1))
    assert sorted(p.name for p in log.glob("metrics_rank_*")) == ["metrics_rank_0.jsonl"]
    assert torch.tensor([r["metrics"]["loss"] for r in steps]).isfinite().all()
