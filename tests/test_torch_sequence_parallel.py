"""Sequence parallelism in the port against the JAX package
(``test_training_sequence_parallel.py``'s contract: SP on trains as SP
off; ``test_tensor_parallel.py::test_sequence_parallel_parity``), on the
CPU, the ranks gloo processes of ``run_ranks``:

- ``ParallelSwiGLUMLP(sequence_parallel_output=True)`` at mp 2, each rank
  given its half of the sequence: the output's rows, put together, within
  atol 1e-5 of JAX's layer on one device and on a model-2 mesh with
  ``sequence_parallel``; the input's gradient rows and the parameters'
  gradients (the replicated ``down_proj`` bias's summed over the group, as
  the step sums a sequence-parallel leaf) against ``jax.grad`` on one device;
- the Trainer (``train.main``) of a toy rms/swiglu model (hidden 128, 2
  layers, 4/2 heads, vocab 96, seq 32, f32, untied, accumulation 2) at dp 2
  x mp 2 with ZeRO-3 and ``every_layer`` remat, mp 2 x cp 2 ring, mp 2 x
  cp 2 Ulysses, and pp 2 x mp 2 x 2 token slices, each with
  ``sequence_parallel``: 3 steps from the
  JAX trainer's initialisation, within rtol 1e-5 of JAX's Trainer at the
  same layout and of the port at the same layout without sequence
  parallelism; each rank's parameters after the steps within a relative
  1e-3 of their norm of the run without it (the bound and reason of
  ``test_torch_context_parallel_training.py``);
- dropout at every site at mp 2: the masks are the one-rank masks' slices
  at any layout (``nn.base_layer``), so sequence parallelism on and off
  draw the same masks: their losses within rtol 1e-5, and dropout acts
  (the losses differ from the runs without it);
- ``MESH.json`` of a sequence-parallel run names ``sequence_parallel``; a
  local sequence that the model group does not divide is refused by name.
"""

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from scaling_tpu.nn import ForwardContext, ParallelSwiGLUMLP as JaxSwiGLU  # noqa: E402
from scaling_tpu.ops.rms_norm import force_rms_interpret  # noqa: E402
from scaling_tpu.topology import Topology as JaxTopology  # noqa: E402
from scaling_tpu.topology import TopologyConfig as JaxTopologyConfig  # noqa: E402
from scaling_tpu_torch.models.transformer import TransformerConfig  # noqa: E402
from scaling_tpu_torch.resilience import read_mesh_meta  # noqa: E402

from .test_torch_checkpoint import jax_trainer  # noqa: E402
from .test_torch_context_parallel_training import ARCH  # noqa: E402
from .test_torch_dist_helpers import run_ranks, sp_swiglu_worker, train_worker  # noqa: E402
from .test_torch_parity_helpers import draw, module_state, one_torch_thread  # noqa: E402,F401
from .test_torch_pipeline_training import data  # noqa: E402,F401

STEPS = 3
# name -> topology keys (sequence_parallel added for the SP run), zero stage
LAYOUTS = {
    "dp2_mp2_zero3": ({"data_parallel_size": 2, "model_parallel_size": 2,
                       "activation_checkpointing_type": "every_layer"}, 3),
    "mp2_cp2_ring": ({"model_parallel_size": 2, "context_parallel_size": 2,
                      "context_parallel_variant": "ring"}, 0),
    "mp2_cp2_ulysses": ({"model_parallel_size": 2, "context_parallel_size": 2,
                         "context_parallel_variant": "ulysses"}, 0),
    "pp2_mp2_s2": ({"model_parallel_size": 2, "pipe_parallel_size": 2,
                    "pipe_token_slices": 2}, 0),
}
DROPOUT = {"dropout_embedding": 0.1, "dropout_after_attention": 0.1,
           "dropout_after_mlp": 0.1, "dropout_attention_probs": 0.1}
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
PARAM_RTOL = 1e-3


def config(data, root: Path, topo: dict, zero: int = 0, sp: bool = False, arch=None,
           load_dir=None) -> dict:
    t = {"model_parallel_size": 1, "pipe_parallel_size": 1, "data_parallel_size": 1,
         "context_parallel_size": 1, "gradient_accumulation_steps": 2, **topo,
         "sequence_parallel": sp}
    dp = t["data_parallel_size"]
    t.update(micro_batch_size=4 // dp, world_size=world(t))
    return {
        "topology": t,
        "transformer_architecture": arch or ARCH,
        "optimizer": {"gradient_clipping": 1.0, "zero": zero > 0, "zero_stage": max(zero, 1)},
        "learning_rate_scheduler": {"learning_rate": 0.01, "learning_rate_warmup_steps": 2,
                                    "learning_rate_decay_iters": 50},
        "trainer": {"train_iterations": STEPS, "seed": 42, "save_dir": str(root / "ckpt"),
                    "save_interval": STEPS,
                    "load_dir": None if load_dir is None else str(load_dir),
                    "assert_checkpoint_loaded": load_dir is not None,
                    "load_optimizer_states": load_dir is not None,
                    "delete_past_optimizer_states": False},
        "data": {"data_prefixes": data},
        "logger": {"log_dir": str(root / "logs")},
    }


def world(topo: dict) -> int:
    return (topo["model_parallel_size"] * topo["pipe_parallel_size"]
            * topo["data_parallel_size"] * topo["context_parallel_size"])


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    root = tmp_path_factory.mktemp("sp")
    with force_rms_interpret():
        jax_trainer(config(data, root / "seed", {}), load=False).save_checkpoint()
    step0 = root / "seed" / "ckpt" / "global_step0"
    jobs = {}
    for name, (topo, zero) in LAYOUTS.items():
        for sp in (True, False):
            jobs[(name, sp)] = config(data, root / f"{name}_{sp}", topo, zero, sp,
                                      load_dir=step0)
    for sp in (True, False):
        jobs[("dropout", sp)] = config(data, root / f"dropout_{sp}",
                                       {"model_parallel_size": 2}, 0, sp,
                                       dict(ARCH, **DROPOUT), step0)
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {key: pool.submit(run_ranks, train_worker, world(cfg["topology"]), cfg,
                                    timeout=240) for key, cfg in jobs.items()}
        jax_losses = {}
        with force_rms_interpret():
            for name, (topo, zero) in LAYOUTS.items():
                run = jax_trainer(config(data, root / f"jax_{name}", topo, zero, True,
                                         load_dir=step0), load=True)
                jax_losses[name] = [float(run.train_step().loss) for _ in range(STEPS)]
        port = {key: f.result() for key, f in futures.items()}
    return {"root": root, "jax": jax_losses, "port": port}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_sequence_parallel_losses_match_jax_and_sp_off(runs, name):
    off = runs["port"][(name, False)][0]["losses"]
    for rank in runs["port"][(name, True)]:  # every rank reports the global loss
        np.testing.assert_allclose(rank["losses"], runs["jax"][name], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
        np.testing.assert_allclose(rank["losses"], off, rtol=LOSS_RTOL, atol=LOSS_ATOL)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_sequence_parallel_parameters_match_sp_off(runs, name):
    for on, off in zip(runs["port"][(name, True)], runs["port"][(name, False)]):
        assert set(on["params"]) == set(off["params"])
        for n, p in on["params"].items():
            rel = np.linalg.norm(p - off["params"][n]) / np.linalg.norm(off["params"][n])
            assert rel <= PARAM_RTOL, (n, rel)


def test_dropout_under_sequence_parallelism_draws_the_masks_of_sp_off(runs):
    on, off = runs["port"][("dropout", True)], runs["port"][("dropout", False)]
    for rank in on:
        np.testing.assert_allclose(rank["losses"], off[0]["losses"], rtol=LOSS_RTOL, atol=0)
    plain = runs["jax"]["dp2_mp2_zero3"]
    assert all(abs(a - b) > 1e-3 for a, b in zip(on[0]["losses"], plain))  # dropout acts


def test_mesh_json_names_sequence_parallel(runs):
    meta = read_mesh_meta(runs["root"] / "dp2_mp2_zero3_True" / "ckpt" / f"global_step{STEPS}")
    assert meta["topology"]["sequence_parallel"] is True
    assert meta["optimizer"]["zero_stage"] == 3
    off = read_mesh_meta(runs["root"] / "dp2_mp2_zero3_False" / "ckpt" / f"global_step{STEPS}")
    assert "sequence_parallel" not in off["topology"]


def test_a_local_sequence_the_model_group_does_not_divide_is_refused(data, tmp_path):
    cfg = config(data, tmp_path, {"model_parallel_size": 2, "context_parallel_size": 2},
                 sp=True, arch=dict(ARCH, sequence_length=34))
    with pytest.raises(ValueError, match="sequence_parallel"):
        TransformerConfig.from_dict(cfg)
    # mp 1: sequence parallelism has no effect, as in JAX
    cfg = config(data, tmp_path, {"context_parallel_size": 2}, sp=True,
                 arch=dict(ARCH, sequence_length=34))
    assert not TransformerConfig.from_dict(cfg).topology.sequence_parallel


def test_swiglu_with_sequence_parallel_output_matches_jax():
    layer = JaxSwiGLU(32, intermediate_feature_factor=2.0, bias=True,
                      sequence_parallel_output=True)
    params = draw(layer, seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 8, 32)).astype(np.float32)
    g = rng.standard_normal((4, 8, 32)).astype(np.float32)
    plain = np.asarray(layer(params, jnp.asarray(x), ForwardContext()))
    topo = JaxTopology(JaxTopologyConfig(model_parallel_size=2, pipe_parallel_size=1,
                                         data_parallel_size=1, micro_batch_size=4,
                                         gradient_accumulation_steps=1))
    metas = layer.param_metas()
    placed = jax.tree.map(lambda p, m: jax.device_put(p, NamedSharding(topo.mesh, m.spec())),
                          params, metas, is_leaf=lambda v: hasattr(v, "partition_spec"))

    def fwd(p, xx):
        ctx = ForwardContext(mesh=topo.mesh, model_parallel_size=2, sequence_parallel=True)
        return layer(p, xx, ctx)

    mesh_sp = np.asarray(jax.jit(fwd)(placed, jax.device_put(
        jnp.asarray(x), NamedSharding(topo.mesh, P(None, None, None)))))
    grads, x_grad = jax.grad(
        lambda p, xx: (layer(p, xx, ForwardContext()) * g).sum(), argnums=(0, 1))(
        params, jnp.asarray(x))
    ranks = run_ranks(sp_swiglu_worker, 2, module_state(params), x, g, timeout=90)
    y = np.concatenate([r["y"] for r in ranks], axis=1)
    np.testing.assert_allclose(y, plain, atol=1e-5)
    np.testing.assert_allclose(y, mesh_sp, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([r["x_grad"] for r in ranks], axis=1),
                               np.asarray(x_grad), atol=1e-5)
    want = module_state(jax.tree.map(np.asarray, grads))
    for name, ref in want.items():
        parts = [r["grads"][name] for r in ranks]
        if name == "down_proj.bias":  # replicated, each rank's rows: summed
            got = parts[0] + parts[1]
        else:
            dims = [d for d in range(ref.ndim) if parts[0].shape[d] != ref.shape[d]]
            got = np.concatenate(parts, axis=dims[0]) if dims else parts[0]
        np.testing.assert_allclose(got, ref.numpy(), atol=1e-5, err_msg=name)
