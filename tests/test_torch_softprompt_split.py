"""A soft prompt where the sequence is split: the JAX embedding writes the
prompt over the first ``n_tokens`` slots of the whole sequence once
(scaling_tpu/models/transformer/layers/embedding.py); the port embeds a
context rank's slice, a pipeline's token slice, or under sequence
parallelism a model rank's shard of either, and writes the prompt only at
the rows whose absolute slot is below ``n_tokens``. A toy rms/swiglu model
(hidden 128, 2 layers, 4/2 heads, vocab 96, seq 32, f32, untied,
accumulation 2) with a soft prompt of 3 tokens trains 3 steps through
``train.main`` from the JAX trainer's initialisation at cp 2 ring, cp 2
Ulysses, pp 2 x 2 token slices and mp 2 with ``sequence_parallel``: the
losses within rtol 1e-5 of the port's one-rank run and of JAX's Trainer at
the same layout, and the trained prompt within 1e-3 of its norm of the
one-rank run's (the bound of ``test_torch_context_parallel_training.py``).
Before the rule, every slice wrote the prompt at its own start (a loss of
5.2649 against one rank's 5.2247 in a probe at cp 2).
"""

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from scaling_tpu.ops.rms_norm import force_rms_interpret  # noqa: E402

from .test_torch_checkpoint import jax_trainer  # noqa: E402
from .test_torch_context_parallel_training import ARCH as BASE  # noqa: E402
from .test_torch_dist_helpers import run_ranks, train_worker  # noqa: E402
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401
from .test_torch_pipeline_training import data  # noqa: E402,F401

ARCH = dict(BASE, softprompt_config={"name": "sp", "n_tokens": 3})
PROMPT = "layers.layer_0.softprompt_sp"
STEPS = 3
LAYOUTS = {  # name -> topology keys
    "cp2_ring": {"context_parallel_size": 2, "context_parallel_variant": "ring"},
    "cp2_ulysses": {"context_parallel_size": 2, "context_parallel_variant": "ulysses"},
    "pp2_s2": {"pipe_parallel_size": 2, "pipe_token_slices": 2},
    "mp2_sp": {"model_parallel_size": 2, "sequence_parallel": True},
}
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6


def config(data, root: Path, topo: dict, load_dir=None) -> dict:
    t = {"model_parallel_size": 1, "pipe_parallel_size": 1, "data_parallel_size": 1,
         "context_parallel_size": 1, "micro_batch_size": 4, "gradient_accumulation_steps": 2,
         **topo}
    t["world_size"] = (t["model_parallel_size"] * t["pipe_parallel_size"]
                       * t["context_parallel_size"])
    return {
        "topology": t,
        "transformer_architecture": ARCH,
        "optimizer": {"gradient_clipping": 1.0},
        "learning_rate_scheduler": {"learning_rate": 0.01, "learning_rate_warmup_steps": 2,
                                    "learning_rate_decay_iters": 50},
        "trainer": {"train_iterations": STEPS, "seed": 42, "save_dir": str(root / "ckpt"),
                    "save_interval": 100,
                    "load_dir": None if load_dir is None else str(load_dir),
                    "assert_checkpoint_loaded": load_dir is not None,
                    "load_optimizer_states": load_dir is not None},
        "data": {"data_prefixes": data},
        "logger": {"log_dir": str(root / "logs")},
    }


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    root = tmp_path_factory.mktemp("softprompt")
    with force_rms_interpret():
        jax_trainer(config(data, root / "seed", {}), load=False).save_checkpoint()
    step0 = root / "seed" / "ckpt" / "global_step0"
    jobs = {name: config(data, root / name, topo, step0) for name, topo in LAYOUTS.items()}
    jobs["one"] = config(data, root / "one", {}, step0)
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(run_ranks, train_worker, cfg["topology"]["world_size"],
                                     cfg, timeout=240) for name, cfg in jobs.items()}
        jax_losses = {}
        with force_rms_interpret():
            for name, topo in LAYOUTS.items():
                run = jax_trainer(config(data, root / f"jax_{name}", topo, step0), load=True)
                jax_losses[name] = [float(run.train_step().loss) for _ in range(STEPS)]
        port = {name: f.result() for name, f in futures.items()}
    return {"jax": jax_losses, "port": port}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_soft_prompt_losses_match_one_rank_and_jax(runs, name):
    one = runs["port"]["one"][0]["losses"]
    for rank in runs["port"][name]:
        np.testing.assert_allclose(rank["losses"], one, rtol=LOSS_RTOL, atol=LOSS_ATOL)
        np.testing.assert_allclose(rank["losses"], runs["jax"][name], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_the_trained_prompt_matches_one_rank(runs, name):
    want = runs["port"]["one"][0]["params"][PROMPT]
    held = [rank["params"][PROMPT] for rank in runs["port"][name] if PROMPT in rank["params"]]
    assert held  # the first stage (every rank off the pipe) holds the prompt
    for p in held:
        assert np.linalg.norm(p - want) / np.linalg.norm(want) <= 1e-3
