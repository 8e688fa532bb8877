"""Data parallelism and ZeRO-1 of the port on the CPU (JAX's
``test_zero_matches_nonzero_losses``, rtol 1e-5): a toy model trained 5
steps with gradient accumulation 2 by one rank on the global batch, by 2
data ranks, by 2 data ranks with ZeRO-1 and by dp 2 x mp 2 with ZeRO-1,
the loss weights of one data rank's rows mostly zero (a mean of the ranks'
means would differ from the global mean there): equal losses and global
clipping norms, each step clipped (the norm is above the clip), and equal
final parameters (atol 1e-5 between the data-parallel runs, 5e-5 against
one rank: Adam's update of an element whose gradient is near zero turns
reduction-order error into up to ~1e-5 after 5 steps). Under ZeRO a rank keeps the f32 masters of its data
slice of each leaf (the last dim JAX's ``spec_with_data_axis`` picks) and
no other."""

import numpy as np
import pytest
import torch

from .test_torch_dist_helpers import TOY_ARCH, run_ranks, step_worker, topology
from .test_torch_parity_helpers import one_torch_thread  # noqa: F401

GAS, MBS, STEPS, SEQ = 2, 4, 5, 16


def _config(dp: int, mp: int, zero: bool) -> dict:
    return {
        "topology": {"model_parallel_size": mp, "pipe_parallel_size": 1,
                     "data_parallel_size": dp, "micro_batch_size": MBS // dp,
                     "gradient_accumulation_steps": GAS},
        "transformer_architecture": dict(TOY_ARCH, precision="float32",
                                         sequence_length=SEQ),
        "optimizer": {"gradient_clipping": 0.5, "zero": zero},
        "learning_rate_scheduler": {"learning_rate": 0.01, "learning_rate_warmup_steps": 1,
                                    "learning_rate_decay_iters": 50},
        "training": {"weight_decay": 0.1},
        "trainer": {"seed": 3},
    }


def _batches() -> list:
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        tokens = rng.integers(1, TOY_ARCH["vocab_size"], size=(GAS, MBS, SEQ + 1))
        weights = np.ones((GAS, MBS, SEQ), np.float32)
        weights[:, :MBS // 2] = rng.random((GAS, MBS // 2, SEQ)) < 0.2  # data rank 0's rows
        out.append({"token_ids": tokens[..., :-1].astype(np.int32),
                    "target_token_ids": tokens[..., 1:].astype(np.int64),
                    "loss_weights": weights,
                    "position_ids": np.broadcast_to(np.arange(SEQ, dtype=np.int32),
                                                    (GAS, MBS, SEQ)).copy(),
                    "segment_ids": np.zeros((GAS, MBS, SEQ), np.int32)})
    return out


@pytest.fixture(scope="module")
def runs():
    batches = _batches()
    return {
        "one": run_ranks(step_worker, 1, 1, 1, _config(1, 1, False), batches)[0],
        "dp2": run_ranks(step_worker, 2, 1, 2, _config(2, 1, False), batches),
        "dp2_zero": run_ranks(step_worker, 2, 1, 2, _config(2, 1, True), batches),
        "dp2_mp2_zero": run_ranks(step_worker, 4, 2, 2, _config(2, 2, True), batches),
    }


@pytest.mark.parametrize("layout", ["dp2", "dp2_zero", "dp2_mp2_zero"])
def test_losses_and_clip_norms_equal_one_rank(runs, layout):
    one = runs["one"]
    assert min(one["norms"]) > 0.5  # every step clipped
    for rank in runs[layout]:
        np.testing.assert_allclose(rank["losses"], one["losses"], rtol=1e-5)
        np.testing.assert_allclose(rank["norms"], one["norms"], rtol=1e-5)


def test_zero_matches_nonzero_losses_and_parameters(runs):
    for a, b in zip(runs["dp2"], runs["dp2_zero"]):
        np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-5)
        for name, p in a["params"].items():
            np.testing.assert_allclose(b["params"][name], p, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
    for name, p in runs["one"]["params"].items():
        np.testing.assert_allclose(runs["dp2_zero"][1]["params"][name], p, rtol=1e-5,
                                   atol=5e-5, err_msg=name)


def test_zero_keeps_the_data_slice_of_each_master(runs):
    whole = runs["dp2"][0]["masters"]
    for r, rank in enumerate(runs["dp2_zero"]):
        dims = rank["zero_dims"]
        assert dims, "no leaf sliced"
        for name, master in rank["masters"].items():
            dim = dims.get(name)
            if dim is None:
                assert master.shape == whole[name].shape
                continue
            n = whole[name].shape[dim] // 2
            np.testing.assert_allclose(
                master, np.take(whole[name], range(r * n, (r + 1) * n), axis=dim),
                rtol=1e-5, atol=1e-5, err_msg=name)
    # a matrix's slice is over its input features (the JAX (in, out) layout's
    # last free dim is "out" for a row-parallel weight, "in" for a column one)
    dims = runs["dp2_zero"][0]["zero_dims"]
    assert dims["layers.layer_1.attention.query.weight"] == 1
    assert dims["layers.layer_1.mlp.down_proj.weight"] == 0
    assert torch.Size(runs["dp2_zero"][0]["masters"]["layers.layer_1.attention.query.weight"]
                      .shape) == torch.Size([64, 32])


def _async_save_worker(rank: int, world: int) -> str:
    from scaling_tpu_torch.models.transformer import TransformerConfig
    from scaling_tpu_torch.models.transformer.context import TransformerContext
    from scaling_tpu_torch.models.transformer.model import (
        init_model,
        init_optimizer,
        loss_function,
    )
    from scaling_tpu_torch.trainer import BaseTrainer, TrainerConfig

    cfg = TransformerConfig.from_dict(_config(2, 1, True))
    module = init_model(cfg, device="cpu", topology=topology(1, 2, MBS // 2, GAS))
    try:
        BaseTrainer(TrainerConfig(save_checkpoint_async=True),
                    TransformerContext(config=cfg, topology=cfg.topology), module,
                    init_optimizer(cfg, module.model, module), loss_function)
    except NotImplementedError as e:
        return str(e)
    return "accepted"


def test_an_asynchronous_save_over_several_ranks_is_refused_by_name():
    for message in run_ranks(_async_save_worker, 2):
        assert message == "trainer.save_checkpoint_async over several ranks is not ported"
