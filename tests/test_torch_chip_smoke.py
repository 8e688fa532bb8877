"""The training-path recompute of ``chip_smoke.py`` can tell a wrong
forward: on the toy model on the CPU (a bf16 forward against an f32 one,
as card against CPU), the intact forward passes the logit tolerance, and
a forward with the attention output zeroed or with each query head fed
the wrong KV head fails it. The loss alone moves by about 1 % under
either fault, which is why the check compares logits."""

import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
import scaling_tpu_torch.nn.attention as attention  # noqa: E402
from scaling_tpu_torch.train.bench import build, synth_batch  # noqa: E402


def _on_bf16(fault, plain):
    """Apply ``fault`` only on the bf16 side, the stand-in for the card."""
    return lambda q, k, v, *a, **kw: (fault if q.dtype == torch.bfloat16 else plain)(
        q, k, v, *a, **kw)


def _zero(fn):
    return lambda q, k, v, *a, **kw: torch.zeros_like(q)


def _wrong_kv_head(fn):
    return lambda q, k, v, *a, **kw: fn(q, k.roll(1, 2), v.roll(1, 2), *a, **kw)


@pytest.fixture(scope="module")
def toy():
    config, module, _ = build("toy", 128, 2, device=torch.device("cpu"), seed=0)
    vocab = config.transformer_architecture.vocab_size
    batch = synth_batch(np.random.default_rng(0), 2, 128, vocab, 1, torch.device("cpu"))
    return module, batch


@pytest.mark.parametrize("fault", [None, _zero, _wrong_kv_head],
                         ids=["intact", "attention_zeroed", "wrong_kv_head"])
def test_train_recompute_tells_a_wrong_forward(toy, monkeypatch, fault):
    module, batch = toy
    assert module.model.architecture.dtype == torch.bfloat16
    if fault is not None:
        for name in ("flash_attention", "multi_head_attention"):
            plain = getattr(attention, name)
            monkeypatch.setattr(attention, name, _on_bf16(fault(plain), plain))
    rec = chip_smoke.recompute_train_row(module, batch)
    assert rec["uniform_err"] > chip_smoke.TRAIN_LOGIT_TOL
    if fault is None:
        assert rec["err"] <= chip_smoke.TRAIN_LOGIT_TOL, rec
    else:
        assert rec["err"] > 10 * chip_smoke.TRAIN_LOGIT_TOL, rec
