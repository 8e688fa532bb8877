"""The training-path recompute of ``chip_smoke.py`` can tell a wrong
forward: on the toy model on the CPU (a bf16 forward against an f32 one,
as card against CPU), the intact forward passes the logit tolerance, and
a forward with the attention output zeroed or with each query head fed
the wrong KV head fails it. The loss alone moves by about 1 % under
either fault, which is why the check compares logits. Beside it, the
build phase's reading of the ``ptxas -v`` log (registers and spills)."""

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


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__0_18_flash_attention_cu_0d6f9d4a22flash_bwd_delta_kernelILi128EEEvNS_9BwdParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__0_18_flash_attention_cu_0d6f9d4a22flash_bwd_delta_kernelILi128EEEvNS_9BwdParamsE
    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 26 registers, used 0 barriers
ptxas info    : Compiling entry function '_Z22paged_attention_kernelI13__nv_bfloat16S0_Li64ELi32EEvPKT_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 126 registers, used 1 barriers
"""


def test_ptxas_log_gives_each_kernels_registers_and_spills():
    """Phase 2's reading of ``ptxas -v``, which fails the run when a flash
    kernel spills: each entry function by its short name and head dim, its
    registers, and its spill stores plus loads (no launch, no library)."""
    rows = chip_smoke.kernel_resources(PTXAS_LOG)
    assert [(r["kernel"], r["registers"], r["spill"]) for r in rows] == [
        ("flash_bwd_delta_kernel<128>", 26, 12), ("paged_attention_kernel<64>", 126, 0)]
    with pytest.raises(AssertionError, match="no ptxas"):
        chip_smoke.kernel_resources("nvcc printed nothing")


def test_trainer_phase_runs_on_the_cpu_at_toy_size(monkeypatch, capsys):
    """The trainer phase's control flow on the toy model on the CPU: token
    datasets, two checkpoints that verify, the resume from step 3 with the
    same state, batch and step-4 loss, and the checkpoint served with the
    trainer's own tokens. What only the card can give stays unchecked here:
    kernel launches (the CPU runs the plain versions) and ``palm_mfu``."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    for key, value in dict(model="toy", seq=128, mbs=2, tokens=20_000, valid_tokens=2_000,
                           doc_len=(16, 400), serve_prompt=(16, 64), serve_output=8).items():
        monkeypatch.setitem(chip_smoke.TRAINER, key, value)
    monkeypatch.setitem(chip_smoke.SERVE, "num_blocks", 128)
    monkeypatch.setitem(chip_smoke.SERVE, "max_blocks_per_seq", 16)
    seen = {}
    monkeypatch.setattr(chip_smoke, "check_trainer_launches",
                        lambda kernel, plain: seen.update(kernel=kernel, plain=plain))
    monkeypatch.setattr(chip_smoke, "check_step_records", lambda steps: None)
    chip_smoke.trainer_phase(1.0, device="cpu")
    out = capsys.readouterr().out
    assert "step 4 bitwise equal" in out and "tokens equal to the trainer's" in out
    assert seen["kernel"] == {} and seen["plain"]["flash_attention_bwd"] > 0
    assert seen["plain"]["paged_attention"] > 0
