"""The training-path recompute of ``chip_smoke.py`` can tell a wrong
forward: on the toy model on the CPU (a bf16 forward against an f32 one,
as card against CPU), the intact forward passes the logit tolerance, and
a forward with the attention output zeroed or with each query head fed
the wrong KV head fails it. The loss alone moves by about 1 % under
either fault, which is why the check compares logits. The generation
phase's recompute does the same for a bf16 ``generate`` against the f32
``logits()``: a zeroed attention or K/V written one cache slot late
fails it. Beside them, the build phase's reading of the ``ptxas -v`` log
(registers and spills), and the trainer and generation phases' control
flow at toy size, where ``evaluate`` on the step-3 checkpoint in place of
step 6's fails the trainer phase."""

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


def _toy_trainer(monkeypatch) -> dict:
    """The trainer phase cut to the toy model on the CPU, its launch and
    ``palm_mfu`` checks replaced by a record of the counts."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    # 8 eval batches: the toy's eval sets (2048 tokens) are small enough that
    # evaluate's sequential batches and the trainer's shuffled ones would
    # otherwise differ by more than EVAL_NATS
    for key, value in dict(model="toy", seq=128, mbs=2, tokens=20_000, valid_tokens=2_000,
                           doc_len=(16, 400), serve_prompt=(16, 64), serve_output=8,
                           eval_iterations=8).items():
        monkeypatch.setitem(chip_smoke.TRAINER, key, value)
    monkeypatch.setitem(chip_smoke.SERVE, "num_blocks", 128)
    monkeypatch.setitem(chip_smoke.SERVE, "max_blocks_per_seq", 16)
    seen = {}
    monkeypatch.setattr(chip_smoke, "check_trainer_launches",
                        lambda kernel, plain: seen.update(kernel=kernel, plain=plain))
    monkeypatch.setattr(chip_smoke, "check_step_records", lambda steps: None)
    monkeypatch.setattr(chip_smoke, "check_evaluate_launches",
                        lambda kernel, plain: seen.update(eval_plain=plain))
    return seen


def test_trainer_phase_runs_on_the_cpu_at_toy_size(monkeypatch, capsys):
    """The trainer phase's control flow on the toy model on the CPU: token
    datasets, two checkpoints that verify, the resume from step 3 with the
    same state, batch and step-4 loss, ``evaluate`` held to the trainer's
    in-memory weights, and the checkpoint served with the trainer's own
    tokens. What only the card can give stays unchecked here: kernel
    launches (the CPU runs the plain versions) and ``palm_mfu``."""
    seen = _toy_trainer(monkeypatch)
    chip_smoke.trainer_phase(1.0, device="cpu")
    out = capsys.readouterr().out
    assert "step 4 bitwise equal" in out and "tokens equal to the trainer's" in out
    assert "evaluate (step 6 checkpoint" in out and seen["eval_plain"]["rms_norm"] > 0
    assert "the trainer's forward on its in-memory step-6 weights" in out
    assert seen["kernel"] == {} and seen["plain"]["flash_attention_bwd"] > 0
    assert seen["plain"]["paged_attention"] > 0


def test_trainer_phase_evaluate_tells_the_step3_checkpoint(monkeypatch):
    """``evaluate`` pointed at the step-3 checkpoint where the phase asks for
    step 6's fails the hold against the trainer's in-memory weights."""
    import scaling_tpu_torch.models.transformer.evaluate as evaluate_module

    _toy_trainer(monkeypatch)
    evaluate = evaluate_module.evaluate

    def step3(checkpoint, *a, **kw):
        checkpoint = pathlib.Path(checkpoint)
        if checkpoint.name == "ckpt":
            checkpoint = checkpoint / "global_step3"
        return evaluate(checkpoint, *a, **kw)

    monkeypatch.setattr(evaluate_module, "evaluate", step3)
    with pytest.raises(AssertionError, match="vs in-memory"):
        chip_smoke.trainer_phase(1.0, device="cpu")


def _toy_generation(monkeypatch):
    """The generation phase's shapes cut to the toy model: 3 prompts of
    40-128 tokens (the longest 128, so the bf16 prefill takes the flash
    path), 8 tokens each."""
    from scaling_tpu_torch.train.bench import MODELS

    monkeypatch.setitem(chip_smoke.GEN, "batch", 3)
    monkeypatch.setitem(chip_smoke.GEN, "prompt_len", (40, 128))
    monkeypatch.setitem(chip_smoke.GEN, "max_tokens", 8)
    return MODELS["toy"]


@pytest.mark.parametrize("fault", [None, "attention_zeroed", "cache_slot_off_by_one"])
def test_generation_recompute_tells_a_wrong_decode(monkeypatch, fault):
    """The generation check on the CPU (a bf16 generate against the f32
    ``logits()``, as card against CPU): the intact decode passes, and a
    zeroed attention output or K/V written one cache slot late fails."""
    from scaling_tpu_torch.models.transformer import (
        TransformerArchitectureConfig,
        TransformerInferenceModule,
    )

    arch = TransformerArchitectureConfig.from_dict(_toy_generation(monkeypatch))
    inf = TransformerInferenceModule.random_init(arch, seed=0, device="cpu")
    if fault == "attention_zeroed":
        for name in ("flash_attention", "multi_head_attention"):
            plain = getattr(attention, name)
            monkeypatch.setattr(attention, name, _on_bf16(_zero(plain), plain))
    elif fault == "cache_slot_off_by_one":
        write = attention.dense_kv_write
        monkeypatch.setattr(attention, "dense_kv_write",
                            lambda cache, k, v, offset, seg=None: write(cache, k, v, offset + 1,
                                                                        seg))
    prompts = chip_smoke.generation_prompts(arch.vocab_size)
    outs = inf.generate(prompts, max_tokens=chip_smoke.GEN["max_tokens"])
    rec = chip_smoke.recompute_generation(inf, prompts[-1], outs[-1])
    assert rec["uniform_err"] > chip_smoke.GEN_LOGIT_TOL
    if fault is None:
        assert rec["err"] <= chip_smoke.GEN_LOGIT_TOL and rec["disagree"] == 0, rec
    else:
        assert rec["err"] > chip_smoke.GEN_LOGIT_TOL, rec


def test_generation_phase_runs_on_the_cpu_at_toy_size(monkeypatch, capsys):
    """The generation phase's control flow with both architectures at toy
    size on the CPU: tokens, repeats, the 1-D prompt and the recompute.
    What only the card gives stays unchecked here: the kernel launches and
    the timed and profiled runs (CUDA events, the profiler)."""
    toy = _toy_generation(monkeypatch)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "time_generation", lambda inf, prompts: {"outs": [
        inf.generate(prompts, max_tokens=chip_smoke.GEN["max_tokens"]) for _ in range(2)]})
    seen = []
    monkeypatch.setattr(chip_smoke, "check_generation_launches",
                        lambda name, kernel, plain, needed: seen.append((kernel, plain, needed)))
    for name, arch in (("toy", toy), ("toy_default_arch", dict(toy, **chip_smoke.DEFAULT_ARCH))):
        chip_smoke.generation_phase(name, arch, device="cpu")
    out = capsys.readouterr().out
    assert out.count("4 batch runs give the same tokens") == 2
    assert [needed for _, _, needed in seen] == [("flash_attention_fwd", "rms_norm"),
                                                 ("flash_attention_fwd",)]
    assert all(kernel == {} and plain["flash_attention_fwd"] > 0 for kernel, plain, _ in seen)
