"""Phases 19, 20 and 21 of ``chip_smoke.py`` (dp 2 x mp 2 with ZeRO-1, and pp 2
x vpp 2 x dp 2 with ZeRO-1 and ``every_pipe_stage``, through
``runner_main``) at toy size on the CPU: four gloo worker processes, a
one-rank run beside them, SIGTERM to rank 3, a one-rank resume of the
step-2 checkpoint. The intact runs pass their checks; a phase-19 run whose
row-parallel products are not summed over the model group fails the
loss or the logit check, a phase-20 run whose stages send zeros for their
inputs' gradients fails the check of the pipelined backward against the
one-rank child's, and a run where one rank runs the plain versions fails
the launch check. Phase 21 runs beside them as in the script: (a) ring at
cp 2 x dp 2 and (b) Ulysses at cp 2 held to phase 19's one-rank run, (c)
pp 2 x S 2 resuming phase 20's step-2 checkpoint held to its child; a ring
whose dK/dV are dropped, and token slices whose cache passes no gradient to
the earlier slices' K/V, fail the check of the backward (the gradient norm
and the layers' Adam first moments). The workers are
``tests/test_torch_dist_helpers.py``'s ``phase19_worker``, which counts
the CPU's plain runs as the card's launches."""

import pathlib
import sys

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401


def _toy_dist(monkeypatch, tmp_path, fault: str) -> dict:
    for key, value in dict(model="toy", seq=128, mbs=4, tokens=20_000, valid_tokens=2_000,
                           doc_len=(16, 400)).items():
        monkeypatch.setitem(chip_smoke.TRAINER, key, value)
    monkeypatch.setitem(chip_smoke.DIST, "script", "tests.test_torch_dist_helpers")
    monkeypatch.setitem(chip_smoke.DIST, "pause_s", 0.2)
    monkeypatch.setitem(chip_smoke.DIST, "timeout_s", 100)
    monkeypatch.setenv("PHASE19_FAULT", fault)
    vocab = chip_smoke.trainer_arch()["vocab_size"]
    root = tmp_path / "data"
    root.mkdir()
    prefixes = chip_smoke.write_token_datasets(root, vocab)
    return {"prefixes": {k: prefixes[k] for k in ("a", "b")}}  # what phase 8 keeps


@pytest.mark.parametrize("fault,match", [
    ("", None),
    ("skip_row_reduction", r"phase 19 \((a|b)\)"),
    ("plain_rank_1", r"phase 19 rank 1"),
], ids=["intact", "row_reduction_skipped", "plain_on_rank_1"])
def test_dist_phase_on_the_cpu_tells_a_wrong_layout(monkeypatch, tmp_path, capsys, fault,
                                                    match):
    base = _toy_dist(monkeypatch, tmp_path, fault)
    if match is None:
        launches = chip_smoke.dist_phase(base, device="cpu")
        out = capsys.readouterr().out
        assert "(e) SIGTERM to rank 3" in out and "stopped at steps [4, 4, 4, 4]" in out
        assert "(d) MESH.json of step 2: dp 2 x mp 2, zero_stage 1" in out
        assert "backend gloo, 4 ranks" in out
        layers = chip_smoke.trainer_arch()["num_layers"]
        assert launches["dist_4ranks"]["flash_attention_bwd"] == 4 * 4 * layers
        return
    with pytest.raises(AssertionError, match=match):
        chip_smoke.dist_phase(base, device="cpu")


def test_dist_probe_row_fits_the_model():
    arch = type("Arch", (), {"sequence_length": 128, "vocab_size": 50})()
    row = chip_smoke.dist_probe_row(arch)
    assert row.shape == (1, 128) and row.dtype == torch.int32 and int(row.max()) < 50
    assert torch.equal(row, chip_smoke.dist_probe_row(arch))


@pytest.mark.parametrize("fault,match", [
    ("", None),
    ("plain_rank_2", r"phase 20 \(c\)"),
    ("zero_send_grad", r"phase 20 \(a\)"),
], ids=["intact", "plain_on_rank_2", "zero_send_grad"])
def test_pipe_phase_on_the_cpu_tells_a_wrong_run(monkeypatch, tmp_path, capsys, fault, match):
    base = _toy_dist(monkeypatch, tmp_path, fault)
    monkeypatch.setitem(chip_smoke.PIPE, "pause_s", 0.2)
    monkeypatch.setitem(chip_smoke.PIPE, "timeout_s", 100)
    if match is not None:
        with pytest.raises(AssertionError, match=match):
            chip_smoke.pipe_phase(base, device="cpu")
        return
    launches = chip_smoke.pipe_phase(base, device="cpu")
    out = capsys.readouterr().out
    assert "stopped at steps [4, 4, 4, 4]" in out
    assert "MESH.json of step 2: pp 2 x vpp 2 x dp 2" in out
    assert "schedule: interleaved(v=2) pp=2 gas=4" in out
    # every rank ran 4 steps and the probe's forward: K5 once a layer and micro-batch
    gas, layers = chip_smoke.PIPE["gas"], chip_smoke.PIPE["layers"]
    assert launches["pipe_4ranks"]["flash_attention_bwd"] == 2 * 4 * gas * layers


@pytest.mark.parametrize("fault,match", [
    ("", None),
    ("ring_dkv_dropped", r"phase 21 \(a\) ring"),
], ids=["intact", "ring_dkv_dropped"])
def test_split_phase_on_the_cpu_tells_a_wrong_backward(monkeypatch, tmp_path, capsys, fault,
                                                       match):
    """Phase 19 and phase 21 (a), (b) side by side, as ``main`` runs them."""
    from concurrent.futures import Future, ThreadPoolExecutor

    base = _toy_dist(monkeypatch, tmp_path, fault)
    lines: list = []
    one_rank = Future()
    with ThreadPoolExecutor(1) as pool:
        split = pool.submit(chip_smoke.split_phase, base, one_rank, "cpu", lines.append)
        chip_smoke.dist_phase(base, device="cpu", share=one_rank)
        if match is not None:
            with pytest.raises(AssertionError, match=match):
                split.result()
            return
        launches = split.result()
    out = "\n".join(lines)
    assert "(a) ring, cp 2 x dp 2 with ZeRO-1: losses" in out
    assert "(b) Ulysses, cp 2: K2-K5" in out
    layers = chip_smoke.trainer_arch()["num_layers"]
    # ring: no flash kernel; Ulysses: K5 once a layer a step on each of 2 ranks
    assert launches["split_ring"].get("flash_attention_bwd", 0) == 0
    assert launches["split_ulysses"].get("flash_attention_bwd", 0) == 2 * 2 * layers


@pytest.mark.parametrize("fault,match", [
    ("", None),
    ("slice_kv_detached", r"phase 21 \(c\)"),
], ids=["intact", "slice_kv_detached"])
def test_token_slices_on_the_cpu_tell_a_wrong_backward(monkeypatch, tmp_path, capsys, fault,
                                                       match):
    base = _toy_dist(monkeypatch, tmp_path, fault)
    monkeypatch.setitem(chip_smoke.PIPE, "pause_s", 0.2)
    monkeypatch.setitem(chip_smoke.PIPE, "timeout_s", 100)
    lines: list = []
    if match is not None:
        with pytest.raises(AssertionError, match=match):
            chip_smoke.pipe_phase(base, device="cpu", say_slices=lines.append)
        return
    launches = chip_smoke.pipe_phase(base, device="cpu", say_slices=lines.append)
    out = "\n".join(lines)
    assert "(c) token slices, pp 2 x S 2, every_pipe_stage: losses" in out
    assert "1/2 of an unsliced micro-batch's" in out
    assert launches["split_slices"].get("flash_attention_bwd", 0) == 0
