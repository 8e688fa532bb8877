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
step 6's fails the trainer phase, and the supervise phase's parent and
child processes, where an asynchronous save that hands its writer the
live optimizer state fails the check against the synchronous save. Phase
10 (observability) at toy size: the report over phase 9's run directory,
the observed Trainer run with its profiler window, ``serve bench
--run-dir`` and its report, and the checks of the trace's kernel names
and of ``mfu`` against ``palm_mfu``, which a TPU peak fails. Phase 3's
kernel checks at their shapes (K1 at s = 1, K4 on the prefill buckets)
and phase 13's in-process modes at toy size run here too, through the
plain versions."""

import json
import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
import scaling_tpu_torch.nn.attention as attention  # noqa: E402
from scaling_tpu_torch.train.bench import build, synth_batch  # noqa: E402

from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401


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


K3_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__a4bf5a05_15_rms_norm_bwd_cu_4901032019rms_norm_bwd_kernelILi1ELi1ELb1EEEvNS_6ParamsE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 228 registers, used 16 barriers, 4352 bytes smem
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__a4bf5a05_15_rms_norm_bwd_cu_4901032019rms_norm_bwd_kernelILi0ELi2ELb0EEEvNS_6ParamsE' for 'sm_90a'
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 16 barriers, 128 bytes smem
"""


def test_ptxas_log_names_each_k3_instantiation():
    """K3's entry functions by their x and g dtypes and variant, with the
    ring's shared memory at the training rows for those dtypes; the build
    phase fails on a K3 kernel that spills, as on a flash one."""
    rows = chip_smoke.kernel_resources(K3_PTXAS_LOG)
    assert [(r["kernel"], r["registers"], r["spill"]) for r in rows] == [
        ("rms_norm_bwd_kernel<x bf16, g bf16, dx and dw>", 228, 0),
        ("rms_norm_bwd_kernel<x f32, g f16, dx only>", 255, 8)]
    assert rows[0]["smem"] == 1024 + 4 * 2048 + 2 * 8 * 2048 * 4
    assert rows[1]["smem"] == 1024 + 4 * 2048 + 2 * 4 * 2048 * 6


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


@pytest.fixture
def one_cpu_thread(monkeypatch):
    """The parent and its children on one CPU thread each: phase 9 holds the
    children's losses and bytes bitwise against the parent's phase 8, and a
    CPU matmul may sum in another order on another thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        monkeypatch.setenv(var, "1")
    yield
    torch.set_num_threads(threads)


def test_supervise_phase_runs_on_the_cpu_at_toy_size(monkeypatch, capsys, one_cpu_thread,
                                                      tmp_path):
    """Phase 9's parent and child processes on the toy model on the CPU, held
    against the toy trainer phase: a real SIGTERM once step 4 is logged,
    the save at the boundary reached, steps 1-k bitwise, global_step3's
    bytes those of the synchronous save, ``run_with_resume`` to step 6,
    pruning after the commit, no stall; then phase 10's report over its
    run directory: six step records, the asynchronous saves' ``ckpt.*``
    spans and the SIGTERM and relaunch in the timeline. Launches and
    ``mfu`` stay unchecked (the CPU runs the plain versions, and a CPU run
    records no rate of the card's peak)."""
    seen = _toy_trainer(monkeypatch)
    monkeypatch.setattr(chip_smoke, "KEEP_DIR", tmp_path / "kept")
    run = chip_smoke.trainer_phase(1.0, device="cpu")
    monkeypatch.setattr(chip_smoke, "check_supervise_launches",
                        lambda kernel, plain: seen.update(sup_kernel=kernel, sup_plain=plain))
    monkeypatch.setattr(chip_smoke, "check_mfu", lambda records, where, section: len(records))
    supervised = chip_smoke.supervise_phase(run, 1.0, device="cpu")
    try:
        chip_smoke.observe_supervised(supervised["run_dir"], supervised["k"])
    finally:
        import shutil

        shutil.rmtree(supervised["run_dir"].parent)
    out = capsys.readouterr().out
    assert "bitwise equal to phase 8" in out and "carry the crc32s of phase 8's" in out
    assert "lost their optimizer files after its commit; watchdog stalls (0, 0)" in out
    assert out.count("async save global_step") == 3
    assert seen["sup_kernel"] == {} and seen["sup_plain"]["flash_attention_bwd"] > 0
    assert "report | totals: restarts=1 preemptions=1 stalls=0" in out
    assert "report | host 0: n=6 " in out
    assert (tmp_path / "kept" / "observe_supervised_report.txt").is_file()


# the child of phase 9 with a writer that takes no host copy: it writes the
# live tensors later, behind the loop, without backpressure
ALIASING_CHILD = """
import runpy, sys, time
import scaling_tpu_torch.checkpoint.checkpoint as ckpt
from scaling_tpu_torch.parallel.parallel_module import transposed_in_jax
to_numpy, write = ckpt._to_numpy, ckpt._write_npz

def live(key, t):
    t = t.detach()
    if t.dtype == ckpt.torch.float32 and not transposed_in_jax(key, t.ndim):
        return t.numpy()
    return to_numpy(key, t)

def late(path, arrays, recorder):
    time.sleep(0.3)
    write(path, arrays, recorder)

ckpt._to_numpy, ckpt._write_npz = live, late
ckpt.AsyncCheckpointWriter.__init__.__defaults__ = (64,)
sys.argv = [sys.argv[1], "--supervise-child", sys.argv[2]]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def test_supervise_phase_tells_an_async_snapshot_of_the_live_state(monkeypatch, one_cpu_thread):
    """A child whose asynchronous save hands the writer the live optimizer
    state instead of a host copy: the steps after the save change it before
    it is written, and phase 9's check of global_step3 against phase 8's
    synchronous save fails."""
    _toy_trainer(monkeypatch)
    run = chip_smoke.trainer_phase(1.0, device="cpu")
    monkeypatch.setattr(chip_smoke, "supervise_child_command", lambda spec: [
        sys.executable, "-c", ALIASING_CHILD, chip_smoke.__file__, str(spec)])
    with pytest.raises(AssertionError, match="global_step3 differs from phase 8"):
        chip_smoke.supervise_phase(run, 1.0, device="cpu")


def test_observe_train_runs_on_the_cpu_at_toy_size(monkeypatch, capsys, tmp_path):
    """Phase 10's observed Trainer run at toy size on the CPU: the profiler
    window's observations JSON holds steps 2-3 and its trace is exported,
    ``obs report`` renders the run's step-time section, the turns of the
    three kinds and the host costs are measured, and the process logger is
    left with no sinks. What only the card gives is recorded, not checked:
    the launches, the trace's kernel names (the CPU launches no kernel),
    ``mfu`` and the sync-debug check."""
    seen = _toy_trainer(monkeypatch)
    monkeypatch.setattr(chip_smoke, "KEEP_DIR", tmp_path / "kept")
    monkeypatch.setattr(chip_smoke, "check_observe_launches",
                        lambda where, kernel, plain, needed: seen.update(plain=plain))
    traces = []
    monkeypatch.setattr(chip_smoke, "check_trace",
                        lambda d: traces.extend(json.loads(f.read_text())
                                                for f in sorted(d.glob("*.json"))))
    monkeypatch.setattr(chip_smoke, "check_mfu",
                        lambda records, where, section: seen.update(records=records))
    monkeypatch.setattr(chip_smoke, "check_no_added_sync", lambda trainer: {
        "in_flight": True, "still_in_flight": True, "derived": {}})
    result = chip_smoke.observe_train(1.0, device="cpu")
    out = capsys.readouterr().out
    assert "profiler observations: [{'step': 2," in out and "'step': 3," in out
    assert len(traces) == 1 and traces[0]["traceEvents"]
    assert seen["plain"]["flash_attention_bwd"] > 0
    assert [r["step"] for r in seen["records"] if "loss" in r["metrics"]] == [1, 2, 3, 4, 5]
    assert "report | host 0: n=5 " in out
    assert result["span_ms"] > 0 and result["telemetry_ms"] > 0
    assert out.count("turns obs ") == 3
    assert set(result["turns"]) == {"on", "no_events", "stub"}
    from scaling_tpu_torch.logging import LoggerConfig, logger

    assert logger.config == LoggerConfig()


def test_observe_serve_runs_on_the_cpu_at_toy_size(monkeypatch, capsys, tmp_path):
    """``serve bench --run-dir`` and its report at toy size on the CPU: the
    serving section counts every request and gives the bench's tokens/s."""
    monkeypatch.setattr(chip_smoke, "KEEP_DIR", tmp_path / "kept")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for key, value in dict(n_requests=4, rate=100.0, prompt_len=(8, 24),
                           output_len=(2, 6)).items():
        monkeypatch.setitem(chip_smoke.WORKLOAD, key, value)
    for key, value in dict(num_slots=4, block_size=4, num_blocks=64, max_blocks_per_seq=16,
                           prefill_chunk=8).items():
        monkeypatch.setitem(chip_smoke.SERVE, key, value)
    seen = {}
    monkeypatch.setattr(chip_smoke, "check_observe_launches",
                        lambda where, kernel, plain, needed: seen.update(plain=plain))
    result = chip_smoke.observe_serve({"tokens_per_s": 1.0, "wall_s": 1.0, "ticks": 1},
                                      model="toy", device="cpu")
    out = capsys.readouterr().out
    assert " 4 request(s))" in out and result["turns"]["run_dir"]["tokens_per_s"] > 0
    assert out.count("turns ") == 3 and result["turns"]["none"]["tick_ms"] > 0
    assert result["turns"]["stub"]["tick_ms"] > 0
    assert seen["plain"]["paged_attention"] > 0



def test_obs_stubbed_makes_every_obs_call_of_the_paths_a_no_op(monkeypatch, tmp_path):
    """Inside ``obs_stubbed`` an engine records nothing into the registry, a
    span and ``log_event`` write no event, and the trainer's telemetry does
    nothing; after it every stubbed name is what it was."""
    from scaling_tpu_torch import obs
    from scaling_tpu_torch.logging import logger
    from scaling_tpu_torch.serve import bench
    from scaling_tpu_torch.trainer import trainer as trainer_module

    events = tmp_path / "events.jsonl"
    monkeypatch.setenv("SCALING_TPU_EVENTS_PATH", str(events))
    telemetry = obs.StepTelemetry(registry=obs.MetricsRegistry())
    owner = type("Trainer", (), {"telemetry": telemetry})()
    names = [(obs, "span"), (obs, "get_registry"), (bench, "span"), (trainer_module, "span")]
    before = [getattr(o, n) for o, n in names]
    with chip_smoke.obs_stubbed(owner):
        with obs.span("x"), bench.span("y"), trainer_module.span("z"):
            pass
        logger.log_event("e")
        reg = obs.get_registry()
        reg.counter("c").inc()
        reg.flush_step(1)
        assert telemetry.on_step(1, 0.1) == {}
        telemetry.flush(1)
    assert not events.exists() and telemetry.registry.snapshot()["counters"] == {}
    assert [getattr(o, n) for o, n in names] == before
    assert "log_event" not in vars(logger) and "on_step" not in vars(telemetry)
    with obs.span("x"):
        pass
    assert [e["span"] for e in map(json.loads, events.read_text().splitlines())] == ["x"]


def _trace(tmp_path, names):
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": [
        {"name": n, "cat": "kernel", "ph": "X"} for n in names]}))
    return tmp_path


def test_trace_check_wants_k4_and_k5_kernel_events(tmp_path, capsys):
    chip_smoke.check_trace(_trace(tmp_path, ["void flash_fwd_kernel<128>(FwdParams)",
                                             "void flash_bwd_dq_kernel<128>(BwdParams)"]))
    with pytest.raises(AssertionError, match="K4 and K5"):
        chip_smoke.check_trace(_trace(tmp_path, ["void flash_fwd_kernel<128>(FwdParams)",
                                                 "ampere_sgemm"]))


@pytest.mark.parametrize("peak", [989.4, 459.0], ids=["h100", "tpu_v5p"])
def test_mfu_check_wants_the_cards_peak(peak):
    """A record whose ``mfu`` came from another peak than the H100's (a
    TPU's 459 TFLOP/s reads 2.2x high) fails the check."""
    from scaling_tpu_torch.models.transformer.utils.get_tflops import (
        get_flops_per_token,
        get_palm_mfu,
    )

    fpt = get_flops_per_token(495_110_144, 8, 2048, 2048)
    tokens, step = 8192, 0.08
    achieved = fpt * tokens / step / 1e12
    record = {"metrics": {"loss": 10.0, "achieved_tflops": achieved, "mfu": achieved / peak,
                          "palm_mfu": get_palm_mfu(495_110_144, 8, 2048, 2048, tokens / step)}}
    section = [f"  mfu: mean={record['metrics']['mfu']:.4f}"]
    if peak == 989.4:
        assert chip_smoke.check_mfu([record], "toy", section) == 1
        with pytest.raises(AssertionError, match="MFU section"):
            chip_smoke.check_mfu([record], "toy", ["  mfu: (not recorded)"])
    else:
        with pytest.raises(AssertionError, match="achieved_tflops / 989.4"):
            chip_smoke.check_mfu([record], "toy", section)


# phase 11 at toy size: timeouts for a CPU worker (3-4 s to its first
# heartbeat on an idle machine, no silent stretch above a second)
TOY_RUNNER = {"heartbeat_timeout_seconds": 5.0, "startup_grace_seconds": 20.0,
              "restart_budget": 2, "restart_backoff_seconds": 0.2, "worker_grace_seconds": 1.0,
              "supervisor_poll_seconds": 0.05}


def _toy_relaunch(monkeypatch, seen: dict) -> None:
    monkeypatch.setitem(chip_smoke.RELAUNCH, "runner", TOY_RUNNER)
    monkeypatch.setitem(chip_smoke.RELAUNCH, "timeout_s", 180)
    monkeypatch.setitem(chip_smoke.RELAUNCH, "resume_timeout_s", 120)
    monkeypatch.setattr(chip_smoke, "check_relaunch_launches",
                        lambda key, kernel, plain: seen.setdefault("relaunch", []).append(
                            (key, kernel, plain)))


@pytest.fixture(scope="module")
def relaunched(tmp_path_factory):
    """Phase 11's parent, supervisors and workers on the toy model on the CPU,
    one thread each (the workers' losses are held bitwise against the
    parent's phase 8), held against the toy trainer phase; its directory
    kept for the tests of the checks' failure modes."""
    kept = tmp_path_factory.mktemp("relaunch") / "root"
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        torch.set_num_threads(1)
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
            mp.setenv(var, "1")
        seen = _toy_trainer(mp)
        _toy_relaunch(mp, seen)
        run = chip_smoke.trainer_phase(1.0, device="cpu")
        check = chip_smoke.check_relaunch

        def keep_and_check(root, gold):
            shutil.copytree(root, kept)
            return check(root, gold)

        mp.setattr(chip_smoke, "check_relaunch", keep_and_check)
        try:
            result = chip_smoke.relaunch_phase(run, device="cpu")
        finally:
            torch.set_num_threads(threads)
    return {"result": result, "root": kept, "gold": run["losses"], "seen": seen}


def test_relaunch_phase_runs_on_the_cpu_at_toy_size(relaunched):
    """Phase 11 on the CPU: the crash, the hang and the drain with their
    events, the losses against phase 8, the second supervisor to step 6,
    ``obs report``'s gate, the time to recover. The card's counters and
    free memory stay unchecked here (the CPU runs the plain versions)."""
    result = relaunched["result"]
    for what in ("crash", "hang"):
        split = result["recover"][what]
        parts = ("detection", "teardown", "backoff", "start_to_heartbeat", "step_replayed")
        assert all(split[p] >= 0 for p in parts) and split["of_which_load"] > 0
        assert split["total"] == pytest.approx(sum(split[p] for p in parts), abs=1e-6)
    assert result["recover"]["max_heartbeat_gap"] < TOY_RUNNER["heartbeat_timeout_seconds"]
    keys = [key for key, _, _ in relaunched["seen"]["relaunch"]]
    assert keys[:3] == [("supervisor", 0), ("supervisor", 1), ("supervisor", 2)]
    assert all(kernel == {} and plain["flash_attention_bwd"] > 0
               for _, kernel, plain in relaunched["seen"]["relaunch"])


def _doctored(relaunched, tmp_path) -> pathlib.Path:
    root = tmp_path / "root"
    shutil.copytree(relaunched["root"], root)
    return root


def _rewrite_events(path: pathlib.Path, edit) -> None:
    events = [json.loads(line) for line in path.read_text().splitlines()]
    path.write_text("".join(json.dumps(e) + "\n" for e in edit(events)))


def test_relaunch_check_tells_a_healthy_worker_read_as_hung(relaunched, tmp_path, monkeypatch):
    """A supervisor whose timeout is too tight for the card's silent
    stretches reads the healthy epoch 2 as hung and tears it down: the
    phase fails."""
    root = _doctored(relaunched, tmp_path)
    monkeypatch.setattr(chip_smoke, "check_relaunch_launches", lambda *a: None)

    def misread(events):
        start = max(i for i, e in enumerate(events) if e["event"] == "epoch-start")
        ts = events[start]["ts"] + 1
        return events[:start + 1] + [
            {"event": "host-dead", "epoch": 2, "hosts": [0], "reason": "heartbeat-stale",
             "exit_codes": {}, "ts": ts},
            {"event": "teardown-complete", "killed_pids": [1], "remote_hosts": [], "ts": ts}]

    _rewrite_events(root / "obs" / "supervisor" / "events.jsonl", misread)
    with pytest.raises(AssertionError, match="supervisor: events"):
        chip_smoke.check_relaunch(root, relaunched["gold"])


def test_relaunch_check_tells_a_supervisor_that_initialised_cuda(relaunched, tmp_path,
                                                                monkeypatch):
    root = _doctored(relaunched, tmp_path)
    monkeypatch.setattr(chip_smoke, "check_relaunch_launches", lambda *a: None)
    (root / "resume_result.json").write_text(json.dumps({"rc": 0, "cuda_initialized": True}))
    with pytest.raises(AssertionError, match="without initialising CUDA"):
        chip_smoke.check_relaunch(root, relaunched["gold"])


@pytest.mark.parametrize("where", ["events", "report"])
def test_relaunch_check_tells_a_missing_epoch_start(relaunched, tmp_path, monkeypatch, where):
    """Without ``epoch-start`` events the supervisor's event order fails,
    and, with the order read from the intact run, so does ``obs report
    --assert-max-resizes 0``, which cannot tell a supervised run without
    them."""
    root = _doctored(relaunched, tmp_path)
    monkeypatch.setattr(chip_smoke, "check_relaunch_launches", lambda *a: None)
    for name in ("supervisor", "resume"):
        _rewrite_events(root / "obs" / name / "events.jsonl",
                        lambda events: [e for e in events if e["event"] != "epoch-start"])
    if where == "events":
        with pytest.raises(AssertionError, match="supervisor: events"):
            chip_smoke.check_relaunch(root, relaunched["gold"])
        return
    events, pristine = chip_smoke.supervisor_events, relaunched["root"] / "obs"
    monkeypatch.setattr(chip_smoke, "supervisor_events",
                        lambda run_dir: events(pristine / run_dir.name))
    with pytest.raises(AssertionError, match="obs report .* exited 1"):
        chip_smoke.check_relaunch(root, relaunched["gold"])



def _toy_finetune(monkeypatch, tmp_path) -> dict:
    """Phase 12's base at a size the CPU trains in seconds: an f32 model of
    the toy's widths but hidden 64, one step of phase 8's config saved and
    kept as phase 8 keeps its step-6 checkpoint; phase 12 cut to 4 steps
    saving at 2, one probability-dropout step, 2 served requests of 8-24
    prompt tokens, a 32-token merge row and a small dropout call."""
    from scaling_tpu_torch.models.transformer import TransformerConfig
    from scaling_tpu_torch.models.transformer.train import main
    from scaling_tpu_torch.train import bench

    _toy_trainer(monkeypatch)
    monkeypatch.setitem(bench.MODELS, "tiny", dict(bench.MODELS["toy"], precision="float32",
                                                   hidden_size=64))
    for key, value in dict(model="tiny", seq=64, iterations=1, interval=1).items():
        monkeypatch.setitem(chip_smoke.TRAINER, key, value)
    for key, value in dict(iterations=4, interval=2, prob_steps=1, serve_requests=2,
                           merge_tokens=32, dropout_shape=(2, 64, 64)).items():
        monkeypatch.setitem(chip_smoke.FINETUNE, key, value)
    monkeypatch.setitem(chip_smoke.WORKLOAD, "prompt_len", (8, 24))
    monkeypatch.setitem(chip_smoke.WORKLOAD, "output_len", (3, 5))
    prefixes = chip_smoke.write_token_datasets(tmp_path / "data", 512)
    main(TransformerConfig.from_dict(chip_smoke.trainer_config(
        prefixes, tmp_path / "logs", save_dir=tmp_path / "ckpt")), device="cpu")
    chip_smoke.reset_logger()
    base = chip_smoke.keep_base(tmp_path / "ckpt" / "global_step1", prefixes, tmp_path / "keep")
    return {**base, "step_ms": 1.0, "peak_bytes": None}


def test_finetune_phase_runs_on_the_cpu_at_toy_size(monkeypatch, capsys, tmp_path):
    """Phase 12's control flow on the CPU: the LoRA finetune from phase 8's
    kept checkpoint (its optimizer files pruned, the checkpoint still
    verifying; frozen leaves bitwise, B moved, the LoRA-only group), the
    bitwise resume, remat's bitwise loss, probability dropout without the
    flash path, the merge against the unmerged f32 model, serving against
    ``generate``, and the dropout call. The card's launch checks stay
    unchecked here."""
    from scaling_tpu_torch.resilience import verify_checkpoint

    base = _toy_finetune(monkeypatch, tmp_path)
    step_dir = base["ckpt"] / "global_step1"
    assert not list(step_dir.glob("optimizer_state_*")) and not verify_checkpoint(step_dir)
    out = chip_smoke.finetune_phase(base, device="cpu")
    text = capsys.readouterr().out
    for line in ("frozen leaves bitwise equal to phase 8's checkpoint",
                 "bitwise equal to (a)'s", "(c) dropout_attention_probs 0.1",
                 "(d) merged on load", "(d) served 2 requests", "same mask: True"):
        assert line in text, line
    assert out["launches"] == {} and np.isfinite(out["step_ms"])


def test_finetune_resume_tells_a_mask_drawn_from_a_running_counter(monkeypatch, tmp_path):
    """Masks seeded from a call counter carried across calls (as JAX's key
    counter, were it kept between steps) instead of the static site id:
    the resumed run draws other masks than the run it resumes, and the
    bitwise check fails."""
    import scaling_tpu_torch.nn.base_layer as base_layer

    base = _toy_finetune(monkeypatch, tmp_path)
    calls = [0]
    draw = base_layer.draw_mask

    def counted(key, site, shape, keep, device):
        calls[0] += 1
        return draw(key, f"call{calls[0]}", shape, keep, device)

    monkeypatch.setattr(base_layer, "draw_mask", counted)
    with pytest.raises(AssertionError, match="resumed losses"):
        chip_smoke.finetune_phase(base, device="cpu")


def _toy_greedy():
    from scaling_tpu_torch.serve.bench import build_inference

    inf = build_inference("toy", seed=0, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 512, size=n).tolist() for n in (9, 14, 21)]
    want = {i: list(out.completion_ids) for i, out in
            enumerate(inf.generate(prompts, max_tokens=6))}
    return inf, prompts, want


def test_modes_token_check_tells_a_changed_token_dict():
    """Phase 13 holds each mode's tokens against another run's: equal
    passes; a token swapped for the least likely one (no near tie) fails,
    as does a dict that lost a request."""
    inf, prompts, want = _toy_greedy()
    assert chip_smoke.check_near_ties(inf, prompts, want, want, "same") == len(want)
    got = {i: list(t) for i, t in want.items()}
    logits = inf.logits(prompts[1] + got[1][:3])[0, -1]
    got[1][3] = int(logits.argmin())
    with pytest.raises(AssertionError, match="parts at token 3"):
        chip_smoke.check_near_ties(inf, prompts, got, want, "changed")
    with pytest.raises(AssertionError, match="requests"):
        chip_smoke.check_near_ties(inf, prompts, {0: want[0]}, want, "lost")


def test_modes_drain_check_wants_unsubmitted_work():
    chip_smoke.check_drain({"drained": True, "unsubmitted": 3})
    for stats in ({"drained": True, "unsubmitted": 0}, {"drained": False, "unsubmitted": 3}):
        with pytest.raises(AssertionError, match="drain"):
            chip_smoke.check_drain(stats)


def test_modes_journal_check_wants_every_offer_ended(tmp_path):
    """Completed + shed + timed out must be every offered request, with
    nothing left incomplete."""
    from scaling_tpu_torch.serve.journal import RequestJournal, replay_journal
    from scaling_tpu_torch.serve.scheduler import Request

    journal = RequestJournal(tmp_path / "journal.jsonl")
    for r in range(3):
        journal.record_submit(Request(req_id=r, prompt=[1, 2], max_new_tokens=2))
    journal.record_finish(0, "completed", tokens=[5, 6])
    journal.record_finish(1, "timeout")
    journal.record_shed("queue-depth")
    with pytest.raises(AssertionError, match="incomplete 1"):
        chip_smoke.check_journal_counts(replay_journal(tmp_path / "journal.jsonl"), 4, "x")
    journal.record_finish(2, "completed", tokens=[7, 8])
    replay = replay_journal(tmp_path / "journal.jsonl")
    chip_smoke.check_journal_counts(replay, 4, "x")
    with pytest.raises(AssertionError, match="offered 4 of 5"):
        chip_smoke.check_journal_counts(replay, 5, "x")


def test_modes_time_to_recover_splits_the_gap():
    """The crash's time to recover from the events: the parts add up to
    the kill-to-first-token gap."""
    events = [
        {"event": "span", "span": "serve.supervisor.spawn", "ts": 0.0},
        {"event": "serve-start", "ts": 1.0, "free_bytes": 5},
        {"event": "span", "span": "serve.tick", "ts": 10.0},
        {"event": "serve-restart", "ts": 10.5, "rc": -9},
        {"event": "span", "span": "serve.supervisor.spawn", "ts": 10.6},
        {"event": "serve-start", "ts": 18.6, "free_bytes": 5},
        {"event": "serve-resume", "ts": 22.0, "replay_s": 0.4},
        {"event": "serve-request", "ts": 30.0, "e2e_s": 7.5, "ttft_s": 0.9},
    ]
    ttr = chip_smoke.serve_time_to_recover(events)
    assert ttr["total"] == pytest.approx(13.4) and ttr["detection"] == pytest.approx(0.5)
    assert ttr["process_start"] == pytest.approx(8.0) and ttr["model_build"] == pytest.approx(3.0)
    assert ttr["first_token"] == pytest.approx(1.4)
    parts = sum(v for k, v in ttr.items() if k != "total")
    assert parts + 0.1 == pytest.approx(ttr["total"])  # the restart-to-spawn gap


def test_kernel_checks_run_on_the_cpu_at_their_shapes(monkeypatch, capsys):
    """Phase 3's checks at their full shapes on the CPU, where each wrapper
    runs its plain version: K1 also at s = 1 on the decode rows (an idle
    slot among them), K4 on the whole-prompt buckets with their pads in
    segment 1, each case printed with its error."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    errs = chip_smoke.check_kernels(device="cpu")
    out = capsys.readouterr().out
    assert set(errs) == {"paged_attention", "paged_attention_int8", "rms_norm",
                         "flash_attention_fwd"}
    assert all(e == 0.0 for e in errs.values())
    assert out.count("decode rows at s = 1") == 2
    for bucket, prompt_len in chip_smoke.K4_PREFILLS:
        assert f"bucket {bucket} ({prompt_len} tokens, {bucket - prompt_len} pads" in out
    rows = chip_smoke.K1_DECODE_ROWS
    assert len(rows) == chip_smoke.K1_ROWS and max(c for c, _ in rows) == 2047
    _, _, _, seg = chip_smoke.prefill_inputs(torch.Generator(), 128, 100, "cpu")
    assert seg.tolist() == [[0] * 100 + [1] * 28]


def test_modes_in_process_runs_on_the_cpu_at_toy_size(monkeypatch, capsys):
    """Phase 13 (a)-(c) at toy size on the CPU: every mode against the
    chunked run beside it, its ratios printed, the separate forwards' K1
    widths read from the counters."""
    from scaling_tpu_torch.serve.bench import build_inference

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for key, value in dict(n_requests=4, rate=100.0, prompt_len=(8, 24),
                           output_len=(16, 32)).items():
        monkeypatch.setitem(chip_smoke.WORKLOAD, key, value)
    for key, value in dict(num_slots=4, block_size=4, num_blocks=128, max_blocks_per_seq=16,
                           prefill_chunk=8).items():
        monkeypatch.setitem(chip_smoke.SERVE, key, value)
    monkeypatch.setitem(chip_smoke.MODES, "first_token_prompt", 40)
    monkeypatch.setitem(chip_smoke.MODES, "segment", (2, 4))
    monkeypatch.setitem(chip_smoke.MODES, "requests", 4)
    monkeypatch.setitem(chip_smoke.MODES, "separate_requests", 2)
    monkeypatch.setattr(chip_smoke, "check_mode_launches", lambda what, stats, needed: None)
    widths = []
    monkeypatch.setattr(chip_smoke, "check_k1_widths",
                        lambda got, needed: widths.append(dict(got)))
    inf = build_inference("toy", seed=0, device="cpu")
    phase4 = chip_smoke.serve_mode(inf, chip_smoke.phase4_workload(512), "cpu")
    out = chip_smoke.modes_in_process(inf, phase4, "cpu")
    text = capsys.readouterr().out
    assert set(out["launches"]) == {"spec", "spec_off", "chunked", "spec_random",
                                    "whole_prompt", "separate"}
    assert "chunked / whole ttft p50" in text and text.count("spec on / off tokens/s") == 2
    assert "fused, beside it:" in text and out["longest_tick_s"] > 0
    assert widths == [{}]  # the CPU counts no kernel launch at any width


def test_kernel_times_refuse_a_profile_that_dropped_events():
    """A kernel seen fewer times than the calls profiled marks a profile
    that lost device events: its times are refused, not averaged. A rare
    event of a small share of the time does not refuse the profile."""
    from types import SimpleNamespace as E

    full = [E(key="void flash_fwd_kernel<128>(Params)", self_device_time_total=2800.0, count=20),
            E(key="Memcpy DtoD", self_device_time_total=40.0, count=20),
            E(key="aten::empty", self_device_time_total=0.0, count=3)]
    assert chip_smoke.kernel_ms(full, 20) == pytest.approx(
        {"flash_fwd_kernel": 0.14, "Memcpy DtoD": 0.002})
    full[1].count = 1
    assert chip_smoke.kernel_ms(full, 20) == pytest.approx(
        {"flash_fwd_kernel": 0.14, "Memcpy DtoD": 0.002})
    full[0].count, full[0].self_device_time_total = 8, 1146.0
    assert chip_smoke.kernel_ms(full, 20) == {}


def test_fleet_phase_runs_on_the_cpu_at_toy_size(monkeypatch, capsys):
    """Phase 14 (a)-(e) at toy size on the CPU: the fleets in child
    processes, the kill (here at replica 1's 3rd tick with work) failed
    over with every request ended once, the time to recover split from the
    events, the drain's workers exiting 0. The card's launch and memory
    checks stay unchecked here (the CPU runs the plain versions)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for key, value in dict(n_requests=12, rate=60.0, prompt_len=(8, 24), output_len=(16, 32),
                           shared_prefix_len=8, prefix_families=4, kill_tick=3,
                           drain_rate=4.0, drain_after_s=0.5).items():
        monkeypatch.setitem(chip_smoke.FLEET, key, value)
    for key, value in dict(num_slots=2, block_size=4, num_blocks=128, max_blocks_per_seq=32,
                           prefill_chunk=8).items():
        monkeypatch.setitem(chip_smoke.SERVE, key, value)
    monkeypatch.setattr(chip_smoke, "check_mode_launches", lambda what, stats, needed: None)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = chip_smoke.fleet_phase(model="toy", device="cpu")
    text = capsys.readouterr().out
    assert set(out) == {"fleet_one", "fleet_threads", "fleet_procs", "fleet_kill"}
    for line in ("(a) one engine on F:", "(b) --replicas 2", "(c) --replicas-proc 2",
                 "(d) serve.replica.kill=kill@3@host=1: 12 of 12 completed",
                 "restarts 1; obs report --assert-max-replica-restarts 1 passes",
                 "(d) time to recover from the last tick: dead verdict",
                 "(e) SIGTERM 0.5s after both workers were ready", "worker exit codes [0, 0]",
                 "tokens/s on F: one engine"):
        assert line in text, line


def test_fleet_time_to_recover_splits_the_gap():
    """The kill's time to recover from the events: the killed replica's last
    tick, the dead verdict, the relaunch's spawn span (its start), its ready
    event and the first token of a request re-dispatched to the survivor."""
    events = [
        {"event": "span", "span": "serve.admit", "req": 4, "replica": 1, "ts": 1.0},
        {"event": "span", "span": "serve.admit", "req": 5, "replica": 0, "ts": 1.1},
        {"event": "span", "span": "serve.tick", "replica": 1, "ts": 9.0},
        {"event": "span", "span": "serve.tick", "replica": 0, "ts": 9.5},
        {"event": "serve-replica-dead", "replica": 1, "ts": 10.0},
        {"event": "span", "span": "serve.admit", "req": 4, "replica": 0, "ts": 10.1},
        {"event": "serve-request", "req": 5, "replica": 0, "ts": 10.2, "e2e_s": 9.0,
         "ttft_s": 0.5},
        {"event": "serve-request", "req": 4, "replica": 0, "ts": 12.0, "e2e_s": 1.9,
         "ttft_s": 0.4},
        {"event": "serve-replica-ready", "replica": 1, "ts": 14.0},
        {"event": "span", "span": "serve.replica.spawn", "replica": 1, "ts": 14.1,
         "dur_s": 3.6},
    ]
    ttr = chip_smoke.fleet_time_to_recover(events)
    assert ttr["detection"] == pytest.approx(1.0) and ttr["spawn"] == pytest.approx(1.5)
    assert ttr["ready"] == pytest.approx(5.0) and ttr["first_token"] == pytest.approx(1.5)
    assert ttr["redispatched"] == 1


# ------------------------------------------------------------ phase 15
TOY_MOE = {"vocab_size": 512, "hidden_size": 256, "num_layers": 2, "num_attention_heads": 4,
           "attention_num_kv_heads": 2, "sequence_length": 128, "precision": "bfloat16",
           "norm_type": "rms", "layernorm": {"optimization_type": "fused"},
           "weight_tying": False, "attention_qkv_in_one": False,
           "masked_softmax": {"kernel": "flash_attention"}, "mlp_type": "moe",
           "mlp_bias": False, "activation_function": "silu", "mlp_factor": 2.0,
           "moe_num_experts": 8, "moe_top_k": 2,
           "mup": {"base_hidden_size": 64, "output_mult": 2.0, "readout_zero_init": False}}


def _bf16_router(layer):
    """The router's product in bf16: its weight and input rounded, the
    logits too."""
    route = layer.route

    def bf16_route(x, with_aux=True):
        w = layer.router.weight
        layer.router.weight = torch.nn.Parameter(w.detach().bfloat16().float())
        try:
            return route(x.bfloat16().float(), with_aux)
        finally:
            layer.router.weight = w

    layer.route = bf16_route
    return layer


def _zeroed_expert(layer):
    with torch.no_grad():
        layer.w_out[0].zero_()
    return layer


@pytest.fixture
def toy_moe(monkeypatch):
    """Phase 15's model cut to the toy MoE in both benches' tables."""
    from scaling_tpu_torch.serve import bench
    from scaling_tpu_torch.train import bench as train_bench

    monkeypatch.setitem(bench.MODELS, chip_smoke.MOE["model"], TOY_MOE)
    monkeypatch.setitem(train_bench.MODELS, chip_smoke.MOE["model"], TOY_MOE)
    monkeypatch.setitem(chip_smoke.MOE, "layer_shape", (4, 128))
    return TOY_MOE


@pytest.mark.parametrize("fault", [None, _bf16_router, _zeroed_expert],
                         ids=["intact", "bf16_router", "zeroed_expert"])
def test_moe_layer_check_tells_a_bf16_router_and_a_zeroed_expert(toy_moe, monkeypatch, fault):
    """Phase 15 (a) with the card's copy on the CPU: the intact copy routes
    every token alike and passes; one whose router computes in bf16 routes
    more than a thousandth of the tokens otherwise, one with an expert's
    output zeroed misses the output tolerance."""
    copy_to = chip_smoke.card_copy
    monkeypatch.setattr(chip_smoke, "card_copy",
                        lambda layer, device: (fault or (lambda m: m))(copy_to(layer, device)))
    rec = chip_smoke.moe_layer_check(device="cpu")
    if fault is None:
        assert rec["alike"] == 1.0 and rec["err"] == 0.0
        chip_smoke.check_moe_layer(rec)
        return
    with pytest.raises(AssertionError, match="routing|output"):
        chip_smoke.check_moe_layer(rec)
    if fault is _bf16_router:
        assert rec["alike"] < chip_smoke.MOE["route_agree"], rec
    else:
        assert rec["alike"] == 1.0 and rec["err"] > 100 * chip_smoke.MOE["layer_tol"], rec


@pytest.mark.parametrize("fault", [None, "zeroed_expert"])
def test_moe_train_recompute_tells_a_zeroed_expert(toy_moe, monkeypatch, fault):
    """Phase 15 (b)'s row recompute on the toy MoE model (a bf16 forward
    against the f32 copy, as card against CPU): routing captured on both
    sides, few decisions differ; an expert whose output is zeroed on the
    bf16 side alone fails the check (its tokens' changed outputs reroute
    the next layer, or the logits miss their tolerance)."""
    from scaling_tpu_torch.nn.moe import ParallelMoEMLP

    config, module, _ = build(chip_smoke.MOE["model"], 128, 2, device=torch.device("cpu"),
                              seed=0)
    assert sum(p.numel() for p in module.model.parameters()) < 10_000_000  # the toy
    batch = synth_batch(np.random.default_rng(0), 2, 128, TOY_MOE["vocab_size"], 1,
                        torch.device("cpu"))
    if fault:
        forward = ParallelMoEMLP.forward

        def zeroed(self, x, with_aux=True):  # expert 0's output zeroed, bf16 side only
            if x.dtype != torch.bfloat16:
                return forward(self, x, with_aux)
            w_out = self.w_out.data
            self.w_out.data = w_out.clone().index_fill_(0, torch.tensor([0]), 0)
            try:
                return forward(self, x, with_aux)
            finally:
                self.w_out.data = w_out

        monkeypatch.setattr(ParallelMoEMLP, "forward", zeroed)
    rec = chip_smoke.recompute_train_row(module, batch)
    assert rec["uniform_err"] > chip_smoke.TRAIN_LOGIT_TOL
    if fault is None:
        assert rec["flips"] <= chip_smoke.MOE["flip_share"], rec
        assert rec["err"] <= chip_smoke.TRAIN_LOGIT_TOL, rec
        chip_smoke.check_train_row(rec, moe=True)
    else:  # the zeroed outputs reroute the next layer's tokens, or miss the logits
        with pytest.raises(AssertionError, match="routing disagrees|logits recompute"):
            chip_smoke.check_train_row(rec, moe=True)


def test_serve_tick_recompute_holds_the_moe_routing(toy_moe, monkeypatch, capsys):
    """Phase 15 (c): ``serve`` on the toy MoE model on the CPU (the engine
    at phase 4's settings, 4 requests; the bf16 model stands for the
    card's, the plain versions' counts for the kernels'), its tick
    recomputed in f32 with the routing captured on both sides."""
    monkeypatch.setattr(chip_smoke, "WORKLOAD", dict(chip_smoke.WORKLOAD, n_requests=4,
                                                     prompt_len=(16, 64), output_len=(8, 16)))
    monkeypatch.setattr(chip_smoke, "RECOMPUTE_TICK", 3)
    monkeypatch.setattr(chip_smoke, "profile_ticks", lambda engine, vocab: {
        "tick_ms": 0.0, "device_busy_ms_per_tick": 0.0, "device_idle_share": 0.0,
        "device_ms_per_tick": {}})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(torch, "device", lambda name: torch.empty(0).device
                        if name == "cuda" else torch.empty(0, device=name).device)
    from scaling_tpu_torch.ops import launches

    add = launches.add  # the CPU's plain versions stand for the card's kernels
    monkeypatch.setattr(launches, "add", lambda counter, key: add(
        launches.KERNEL if counter is launches.PLAIN else counter, key))
    stats = chip_smoke.serve("native", chip_smoke.MOE["model"])
    assert stats["completed"] == 4 and stats["launches"]["paged_attention"] > 0
    out = capsys.readouterr().out
    assert "the tick's routing, card vs cpu" in out and "tick 3 recomputed" in out


def _toy_features(monkeypatch):
    """Phase 16 cut to the bf16 toy (flash, fused RMS) on the CPU: 2 layers,
    micro-batch 2 of 384 tokens with images at 8 and 200, a ViT of width 64,
    one block; a 4-stage ResNet of 8 channels and a CLIP ViT of width 64 on 2
    images; 2 of 4 heads local with window 16 over 2 prompts of 128 tokens,
    8 new tokens; 2 timed steps a remat mode."""
    for key, value in dict(
            model="toy", mbs=2, seq=384, image_starts=(8, 200), steps=4,
            encoder={"image_encoder_width": 64, "image_encoder_layers": 1,
                     "image_encoder_heads": 4},
            clip_images=2, resnet={"resnet_stages": (1, 1, 1, 1), "resnet_channels": 8},
            vit={"width": 64, "layers": 1, "heads": 4}, clip_source_grid=3, local_heads=2,
            window=16, local_prompts=2, local_prompt_len=128, local_tokens=8,
            remat_model="toy", remat_steps=2).items():
        monkeypatch.setitem(chip_smoke.FEATURES, key, value)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)


def test_features_phase_runs_on_the_cpu_at_toy_size(monkeypatch, capsys):
    """Phase 16's control flow on the CPU: the multimodal steps (the loss
    falls, the logits before the first image stay bitwise), both CLIP
    backbones against their f32 copies, the local-window decode cached
    against uncached (K4's plain version with the local heads), and the
    remat modes (save_dots running the plain versions as often as
    every_layer). What only the card gives stays unchecked: times, peak
    memory and the kernels' counters."""
    _toy_features(monkeypatch)
    out = chip_smoke.features_phase(device="cpu")
    text = capsys.readouterr().out
    for line in ("(a) multimodal:", "logits before position 8 bitwise the same: True",
                 "(b) clip_resnet", "BatchNorm statistics without gradient: True",
                 "(b) clip ViT", "(c) 2 of 4 heads local", "K4 ran with num_local_heads [2]",
                 "(d) phase 5's step, every_layer_save_dots"):
        assert line in text, line
    assert out == {"multimodal": {}, "local_window": {}, "remat_save_dots": {}}


def test_atman_phase_runs_on_the_cpu_at_toy_size(monkeypatch, capsys):
    """Phase 6's AtMan check on the bf16 toy: factor 1 is the unfused
    logits (bitwise, log-additive), factor 0 keeps the earlier positions
    bitwise and moves the later ones, in both variants; the controlled
    logits run K2's plain version and not K4's."""
    from scaling_tpu_torch.train.bench import MODELS

    monkeypatch.setitem(chip_smoke.ATMAN, "seq", 256)
    monkeypatch.setitem(chip_smoke.ATMAN, "batch", 2)
    monkeypatch.setitem(chip_smoke.ATMAN, "token", 100)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    chip_smoke.atman_phase(MODELS["toy"], device="cpu")
    text = capsys.readouterr().out
    assert "atman log-additive: factor 1 vs the uncontrolled unfused logits" in text
    assert "(bitwise: True" in text and "atman multiplicative" in text


def test_features_remat_check_tells_a_save_dots_step_without_recompute(monkeypatch):
    """Phase 16 (d) fails when ``every_layer_save_dots`` runs without the
    recompute (the remat switch of the slice before, which knew only
    ``every_layer``): its forward kernels then run once a step, not twice
    as under ``every_layer``."""
    from scaling_tpu_torch.parallel.parallel_module import ParallelModule
    from scaling_tpu_torch.topology import ActivationCheckpointingType

    _toy_features(monkeypatch)
    monkeypatch.setattr(ParallelModule, "remat", property(
        lambda self: self.topology.activation_checkpointing_type
        == ActivationCheckpointingType.EVERY_LAYER))
    with pytest.raises(AssertionError, match="launches differ"):
        chip_smoke.remat_modes_check(device="cpu")


def test_tooling_phase_runs_on_the_cpu_at_toy_size(monkeypatch, capsys, tmp_path):
    """Phase 17's control flow on the CPU, on an f32 model of the toy's
    widths but hidden 64 with steps 1 and 2 kept as phase 8 keeps its steps
    3 and 6: Megatron data through the Trainer with the C++ windows against
    the plain loop's, the pack builder, the reference checkpoint out, in
    (bit-equal) and served against ``generate``, the three restores with
    their fault points and the ladder's child at mbs 1 and 2. The card's
    launch checks stay unchecked here."""
    from scaling_tpu_torch.models.transformer import TransformerConfig
    from scaling_tpu_torch.models.transformer.train import main
    from scaling_tpu_torch.train import bench

    _toy_trainer(monkeypatch)
    monkeypatch.setitem(bench.MODELS, "tiny", dict(bench.MODELS["toy"], precision="float32",
                                                   hidden_size=64))
    for key, value in dict(model="tiny", seq=64, iterations=2, interval=1).items():
        monkeypatch.setitem(chip_smoke.TRAINER, key, value)
    monkeypatch.setitem(chip_smoke.WORKLOAD, "prompt_len", (8, 24))
    monkeypatch.setitem(chip_smoke.WORKLOAD, "output_len", (3, 5))
    for key, value in dict(tokens=20_000, doc_len=(16, 200), pack_docs=20_000, serve_requests=2,
                           model="toy", mbs_plan="1,2", ladder_steps=1, ladder_seq=32).items():
        monkeypatch.setitem(chip_smoke.TOOLING, key, value)
    prefixes = chip_smoke.write_token_datasets(tmp_path / "data", 512)
    main(TransformerConfig.from_dict(chip_smoke.trainer_config(
        prefixes, tmp_path / "logs", save_dir=tmp_path / "ckpt")), device="cpu")
    chip_smoke.reset_logger()
    ckpt = tmp_path / "ckpt"
    base = chip_smoke.keep_base(ckpt / "global_step2", prefixes, tmp_path / "keep",
                                (ckpt / "global_step1",))
    out = chip_smoke.tooling_phase(base, device="cpu")
    text = capsys.readouterr().out
    for line in ("(a) Megatron data written", "windows by the C++ builder equal to the plain",
                 "(b) 20000 documents", "every_n 4:", "(c) export: 5 .pt files",
                 "bit-equal to the source", "(c) served 2 requests of the import",
                 "(d) transient (restore.assemble=fail@1): restored step 2, restore.assemble "
                 "hits 6", "(d) persistent (restore.assemble=fail@1x3): restored step 1, "
                 "restore.assemble hits 8", "restored step 2, ckpt.reshard hits 1",
                 "(e) | ladder: mbs=1 ", "(e) | launches: "):
        assert line in text, line
    assert sorted(out) == ["tooling_import_serve", "tooling_legacy_trainer"]


# ------------------------------------------------------------ phase 18
def test_block_overhead_fit_recovers_a_known_overhead():
    ms = {bs: 0.04 * (1 + 6.0 / bs) for bs in (8, 16, 32)}
    c, overhead = chip_smoke.fit_block_overhead(ms)
    assert c == pytest.approx(0.04) and overhead == pytest.approx(6.0)


def test_k1_block_sizes_hold_the_same_rows_against_the_plain_version(capsys):
    """Phase 18 (a) on the CPU: the kernel's wrapper runs its plain version,
    so every block size agrees with it; the printed fit names the tuner's
    constant."""
    out = chip_smoke.k1_block_sizes(device="cpu")
    assert sorted(out["ms"]) == [8, 16, 32]
    text = capsys.readouterr().out
    assert text.count("(a) K1 at block size") == 3 and "PAGED_BLOCK_OVERHEAD" in text


def _toy_serving(monkeypatch):
    for key, value in dict(n_requests=4, rate=100.0, prompt_len=(8, 24),
                           output_len=(2, 6)).items():
        monkeypatch.setitem(chip_smoke.WORKLOAD, key, value)
    for key, value in dict(num_slots=4, block_size=4, num_blocks=64, max_blocks_per_seq=16,
                           prefill_chunk=8).items():
        monkeypatch.setitem(chip_smoke.SERVE, key, value)
    monkeypatch.setitem(chip_smoke.TUNE, "requests", 3)


TOY_SPEC = "256,2,4,2,512,512,2.0"  # the serving toy as the tuner's ModelSpec


def test_serving_tuner_check_serves_the_emitted_config_on_the_cpu(monkeypatch, capsys,
                                                                 tmp_path):
    """Phase 18 (b) at toy size: the tuner calibrated from a toy ``serve bench
    --run-dir``, its config served in process; the engine the bench ran is
    the emitted one, the prediction and the measured tick printed."""
    from scaling_tpu_torch.serve.bench import main as bench_main

    _toy_serving(monkeypatch)
    run = tmp_path / "phase10"
    assert bench_main(chip_smoke.bench_base("toy", "cpu") + ["--run-dir", str(run)]) == 0
    out = chip_smoke.serving_tuner_check(run, device="cpu", model="toy", tune_model=TOY_SPEC)
    text = capsys.readouterr().out
    assert "(b) chosen mp1·r1·bs" in text and "calibration factor" in text
    assert out["measured_tick_s"] > 0 and out["factor"] > 0
    assert out["label"].startswith("mp1·r1·")


def test_ladder_vs_tuner_prints_every_rung_beside_the_measured_one(capsys):
    ladder = {"rungs": [{"mbs": 4, "oom": False, "tokens_per_s": 100.0, "peak_gb": 16.5},
                        {"mbs": 8, "oom": False, "tokens_per_s": 120.0, "peak_gb": 24.0}],
              "winner": 8}
    out = chip_smoke.ladder_vs_tuner(0.35, ladder)
    text = capsys.readouterr().out
    for mbs in (4, 8, 16, 32):
        assert f"(c) mbs {mbs}: predicted" in text
    assert "not measured (the climb stopped before it)" in text
    assert out["winner"] == 8 and out["pick"] in (4, 8, 16, 32)


def test_observed_run_prediction_prices_phase_10s_shape():
    pred = chip_smoke.observed_run_prediction(0.3)
    assert pred["world_size"] == 1 and pred["predicted_step_s"] > 0
    assert pred["source"] == "measured mfu 0.3 (--mfu)"


def test_audit_of_a_step_and_a_tick_on_the_cpu(monkeypatch, capsys):
    """Phase 18 (d) at toy size: the step's plain runs at 2L+1 / 2L+1 / L /
    L, the tick's paged attention and RMSNorm; a count off by one fails."""
    from scaling_tpu_torch.analysis import dispatch_audit
    from scaling_tpu_torch.serve import EngineConfig, ServeEngine
    from scaling_tpu_torch.serve.bench import build_inference

    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", 128)
    monkeypatch.setattr(chip_smoke, "TRAIN_MBS", 2)
    report = chip_smoke.audit_train_step_check(device="cpu", model="toy")
    assert report["launches"]["plain"]["rms_norm"] == 5
    assert "(d) phase 5's step (2 layers)" in capsys.readouterr().out

    _toy_serving(monkeypatch)
    monkeypatch.setattr(chip_smoke, "RECOMPUTE_TICK", 3)
    engine = ServeEngine(build_inference("toy", device="cpu"),
                         EngineConfig(**chip_smoke.SERVE), device="cpu")
    tick = chip_smoke.audit_tick(engine, 512, device="cpu")
    assert tick["launches"]["plain"]["paged_attention"] == 2
    assert not engine.scheduler.has_work

    real = dispatch_audit.audit_train_step

    def off_by_one(*a, **k):
        r = real(*a, **k)
        r["launches"]["plain"]["rms_norm"] -= 1
        return r

    monkeypatch.setattr(dispatch_audit, "audit_train_step", off_by_one)
    with pytest.raises(AssertionError, match="the step's launches"):
        chip_smoke.audit_train_step_check(device="cpu", model="toy")
