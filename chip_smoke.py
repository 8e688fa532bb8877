#!/usr/bin/env python3
"""Drive the PyTorch port (scaling_tpu_torch) on one CUDA card.

Phases, each of which must pass:

1. print the card (nvidia-smi name and power limit) and require compute
   capability 9.0;
2. build every kernel of the serving and the training path from this
   checkout's sources (nvcc for the CUDA kernels, one process per source,
   all started together; Triton's compiler for the Triton ones) and print
   the build time;
3. hold each kernel against its plain PyTorch version on the same inputs
   at the shapes its path gives it, and print the max error beside the
   tolerance: K1 and K2 at serving shapes; K3 (RMSNorm backward) at the
   training rows and an odd row count; K4 and K5 (flash attention forward
   and backward) at the training shape, unsegmented, with 3 packed
   documents, and with 4 local heads of window 256. K5's gradients and
   K3's dw must repeat bitwise;
4. serve the full-width 0.5B model (random weights from a seed) with
   native and with int8 KV: every request must finish with its token
   count, the kernel launch counters must be > 0 and the plain-version
   counter 0, and one tick recomputed on the CPU in f32 with the plain
   versions, from a copy of the pools taken before the tick, must agree
   with the card's logits; print tokens/s, TTFT and ITL;
   a profiled window of steady ticks gives the device's busy time, its
   idle share and the device time by kernel;
5. train the same model (bench.py's first rung: micro-batch 4, seq 2048,
   bf16, no remat): the first row's logits before any update, recomputed
   on the CPU in f32 through the plain versions from a copy of the
   weights, must agree with the card's (a tolerance that constant logits
   per position could not meet); then, counters reset, 3 warm-up and 10
   timed steps: losses finite, K2-K5 launched and no plain version run;
   print step ms, tokens/s, MFU, peak memory and the losses; one profiled
   step gives the device's busy time, its idle share and the device time
   by kernel group;
6. time each kernel, its plain version and, where one PyTorch call
   computes the same function, that call: device time from
   ``torch.profiler``, and the per-call time with CUDA events;

then print one ``{"kernels": [...]}`` line, the card line, and as the last
line ``{"ok": true, "device": {...}}``. Any failure exits non-zero, and
nothing is printed as a result without a card.

Run from the root of a checkout: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# dense peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

K1_ROWS, K1_S, K1_HEADS, K1_KV_HEADS, K1_HEAD_DIM = 16, 32, 16, 4, 128
K1_NUM_BLOCKS, K1_BLOCK_SIZE, K1_MAX_BLOCKS = 1024, 16, 128
K2_SHAPES = ((512, 2048), (333, 2048))
KERNEL_TOL = 1e-2  # atol and rtol: bf16 outputs, one rounding apart
TICK_TOL = 0.05    # max |logit error| / max |logit|: bf16 through 8 layers vs f32
SERVE = dict(num_slots=16, block_size=16, num_blocks=1024, max_blocks_per_seq=128,
             prefill_chunk=32)
WORKLOAD = dict(n_requests=32, rate=64.0, prompt_len=(128, 1024),
                output_len=(64, 256), seed=0)
RECOMPUTE_TICK = 12  # which measured tick is recomputed with the plain versions
# the training path: bench.py's first rung on the 0.5B model
TRAIN_MBS, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS = 4, 2048, 3, 10
FLASH_SHAPE = dict(b=TRAIN_MBS, s=TRAIN_SEQ, n=16, n_kv=4, d=128)
FLASH_CASES = (  # name, packed documents, local heads, window
    ("causal", 1, 0, None), ("packed3", 3, 0, None), ("local4", 1, 4, 256))
K3_SHAPES = ((TRAIN_MBS * TRAIN_SEQ, 2048), (8191, 2048))
FLASH_OUT_TOL = 1e-2    # atol and rtol: bf16 output, one rounding apart
LSE_TOL = 1e-3          # atol: f32 from the same bf16 products
FLASH_GRAD_TOL = 2e-2   # max |err| / max |ref|: P and dS enter the products as bf16
K3_DW_TOL = 1e-2        # max |err| / max |ref|: a bf16 dw summed over 8192 rows
TRAIN_LOGIT_TOL = 0.05  # max |logit error| / max |logit|: bf16 through 8 layers vs f32


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- inputs
def k1_inputs(gen: torch.Generator, quantized: bool, dev):
    """Serving-shaped K1 operands: one mixed tick of 16 rows of width 32
    over a 1024-block pool, rows of every kind (idle, fresh decode, a
    short chunk, decode and chunk at the full 2048-slot context)."""
    from scaling_tpu_torch.nn.attention import kv_quantize_int8

    pool_shape = (K1_NUM_BLOCKS, K1_BLOCK_SIZE, K1_KV_HEADS, K1_HEAD_DIM)
    q = torch.randn(K1_ROWS, K1_S, K1_HEADS, K1_HEAD_DIM, generator=gen, device=dev)
    pk = torch.randn(pool_shape, generator=gen, device=dev)
    pv = torch.randn(pool_shape, generator=gen, device=dev)
    ctx = torch.randint(0, 2048 - K1_S, (K1_ROWS,), generator=gen, device=dev)
    new = torch.randint(1, K1_S + 1, (K1_ROWS,), generator=gen, device=dev)
    fixed = [(0, 0), (0, 1), (0, 17), (2047, 1), (2048 - K1_S, K1_S)]
    for row, (c, n) in enumerate(fixed):
        ctx[row], new[row] = c, n
    valid = ctx + new
    nblk = (valid + K1_BLOCK_SIZE - 1) // K1_BLOCK_SIZE
    table = torch.randint(1, K1_NUM_BLOCKS, (K1_ROWS, K1_MAX_BLOCKS), generator=gen,
                          device=dev)
    table = torch.where(torch.arange(K1_MAX_BLOCKS, device=dev)[None] < nblk[:, None],
                        table, 0)
    scales = {}
    if quantized:
        pk, sk = kv_quantize_int8(pk)
        pv, sv = kv_quantize_int8(pv)
        scales = dict(scale_k=sk, scale_v=sv)
    else:
        pk, pv = pk.bfloat16(), pv.bfloat16()
    args = (q.bfloat16(), pk, pv, table.int(), valid.int(), ctx.int())
    kw = dict(sm_scale=K1_HEAD_DIM ** -0.5, num_repeat_kv=K1_HEADS // K1_KV_HEADS,
              **scales)
    return args, kw


def k1_bound_ms(args, kw) -> tuple:
    """Least time for the work these inputs need: every visible K/V slot
    read once (plus q, tables, scales, and the output written once), and
    two dot products of head_dim per visible slot and query head."""
    q, pk, _, table, valid, base = args
    rows, s, n, h = q.shape
    n_kv = pk.shape[2]
    v = valid.long().cpu()
    b = base.long().cpu()
    kv_bytes = int(v.sum()) * n_kv * h * pk.element_size() * 2
    if "scale_k" in kw:
        kv_bytes += int(v.sum()) * n_kv * 4 * 2
    moved = (kv_bytes + 2 * q.numel() * q.element_size()
             + (table.numel() + 2 * rows) * 4)
    steps = torch.arange(s)
    visible = torch.minimum(v[:, None], b[:, None] + steps[None] + 1).clamp_min(0)
    flops = int(visible.sum()) * n * h * 2 * 2
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k2_bound_ms(x: torch.Tensor) -> tuple:
    d = x.shape[-1]
    moved = 2 * x.numel() * x.element_size() + d * x.element_size()
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, 4 * x.numel() / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bound(moved_bytes: float, flops: float) -> tuple:
    t_bytes, t_ops = moved_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k3_bound_ms(x: torch.Tensor) -> tuple:
    """Read x, g and w, write dx and dw: what the function needs, not the
    kernel's own f32 dw partials; about ten operations an element."""
    d = x.shape[-1]
    moved = 3 * x.numel() * x.element_size() + 2 * d * x.element_size()
    return bound(moved, 10 * x.numel())


def flash_flops(b: int, s: int, n: int, d: int) -> int:
    """The causal forward's products over the pairs it needs (k <= q):
    2 products x 2 operations x d for each of b*n*s*(s+1)/2 pairs, about
    2*b*n*d*s^2 (the causal half of 4*b*n*d*s^2)."""
    return 4 * d * b * n * s * (s + 1) // 2


def k4_bound_ms(q, k) -> tuple:
    b, s, n, d = q.shape
    moved = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size() + b * n * s * 4
    return bound(moved, flash_flops(b, s, n, d))


def k5_bound_ms(q, k) -> tuple:
    """Read q, k, v, out, dO and the lse; write dq, dk, dv. Five products
    (S, dP, dV, dK, dQ): 2.5x the forward's operations."""
    b, s, n, d = q.shape
    qb, kb = q.numel() * q.element_size(), k.numel() * k.element_size()
    moved = 4 * qb + 4 * kb + b * n * s * 4
    return bound(moved, 2.5 * flash_flops(b, s, n, d))


def time_ms(fn, reps: int = 20) -> tuple:
    """(device ms, launch ms) of one call of ``fn``. Device ms: the sum of
    the CUDA kernels and copies the call runs, from ``torch.profiler``
    (CUPTI), averaged over ``reps`` calls; where the profiler sees no
    device time, CUDA events around ``reps`` back-to-back calls. Launch
    ms: CUDA events around one call at a time (median), which for a
    small kernel is the host's launch cost, not the kernel's."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    launch_ms = statistics.median(samples)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device_us = sum(getattr(e, "self_device_time_total", 0) or 0
                    for e in prof.key_averages())
    if device_us > 0:
        return device_us / reps / 1e3, launch_ms
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, launch_ms


# ---------------------------------------------------------------- phases
def build_kernels() -> float:
    """Build every kernel of the serving and training paths; returns seconds."""
    from scaling_tpu_torch.ops import cuda_build, rms_norm, rms_norm_bwd

    t0 = time.monotonic()
    sources = ("paged_attention", "flash_attention")
    for name in sources:
        cuda_build.start(name)  # one nvcc per source, all in the background
    dev = torch.device("cuda")
    for rows, d in K2_SHAPES + K3_SHAPES:  # Triton compiles at first launch
        x = torch.ones(rows, d, device=dev, dtype=torch.bfloat16)
        w = torch.ones(d, device=dev, dtype=torch.bfloat16)
        rms_norm(x, w, 1e-5)
        rms_norm_bwd(x, w, x, 1e-5)
    for name in sources:
        cuda_build.load(name)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    for name in sources:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    return seconds


def check_kernels() -> dict:
    """Each kernel against its plain version at serving shapes."""
    from scaling_tpu_torch.ops import paged_attention, paged_attention_plain
    from scaling_tpu_torch.ops import rms_norm, rms_norm_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    errs = {}
    for name, quantized in (("paged_attention", False), ("paged_attention_int8", True)):
        args, kw = k1_inputs(gen, quantized, dev)
        out = paged_attention(*args, **kw)
        ref = paged_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"{name}: non-finite output")
        if not bool((out[0] == 0).all()):
            raise AssertionError(f"{name}: the valid_len 0 row is not zeros")
        errs[name] = (out.float() - ref.float()).abs().max().item()
        print(f"  {name}: max_abs_err={errs[name]:.3e} (atol=rtol={KERNEL_TOL})")
        torch.testing.assert_close(out.float(), ref.float(), atol=KERNEL_TOL,
                                   rtol=KERNEL_TOL)
    err = 0.0
    for rows, d in K2_SHAPES:
        x = torch.randn(rows, d, generator=gen, device=dev).bfloat16()
        w = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).bfloat16()
        out, ref = rms_norm(x, w, 1e-5), rms_norm_plain(x, w, 1e-5)
        torch.cuda.synchronize()
        err = max(err, (out.float() - ref.float()).abs().max().item())
        torch.testing.assert_close(out.float(), ref.float(), atol=KERNEL_TOL,
                                   rtol=KERNEL_TOL)
    errs["rms_norm"] = err
    print(f"  rms_norm {K2_SHAPES}: max_abs_err={err:.3e} (atol=rtol={KERNEL_TOL})")
    return errs


def flash_inputs(gen, documents: int, dev):
    """Training-shaped K4/K5 operands: q already scaled (the wrapper's job),
    k and v unrepeated, segment ids of ``documents`` packed documents."""
    b, s, n, n_kv, d = (FLASH_SHAPE[k] for k in ("b", "s", "n", "n_kv", "d"))
    q = (torch.randn(b, s, n, d, generator=gen, device=dev) * d ** -0.5).bfloat16()
    k = torch.randn(b, s, n_kv, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, s, n_kv, d, generator=gen, device=dev).bfloat16()
    seg = torch.zeros(b, s, dtype=torch.int32, device=dev)
    for cut in sorted(torch.randint(1, s, (documents - 1,), generator=gen, device=dev).tolist()):
        seg[:, cut:] += 1
    return q, k, v, seg


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def check_training_kernels() -> dict:
    """K2, K3, K4 and K5 against their plain versions at training shapes;
    K5's gradients and K3's dw must repeat bitwise."""
    from scaling_tpu_torch.ops import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_fwd,
        flash_attention_plain,
        rms_norm,
        rms_norm_bwd,
        rms_norm_bwd_plain,
        rms_norm_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    errs = {"rms_norm": 0.0, "rms_norm_bwd": 0.0, "flash_attention_fwd": 0.0,
            "flash_attention_bwd": 0.0}
    for rows, d in K3_SHAPES:
        x = (3 * torch.randn(rows, d, generator=gen, device=dev)).bfloat16()
        w = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).bfloat16()
        g = torch.randn(rows, d, generator=gen, device=dev).bfloat16()
        y, y_ref = rms_norm(x, w, 1e-5), rms_norm_plain(x, w, 1e-5)
        torch.cuda.synchronize()
        errs["rms_norm"] = max(errs["rms_norm"], (y.float() - y_ref.float()).abs().max().item())
        print(f"  rms_norm ({rows}, {d}): max_abs_err={errs['rms_norm']:.3e} "
              f"(atol=rtol={KERNEL_TOL})")
        torch.testing.assert_close(y.float(), y_ref.float(), atol=KERNEL_TOL, rtol=KERNEL_TOL)
        (dx, dw), (dx2, dw2) = rms_norm_bwd(x, w, g, 1e-5), rms_norm_bwd(x, w, g, 1e-5)
        ref_dx, ref_dw = rms_norm_bwd_plain(x, w, g, 1e-5)
        torch.cuda.synchronize()
        if not torch.equal(dw, dw2) or not torch.equal(dx, dx2):
            raise AssertionError(f"rms_norm_bwd ({rows}, {d}): repeats differ")
        torch.testing.assert_close(dx.float(), ref_dx.float(), atol=KERNEL_TOL, rtol=KERNEL_TOL)
        dx_err = (dx.float() - ref_dx.float()).abs().max().item()
        dw_err = rel_err(dw, ref_dw)
        print(f"  rms_norm_bwd ({rows}, {d}): dx max_abs_err={dx_err:.3e} "
              f"(atol=rtol={KERNEL_TOL}) dw max_err/max|dw|={dw_err:.3e} (tol {K3_DW_TOL}); "
              "repeats bitwise equal")
        if not dw_err <= K3_DW_TOL:
            raise AssertionError(f"rms_norm_bwd dw disagrees: {dw_err}")
        errs["rms_norm_bwd"] = max(errs["rms_norm_bwd"], dx_err)
    for name, documents, n_local, window in FLASH_CASES:
        q, k, v, seg = flash_inputs(gen, documents, dev)
        out, lse = flash_attention_fwd(q, k, v, seg, n_local, window)
        ref_out, ref_lse = flash_attention_plain(q, k, v, seg, n_local, window)
        torch.cuda.synchronize()
        out_err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        print(f"  flash_attention_fwd {name}: out max_abs_err={out_err:.3e} "
              f"(atol=rtol={FLASH_OUT_TOL}) lse max_abs_err={lse_err:.3e} (atol {LSE_TOL})")
        torch.testing.assert_close(out.float(), ref_out.float(), atol=FLASH_OUT_TOL,
                                   rtol=FLASH_OUT_TOL)
        torch.testing.assert_close(lse, ref_lse, atol=LSE_TOL, rtol=0)
        dout = torch.randn(q.shape, generator=gen, device=dev).bfloat16()
        grads = flash_attention_bwd(q, k, v, out, lse, dout, seg, n_local, window)
        again = flash_attention_bwd(q, k, v, out, lse, dout, seg, n_local, window)
        refs = flash_attention_bwd_plain(q, k, v, out, lse, dout, seg, n_local, window)
        torch.cuda.synchronize()
        gerrs, gabs = {}, 0.0
        for gname, got, rep, ref in zip(("dq", "dk", "dv"), grads, again, refs):
            if not torch.equal(got, rep):
                raise AssertionError(f"flash_attention_bwd {name}: {gname} repeats differ")
            gerrs[gname] = rel_err(got, ref)
            gabs = max(gabs, (got.float() - ref.float()).abs().max().item())
        print(f"  flash_attention_bwd {name}: max_err/max|ref| "
              + " ".join(f"{g}={e:.3e}" for g, e in gerrs.items())
              + f" (tol {FLASH_GRAD_TOL}); repeats bitwise equal")
        if not max(gerrs.values()) <= FLASH_GRAD_TOL:
            raise AssertionError(f"flash_attention_bwd {name} disagrees: {gerrs}")
        errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"], out_err)
        errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], gabs)
        del q, k, v, out, lse, ref_out, ref_lse, dout, grads, again, refs
        torch.cuda.empty_cache()
    return errs


def recompute_on_cpu(inf, captured) -> tuple:
    """The captured tick once more on the CPU in f32, through the plain
    versions, from the pool copy taken before the card ran it."""
    from scaling_tpu_torch.models.transformer import TransformerInferenceModule
    from scaling_tpu_torch.serve.kvcache import PagedKVPools

    arch32 = dataclasses.replace(inf.architecture, precision="float32")
    state = {k: v.float().cpu() for k, v in inf.model.state_dict().items()}
    cpu_inf = TransformerInferenceModule.from_state_dict(arch32, state, device="cpu")
    pools, inp, card_logits = captured
    cpu_pools = PagedKVPools(*[
        None if p is None else [t.cpu() for t in p]
        for p in (pools.pool_k, pools.pool_v, pools.scale_k, pools.scale_v)
    ], block_size=pools.block_size)
    width = inp.tokens.shape[1]
    tokens, ctx = torch.from_numpy(inp.tokens), torch.from_numpy(inp.ctx)
    new_lens = torch.from_numpy(inp.new_lens)
    pos = ctx[:, None] + torch.arange(width, dtype=torch.int32)
    logits = cpu_inf._run_layers(
        cpu_inf._make_batch(tokens, pos),
        cpu_pools.views(torch.from_numpy(inp.tables), ctx, new_lens),
        gather_start=(new_lens - 1).clamp(0, width - 1), gather_width=1,
    )
    card = card_logits.float().cpu()
    err = (card - logits).abs().max().item()
    scale = logits.abs().max().item()
    agree = (card.argmax(-1) == logits.argmax(-1)).float().mean().item()
    return err, scale, agree


def profile_ticks(engine, vocab: int, n_ticks: int = 30) -> dict:
    """Where a steady tick's time goes: 16 requests of 256-512 prompt
    tokens, ``n_ticks`` ticks traced with ``torch.profiler`` (device
    activity only, to keep the tracer's host cost low) after 8 ticks of
    warm-up. Device busy time is the sum of the kernels' device time
    (one stream: they do not overlap); the idle share is the rest of the
    host's wall clock over those ticks."""
    from torch.profiler import ProfilerActivity, profile

    from scaling_tpu_torch.serve.bench import sample_workload

    for _, prompt, olen in sample_workload(16, 1000.0, (256, 512), (64, 64), vocab, 5):
        engine.submit(prompt, olen)
    for _ in range(8):
        engine.tick()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n_ticks):
            engine.tick()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    engine.run_until_done()
    groups = {"paged_attention": 0.0, "rms_norm": 0.0, "gemm": 0.0, "other": 0.0}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        name = e.key.lower()
        if "paged_attention" in name:
            groups["paged_attention"] += us
        elif "rms_norm" in name:
            groups["rms_norm"] += us
        elif any(k in name for k in ("gemm", "nvjet", "cutlass", "sm90_xmma")):
            groups["gemm"] += us
        else:
            groups["other"] += us
    busy_ms = sum(groups.values()) / 1e3
    return {
        "tick_ms": wall_ms / n_ticks,
        "device_busy_ms_per_tick": busy_ms / n_ticks,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_ms_per_tick": {k: v / 1e3 / n_ticks for k, v in groups.items()},
    }


def serve(kv_dtype: str) -> dict:
    """The 0.5B model through the engine, counters reset just before the
    measured run and read just after."""
    from scaling_tpu_torch.ops import launches
    from scaling_tpu_torch.serve import EngineConfig, ServeEngine
    from scaling_tpu_torch.serve.bench import build_inference, run_bench, sample_workload

    dev = torch.device("cuda")
    inf = build_inference("0.5b", seed=0, device=dev)
    n_params = sum(p.numel() for p in inf.model.parameters())
    engine = ServeEngine(inf, EngineConfig(kv_dtype=kv_dtype, **SERVE), device=dev)
    engine.submit(list(range(1, 41)), 4)  # warm-up request, off the books
    engine.run_until_done()

    captured = {}
    forward = engine._forward_mixed
    calls = [0]

    def capture(inp):
        calls[0] += 1
        if calls[0] != RECOMPUTE_TICK:
            return forward(inp)
        snapshot = type(engine.pools)(*[
            None if p is None else [t.clone() for t in p]
            for p in (engine.pools.pool_k, engine.pools.pool_v,
                      engine.pools.scale_k, engine.pools.scale_v)
        ], block_size=engine.pools.block_size)
        logits, sampled = forward(inp)
        captured["tick"] = (snapshot, inp, logits.clone())
        return logits, sampled

    engine._forward_mixed = capture
    work = sample_workload(WORKLOAD["n_requests"], WORKLOAD["rate"],
                           WORKLOAD["prompt_len"], WORKLOAD["output_len"],
                           inf.architecture.vocab_size, WORKLOAD["seed"])
    launches.reset()
    stats = run_bench(engine, work)
    torch.cuda.synchronize()
    kernel, plain = dict(launches.KERNEL), dict(launches.PLAIN)
    engine._forward_mixed = forward

    finished = {s.request.req_id: s for s in engine.finished}
    for i, (_, _, olen) in enumerate(work):
        seq = finished.get(i + 1)  # id 0 was the warm-up request
        if seq is None or len(seq.generated) != olen or seq.finish_status != "completed":
            raise AssertionError(f"{kv_dtype}: request {i} did not complete {olen} tokens")
    paged = "paged_attention_int8" if kv_dtype == "int8" else "paged_attention"
    if kernel.get(paged, 0) <= 0 or kernel.get("rms_norm", 0) <= 0:
        raise AssertionError(f"{kv_dtype}: kernels not launched on the main path: {kernel}")
    if sum(plain.values()) != 0:
        raise AssertionError(f"{kv_dtype}: plain versions ran on the card: {plain}")
    err, scale, agree = recompute_on_cpu(inf, captured["tick"])
    print(f"  {kv_dtype}: params={n_params} requests={stats['completed']}/"
          f"{stats['requests']} ticks={stats['ticks']} preemptions={stats['preemptions']} "
          f"wall={stats['wall_s']:.3f}s")
    print(f"  {kv_dtype}: output tokens/s={stats['tokens_per_s']:.1f} "
          f"ttft p50={stats['ttft_p50_s']:.4f}s p99={stats['ttft_p99_s']:.4f}s "
          f"itl p50={stats['itl_p50_s']:.4f}s p99={stats['itl_p99_s']:.4f}s")
    print(f"  {kv_dtype}: launches kernel={kernel} plain={plain} "
          f"per tick: {paged}={kernel[paged] / stats['ticks']:.2f} "
          f"rms_norm={kernel['rms_norm'] / stats['ticks']:.2f}")
    print(f"  {kv_dtype}: tick {RECOMPUTE_TICK} recomputed on CPU f32: "
          f"max_abs_err={err:.4e} max|logit|={scale:.4e} "
          f"(tol {TICK_TOL} x max|logit|) argmax agreement={agree:.3f}")
    if not err <= TICK_TOL * scale:
        raise AssertionError(f"{kv_dtype}: tick recompute disagrees: {err} > {TICK_TOL * scale}")
    prof = profile_ticks(engine, inf.architecture.vocab_size)
    print(f"  {kv_dtype}: steady ticks (torch.profiler): tick={prof['tick_ms']:.3f}ms "
          f"device busy={prof['device_busy_ms_per_tick']:.3f}ms "
          f"idle share={prof['device_idle_share']:.3f} device ms/tick by kernel: "
          + " ".join(f"{k}={v:.3f}" for k, v in prof["device_ms_per_tick"].items()))
    stats["launches"] = kernel
    del engine, inf
    torch.cuda.empty_cache()
    return stats


def recompute_train_row(module, batch) -> dict:
    """The first row of the first micro-batch, before any update, on the
    card (bf16, the kernels) and on the CPU in f32 through the plain
    versions, from a copy of the weights. One row, not the micro-batch's
    four: the CPU's f32 forward of the 0.5B model costs ~2 TFLOP a row.

    The logits are compared, not the loss: at random weights the loss sits
    near ln(vocab) whatever the forward does. ``err`` is max |card - cpu|
    over max |cpu|; ``uniform_err`` is the least ``err`` a forward giving
    each position constant logits could reach (half the widest row's range),
    which the tolerance must stay below for the check to tell."""
    from scaling_tpu_torch.models.transformer import TransformerModel, loss_function
    from scaling_tpu_torch.parallel import ParallelModule

    row = {k: v[0, :1] for k, v in batch.items()}
    with torch.no_grad():
        card_out = module.forward(row)
        card_loss = loss_function(card_out, row)[0].item()
        card = card_out["activations"].float().cpu()
        del card_out
        arch32 = dataclasses.replace(module.model.architecture, precision="float32")
        cpu_model = TransformerModel(arch32, device="cpu")
        cpu_model.load_state_dict({k: v.float().cpu() for k, v in
                                   module.model.state_dict().items()})
        cpu_module = ParallelModule(cpu_model, module.topology)
        cpu_row = {k: v.cpu() for k, v in row.items()}
        cpu_out = cpu_module.forward(cpu_row)
        cpu_loss = loss_function(cpu_out, cpu_row)[0].item()
        cpu = cpu_out["activations"]
    scale = cpu.abs().max().item()
    return {
        "card_loss": card_loss, "cpu_loss": cpu_loss, "scale": scale,
        "err": (card - cpu).abs().max().item() / scale,
        "uniform_err": ((cpu.amax(-1) - cpu.amin(-1)) / 2).max().item() / scale,
        "agree": (card.argmax(-1) == cpu.argmax(-1)).float().mean().item(),
    }


TRAIN_GROUPS = (("flash_fwd", ("flash_fwd",)), ("flash_bwd", ("flash_bwd",)),
                ("rms_fwd", ("rms_norm_fwd",)), ("rms_bwd", ("rms_norm_bwd", "sum_partials")),
                ("gemm", ("gemm", "nvjet", "cutlass", "sm90_xmma", "cublas")),
                ("optimizer_foreach", ("multi_tensor_apply", "foreach")))


def profile_train_step(step, batch) -> dict:
    """One training step under ``torch.profiler`` (device activity only):
    the device's busy time (the kernels' sum; one stream), its idle share
    of the host's wall clock, and the device time by kernel group."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    groups = {name: 0.0 for name, _ in TRAIN_GROUPS}
    groups["other"] = 0.0
    other = []
    for e in prof.key_averages():
        ms = (getattr(e, "self_device_time_total", 0) or 0) / 1e3
        key = e.key.lower()
        group = next((g for g, pats in TRAIN_GROUPS if any(p in key for p in pats)), "other")
        groups[group] += ms
        if group == "other" and ms > 0:
            other.append((ms, e.count, e.key[:90]))
    busy = sum(groups.values())
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms), "device_ms": groups,
            "top_other": sorted(other, reverse=True)[:8]}


def train() -> dict:
    """The 0.5B training step (bench.py's first rung), counters reset just
    before the warm-up and timed steps and read just after."""
    from scaling_tpu_torch.models.transformer import loss_function
    from scaling_tpu_torch.models.transformer.utils.get_tflops import (
        get_model_parameter_count,
        get_palm_mfu,
    )
    from scaling_tpu_torch.ops import launches
    from scaling_tpu_torch.train.bench import build, synth_batch, timed_windows

    dev = torch.device("cuda")
    config, module, optimizer = build("0.5b", TRAIN_SEQ, TRAIN_MBS, device=dev, seed=0)
    arch = config.transformer_architecture
    n_params = sum(p.numel() for p in module.model.parameters())
    step = module.build_train_step(optimizer, loss_function)
    batch = synth_batch(np.random.default_rng(0), TRAIN_MBS, TRAIN_SEQ, arch.vocab_size, 1, dev)
    t0 = time.monotonic()
    rec = recompute_train_row(module, batch)
    print(f"  first row before any update, card bf16 vs cpu f32 (plain versions): logits "
          f"max_abs_err={rec['err'] * rec['scale']:.4e} max|logit|={rec['scale']:.4e} "
          f"err/max|logit|={rec['err']:.3e} (tol {TRAIN_LOGIT_TOL}; constant logits would "
          f"give >= {rec['uniform_err']:.3e}) argmax agreement={rec['agree']:.3f}; "
          f"loss card={rec['card_loss']:.5f} cpu={rec['cpu_loss']:.5f} "
          f"({time.monotonic() - t0:.1f}s)")
    if not rec["uniform_err"] > TRAIN_LOGIT_TOL:
        raise AssertionError(f"constant logits would pass the logit check: {rec}")
    if not rec["err"] <= TRAIN_LOGIT_TOL:
        raise AssertionError(f"train logits recompute disagrees: {rec}")

    launches.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    losses = [float(step(batch)[0]) for _ in range(TRAIN_WARMUP)]
    seconds, timed = timed_windows(step, batch, dev, TRAIN_STEPS, windows=1)
    kernel, plain = dict(launches.KERNEL), dict(launches.PLAIN)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    losses += timed
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    needed = ("rms_norm", "rms_norm_bwd", "flash_attention_fwd", "flash_attention_bwd")
    if any(kernel.get(k, 0) <= 0 for k in needed):
        raise AssertionError(f"training kernels not launched on the main path: {kernel}")
    if sum(plain.values()) != 0:
        raise AssertionError(f"plain versions ran on the card in training: {plain}")
    tokens_per_s = TRAIN_MBS * TRAIN_SEQ / seconds[0]
    mfu = get_palm_mfu(get_model_parameter_count(arch.hidden_size, arch.num_layers,
                                                 arch.vocab_size, arch.mlp_factor, glu=True),
                       arch.num_layers, arch.hidden_size, arch.sequence_length, tokens_per_s)
    print(f"  params={n_params} mbs={TRAIN_MBS} seq={TRAIN_SEQ} steps={TRAIN_WARMUP} warm-up "
          f"+ {TRAIN_STEPS} timed: step={seconds[0] * 1e3:.2f}ms tokens/s={tokens_per_s:.1f} "
          f"mfu={mfu:.4f} peak max_memory_allocated={peak_gb:.2f}GB")
    print(f"  losses: first={losses[0]:.5f} last={losses[-1]:.5f} all finite")
    print(f"  launches kernel={kernel} plain={plain} per step: "
          + " ".join(f"{k}={kernel[k] / n_steps:.2f}" for k in needed))
    prof = profile_train_step(step, batch)
    print(f"  profiled step (torch.profiler): wall={prof['wall_ms']:.3f}ms device busy="
          f"{prof['device_busy_ms']:.3f}ms idle share={prof['device_idle_share']:.3f} "
          "device ms by group: " + " ".join(f"{k}={v:.3f}" for k, v in prof["device_ms"].items()))
    for ms, count, name in prof["top_other"]:
        print(f"    other: {ms:.3f}ms in {count} launches: {name}")
    del module, optimizer, step, batch
    torch.cuda.empty_cache()
    return kernel


def time_kernels(errs: dict, launches_by_path: dict) -> list:
    """One row a kernel. ``launches`` is the sum over the main-path runs,
    ``launches_by_path`` each run's own count (``launches_by_path`` maps a
    run's name to the counters read just after it)."""
    import torch.nn.functional as F

    from scaling_tpu_torch.ops import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_fwd,
        flash_attention_plain,
        paged_attention,
        paged_attention_plain,
        rms_norm,
        rms_norm_bwd,
        rms_norm_bwd_plain,
        rms_norm_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    rows = []

    def row(name, route, source, replaces, fn, plain_fn, bound_ms, library_fn=None):
        by_path = {path: counts.get(name, 0) for path, counts in launches_by_path.items()}
        rows.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path, max_abs_err=errs[name],
            ms=time_ms(fn), plain_ms=time_ms(plain_fn), bound_ms=bound_ms[0],
            bound_by=bound_ms[1], library_ms=time_ms(library_fn) if library_fn else None,
        ))

    for name, quantized in (("paged_attention", False), ("paged_attention_int8", True)):
        args, kw = k1_inputs(gen, quantized, dev)
        row(name, "cuda", "scaling_tpu_torch/csrc/paged_attention.cu",
            "scaling_tpu/nn/paged_attention.py:163",
            lambda: paged_attention(*args, **kw), lambda: paged_attention_plain(*args, **kw),
            k1_bound_ms(args, kw))
    for rows_k2, d in (K2_SHAPES[0], K3_SHAPES[0]):  # serving ticks; a training micro-batch
        x = torch.randn(rows_k2, d, generator=gen, device=dev).bfloat16()
        w = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).bfloat16()
        dev_ms, call_ms = time_ms(lambda: rms_norm(x, w, 1e-5))
        print(f"  rms_norm ({rows_k2}, {d}): device ms={dev_ms:.4f} per call={call_ms:.4f} "
              f"bound={k2_bound_ms(x)[0]:.4f}")
    row("rms_norm", "triton", "scaling_tpu_torch/ops/_rms_norm_triton.py",
        "scaling_tpu/ops/rms_norm.py:107",
        lambda: rms_norm(x, w, 1e-5), lambda: rms_norm_plain(x, w, 1e-5), k2_bound_ms(x),
        lambda: F.rms_norm(x, (d,), w, 1e-5))

    g = torch.randn(x.shape, generator=gen, device=dev).bfloat16()
    xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
    y_lib = F.rms_norm(xr, (d,), wr, 1e-5)  # the library yardstick: autograd of F.rms_norm
    row("rms_norm_bwd", "triton", "scaling_tpu_torch/ops/_rms_norm_bwd_triton.py",
        "scaling_tpu/ops/rms_norm.py:130",
        lambda: rms_norm_bwd(x, w, g, 1e-5), lambda: rms_norm_bwd_plain(x, w, g, 1e-5),
        k3_bound_ms(x),
        lambda: torch.autograd.grad(y_lib, (xr, wr), g, retain_graph=True))

    q, k, v, seg = flash_inputs(gen, 1, dev)
    out, lse = flash_attention_fwd(q, k, v, seg)
    dout = torch.randn(q.shape, generator=gen, device=dev).bfloat16()
    # the library yardstick: SDPA in its (b, n, s, d) layout, laid out once, untimed
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    y_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=1.0,
                                            enable_gqa=True)
    dout_t = dout.transpose(1, 2).contiguous()
    row("flash_attention_fwd", "cuda", "scaling_tpu_torch/csrc/flash_attention.cu",
        "scaling_tpu/ops/flash_attention.py:160",
        lambda: flash_attention_fwd(q, k, v, seg), lambda: flash_attention_plain(q, k, v, seg),
        k4_bound_ms(q, k),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=1.0,
                                               enable_gqa=True))
    row("flash_attention_bwd", "cuda", "scaling_tpu_torch/csrc/flash_attention.cu",
        "scaling_tpu/ops/flash_attention.py:160",
        lambda: flash_attention_bwd(q, k, v, out, lse, dout, seg),
        lambda: flash_attention_bwd_plain(q, k, v, out, lse, dout, seg),
        k5_bound_ms(q, k),
        lambda: torch.autograd.grad(y_sdpa, (qt, kt, vt), dout_t, retain_graph=True))
    for r in rows:
        launch = {k: r[k][1] for k in ("ms", "plain_ms", "library_ms") if r[k]}
        for k in launch:
            r[k] = r[k][0]  # the JSON line carries device time
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {r['name']}: device ms={r['ms']:.4f} plain={r['plain_ms']:.4f} "
              f"library={lib} bound={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"launches={r['launches']} {r['launches_by_path']}; per call with launch (events): "
              + " ".join(f"{k}={v:.4f}" for k, v in launch.items()))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import scaling_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = card_line()
    print(f"== card: {card}")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise AssertionError(f"needs compute capability (9, 0), found {cap}")
    print(f"== torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t_start = time.monotonic()
    print("== build")
    print(f"  kernels built in {build_kernels():.1f}s")
    print("== kernels vs plain versions")
    errs = check_kernels()
    for name, err in check_training_kernels().items():
        errs[name] = max(err, errs.get(name, 0.0))
    print("== serve 0.5B (full width and depth, random weights, seed 0)")
    launches_by_path = {f"serve_{kv_dtype}": serve(kv_dtype)["launches"]
                        for kv_dtype in ("native", "int8")}
    print("== train 0.5B (full width and depth, random weights, seed 0; mbs 4, seq 2048)")
    launches_by_path["train"] = train()
    print("== kernel times (device: torch.profiler; per call: CUDA events)")
    rows = time_kernels(errs, launches_by_path)
    print(f"== done in {time.monotonic() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
