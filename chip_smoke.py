#!/usr/bin/env python3
"""Drive the PyTorch port (scaling_tpu_torch) on one CUDA card.

Phases, each of which must pass:

1. print the card (nvidia-smi name and power limit) and require compute
   capability 9.0;
2. build every kernel of the serving and the training path from this
   checkout's sources (nvcc for the CUDA kernels, one process per source,
   all started together; Triton's compiler for the Triton ones) and print
   the build time, and each CUDA kernel's registers, spills and dynamic
   shared memory from ``ptxas -v``: a flash or paged kernel that spills
   fails;
3. hold each kernel against its plain PyTorch version on the same inputs
   at the shapes its path gives it, and print the max error beside the
   tolerance: K1 (native and int8) at the serving tick's shape and on one
   row of 2048 slots, each also repeated, which must give the same bits;
   K2 at serving shapes; K3 (RMSNorm backward) at the
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
6. generate with two models at full width and depth (random weights from
   seed 0): (a) the same 0.5B model, (b) its widths in the JAX default
   architecture (layernorm, GELU MLP x4, tied head, key/query norm), bf16
   with flash. 8 prompts of 256-1024 tokens (the longest exactly 1024, so
   the left-padded prefill runs K4) and 128 greedy tokens each, four times
   (every row returns its tokens, the same in every run), and one 1-D
   prompt; K4 launched on both and K2 on (a), no plain version run; the
   most-padded row recomputed on the CPU in f32 with the port's
   ``logits()``: every generated position's logits within 0.05 of max
   |logit| of the card's (not constant per position), and every token whose
   CPU top-2 margin exceeds twice that error is the CPU's argmax; print the
   prefill ms, the median decode ms a token, output tokens/s, peak memory,
   and the busy ms and idle share of a profiled window of 32 decode steps;
7. time each kernel, its plain version and, where one PyTorch call
   computes the same function, that call: device time from
   ``torch.profiler``, and the per-call time with CUDA events;
8. the Trainer (``models/transformer/train.py:main``) trains the same
   model at full width and depth from token datasets the port's builder
   writes from seed 0 (two blended prefixes of ~2M tokens, documents of
   64-4096 tokens, and a ~64k-token validation prefix), micro-batch 4,
   seq 2048, 6 iterations saving and evaluating at 3 and 6: losses finite,
   6 step records with ``palm_mfu``, two checkpoints that verify; a
   second ``main`` resumes from step 3 with the first run's parameters and
   f32 optimizer state, bitwise, and its step-4 batch; its step-4 loss is
   the first run's, bitwise, and steps 5-6 within rtol 1e-4; the
   checkpoint (``TransformerInferenceModule.from_checkpoint``) serves 4
   greedy requests with the tokens of an engine on the trainer's own
   weights; ``evaluate`` scores the step-6 checkpoint on 2 batches of the
   validation prefix read in order: finite, within 1e-4 nats of the
   trainer's forward on its in-memory step-6 weights over the same batches
   (a limit the step-3 checkpoint must miss) and within 0.05 nats of the
   trainer's step-6 eval loss, launching K2 and K4 and no plain version;
   K1-K5 launched
   and no plain version run; print the steady
   step ms beside phase 5's, and checkpoint save and load seconds, GB/s
   and size. The checkpoints go to a temporary directory outside the
   checkout, removed at the end;

then print one ``{"kernels": [...]}`` line (K4 and K5 also with their
achieved ``tflops``: the bound's operations over the device time; K1 with
its achieved ``gbps``: the bound's bytes over the device time), the
card line, and as the last line ``{"ok": true, "device": {...}}``. Any
failure exits non-zero, and nothing is printed as a result without a card.

Run from the root of a checkout: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# dense peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

K1_ROWS, K1_S, K1_HEADS, K1_KV_HEADS, K1_HEAD_DIM = 16, 32, 16, 4, 128
K1_NUM_BLOCKS, K1_BLOCK_SIZE, K1_MAX_BLOCKS = 1024, 16, 128
K1_LONG_ROW = ((2048 - 32, 32),)  # one row: a 32-token chunk ending the 2048-slot window
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
# the Trainer: token datasets from seed 0, 6 iterations saving and evaluating at 3
TRAINER = dict(model="0.5b", seq=TRAIN_SEQ, mbs=TRAIN_MBS, tokens=2_000_000,
               valid_tokens=64_000, doc_len=(64, 4096), iterations=6, interval=3,
               eval_iterations=2, serve_requests=4, serve_prompt=(64, 256), serve_output=32)
RESUME_RTOL = 1e-4  # steps 5-6 after the resume: the embedding backward adds with atomics
EVAL_NATS = 0.05  # evaluate's loss on the step-6 checkpoint vs the trainer's step-6 eval loss
EVAL_REF_NATS = 1e-4  # evaluate vs the trainer's forward on its in-memory weights, same batches
# generation: 8 prompts of 256-1024 tokens (the longest exactly 1024, so the
# left-padded prefill is 1024 wide and K4 runs), 128 greedy tokens each
GEN = dict(batch=8, prompt_len=(256, 1024), max_tokens=128, seed=0, profile=(16, 48))
GEN_LOGIT_TOL = 0.05  # max |logit error| / max |logit|: bf16 through 8 layers vs f32
# the bench 0.5B model in the JAX default architecture: its widths, other keys
DEFAULT_ARCH = dict(norm_type="layernorm", layernorm={"optimization_type": "torch"},
                    mlp_type="default", mlp_factor=4.0, activation_function="gelu",
                    weight_tying=True, key_query_norm=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- inputs
def k1_inputs(gen: torch.Generator, quantized: bool, dev, contexts=None):
    """Serving-shaped K1 operands: one mixed tick of 16 rows of width 32
    over a 1024-block pool, rows of every kind (idle, fresh decode, a
    short chunk, decode and chunk at the full 2048-slot context); or, with
    ``contexts``, one row per (context, new tokens) pair."""
    from scaling_tpu_torch.nn.attention import kv_quantize_int8

    rows = K1_ROWS if contexts is None else len(contexts)
    pool_shape = (K1_NUM_BLOCKS, K1_BLOCK_SIZE, K1_KV_HEADS, K1_HEAD_DIM)
    q = torch.randn(rows, K1_S, K1_HEADS, K1_HEAD_DIM, generator=gen, device=dev)
    pk = torch.randn(pool_shape, generator=gen, device=dev)
    pv = torch.randn(pool_shape, generator=gen, device=dev)
    if contexts is None:
        ctx = torch.randint(0, 2048 - K1_S, (rows,), generator=gen, device=dev)
        new = torch.randint(1, K1_S + 1, (rows,), generator=gen, device=dev)
        fixed = [(0, 0), (0, 1), (0, 17), (2047, 1), (2048 - K1_S, K1_S)]
    else:
        ctx = torch.zeros(rows, dtype=torch.int64, device=dev)
        new = torch.zeros(rows, dtype=torch.int64, device=dev)
        fixed = contexts
    for row, (c, n) in enumerate(fixed):
        ctx[row], new[row] = c, n
    valid = ctx + new
    nblk = (valid + K1_BLOCK_SIZE - 1) // K1_BLOCK_SIZE
    table = torch.randint(1, K1_NUM_BLOCKS, (rows, K1_MAX_BLOCKS), generator=gen,
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
    (CUPTI), averaged over ``reps`` calls. The profiler now and then
    hands back no device events; it is asked up to 3 times, and only then
    do CUDA events around ``reps`` back-to-back calls stand in, which for
    a kernel shorter than its launch measure the host (a line says so).
    Launch ms: CUDA events around one call at a time (median), which for a
    small kernel is the host's launch cost, not the kernel's."""
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
    parts = device_ms_by_kernel(fn, reps)
    if parts:
        return sum(parts.values()), launch_ms
    print("  (the profiler saw no device time: CUDA events around back-to-back calls)")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, launch_ms


def device_ms_by_kernel(fn, reps: int = 20) -> dict:
    """Device ms one call of ``fn`` spends in each CUDA kernel or copy it
    runs, by short name (``torch.profiler``, CUPTI, over ``reps`` calls).
    The profiler now and then hands back no device events: it is asked up
    to 3 times, and the result is empty if it never saw any."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or 0
            if us > 0:
                short = re.search(r"(\w+_kernel)", e.key)
                name = short.group(1) if short else e.key[:40]
                by_name[name] = by_name.get(name, 0.0) + us / reps / 1e3
        if by_name:
            return by_name
    return {}


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
        for r in kernel_resources(cuda_build.build_log(name)):
            print(f"  ptxas {name}: {r['kernel']} registers={r['registers']} "
                  f"spill={r['spill']} bytes, dynamic smem={r['smem']} bytes")
            if r["kernel"].startswith(("flash_", "paged_")) and r["spill"] > 0:
                raise AssertionError(f"{r['kernel']} spills {r['spill']} bytes")
    return seconds


FLASH_SMEM_INDEX = {"flash_fwd_kernel": 0, "flash_bwd_dkdv_kernel": 1, "flash_bwd_dq_kernel": 2}


def kernel_resources(log: str) -> list:
    """Each entry function of a ``ptxas -v`` log: its short name, registers
    and spill bytes (stores + loads); for a flash kernel, also the dynamic
    shared memory its launcher requests (0 where it requests none)."""
    from scaling_tpu_torch.ops.flash_attention import _library

    rows = []
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            kernel = re.search(r"((?:flash|paged)_[a-z_]*kernel)I", mangled)
            dim = re.search(r"Li(\d+)E", mangled)
            name = kernel.group(1) if kernel else mangled
            label = f"{dim.group(1)}, int8" if dim and "Lb1E" in mangled else (
                dim.group(1) if dim else None)
            rows.append({"kernel": f"{name}<{label}>" if label else name, "spill": 0,
                         "registers": None, "smem": 0})
            if name in FLASH_SMEM_INDEX and dim:
                rows[-1]["smem"] = _library().flash_attention_smem_bytes(
                    int(dim.group(1)), FLASH_SMEM_INDEX[name])
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and rows:
            rows[-1]["spill"] = int(spill.group(1)) + int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and rows:
            rows[-1]["registers"] = int(regs.group(1))
    if not rows:
        raise AssertionError("no ptxas -v lines in the build log")
    return rows


def check_kernels() -> dict:
    """Each kernel against its plain version at serving shapes."""
    from scaling_tpu_torch.ops import paged_attention, paged_attention_plain
    from scaling_tpu_torch.ops import rms_norm, rms_norm_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    errs = {}
    for name, quantized in (("paged_attention", False), ("paged_attention_int8", True)):
        errs[name] = 0.0
        for case, contexts in (("serving tick", None), ("one 2048-slot row", K1_LONG_ROW)):
            args, kw = k1_inputs(gen, quantized, dev, contexts)
            out = paged_attention(*args, **kw)
            again = paged_attention(*args, **kw)
            ref = paged_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise AssertionError(f"{name} {case}: non-finite output")
            if not bool((out[args[4] == 0] == 0).all()):
                raise AssertionError(f"{name} {case}: a valid_len 0 row is not zeros")
            if not torch.equal(out, again):
                raise AssertionError(f"{name} {case}: repeats differ")
            err = (out.float() - ref.float()).abs().max().item()
            errs[name] = max(errs[name], err)
            print(f"  {name} {case}: max_abs_err={err:.3e} (atol=rtol={KERNEL_TOL}); "
                  "repeats bitwise equal")
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


def cpu_f32_copy(inf):
    """The inference module's weights in f32 on the CPU, where its layers
    run the kernels' plain versions."""
    from scaling_tpu_torch.models.transformer import TransformerInferenceModule

    arch32 = dataclasses.replace(inf.architecture, precision="float32")
    state = {k: v.float().cpu() for k, v in inf.model.state_dict().items()}
    return TransformerInferenceModule.from_state_dict(arch32, state, device="cpu")


def recompute_on_cpu(inf, captured) -> tuple:
    """The captured tick once more on the CPU in f32, through the plain
    versions, from the pool copy taken before the card ran it."""
    from scaling_tpu_torch.serve.kvcache import PagedKVPools

    cpu_inf = cpu_f32_copy(inf)
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
        "device_idle_share": 1.0 - busy_ms / wall_ms,
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
            "device_idle_share": 1.0 - busy / wall_ms, "device_ms": groups,
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
    return {"launches": kernel, "step_ms": seconds[0] * 1e3}


# ------------------------------------------------------------ generation
def generation_models() -> dict:
    """(a) the bench 0.5B model; (b) the same widths in the JAX default
    architecture (layernorm, GELU MLP x4, tied head, key/query norm)."""
    from scaling_tpu_torch.serve.bench import MODELS

    return {"0.5b": MODELS["0.5b"], "0.5b_default_arch": dict(MODELS["0.5b"], **DEFAULT_ARCH)}


def generation_prompts(vocab: int) -> list:
    """``GEN["batch"]`` prompts of token ids from ``GEN["seed"]``, lengths in
    ``GEN["prompt_len"]`` with the first exactly the longest and the last
    exactly the shortest."""
    rng = np.random.default_rng(GEN["seed"])
    lo, hi = GEN["prompt_len"]
    lengths = rng.integers(lo, hi + 1, size=GEN["batch"])
    lengths[0], lengths[-1] = hi, lo
    return [rng.integers(1, vocab, size=int(n)).tolist() for n in lengths]


def recompute_generation(inf, prompt: list, out) -> dict:
    """One row's generation once more on the CPU in f32 through the plain
    versions: the port's ``logits()`` over the prompt and the generated
    tokens, read at each generated position, against the card's per-step
    logits. ``err`` is max |card - cpu| over max |cpu|; ``uniform_err`` the
    least ``err`` that constant logits per position could reach; where the
    CPU's top-2 margin exceeds twice the measured error, the generated
    token must be the CPU's argmax (``disagree`` counts those that are not)."""
    ids = out.completion_ids
    cpu = cpu_f32_copy(inf).logits(prompt + ids[:-1])[0, len(prompt) - 1:]
    card = out.logits.float().cpu()
    scale = cpu.abs().max().item()
    err_abs = (card - cpu).abs().max().item()
    top2 = cpu.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * err_abs
    argmax = cpu.argmax(-1)
    tokens = torch.tensor(ids)
    return {
        "err": err_abs / scale, "err_abs": err_abs, "scale": scale,
        "uniform_err": ((cpu.amax(-1) - cpu.amin(-1)) / 2).max().item() / scale,
        "sure": int(sure.sum()), "disagree": int((sure & (tokens != argmax)).sum()),
        "argmax_agree": (tokens == argmax).float().mean().item(),
    }


class GenerateProbe:
    """CUDA events around the prefill and each decode step of the
    ``generate`` calls made while it is installed on ``inf`` (no host
    sync); with ``profile=(a, b)``, ``torch.profiler`` over decode steps
    a..b-1, synchronised at both ends."""

    def __init__(self, inf, profile=None):
        self.inf, self.profile = inf, profile
        self.prefill, self.steps = [], []
        self.prof = self.window_ms = None

    def __enter__(self):
        inf, probe = self.inf, self
        prefill, decode_step = inf._prefill, inf._decode_step

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def timed_prefill(*a, **kw):
            start = event()
            out = prefill(*a, **kw)
            probe.prefill.append((start, event()))
            return out

        def timed_step(*a, **kw):
            if probe.profile is not None:
                t = len(probe.steps) + 1
                if t in probe.profile:
                    torch.cuda.synchronize()
                    if t == probe.profile[0]:
                        from torch.profiler import ProfilerActivity, profile

                        probe.prof = profile(activities=[ProfilerActivity.CUDA])
                        probe.prof.start()
                        probe.t0 = time.monotonic()
                    else:
                        probe.window_ms = (time.monotonic() - probe.t0) * 1e3
                        probe.prof.stop()
            probe.steps.append(event())
            return decode_step(*a, **kw)

        inf._prefill, inf._decode_step = timed_prefill, timed_step
        return self

    def __exit__(self, *exc):
        del self.inf._prefill, self.inf._decode_step  # the class's methods again
        return False

    def times(self) -> dict:
        torch.cuda.synchronize()
        step_ms = [a.elapsed_time(b) for a, b in zip(self.steps, self.steps[1:])]
        return {"prefill_ms": statistics.median(a.elapsed_time(b) for a, b in self.prefill),
                "decode_ms": statistics.median(step_ms)}

    def window(self) -> dict:
        """The profiled steps' wall clock, device busy time, idle share, and
        the kernels that took the most device time, a step each."""
        steps = self.profile[1] - self.profile[0]
        kernels = sorted(((getattr(e, "self_device_time_total", 0) or 0) / 1e3 / steps,
                          e.count // steps, e.key[:70]) for e in self.prof.key_averages())
        busy = sum(ms for ms, _, _ in kernels) * steps
        return {"steps": steps, "wall_ms": self.window_ms, "busy_ms": busy,
                "idle_share": 1.0 - busy / self.window_ms,
                "top": [k for k in reversed(kernels) if k[0] > 0][:6]}


def time_generation(inf, prompts: list) -> dict:
    """A timed ``generate`` of the batch (host clock to the last token's
    fetch; CUDA events for the prefill and per decode step) and one with a
    profiled window of decode steps."""
    dev = inf.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    with GenerateProbe(inf) as probe:
        t0 = time.monotonic()
        outs = inf.generate(prompts, max_tokens=GEN["max_tokens"])
        wall = time.monotonic() - t0
    peak = (torch.cuda.max_memory_allocated(dev) - before) / 1e9
    timing = probe.times()
    with GenerateProbe(inf, profile=GEN["profile"]) as probe:
        profiled = inf.generate(prompts, max_tokens=GEN["max_tokens"])
    tokens = sum(len(o.completion_ids) for o in outs)
    return {**timing, "wall_s": wall, "tokens_per_s": tokens / wall, "peak_gb": peak,
            "weights_gb": sum(p.numel() * p.element_size() for p in inf.model.parameters()) / 1e9,
            "window": probe.window(), "outs": [outs, profiled]}


def check_generation_launches(name: str, kernel: dict, plain: dict, needed: tuple) -> None:
    if any(kernel.get(k, 0) <= 0 for k in needed):
        raise AssertionError(f"generate {name}: kernels not launched on its path: {kernel}")
    if sum(plain.values()) != 0:
        raise AssertionError(f"generate {name}: plain versions ran on the card: {plain}")


def generation_phase(name: str, arch_dict: dict, device: str = "cuda") -> dict:
    """``generate`` with one model at full width and depth (random weights
    from seed 0): the batch of ``generation_prompts`` four times (tokens
    checked, repeated bitwise, timed, profiled) and one 1-D prompt, launch
    counters reset just before and read just after; then the most-padded
    row recomputed on the CPU. Returns the counters."""
    from scaling_tpu_torch.models.transformer import (
        TransformerArchitectureConfig,
        TransformerInferenceModule,
    )
    from scaling_tpu_torch.ops import launches

    arch = TransformerArchitectureConfig.from_dict(arch_dict)
    inf = TransformerInferenceModule.random_init(arch, seed=0, device=device)
    n_params = sum(p.numel() for p in inf.model.parameters())
    prompts = generation_prompts(arch.vocab_size)
    inf.generate(prompts[0][:128], max_tokens=4)  # warm-up, off the books
    launches.reset()
    first = inf.generate(prompts, max_tokens=GEN["max_tokens"])
    again = inf.generate(prompts, max_tokens=GEN["max_tokens"])
    timing = time_generation(inf, prompts)
    single = inf.generate(prompts[-1], max_tokens=GEN["max_tokens"])
    if device == "cuda":
        torch.cuda.synchronize()
    kernel, plain = dict(launches.KERNEL), dict(launches.PLAIN)
    runs = [first, again] + timing.pop("outs")
    for outs in runs:
        if [len(o.completion_ids) for o in outs] != [GEN["max_tokens"]] * len(prompts):
            raise AssertionError(f"generate {name}: a row did not return its "
                                 f"{GEN['max_tokens']} tokens")
    if any([o.completion_ids for o in outs] != [o.completion_ids for o in first]
           for outs in runs[1:]):
        raise AssertionError(f"generate {name}: a repeated generate gave other tokens")
    logits_equal = all(torch.equal(a.logits, b.logits) for a, b in zip(first, again))
    if len(single.completion_ids) != GEN["max_tokens"]:
        raise AssertionError(f"generate {name}: the 1-D prompt did not return its tokens")
    same = sum(a == b for a, b in zip(single.completion_ids, first[-1].completion_ids))
    rec = recompute_generation(inf, prompts[-1], first[-1])
    print(f"  {name}: params={n_params} prompts={len(prompts)} of "
          f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
          f"{GEN['max_tokens']} greedy tokens each; 4 batch runs give the same tokens "
          f"(logits bitwise equal: {logits_equal}); the 1-D prompt alone matches its batch "
          f"row in {same}/{GEN['max_tokens']} tokens")
    print(f"  {name}: most-padded row recomputed on CPU f32 (plain versions): logits "
          f"max_abs_err={rec['err_abs']:.4e} max|logit|={rec['scale']:.4e} "
          f"err/max|logit|={rec['err']:.3e} (tol {GEN_LOGIT_TOL}; constant logits would give "
          f">= {rec['uniform_err']:.3e}); tokens where the CPU's top-2 margin exceeds 2x the "
          f"error: {rec['sure']}, of which not the CPU argmax: {rec['disagree']}; argmax "
          f"agreement {rec['argmax_agree']:.3f}")
    if not rec["uniform_err"] > GEN_LOGIT_TOL:
        raise AssertionError(f"generate {name}: constant logits would pass: {rec}")
    if not rec["err"] <= GEN_LOGIT_TOL:
        raise AssertionError(f"generate {name}: logits recompute disagrees: {rec}")
    if rec["disagree"]:
        raise AssertionError(f"generate {name}: a token is not the CPU's clear argmax: {rec}")
    print(f"  {name}: launches kernel={kernel} plain={plain}")
    needed = ("flash_attention_fwd", "rms_norm") if arch.fused_norm else ("flash_attention_fwd",)
    check_generation_launches(name, kernel, plain, needed)
    if "window" in timing:
        w = timing["window"]
        print(f"  {name}: prefill (b {len(prompts)}, s {max(map(len, prompts))})="
              f"{timing['prefill_ms']:.3f}ms median decode step={timing['decode_ms']:.3f}ms "
              f"a token; output tokens/s={timing['tokens_per_s']:.1f} "
              f"(wall {timing['wall_s']:.3f}s); peak memory of the call "
              f"{timing['peak_gb']:.3f}GB above what was allocated before it (the weights: "
              f"{timing['weights_gb']:.3f}GB)")
        print(f"  {name}: profiled decode steps {GEN['profile'][0]}-{GEN['profile'][1] - 1} "
              f"(torch.profiler): wall={w['wall_ms'] / w['steps']:.3f}ms a step, device busy="
              f"{w['busy_ms'] / w['steps']:.3f}ms a step, idle share={w['idle_share']:.3f}")
        for ms, count, op in w["top"]:
            print(f"    {ms:.4f}ms a step in {count} launches: {op}")
    del inf
    if device == "cuda":
        torch.cuda.empty_cache()
    return kernel


def write_token_datasets(root: Path, vocab: int) -> dict:
    """Two training prefixes of ~``tokens`` tokens and a validation prefix,
    documents of ``doc_len`` tokens ending in EOD 0, uint16, from seed 0,
    written by the port's builder."""
    from scaling_tpu_torch.data import MemoryMapDatasetBuilder

    rng = np.random.default_rng(0)
    prefixes = {}
    for name, tokens in (("a", TRAINER["tokens"]), ("b", TRAINER["tokens"]),
                         ("valid", TRAINER["valid_tokens"])):
        written = 0
        with MemoryMapDatasetBuilder(root / name, dtype=np.uint16) as builder:
            while written < tokens:
                doc = rng.integers(1, vocab, size=int(rng.integers(*TRAINER["doc_len"])) - 1)
                builder.add(np.append(doc, 0))
                written += doc.size + 1
        prefixes[name] = str(root / name)
    return prefixes


def trainer_config(prefixes: dict, log_dir: Path, save_dir=None, load_dir=None) -> dict:
    """The JAX-shaped training config of the trainer phase: the bench model
    and optimizer of phase 5, blended token data, eval and checkpoints."""
    from scaling_tpu_torch.train.bench import LR_SCHEDULE, MODELS, OPTIMIZER

    return {
        "topology": {"model_parallel_size": 1, "pipe_parallel_size": 1,
                     "data_parallel_size": 1, "micro_batch_size": TRAINER["mbs"],
                     "gradient_accumulation_steps": 1},
        "transformer_architecture": dict(MODELS[TRAINER["model"]],
                                         sequence_length=TRAINER["seq"]),
        "optimizer": OPTIMIZER,
        "learning_rate_scheduler": LR_SCHEDULE,
        "trainer": {"seed": 0, "train_iterations": TRAINER["iterations"],
                    "save_dir": None if save_dir is None else str(save_dir),
                    "save_interval": TRAINER["interval"],
                    "load_dir": None if load_dir is None else str(load_dir),
                    "eval_interval": TRAINER["interval"],
                    "eval_iterations": TRAINER["eval_iterations"],
                    "delete_past_optimizer_states": False},
        "data": {"data_prefixes": [prefixes["a"], prefixes["b"]],
                 "validation_data_prefixes": [prefixes["valid"]]},
        "logger": {"log_dir": str(log_dir)},
    }


def trainer_state(trainer) -> dict:
    """A host copy of the trainer's parameters and f32 optimizer state."""
    opt = trainer.optimizer.state
    state = {f"param.{n}": p.detach().to("cpu", copy=True)
             for n, p in trainer.module.model.named_parameters()}
    for field in ("master", "exp_avg", "exp_avg_sq"):
        state.update({f"{field}.{n}": t.to("cpu", copy=True)
                      for n, t in getattr(opt, field).items()})
    return state


class TrainerProbe:
    """Watches ``TransformerTrainer`` for one run: the host batch of each
    step, the state at the save of step ``interval`` (a host copy, taken
    before the save and outside its time), and the seconds of each save and
    load. Installed around one ``main`` and removed after it."""

    def __init__(self, snapshot_at=None, on_load=None):
        self.batches, self.saves, self.loads = [], [], []
        self.snapshot, self.snapshot_at, self.on_load = None, snapshot_at, on_load

    def __enter__(self):
        from scaling_tpu_torch.models.transformer.train import TransformerTrainer

        self.cls = TransformerTrainer
        self.orig = {k: getattr(TransformerTrainer, k)
                     for k in ("_assemble_micro_batches", "save_checkpoint", "load_checkpoint")}
        probe, orig = self, self.orig

        def assemble(trainer):
            batch = orig["_assemble_micro_batches"](trainer)
            probe.batches.append(batch)
            return batch

        def save(trainer, *a, **kw):
            if trainer.context.iterations == probe.snapshot_at:
                probe.snapshot = trainer_state(trainer)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            step_dir = orig["save_checkpoint"](trainer, *a, **kw)
            probe.saves.append((step_dir, time.monotonic() - t0))
            return step_dir

        def load(trainer, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            loaded = orig["load_checkpoint"](trainer, *a, **kw)
            torch.cuda.synchronize()
            probe.loads.append(time.monotonic() - t0)
            if probe.on_load is not None:
                probe.on_load(trainer)
            return loaded

        TransformerTrainer._assemble_micro_batches = assemble
        TransformerTrainer.save_checkpoint = save
        TransformerTrainer.load_checkpoint = load
        return self

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.cls, k, fn)
        return False


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def serve_greedy(inf, vocab: int) -> dict:
    """4 greedy requests (prompts of 64-256 tokens, 32 output tokens each)
    through an engine with native KV; tokens by request id."""
    from scaling_tpu_torch.serve import EngineConfig, ServeEngine

    engine = ServeEngine(inf, EngineConfig(kv_dtype="native", **SERVE), device=inf.device)
    rng = np.random.default_rng(6)
    for _ in range(TRAINER["serve_requests"]):
        n = int(rng.integers(TRAINER["serve_prompt"][0], TRAINER["serve_prompt"][1] + 1))
        engine.submit(rng.integers(1, vocab, size=n).tolist(), TRAINER["serve_output"])
    return {s.request.req_id: list(s.generated) for s in engine.run_until_done()}


def check_trainer_launches(kernel: dict, plain: dict) -> None:
    needed = ("paged_attention", "rms_norm", "rms_norm_bwd", "flash_attention_fwd",
              "flash_attention_bwd")
    if any(kernel.get(k, 0) <= 0 for k in needed):
        raise AssertionError(f"trainer phase: kernels not launched on its path: {kernel}")
    if sum(plain.values()) != 0:
        raise AssertionError(f"trainer phase: plain versions ran on the card: {plain}")


def trainer_phase(bench_step_ms: float, device: str = "cuda") -> dict:
    """The Trainer end to end (phase 8 of the module's docstring); the
    launch counters reset just before and read just after. Returns them."""
    from scaling_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerInferenceModule,
        TransformerModel,
    )
    from scaling_tpu_torch.models.transformer.train import main
    from scaling_tpu_torch.ops import launches
    from scaling_tpu_torch.resilience import verify_checkpoint
    from scaling_tpu_torch.train.bench import MODELS

    vocab = MODELS[TRAINER["model"]]["vocab_size"]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_trainer_"))
    try:
        free = shutil.disk_usage(root).free
        # a checkpoint: 4 bytes a parameter for the weights, 12 for the optimizer
        need = 2 * 16 * 495_110_144 + (1 << 30) if TRAINER["model"] == "0.5b" else 1 << 30
        print(f"  temporary directory {root}: {free / 1e9:.1f} GB free, two checkpoints need "
              f"~{need / 1e9:.1f} GB")
        if free < need:
            raise AssertionError(f"not enough disk for two checkpoints under {root}")
        t0 = time.monotonic()
        prefixes = write_token_datasets(root, vocab)
        print(f"  token datasets written in {time.monotonic() - t0:.1f}s: "
              + " ".join(f"{k}={Path(v).with_suffix('.bin').stat().st_size // 2} tokens"
                         for k, v in prefixes.items()))
        save_dir = root / "ckpt"
        launches.reset()

        with TrainerProbe(snapshot_at=TRAINER["interval"]) as first:
            trainer = main(TransformerConfig.from_dict(
                trainer_config(prefixes, root / "logs", save_dir=save_dir)), device=device)
        arch = trainer.context.config.transformer_architecture
        weights = {k: v.clone() for k, v in trainer.module.model.state_dict().items()}
        in_memory_loss = in_memory_eval_loss(trainer, prefixes["valid"])
        del trainer
        torch.cuda.empty_cache()
        records = [json.loads(line) for line in (root / "logs" / "metrics_rank_0.jsonl")
                   .read_text().splitlines()]
        steps = [r for r in records if "loss" in r["metrics"]]
        losses = [r["metrics"]["loss"] for r in steps]
        if [r["step"] for r in steps] != list(range(1, TRAINER["iterations"] + 1)):
            raise AssertionError(f"step records: {[r['step'] for r in steps]}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite trainer loss: {losses}")
        check_step_records(steps)
        step_dirs = [d for d, _ in first.saves]
        if [d.name for d in step_dirs] != ["global_step3", "global_step6"]:
            raise AssertionError(f"checkpoints: {step_dirs}")
        for d in step_dirs:
            problems = verify_checkpoint(d)
            if problems:
                raise AssertionError(f"{d.name} fails verification: {problems}")

        def check_loaded(trainer):
            ctx = trainer.context
            if (ctx.iterations, ctx.consumed_samples) != (3, 3 * TRAINER["mbs"]):
                raise AssertionError(f"resumed at {ctx.iterations} / {ctx.consumed_samples}")
            now = trainer_state(trainer)
            if now.keys() != first.snapshot.keys():
                raise AssertionError("the resumed state has other tensors than step 3's")
            differ = [k for k, v in now.items() if not torch.equal(v, first.snapshot[k])]
            if differ:
                raise AssertionError(f"resumed state differs from step 3's: {differ[:5]}")

        with TrainerProbe(on_load=check_loaded) as second:
            resumed = main(TransformerConfig.from_dict(
                trainer_config(prefixes, root / "logs2", load_dir=save_dir / "global_step3")),
                device=device)
        del resumed
        torch.cuda.empty_cache()
        step4_first, step4_again = first.batches[3], second.batches[0]
        for field in vars(step4_first):
            if not np.array_equal(getattr(step4_first, field), getattr(step4_again, field)):
                raise AssertionError(f"the resumed step-4 batch differs in {field}")
        again = [json.loads(line)["metrics"]["loss"] for line in
                 (root / "logs2" / "metrics_rank_0.jsonl").read_text().splitlines()
                 if "loss" in json.loads(line)["metrics"]]
        print(f"  losses: first run {losses}; resumed at 3: {again}")
        if again[0] != losses[3]:
            raise AssertionError(f"step-4 loss after the resume {again[0]!r} != {losses[3]!r}")
        rel = [abs(a - b) / abs(b) for a, b in zip(again[1:], losses[4:])]
        print(f"  step 4 bitwise equal; steps 5-6 rel. diff {rel} (rtol {RESUME_RTOL})")
        if len(again) != 3 or not max(rel) <= RESUME_RTOL:
            raise AssertionError(f"resumed losses {again} vs {losses[3:]}")

        evaluate_checkpoint(save_dir, prefixes["valid"], records, in_memory_loss, device)
        served = TransformerInferenceModule.from_checkpoint(save_dir, device=device)
        differ = [k for k, v in served.model.state_dict().items() if not torch.equal(v, weights[k])]
        if differ:
            raise AssertionError(f"bf16 -> f32 npz -> bf16 is not exact: {differ[:5]}")
        tokens = serve_greedy(served, vocab)
        del served
        model = TransformerModel(arch, device=device)
        model.load_state_dict(weights)
        in_memory = serve_greedy(TransformerInferenceModule(arch, model), vocab)
        if tokens != in_memory or any(len(t) != TRAINER["serve_output"] for t in tokens.values()):
            raise AssertionError("the checkpoint serves other tokens than the trainer's weights")
        torch.cuda.synchronize()
        kernel, plain = dict(launches.KERNEL), dict(launches.PLAIN)
        print(f"  checkpoint served: {len(tokens)} greedy requests, tokens equal to the "
              f"trainer's in-memory weights'")
        print(f"  launches kernel={kernel} plain={plain}")
        check_trainer_launches(kernel, plain)

        durations = [r["metrics"]["step_duration"] for r in steps[1:]]
        step_ms = statistics.median(durations) * 1e3
        tokens_per_s = TRAINER["mbs"] * TRAINER["seq"] / (step_ms / 1e3)
        size = dir_bytes(step_dirs[0])
        mfus = [r["metrics"].get("palm_mfu") for r in steps[1:]]
        mfu = "not measured" if None in mfus else f"{statistics.median(mfus):.4f}"
        print(f"  trainer steady step (median of steps 2-{TRAINER['iterations']}, host clock "
              f"to the loss's fetch): {step_ms:.2f}ms tokens/s={tokens_per_s:.1f} mfu={mfu}; "
              f"phase 5's bench step at the same shape {bench_step_ms:.2f}ms "
              f"(gap {step_ms - bench_step_ms:.2f}ms: the host's data path)")
        for (d, sec) in first.saves:
            print(f"  checkpoint save {d.name}: {sec:.2f}s {dir_bytes(d) / sec / 1e9:.2f}GB/s")
        for sec in second.loads:
            print(f"  checkpoint load (verify crc32 + read): {sec:.2f}s "
                  f"{size / sec / 1e9:.2f}GB/s")
        opt_bytes = sum(f.stat().st_size for f in step_dirs[0].glob("optimizer_state*"))
        print(f"  checkpoint size: {size} bytes ({size / 1e9:.2f} GB): {size - opt_bytes} "
              f"weights and the rest, {opt_bytes} optimizer state")
        return kernel
    finally:
        shutil.rmtree(root, ignore_errors=True)


def check_evaluate_launches(kernel: dict, plain: dict) -> None:
    if any(kernel.get(k, 0) <= 0 for k in ("rms_norm", "flash_attention_fwd")):
        raise AssertionError(f"evaluate: kernels not launched on its path: {kernel}")
    if sum(plain.values()) != 0:
        raise AssertionError(f"evaluate: plain versions ran on the card: {plain}")


def in_memory_eval_loss(trainer, valid_prefix: str) -> float:
    """The trainer's own forward and loss function on its in-memory weights
    (step 6) over ``evaluate``'s batches: the validation prefix read in
    order, ``eval_iterations`` batches of the micro-batch size. The batch
    means are weighted by the batches' loss weights, as ``evaluate`` weighs
    its tokens."""
    from scaling_tpu_torch.models.transformer.data.text_dataset import TextDataset

    mbs = TRAINER["mbs"]
    arch = trainer.context.config.transformer_architecture
    dataset = TextDataset(valid_prefix, sequence_length=arch.sequence_length, shuffle=False)
    trainer.module.model.eval()
    total = weight = 0.0
    with torch.no_grad():
        for b in range(TRAINER["eval_iterations"]):
            items = [dataset[i] for i in range(b * mbs, min((b + 1) * mbs, len(dataset)))]
            batch = trainer.batch_to_model_input(dataset.collate(items), trainer.device)
            loss, _ = trainer.loss_function(trainer.module.forward(batch), batch)
            w = float(batch["loss_weights"].float().sum())
            total, weight = total + float(loss) * w, weight + w
    return total / weight


def evaluate_checkpoint(save_dir: Path, valid_prefix: str, records: list,
                        in_memory_loss: float, device: str) -> dict:
    """``evaluate`` on the checkpoint ``latest`` names (step 6) over the
    validation prefix, 2 batches of the trainer's micro-batch size; its
    launches are the counters' growth over the call. It must give the loss
    of the trainer's forward on its in-memory step-6 weights over the same
    batches within ``EVAL_REF_NATS``, a limit the step-3 checkpoint must
    miss, and lie within ``EVAL_NATS`` of the trainer's own step-6 eval
    loss (other, shuffled batches)."""
    from collections import Counter

    from scaling_tpu_torch.models.transformer.evaluate import evaluate
    from scaling_tpu_torch.ops import launches

    def run(checkpoint: Path) -> dict:
        return evaluate(checkpoint, valid_prefix, batch_size=TRAINER["mbs"],
                        max_batches=TRAINER["eval_iterations"], device=device)

    before = Counter(launches.KERNEL), Counter(launches.PLAIN)
    t0 = time.monotonic()
    stats = run(save_dir)
    seconds = time.monotonic() - t0
    kernel = dict(Counter(launches.KERNEL) - before[0])
    plain = dict(Counter(launches.PLAIN) - before[1])
    step3 = run(save_dir / f"global_step{TRAINER['interval']}")
    eval_loss = [r["metrics"]["eval_loss"] for r in records
                 if r["step"] == TRAINER["iterations"] and "eval_loss" in r["metrics"]][0]
    gap, gap3 = abs(stats["loss"] - in_memory_loss), abs(step3["loss"] - in_memory_loss)
    print(f"  evaluate (step {TRAINER['iterations']} checkpoint, validation prefix, "
          f"{stats['batches']} batches of {TRAINER['mbs']}): loss={stats['loss']} "
          f"accuracy={stats['accuracy']} tokens={stats['tokens']} in {seconds:.2f}s; "
          f"launches kernel={kernel} plain={plain}")
    print(f"  the trainer's forward on its in-memory step-{TRAINER['iterations']} weights over "
          f"the same batches: {in_memory_loss:.6f}, gap {gap:.3g} (tol {EVAL_REF_NATS} nats); "
          f"the step-{TRAINER['interval']} checkpoint: {step3['loss']}, gap {gap3:.3g} (must "
          f"exceed the tol); the trainer's step-{TRAINER['iterations']} eval loss on its own "
          f"batches {eval_loss:.6f} (tol {EVAL_NATS} nats)")
    if not np.isfinite(stats["loss"]) or not gap <= EVAL_REF_NATS:
        raise AssertionError(f"evaluate: loss {stats['loss']} vs in-memory {in_memory_loss}")
    if not gap3 > EVAL_REF_NATS:
        raise AssertionError(f"evaluate cannot tell the step-{TRAINER['interval']} checkpoint: "
                             f"{step3['loss']} vs in-memory {in_memory_loss}")
    if not abs(stats["loss"] - eval_loss) <= EVAL_NATS:
        raise AssertionError(f"evaluate: loss {stats['loss']} vs eval loss {eval_loss}")
    check_evaluate_launches(kernel, plain)
    return stats


def check_step_records(steps: list) -> None:
    if not all("palm_mfu" in r["metrics"] for r in steps):
        raise AssertionError("a step record has no palm_mfu")


def time_kernels(errs: dict) -> list:
    """One row a kernel, its launches added by ``add_launches``."""
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

    def row(name, route, source, replaces, fn, plain_fn, bound_ms, library_fn=None,
            flops=None):
        rows.append(dict(
            name=name, route=route, source=source, replaces=replaces, max_abs_err=errs[name],
            ms=time_ms(fn), plain_ms=time_ms(plain_fn), bound_ms=bound_ms[0],
            bound_by=bound_ms[1], library_ms=time_ms(library_fn) if library_fn else None,
        ))
        if flops is not None:  # the bound's operations over the device time
            rows[-1]["tflops"] = flops / (rows[-1]["ms"][0] * 1e-3) / 1e12

    long_gen = torch.Generator(device=dev)  # apart: the tick's inputs stay as they were
    long_gen.manual_seed(4)
    for name, quantized in (("paged_attention", False), ("paged_attention_int8", True)):
        args, kw = k1_inputs(gen, quantized, dev)
        row(name, "cuda", "scaling_tpu_torch/csrc/paged_attention.cu",
            "scaling_tpu/nn/paged_attention.py:163",
            lambda: paged_attention(*args, **kw), lambda: paged_attention_plain(*args, **kw),
            k1_bound_ms(args, kw))
        long_args, long_kw = k1_inputs(long_gen, quantized, dev, K1_LONG_ROW)
        dev_ms, call_ms = time_ms(lambda: paged_attention(*long_args, **long_kw))
        long_bound = k1_bound_ms(long_args, long_kw)[0]
        print(f"  {name} one 2048-slot row: device ms={dev_ms:.4f} per call={call_ms:.4f} "
              f"bound={long_bound:.4f} gbps={long_bound / dev_ms * HBM_BYTES_PER_S / 1e9:.1f}")
        for case, (a, k) in (("serving tick", (args, kw)), ("one 2048-slot row",
                                                            (long_args, long_kw))):
            parts = device_ms_by_kernel(lambda: paged_attention(*a, **k))
            print(f"  {name} {case}: device ms by kernel: "
                  + (" ".join(f"{n}={ms:.4f}" for n, ms in parts.items()) or "not measured"))
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
                                               enable_gqa=True),
        flops=flash_flops(*q.shape))
    row("flash_attention_bwd", "cuda", "scaling_tpu_torch/csrc/flash_attention.cu",
        "scaling_tpu/ops/flash_attention.py:160",
        lambda: flash_attention_bwd(q, k, v, out, lse, dout, seg),
        lambda: flash_attention_bwd_plain(q, k, v, out, lse, dout, seg),
        k5_bound_ms(q, k),
        lambda: torch.autograd.grad(y_sdpa, (qt, kt, vt), dout_t, retain_graph=True),
        flops=2.5 * flash_flops(*q.shape))
    for r in rows:
        launch = {k: r[k][1] for k in ("ms", "plain_ms", "library_ms") if r[k]}
        for k in launch:
            r[k] = r[k][0]  # the JSON line carries device time
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        if r["name"].startswith("paged_attention") and r["bound_by"] == "bytes":
            # the bound's bytes over the device time
            r["gbps"] = r["bound_ms"] / r["ms"] * HBM_BYTES_PER_S / 1e9
        rate = f" tflops={r['tflops']:.1f}" if "tflops" in r else ""
        rate += f" gbps={r['gbps']:.1f}" if "gbps" in r else ""
        print(f"  {r['name']}: device ms={r['ms']:.4f} plain={r['plain_ms']:.4f} "
              f"library={lib} bound={r['bound_ms']:.4f} ({r['bound_by']}){rate}; "
              "per call with launch (events): "
              + " ".join(f"{k}={v:.4f}" for k, v in launch.items()))
    return rows


def add_launches(rows: list, launches_by_path: dict) -> None:
    """``launches``: the sum over the main-path runs; ``launches_by_path``:
    each run's own count (``launches_by_path`` maps a run's name to the
    counters read just after it)."""
    for r in rows:
        r["launches_by_path"] = {path: counts.get(r["name"], 0)
                                 for path, counts in launches_by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        print(f"  {r['name']}: launches={r['launches']} {r['launches_by_path']}")


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
    trained = train()
    launches_by_path["train"] = trained["launches"]
    for name, arch in generation_models().items():
        print(f"== generate {name} (full width and depth, random weights, seed 0)")
        launches_by_path[f"generate_{name}"] = generation_phase(name, arch)
    print("== kernel times (device: torch.profiler; per call: CUDA events)")
    rows = time_kernels(errs)
    # last: after the trainer's run the profiler drops device events now and
    # then (on an H100 a kernel's profiled sum fell to half its time after
    # it), so the kernel times are taken before it
    print("== trainer: 0.5B from token datasets, checkpoints, resume, serve the checkpoint")
    launches_by_path["trainer"] = trainer_phase(trained["step_ms"])
    print("== launches on the main paths")
    add_launches(rows, launches_by_path)
    print(f"== done in {time.monotonic() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
