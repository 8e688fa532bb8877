#!/usr/bin/env python3
"""Drive the PyTorch port (scaling_tpu_torch) on one CUDA card.

Phases, each of which must pass:

1. print the card (nvidia-smi name and power limit) and require compute
   capability 9.0;
2. build every kernel of the serving path from this checkout's sources
   (nvcc for the CUDA kernel, Triton's compiler for the Triton one) and
   print the build time;
3. hold each kernel against its plain PyTorch version on the same inputs
   at the shapes the serving path gives it, and print the max error
   beside the tolerance;
4. serve the full-width 0.5B model (random weights from a seed) with
   native and with int8 KV: every request must finish with its token
   count, the kernel launch counters must be > 0 and the plain-version
   counter 0, and one tick recomputed on the CPU in f32 with the plain
   versions, from a copy of the pools taken before the tick, must agree
   with the card's logits; print tokens/s, TTFT and ITL;
   a profiled window of steady ticks gives the device's busy time, its
   idle share and the device time by kernel;
5. time each kernel, its plain version and, where one PyTorch call
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
    """Build every kernel of the serving path; returns seconds."""
    from scaling_tpu_torch.ops import cuda_build, rms_norm

    t0 = time.monotonic()
    cuda_build.start("paged_attention")  # nvcc in the background
    dev = torch.device("cuda")
    for rows, d in K2_SHAPES:  # Triton compiles at first launch
        rms_norm(torch.ones(rows, d, device=dev, dtype=torch.bfloat16),
                 torch.ones(d, device=dev, dtype=torch.bfloat16), 1e-5)
    cuda_build.load("paged_attention")
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    for line in cuda_build.build_log("paged_attention").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
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


def time_kernels(errs: dict, launches_by_kernel: dict) -> list:
    import torch.nn.functional as F

    from scaling_tpu_torch.ops import paged_attention, paged_attention_plain
    from scaling_tpu_torch.ops import rms_norm, rms_norm_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    rows = []
    for name, quantized in (("paged_attention", False), ("paged_attention_int8", True)):
        args, kw = k1_inputs(gen, quantized, dev)
        bound, bound_by = k1_bound_ms(args, kw)
        rows.append(dict(
            name=name, route="cuda", source="scaling_tpu_torch/csrc/paged_attention.cu",
            replaces="scaling_tpu/nn/paged_attention.py:163",
            launches=launches_by_kernel.get(name, 0), max_abs_err=errs[name],
            ms=time_ms(lambda: paged_attention(*args, **kw)),
            plain_ms=time_ms(lambda: paged_attention_plain(*args, **kw)),
            bound_ms=bound, bound_by=bound_by, library_ms=None,
        ))
    x = torch.randn(*K2_SHAPES[0], generator=gen, device=dev).bfloat16()
    w = (1 + 0.1 * torch.randn(x.shape[-1], generator=gen, device=dev)).bfloat16()
    bound, bound_by = k2_bound_ms(x)
    rows.append(dict(
        name="rms_norm", route="triton", source="scaling_tpu_torch/ops/_rms_norm_triton.py",
        replaces="scaling_tpu/ops/rms_norm.py:107",
        launches=launches_by_kernel.get("rms_norm", 0), max_abs_err=errs["rms_norm"],
        ms=time_ms(lambda: rms_norm(x, w, 1e-5)),
        plain_ms=time_ms(lambda: rms_norm_plain(x, w, 1e-5)),
        bound_ms=bound, bound_by=bound_by,
        library_ms=time_ms(lambda: F.rms_norm(x, (x.shape[-1],), w, 1e-5)),
    ))
    for r in rows:
        launch = {k: r[k][1] for k in ("ms", "plain_ms", "library_ms") if r[k]}
        for k in launch:
            r[k] = r[k][0]  # the JSON line carries device time
        print(f"  {r['name']}: device ms={r['ms']:.4f} plain={r['plain_ms']:.4f} "
              f"library={r['library_ms']} bound={r['bound_ms']:.4f} ({r['bound_by']}); "
              f"per call with launch (events): "
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
    print("== build")
    print(f"  kernels built in {build_kernels():.1f}s")
    print("== kernels vs plain versions")
    errs = check_kernels()
    print("== serve 0.5B (full width and depth, random weights, seed 0)")
    launches_by_kernel: dict = {}
    for kv_dtype in ("native", "int8"):
        stats = serve(kv_dtype)
        for name, n in stats["launches"].items():
            launches_by_kernel[name] = launches_by_kernel.get(name, 0) + n
    print("== kernel times (device: torch.profiler; per call: CUDA events)")
    rows = time_kernels(errs, launches_by_kernel)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
