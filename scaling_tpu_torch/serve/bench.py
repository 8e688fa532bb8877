"""Serving load generator: Poisson arrivals -> engine -> latency report.

``python -m scaling_tpu_torch.serve bench`` (the single-engine bench of
scaling_tpu/serve/bench.py) drives the continuous-batching engine with an
open-loop Poisson arrival process (exponential gaps at ``--rate`` req/s),
prompt and output lengths drawn uniformly from ``--prompt-len`` /
``--output-len``, and reports output tokens/s, time to first token
(p50, p99) and inter-token latency (p50, p99).

``--checkpoint DIR`` serves the weights of a checkpoint (of either
package; ``latest`` is followed), as the JAX bench's ``--checkpoint``
does. Otherwise the model is randomly initialised from ``--seed``:
``--model 0.5b`` is
``bench.py``'s default decoder (hidden 2048, 8 layers, 16 query and 4 KV
heads, vocab 32768, SwiGLU x2.75, RMSNorm with the fused kernel, RoPE,
untied head, bf16); ``--model toy`` is a small f32 model for the CPU.
It runs on the card unless ``--device cpu`` is given.

The engine's modes: ``--spec-k`` (and ``--spec-k-sweep``),
``--prefill-chunk 0`` (whole-prompt prefill), ``--no-fused-tick``. Its
resilience, as in the JAX bench: ``--deadline-ms`` /
``--ttft-deadline-ms``, the shed watermarks and ``--max-waiting`` (a
shed submission is counted, not retried), SIGTERM drains, the request
journal ``DIR/journal.jsonl`` (off with ``--no-journal``), ``--resume``
replays it, ``--restarts N`` supervises the bench as child processes and
relaunches a dead one with ``--resume``, ``--tick-timeout-s`` kills a
wedged tick so the supervisor can.

``--run-dir DIR`` records the run as the JAX bench does: events (one
``serve-request`` a request, the spans and a final ``serve-summary``)
into ``DIR/events.jsonl`` through ``SCALING_TPU_EVENTS_PATH`` (unless the
environment already names a file), and the metrics registry's snapshots
into ``DIR/metrics.jsonl``; ``python -m scaling_tpu_torch.obs report DIR``
renders them. Each measured request runs under a trace id of its own,
and each tick in a ``serve.tick`` span. A ``serve-start`` event records
the card's free memory before the model is built. Without
``--run-dir`` the bench writes no events, no metrics and no journal,
whatever sinks the process's logger had, unless
``SCALING_TPU_EVENTS_PATH`` or ``SCALING_TPU_METRICS_PATH`` names a file.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..logging.logger import logger
from ..obs import get_registry, new_trace_id, span, trace_context
from ..ops import launches
from ..resilience import StepStallWatchdog
from ..resilience.faults import get_fault_plan
from .journal import open_journal, replay_journal
from .scheduler import Backpressure

MODELS: Dict[str, dict] = {
    # bench.py:build at its defaults (hidden 2048, 8 layers) with
    # BENCH_NORM=fused, i.e. layernorm.optimization_type: fused
    "0.5b": {
        "vocab_size": 32768,
        "hidden_size": 2048,
        "num_layers": 8,
        "num_attention_heads": 16,
        "attention_num_kv_heads": 4,
        "sequence_length": 2048,
        "precision": "bfloat16",
        "mlp_type": "swiglu",
        "mlp_factor": 2.75,
        "norm_type": "rms",
        "relative_position_embedding_type": "rotary",
        "causal": True,
        "masked_softmax": {"kernel": "flash_attention"},
        "layernorm": {"optimization_type": "fused"},
        "weight_tying": False,
        "attention_qkv_in_one": False,
        "dropout_embedding": 0.0,
        "dropout_attention_probs": 0.0,
        "dropout_after_attention": 0.0,
        "dropout_after_mlp": 0.0,
    },
    "toy": {
        "vocab_size": 512,
        "hidden_size": 256,
        "num_layers": 2,
        "num_attention_heads": 4,
        "attention_num_kv_heads": 2,
        "sequence_length": 512,
        "precision": "float32",
        "mlp_type": "swiglu",
        "mlp_factor": 2.0,
        "norm_type": "rms",
        "layernorm": {"optimization_type": "fused"},
        "weight_tying": False,
        "attention_qkv_in_one": False,
    },
}


def build_inference(model: str, seed: int = 0, device=None):
    """Random-init inference module for one of ``MODELS``."""
    from ..models.transformer import TransformerArchitectureConfig, TransformerInferenceModule

    arch = TransformerArchitectureConfig.from_dict(MODELS[model])
    return TransformerInferenceModule.random_init(arch, seed=seed, device=device)


def sample_workload(n_requests: int, rate: float, prompt_len, output_len,
                    vocab: int, seed: int, shared_prefix_len: int = 0):
    """Poisson arrival offsets plus per-request prompts and output budgets.
    ``shared_prefix_len > 0`` prepends one fixed system prompt of that
    length to every request (the prefix-cache case)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, size=shared_prefix_len).tolist()
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))
    arrivals[0] = 0.0  # the first request opens the run
    work = []
    for i in range(n_requests):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        olen = int(rng.integers(output_len[0], output_len[1] + 1))
        work.append((float(arrivals[i]),
                     prefix + rng.integers(1, vocab, size=plen).tolist(), olen))
    return work


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation)."""
    s = sorted(values)
    return s[max(0, min(len(s) - 1, math.ceil(q / 100.0 * len(s)) - 1))]


def run_bench(engine, workload, max_wall_s: float = 600.0, tick_timeout_s: float = 0.0,
              extra_stats: Optional[dict] = None, carry: Optional[dict] = None) -> dict:
    """Open-loop drive: submit each request when the wall clock crosses
    its arrival offset, tick the engine continuously, drain. Returns the
    summary stats, which also go out as the ``serve-summary`` event,
    followed by a registry flush. Every tick ends in a device->host copy
    of its sampled tokens, so the wall clock covers the device work.

    A submission the engine sheds is counted, not retried. Once the
    engine drains (SIGTERM), submission stops, in-flight requests finish
    and the unsubmitted tail is counted. ``tick_timeout_s > 0`` arms a
    tick-stall watchdog (``StepStallWatchdog``): a tick that stops beating
    logs a ``serve-stall`` event, fires the ``serve.stall.kill`` fault
    point and SIGKILLs the process, so that a ``--restarts`` supervisor
    replays the journal instead of waiting on a wedged child. ``carry``
    folds a crashed predecessor's tallies (``completed``, ``timeouts``,
    ``shed``, ``offered``, from the journal) into the summary, which then
    describes the whole run directory. The stats also carry the kernels'
    and plain versions' launches during the run (``ops.launches``)."""
    watchdog = None
    if tick_timeout_s > 0:
        def on_stall(tick, elapsed):
            logger.log_event("serve-stall", tick=tick, stalled_s=round(elapsed, 3))
            get_fault_plan().fire("serve.stall.kill")
            with span("serve.stall.kill", tick=tick):
                os.kill(os.getpid(), signal.SIGKILL)

        watchdog = StepStallWatchdog(tick_timeout_s, on_stall=on_stall)
        watchdog.start()
    kernel_before, plain_before = dict(launches.KERNEL), dict(launches.PLAIN)
    t0 = time.monotonic()
    start_tick = engine.tick_index
    start_finished = len(engine.finished)
    pending = sorted(workload, key=lambda w: w[0])
    idx = 0
    try:
        while True:
            now = time.monotonic() - t0
            if now > max_wall_s:
                raise RuntimeError(
                    f"bench exceeded max_wall_s={max_wall_s}: {idx}/{len(pending)} "
                    f"submitted, {len(engine.finished) - start_finished} finished"
                )
            while not engine.draining and idx < len(pending) and pending[idx][0] <= now:
                arrival, prompt, olen = pending[idx]
                # one trace a measured request, the origin of its spans and events
                with trace_context(new_trace_id()):
                    res = engine.submit(prompt, olen, arrival_s=t0 + arrival)
                if isinstance(res, Backpressure) and res.draining:
                    break  # SIGTERM raced this submission: unsubmitted, not shed
                idx += 1
            if watchdog is not None:
                # every pass beats, idle waits included: only a wedged tick stops it
                watchdog.beat(engine.tick_index)
            if engine.scheduler.has_work:
                with span("serve.tick", step=engine.tick_index):
                    engine.tick()
            elif engine.draining or idx >= len(pending):
                break
            else:
                wait = pending[idx][0] - (time.monotonic() - t0)
                if wait > 0:
                    time.sleep(min(wait, 0.05))
    finally:
        if watchdog is not None:
            watchdog.stop()
    wall_s = time.monotonic() - t0
    seqs = engine.finished[start_finished:]
    completed = [s for s in seqs if s.finish_status == "completed"]
    ttfts = [s.first_token_s - s.request.arrival_s for s in seqs if s.first_token_s is not None]
    itls = [b - a for s in seqs for a, b in zip(s.token_stamps, s.token_stamps[1:])]
    out_tokens = sum(len(s.generated) for s in seqs)
    hit, prefilled = engine.scheduler.prefix_hit_tokens, engine.prefilled_tokens
    carry = carry or {}
    n_completed = len(completed) + int(carry.get("completed", 0))
    shed = engine.shed_count + int(carry.get("shed", 0))
    timeouts = engine.timeout_count + int(carry.get("timeouts", 0))
    attempts = shed + timeouts + n_completed
    rate = engine.spec_accept_rate
    stats = {
        # as the JAX bench counts them: requests completed, then the ways
        # an offered workload item ended otherwise
        "requests": n_completed,
        "completed": n_completed,
        "offered": len(pending) + int(carry.get("offered", 0)),
        "requests_timeout": timeouts,
        "requests_shed": shed,
        "shed_rate": round(shed / attempts, 4) if attempts else 0.0,
        "drained": engine.draining,
        "unsubmitted": len(pending) - idx,
        "output_tokens": out_tokens,
        "prompt_tokens": sum(len(s.request.prompt) for s in seqs),
        "wall_s": wall_s,
        "ticks": engine.tick_index - start_tick,
        "tokens_per_s": out_tokens / wall_s if wall_s > 0 else 0.0,
        "ttft_p50_s": percentile(ttfts, 50) if ttfts else None,
        "ttft_p99_s": percentile(ttfts, 99) if ttfts else None,
        "itl_p50_s": percentile(itls, 50) if itls else None,
        "itl_p99_s": percentile(itls, 99) if itls else None,
        "preemptions": engine.scheduler.preemption_count,
        "prefill_compiles": engine.prefill_program_count,
        "max_concurrent_prefills": engine.max_concurrent_prefills,
        "prefix_hit_tokens": hit,
        # work avoided over work demanded, as the JAX bench reports it
        "prefix_hit_rate": round(hit / (hit + prefilled), 4) if hit + prefilled else 0.0,
        "prefilled_tokens": prefilled,
        "spec_drafted_tokens": engine.spec_drafted_tokens,
        "spec_accepted_tokens": engine.spec_accepted_tokens,
        "spec_accept_rate": round(rate, 4) if rate is not None else None,
        "engine": engine_shape_stats(engine),
        "kernel_launches": {k: v - kernel_before.get(k, 0) for k, v in launches.KERNEL.items()
                            if v > kernel_before.get(k, 0)},
        "plain_launches": {k: v - plain_before.get(k, 0) for k, v in launches.PLAIN.items()
                           if v > plain_before.get(k, 0)},
    }
    if extra_stats:
        stats.update(extra_stats)
    logger.log_event("serve-summary", **stats)
    get_registry().flush_step(engine.tick_index)
    return stats


def engine_shape_stats(engine) -> dict:
    """The engine's shape, carried by the serve-summary as the JAX bench
    carries it."""
    cfg = engine.config
    return {
        "mp": 1,
        "replicas": 1,
        "num_slots": cfg.num_slots,
        "block_size": cfg.block_size,
        "num_blocks": cfg.num_blocks,
        "token_budget": cfg.token_budget,
        "prefill_chunk": cfg.prefill_chunk,
        "spec_k": cfg.spec_k,
    }


def run_supervised(argv: List[str], args) -> int:
    """``--restarts N``: run the bench as a child process (``python -m
    scaling_tpu_torch.serve bench`` with the same flags) and relaunch it
    with ``--resume`` when it dies, so the request journal replays; exit 0
    the moment a child exits 0, the child's code once the budget is spent.
    ``SCALING_TPU_FAULTS`` arms the first launch only (hit counters are per
    process). SIGTERM to the supervisor is relayed to the running child,
    which drains, and ends the loop; a child that dies mid-drain is not
    relaunched. The supervisor never touches the card."""
    child_argv: List[str] = []
    skip = False
    for a in argv:
        if skip:
            skip = False
        elif a == "--restarts":
            skip = True
        elif not a.startswith("--restarts="):
            child_argv.append(a)
    env = dict(os.environ)
    state = {"child": None, "draining": False}

    def relay(signum, frame):
        state["draining"] = True
        child = state["child"]
        if child is not None and child.poll() is None:
            child.send_signal(signal.SIGTERM)

    prev = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM, relay)
    attempts = 0
    try:
        while True:
            if state["draining"]:
                # SIGTERM landed between a crash and the relaunch
                logger.log_event("serve-drain", supervisor=True)
                return 0
            cmd = [sys.executable, "-m", "scaling_tpu_torch.serve", "bench", *child_argv]
            if attempts > 0 and "--resume" not in child_argv:
                cmd.append("--resume")
            get_fault_plan().fire("serve.supervisor.spawn")
            with span("serve.supervisor.spawn", attempt=attempts):
                state["child"] = subprocess.Popen(cmd, env=env)
            if state["draining"]:  # the signal raced the launch
                state["child"].send_signal(signal.SIGTERM)
            rc = state["child"].wait()
            state["child"] = None
            if rc == 0:
                return 0
            if state["draining"]:
                logger.log_event("serve-drain-failed", rc=rc)
                return rc if rc > 0 else 1
            attempts += 1
            if attempts > args.restarts:
                logger.log_event("serve-give-up", attempts=attempts - 1, rc=rc)
                return rc if rc > 0 else 1
            logger.log_event("serve-restart", attempt=attempts, rc=rc)
            env.pop("SCALING_TPU_FAULTS", None)
    finally:
        signal.signal(signal.SIGTERM, prev)


def _run_spec_sweep(args, sweep_ks, workload, make_engine, warmup_engine) -> dict:
    """``--spec-k-sweep``: the same workload once per draft length k on a
    fresh engine each, then a final serve-summary carrying the arm with the
    most tokens/s and the whole sweep table."""
    from .engine import install_drain_handler

    arms = []
    for k in sweep_ks:
        engine = make_engine(spec_k=k)
        install_drain_handler(engine)  # chains: SIGTERM drains the current arm
        warmup_engine(engine)
        arms.append(run_bench(engine, list(workload), max_wall_s=args.max_wall_s,
                              tick_timeout_s=args.tick_timeout_s,
                              extra_stats={"spec_k": k}))
        if engine.draining:
            break  # SIGTERM mid-sweep: no further arm
    best = max(arms, key=lambda a: a["tokens_per_s"])
    stats = dict(best)
    stats["spec_k_best"] = best["spec_k"]
    stats["spec_k_sweep"] = [
        {k: a[k] for k in ("spec_k", "tokens_per_s", "spec_accept_rate", "ttft_p99_s")}
        for a in arms
    ]
    logger.log_event("serve-summary", **stats)
    return stats


@contextlib.contextmanager
def recording_to(run_dir: Optional[str]):
    """The bench's own sinks for the body. The process logger's events
    file and step-metrics sink, and the registry's explicit sink, are off
    whatever they were before (a Trainer run in the same process leaves
    its own there). With ``run_dir`` the events go into
    ``run_dir/events.jsonl`` (unless ``SCALING_TPU_EVENTS_PATH`` already
    names a file) and the registry's snapshots into
    ``run_dir/metrics.jsonl``; without it only a file the environment
    names is written. All of it is put back as it was after the body."""
    reg = get_registry()
    config, sink_before = logger.config, reg._metrics_path
    env_before = os.environ.get("SCALING_TPU_EVENTS_PATH")
    # the sinks only: the console and log-file handlers stay as they are
    logger.config = dataclasses.replace(config, events_path=None, metrics_jsonl=False)
    reg._metrics_path = None
    if run_dir is not None:
        Path(run_dir).mkdir(parents=True, exist_ok=True)
        os.environ.setdefault("SCALING_TPU_EVENTS_PATH", str(Path(run_dir) / "events.jsonl"))
        reg.configure(metrics_path=str(Path(run_dir) / "metrics.jsonl"))
    try:
        yield
    finally:
        logger.config, reg._metrics_path = config, sink_before
        if env_before is None:
            os.environ.pop("SCALING_TPU_EVENTS_PATH", None)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m scaling_tpu_torch.serve bench",
                                allow_abbrev=False)
    p.add_argument("--model", choices=sorted(MODELS), default="toy")
    p.add_argument("--checkpoint", metavar="DIR",
                   help="serve this checkpoint's weights instead of --model's random ones")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--rate", type=float, default=8.0, help="Poisson arrivals, req/s")
    p.add_argument("--prompt-len", type=int, nargs=2, default=(4, 24))
    p.add_argument("--output-len", type=int, nargs=2, default=(4, 16))
    p.add_argument("--shared-prefix-len", type=int, default=0)
    p.add_argument("--seed", type=int, default=0, help="weights and workload")
    p.add_argument("--kv-dtype", choices=["native", "int8"], default="native")
    p.add_argument("--num-slots", type=int, default=8)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--num-blocks", type=int, default=128)
    p.add_argument("--max-blocks-per-seq", type=int, default=16)
    p.add_argument("--token-budget", type=int, default=512)
    p.add_argument("--prefill-chunk", type=int, default=32,
                   help="tokens per prefill chunk; 0 = whole-prompt prefill")
    p.add_argument("--paged-kernel", choices=["pallas", "xla"], default="pallas",
                   help="'pallas' is the paged kernel; 'xla' is not ported")
    p.add_argument("--no-fused-tick", action="store_true",
                   help="separate decode and chunk forwards instead of one mixed forward")
    p.add_argument("--no-prefix-cache", action="store_true")
    p.add_argument("--spec-k", type=int, default=0,
                   help="n-gram draft tokens scored per decode row per tick (0 = off)")
    p.add_argument("--spec-k-sweep", metavar="LIST",
                   help="comma list of k: the workload once per k on a fresh engine, "
                        "no journal; the summary carries every arm and the best")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="per-request total deadline, ms from arrival")
    p.add_argument("--ttft-deadline-ms", type=float, default=None,
                   help="per-request first-token deadline, ms from arrival")
    p.add_argument("--shed-high-watermark", type=float, default=None,
                   help="pool pressure above which submissions are shed")
    p.add_argument("--shed-low-watermark", type=float, default=None,
                   help="pool pressure at which shedding stops (default: the high one)")
    p.add_argument("--max-waiting", type=int, default=None,
                   help="waiting-queue depth beyond which submissions are shed")
    p.add_argument("--no-journal", action="store_true",
                   help="no crash-replay request journal (<run-dir>/journal.jsonl)")
    p.add_argument("--resume", action="store_true",
                   help="replay <run-dir>/journal.jsonl first and skip the workload "
                        "items it consumed")
    p.add_argument("--restarts", type=int, default=0,
                   help="supervise the bench as child processes, relaunching with "
                        "--resume after a crash, up to N times")
    p.add_argument("--tick-timeout-s", type=float, default=0.0,
                   help="tick-stall watchdog: SIGKILL after a tick this long (0 = off)")
    p.add_argument("--warmup", type=int, default=1,
                   help="requests served before the measured run (kernel builds)")
    p.add_argument("--max-wall-s", type=float, default=600.0)
    p.add_argument("--json", metavar="FILE", help="also write the stats here")
    p.add_argument("--run-dir", metavar="DIR",
                   help="record events, registry snapshots and the request journal here")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = p.parse_args(argv)
    sweep_ks = None
    if args.spec_k_sweep:
        try:
            sweep_ks = sorted({int(x) for x in args.spec_k_sweep.split(",") if x.strip()})
        except ValueError:
            sweep_ks = None
        if not sweep_ks or any(k < 0 for k in sweep_ks):
            p.error(f"bad --spec-k-sweep {args.spec_k_sweep!r} "
                    "(want a comma list of ints >= 0)")
        if args.resume:
            p.error("--spec-k-sweep runs without a journal; --resume has nothing to replay")
    if (args.resume or args.restarts) and args.run_dir is None:
        p.error("--resume and --restarts need --run-dir (the journal lives there)")
    with recording_to(args.run_dir):
        if args.restarts > 0:
            return run_supervised(argv, args)
        prev = signal.getsignal(signal.SIGTERM)
        try:
            return _bench(args, sweep_ks)
        finally:
            # the run's drain handlers hold its engines: put back the one before
            signal.signal(signal.SIGTERM, prev)


def _bench(args, sweep_ks) -> int:
    from .engine import EngineConfig, ServeEngine, install_drain_handler

    device = resolve_device(args.device)
    free = total = None
    if device.type == "cuda":  # what the card offers this process, before the model
        free, total = torch.cuda.mem_get_info(device)
    logger.log_event("serve-start", device=str(device), free_bytes=free, total_bytes=total)
    if args.checkpoint:
        from ..models.transformer import TransformerInferenceModule

        inf = TransformerInferenceModule.from_checkpoint(args.checkpoint, device=device)
    else:
        inf = build_inference(args.model, seed=args.seed, device=device)

    def make_engine(spec_k=None):
        return ServeEngine(inf, EngineConfig(
            num_slots=args.num_slots, block_size=args.block_size,
            num_blocks=args.num_blocks, max_blocks_per_seq=args.max_blocks_per_seq,
            token_budget=args.token_budget, kv_dtype=args.kv_dtype,
            prefill_chunk=args.prefill_chunk or None, paged_kernel=args.paged_kernel,
            fused_tick=not args.no_fused_tick,
            enable_prefix_cache=not args.no_prefix_cache,
            spec_k=args.spec_k if spec_k is None else spec_k,
            default_deadline_ms=args.deadline_ms,
            default_ttft_deadline_ms=args.ttft_deadline_ms,
            shed_high_watermark=args.shed_high_watermark,
            shed_low_watermark=args.shed_low_watermark,
            max_waiting=args.max_waiting,
        ), device=device)

    def warmup_engine(engine):  # off the books: the kernels' first builds
        if args.warmup:
            engine.warmup_mode = True
            engine.submit(list(range(1, args.prompt_len[0] + 1)), args.output_len[0])
            engine.run_until_done()
            engine.warmup_mode = False

    vocab = inf.architecture.vocab_size
    work = sample_workload(args.requests, args.rate, args.prompt_len,
                           args.output_len, vocab, args.seed,
                           shared_prefix_len=args.shared_prefix_len)
    offered = len(work)
    if sweep_ks is not None:
        stats = _run_spec_sweep(args, sweep_ks, work, make_engine, warmup_engine)
    else:
        engine = make_engine()
        install_drain_handler(engine)
        t_replay = time.monotonic()
        replay = None
        if args.run_dir is not None and not args.no_journal:
            # --resume folds the crashed run's journal first; a fresh run
            # truncates a stale one of an earlier run in this directory
            journal, replay = open_journal(Path(args.run_dir) / "journal.jsonl", args.resume)
            engine.attach_journal(journal)
        elif args.resume:
            replay = replay_journal(Path(args.run_dir) / "journal.jsonl")
        replay_s = time.monotonic() - t_replay
        warmup_engine(engine)
        extra_stats = carry = None
        if replay is not None and replay.offered_count:
            # crash replay: every request without a terminal status again
            # under its own id (the sampler keys fold it), forced past
            # backpressure, then the workload items the crashed run never
            # consumed, arriving from t = 0
            t_replay = time.monotonic()
            engine._next_req_id = replay.next_req_id
            for rec in replay.incomplete:
                engine.submit(
                    rec["prompt"], rec["max_new_tokens"],
                    eos_token_id=rec.get("eos_token_id"),
                    temperature=rec.get("temperature", 0.0),
                    top_k=rec.get("top_k"), top_p=rec.get("top_p"),
                    deadline_ms=rec.get("deadline_ms"),
                    ttft_deadline_ms=rec.get("ttft_deadline_ms"),
                    req_id=int(rec["req"]), force=True, trace=rec.get("trace"),
                )
            replay_s += time.monotonic() - t_replay
            work = sorted(work, key=lambda w: w[0])[replay.offered_count:]
            if work:
                base = work[0][0]
                work = [(a - base, p, o) for a, p, o in work]
            extra_stats = {"resumed": True,
                           "replayed_incomplete": len(replay.incomplete),
                           "replayed_completed": len(replay.completed)}
            carry = {"completed": len(replay.completed), "timeouts": replay.timeout_count,
                     "shed": replay.shed_count, "offered": replay.offered_count}
            # replay_s: the journal's read and the resubmissions, for the
            # time to recover's split
            logger.log_event("serve-resume", incomplete=len(replay.incomplete),
                             completed=len(replay.completed), remaining_workload=len(work),
                             replay_s=round(replay_s, 6))
        stats = run_bench(engine, work, max_wall_s=args.max_wall_s,
                          tick_timeout_s=args.tick_timeout_s, extra_stats=extra_stats,
                          carry=carry)
    stats["device"] = (torch.cuda.get_device_name(device) if device.type == "cuda"
                       else "cpu")
    stats.update(model=args.checkpoint or args.model, kv_dtype=args.kv_dtype)

    def fmt(v):
        return "n/a" if v is None else f"{v:.4f}s"

    print("== serve bench (scaling_tpu_torch) ==")
    print(f"  device={stats['device']} model={stats['model']} kv_dtype={args.kv_dtype}")
    print(f"  requests={stats['offered']} completed={stats['completed']} "
          f"wall={stats['wall_s']:.3f}s ticks={stats['ticks']} "
          f"preemptions={stats['preemptions']} "
          f"prefix_hit_tokens={stats['prefix_hit_tokens']}")
    if stats["requests_shed"] or stats["requests_timeout"] or stats["drained"]:
        print(f"  resilience: shed={stats['requests_shed']} "
              f"(rate {stats['shed_rate']:.1%}) timeouts={stats['requests_timeout']} "
              f"drained={stats['drained']} unsubmitted={stats['unsubmitted']}")
    print(f"  hot path: paged_kernel={args.paged_kernel} "
          f"prefill_chunk={args.prefill_chunk or 'off'} "
          f"fused_tick={not args.no_fused_tick} "
          f"max_concurrent_prefills={stats['max_concurrent_prefills']}")
    if stats.get("spec_k_sweep"):
        print(f"  spec-k sweep (best k={stats['spec_k_best']}):")
        for row in stats["spec_k_sweep"]:
            ar = row["spec_accept_rate"]
            print(f"    k={row['spec_k']}: {row['tokens_per_s']:.1f} tok/s accept="
                  f"{'n/a' if ar is None else format(ar, '.1%')}")
    if stats["spec_accept_rate"] is not None:
        print(f"  speculation: k={stats['engine']['spec_k']} accepted "
              f"{stats['spec_accepted_tokens']}/{stats['spec_drafted_tokens']} drafts "
              f"(accept rate {stats['spec_accept_rate']:.1%})")
    print(f"  output tokens/s: {stats['tokens_per_s']:.1f} "
          f"({stats['output_tokens']} tokens)")
    print(f"  ttft: p50={fmt(stats['ttft_p50_s'])} p99={fmt(stats['ttft_p99_s'])}")
    print(f"  itl:  p50={fmt(stats['itl_p50_s'])} p99={fmt(stats['itl_p99_s'])}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(stats, f, indent=2)
    ended = (stats["requests"] + stats["requests_timeout"] + stats["requests_shed"]
             + stats["unsubmitted"])
    # every offered workload item completed, timed out, was shed or was
    # left unsubmitted by a drain
    return 0 if ended == offered or sweep_ks is not None else 1
