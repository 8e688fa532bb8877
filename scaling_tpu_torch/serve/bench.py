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

The fleet (the JAX bench's ``--replicas`` and ``--replicas-proc``): one
Poisson stream through ``router.FleetRouter`` to N replicas, either N
engines ticked by threads in this process (``--replicas N``, replica r
on ``cuda:(r % device count)``; ``--prefix-families`` gives the shared
prefix several families, which prefix affinity keeps together), or N
worker processes supervised by ``replica_proc.FleetSupervisor``
(``--replicas-proc N``: journal-exact failover of a dead replica, a
budgeted relaunch, ``--autoscale``). The process fleet's host builds no
model and initialises no CUDA. Host mode (``--hostsfile``), the capacity
channel (``--capacity-dir``) and ``--mp > 1`` are not ported and fail by
name.

``--config FILE`` reads the serving config ``python -m
scaling_tpu_torch.tune --serve --emit-config FILE`` writes: its
``block_size``, ``token_budget``, ``num_slots``, ``num_blocks`` (and
``max_blocks_per_seq`` when present) become the defaults, and a flag
given on the command line wins over the file. An emitted ``mp`` or
``replicas`` above 1 (a fleet of several devices) fails by name.

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
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..logging.logger import logger
from ..obs import get_registry, new_trace_id, span, trace_context
from ..ops import launches
from ..resilience import StepStallWatchdog
from ..resilience.faults import get_fault_plan
from .journal import journal_path, open_journal, replay_journal
from .scheduler import Backpressure

# bench.py:build at its defaults (hidden 2048, 8 layers) with
# BENCH_NORM=fused, i.e. layernorm.optimization_type: fused
MODELS_05B: Dict[str, Any] = {
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
}

MODELS: Dict[str, dict] = {
    "0.5b": MODELS_05B,
    # the 0.5B widths with a routed expert MLP (8 SwiGLU experts, top-2, the JAX
    # defaults of capacity and aux loss) under muP from a 256-wide base: width
    # multiplier 8, attention scale 1/32; the head drawn, not zeroed, with
    # output_mult 2. 2,432,903,168 parameters
    "0.5b-moe": {
        **{k: v for k, v in MODELS_05B.items() if k != "mlp_type"},
        "mlp_type": "moe",
        "mlp_bias": False,
        "activation_function": "silu",
        "moe_num_experts": 8,
        "moe_top_k": 2,
        "moe_capacity_factor": 1.25,
        "moe_aux_loss_coef": 0.01,
        "mup": {"base_hidden_size": 256, "output_mult": 2.0, "readout_zero_init": False},
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
                    vocab: int, seed: int, shared_prefix_len: int = 0,
                    prefix_families: int = 1):
    """Poisson arrival offsets plus per-request prompts and output budgets.
    ``shared_prefix_len > 0`` prepends one of ``prefix_families`` fixed
    system prompts of that length to every request, request ``i`` taking
    family ``i % prefix_families`` (the prefix-cache case, and the traffic
    the fleet router's prefix affinity is for). The same draws as the JAX
    bench's ``sample_workload``."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(1, vocab, size=shared_prefix_len).tolist()
                for _ in range(prefix_families)]
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))
    arrivals[0] = 0.0  # the first request opens the run
    work = []
    for i in range(n_requests):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        olen = int(rng.integers(output_len[0], output_len[1] + 1))
        work.append((float(arrivals[i]), prefixes[i % prefix_families]
                     + rng.integers(1, vocab, size=plen).tolist(), olen))
    return work


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation)."""
    s = sorted(values)
    return s[max(0, min(len(s) - 1, math.ceil(q / 100.0 * len(s)) - 1))]


def _latencies(seqs) -> tuple:
    """(TTFTs, ITLs) of finished sequences, seconds."""
    ttfts = [s.first_token_s - s.request.arrival_s for s in seqs if s.first_token_s is not None]
    itls = [b - a for s in seqs for a, b in zip(s.token_stamps, s.token_stamps[1:])]
    return ttfts, itls


def _pct(values: List[float], q: float) -> Optional[float]:
    return percentile(values, q) if values else None


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
    kernel_before = launches.snapshot(launches.KERNEL)
    plain_before = launches.snapshot(launches.PLAIN)
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
    ttfts, itls = _latencies(seqs)
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
        "ttft_p50_s": _pct(ttfts, 50),
        "ttft_p99_s": _pct(ttfts, 99),
        "itl_p50_s": _pct(itls, 50),
        "itl_p99_s": _pct(itls, 99),
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
        "kernel_launches": launches_since(launches.KERNEL, kernel_before),
        "plain_launches": launches_since(launches.PLAIN, plain_before),
    }
    if extra_stats:
        stats.update(extra_stats)
    logger.log_event("serve-summary", **stats)
    get_registry().flush_step(engine.tick_index)
    return stats


def launches_since(counter, before: dict) -> dict:
    """``counter``'s launches since the snapshot ``before``, the keys that
    moved only."""
    now = launches.snapshot(counter)
    return {k: v - before.get(k, 0) for k, v in now.items() if v > before.get(k, 0)}


def engine_shape_stats(engine, replicas: int = 1) -> dict:
    """The engine's shape, carried by the serve-summary as the JAX bench
    carries it."""
    cfg = engine.config
    return {
        "mp": 1,
        "replicas": replicas,
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


def engine_kwargs(args, spec_k: Optional[int] = None) -> dict:
    """The ``EngineConfig`` keywords of the bench's flags (JSON-safe: a
    process replica's worker config carries them)."""
    return dict(
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
    )


def replica_device(device: str, replica_id: int) -> str:
    """Where fleet replica ``replica_id`` runs: ``cuda`` without an index
    places replica r on ``cuda:(r % device_count)`` (the JAX fleet's
    ``device_offset = r * mp``; on one card every replica shares cuda:0);
    any other device is taken as given. Reads the device count only,
    which initialises no CUDA context."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return f"cuda:{replica_id % max(1, torch.cuda.device_count())}"
    return str(dev)


def run_fleet_bench(router, workload, max_wall_s: float = 600.0,
                    extra_stats: Optional[dict] = None, carry: Optional[dict] = None,
                    fleet_journal=None) -> dict:
    """Open-loop drive of the in-process fleet (``--replicas N``): one
    Poisson stream submits through the router while one tick thread a
    replica runs its engine. On the card each tick thread runs on a CUDA
    stream of its own, so a replica's device->host pull waits for its own
    kernels only; the builds and warm-ups are synchronised before the
    threads start. A submission the whole fleet sheds is counted (and
    journaled in the fleet-level journal: replica journals only see their
    own admissions), not retried; SIGTERM drains every replica and the
    loop ends once the last in-flight request finishes. The summary
    carries the JAX bench's fleet fields (``replicas``, ``replica_stats``,
    ``router``), the launches of the run and each replica's own (its tick
    thread's, ``ops.launches.tally``); the returned stats also carry
    ``outputs`` (request id -> tokens of the completed requests)."""
    handles = list(router.replicas)
    engines = [h.engine for h in handles]
    start_ticks = {h.replica_id: h.engine.tick_index for h in handles}
    start_finished = {h.replica_id: len(h.engine.finished) for h in handles}
    tallies: Dict[int, dict] = {}
    stop = threading.Event()
    # a tick thread that dies is THE bench error, not a silent hang until
    # max_wall_s (the survivors keep has_work true for its stranded requests)
    errors: List[BaseException] = []
    for dev in {e.device for e in engines if e.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    kernel_before = launches.snapshot(launches.KERNEL)
    plain_before = launches.snapshot(launches.PLAIN)

    def tick_loop(handle):
        eng = handle.engine
        on_card = eng.device.type == "cuda"
        stream = (torch.cuda.stream(torch.cuda.Stream(eng.device)) if on_card
                  else contextlib.nullcontext())
        try:
            with stream, launches.tally() as tally:
                tallies[handle.replica_id] = tally
                while not stop.is_set():
                    if eng.scheduler.has_work:
                        with handle.lock:
                            if not eng.scheduler.has_work:
                                continue
                            with span("serve.tick", step=eng.tick_index,
                                      replica=handle.replica_id):
                                eng.tick()
                    else:
                        time.sleep(0.001)
                if on_card:
                    torch.cuda.current_stream(eng.device).synchronize()
        except BaseException as e:  # re-raised by the loop below
            errors.append(e)
            stop.set()

    threads = [threading.Thread(target=tick_loop, args=(h,), daemon=True,
                                name=f"serve-replica-{h.replica_id}")
               for h in handles if h.alive]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    pending = sorted(workload, key=lambda w: w[0])
    idx = 0
    shed = 0
    try:
        while True:
            if errors:
                raise RuntimeError("a replica tick thread died") from errors[0]
            now = time.monotonic() - t0
            if now > max_wall_s:
                raise RuntimeError(
                    f"fleet bench exceeded max_wall_s={max_wall_s}: {idx}/{len(pending)} "
                    f"submitted, {sum(len(e.finished) for e in engines)} finished")
            draining = any(h.engine.draining for h in handles if h.alive)
            while not draining and idx < len(pending) and pending[idx][0] <= now:
                arrival, prompt, olen = pending[idx]
                with trace_context(new_trace_id()):
                    res = router.submit(prompt, olen, arrival_s=t0 + arrival)
                if isinstance(res, Backpressure):
                    if res.draining:
                        draining = True  # SIGTERM raced this submission
                        break
                    # the whole fleet shed this offer: consumed, journaled at
                    # fleet level, counted on the unlabelled shed counter
                    shed += 1
                    get_registry().counter("serve_requests_shed_total").inc()
                    if fleet_journal is not None:
                        fleet_journal.record_shed(res.reason)
                idx += 1
            if (draining or idx >= len(pending)) and not router.has_work:
                break
            time.sleep(0.002)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    wall_s = time.monotonic() - t0
    finished = {h.replica_id: h.engine.finished[start_finished[h.replica_id]:]
                for h in handles}
    seqs = [s for h in handles for s in finished[h.replica_id]]
    completed = [s for s in seqs if s.finish_status == "completed"]
    ttfts, itls = _latencies(seqs)
    out_tokens = sum(len(s.generated) for s in seqs)
    carry = carry or {}
    n_completed = len(completed) + int(carry.get("completed", 0))
    total_shed = shed + int(carry.get("shed", 0))
    timeouts = sum(e.timeout_count for e in engines) + int(carry.get("timeouts", 0))
    attempts = total_shed + timeouts + n_completed
    hit = sum(e.scheduler.prefix_hit_tokens for e in engines)
    prefilled = sum(e.prefilled_tokens for e in engines)
    drafted = sum(e.spec_drafted_tokens for e in engines)
    accepted = sum(e.spec_accepted_tokens for e in engines)
    rstats = router.stats()
    replica_rows = []
    for h in handles:
        e, mine = h.engine, finished[h.replica_id]
        tally = tallies.get(h.replica_id, {"kernel": {}, "plain": {}})
        replica_rows.append({
            "replica": h.replica_id,
            "device": str(e.device),
            "alive": h.alive,
            "requests": sum(1 for s in mine if s.finish_status == "completed"),
            "output_tokens": sum(len(s.generated) for s in mine),
            "timeouts": e.timeout_count,
            "ticks": e.tick_index - start_ticks[h.replica_id],
            "preemptions": e.scheduler.preemption_count,
            "pool_pressure": round(e.scheduler.pool_pressure(), 4),
            "kernel_launches": dict(tally["kernel"]),
            "plain_launches": dict(tally["plain"]),
            **rstats["per_replica"].get(h.replica_id, {}),
        })
    stats = {
        "requests": n_completed,
        "completed": n_completed,
        "offered": len(pending) + int(carry.get("offered", 0)),
        "requests_timeout": timeouts,
        "requests_shed": total_shed,
        "shed_rate": round(total_shed / attempts, 4) if attempts else 0.0,
        "drained": any(e.draining for e in engines),
        "unsubmitted": len(pending) - idx,
        "output_tokens": out_tokens,
        "prompt_tokens": sum(len(s.request.prompt) for s in seqs),
        "wall_s": wall_s,
        "ticks": sum(e.tick_index - start_ticks[h.replica_id] for h, e in zip(handles, engines)),
        "tokens_per_s": out_tokens / wall_s if wall_s > 0 else 0.0,
        "ttft_p50_s": _pct(ttfts, 50),
        "ttft_p99_s": _pct(ttfts, 99),
        "itl_p50_s": _pct(itls, 50),
        "itl_p99_s": _pct(itls, 99),
        "preemptions": sum(e.scheduler.preemption_count for e in engines),
        "prefill_compiles": sum(e.prefill_program_count for e in engines),
        "max_concurrent_prefills": max(e.max_concurrent_prefills for e in engines),
        "prefix_hit_tokens": hit,
        "prefix_hit_rate": round(hit / (hit + prefilled), 4) if hit + prefilled else 0.0,
        "prefilled_tokens": prefilled,
        "spec_drafted_tokens": drafted,
        "spec_accepted_tokens": accepted,
        "spec_accept_rate": round(accepted / drafted, 4) if drafted else None,
        "replicas": len(handles),
        "replica_stats": replica_rows,
        "router": rstats,
        "engine": engine_shape_stats(engines[0], replicas=len(handles)),
        "kernel_launches": launches_since(launches.KERNEL, kernel_before),
        "plain_launches": launches_since(launches.PLAIN, plain_before),
    }
    if extra_stats:
        stats.update(extra_stats)
    logger.log_event("serve-summary", **stats)
    # as the process fleet's: the returned stats and --json carry the
    # completed requests' tokens, the event does not
    stats["outputs"] = {str(s.request.req_id): list(s.generated) for s in completed}
    get_registry().flush_step(max(e.tick_index for e in engines))
    return stats


def _run_fleet(args, infs, workload, make_engine, warmup_engine) -> dict:
    """``--replicas N``: N engines behind the prefix-affinity router, a
    journal namespace each (``journal_r<id>``, with ``--run-dir``) and a
    fleet-level one for whole-fleet sheds, the SIGTERM drain fanned out,
    ``--resume`` replaying each replica's namespace into its engine, one
    Poisson stream through ``run_fleet_bench``."""
    from .router import FleetRouter, install_fleet_drain_handler

    engines = [make_engine(replica_id=r, inf=infs[r]) for r in range(args.replicas)]
    router = FleetRouter(engines)
    install_fleet_drain_handler(router)
    fleet_journal = fleet_replay = None
    replays = {}
    if args.run_dir is not None:
        journal_base = Path(args.run_dir) / "journal.jsonl"
        if not args.no_journal:
            for r, engine in enumerate(engines):
                journal, replays[r] = open_journal(journal_base, args.resume, replica_id=r)
                engine.attach_journal(journal)
            # whole-fleet sheds only: the resume's skip needs one record per
            # consumed workload item, and a shed offer reached no replica
            fleet_journal, fleet_replay = open_journal(journal_base, args.resume)
        elif args.resume:
            replays = {r: replay_journal(journal_path(journal_base, r))
                       for r in range(args.replicas)}
            fleet_replay = replay_journal(journal_base)
    for engine in engines:
        warmup_engine(engine)
    extra_stats = carry = None
    offered = sum(rep.offered_count for rep in replays.values() if rep is not None) + (
        fleet_replay.shed_count if fleet_replay is not None else 0)
    if args.resume and offered:
        incomplete = completed = timeouts = 0
        for r, rep in sorted(replays.items()):
            if rep is None:
                continue
            engine = engines[r]
            engine._next_req_id = rep.next_req_id
            # each replica replays its own namespace under the original ids
            for rec in rep.incomplete:
                engine.submit(
                    rec["prompt"], rec["max_new_tokens"],
                    eos_token_id=rec.get("eos_token_id"),
                    temperature=rec.get("temperature", 0.0),
                    top_k=rec.get("top_k"), top_p=rec.get("top_p"),
                    deadline_ms=rec.get("deadline_ms"),
                    ttft_deadline_ms=rec.get("ttft_deadline_ms"),
                    req_id=int(rec["req"]), force=True, trace=rec.get("trace"),
                )
            incomplete += len(rep.incomplete)
            completed += len(rep.completed)
            timeouts += rep.timeout_count
        router.sync_next_req_id()
        workload = sorted(workload, key=lambda w: w[0])[offered:]
        if workload:
            base = workload[0][0]
            workload = [(a - base, p, o) for a, p, o in workload]
        extra_stats = {"resumed": True, "replayed_incomplete": incomplete,
                       "replayed_completed": completed}
        carry = {"completed": completed, "timeouts": timeouts, "offered": offered,
                 "shed": fleet_replay.shed_count if fleet_replay is not None else 0}
        logger.log_event("serve-resume", incomplete=incomplete, completed=completed,
                         remaining_workload=len(workload))
    return run_fleet_bench(router, workload, max_wall_s=args.max_wall_s,
                           extra_stats=extra_stats, carry=carry, fleet_journal=fleet_journal)


def _run_fleet_proc(args, workload, run_dir: Path) -> dict:
    """``--replicas-proc N``: every replica a subprocess behind the same
    router policy, supervised by ``replica_proc.FleetSupervisor``: a
    SIGKILLed replica's journal is harvested, its incomplete requests go
    to the survivors token-exact, and it relaunches on the budgeted
    backoff; with ``--autoscale`` the supervisor also spawns under
    sustained pressure and drains at sustained idle.

    The host initialises no CUDA and is single-threaded: submissions,
    polls and supervision all run on this loop. Finished requests come
    back through cursor-based ``poll`` RPCs; the returned stats' ``outputs``
    (request id -> tokens) is what the failover drill holds against a
    fault-free run. The summary also records the host's
    ``torch.cuda.is_initialized()``, each replica's launches (from its
    stats, the dead incarnations' as of their last heartbeat), the
    longest tick-loop age and stats round trip seen, and each worker's
    exit code."""
    from concurrent.futures import ThreadPoolExecutor

    from .journal import RequestJournal
    from .replica_proc import FleetSupervisor, spawn_replica_proc
    from .router import AutoscalePolicy, FleetRouter, ReplicaUnreachable

    journal_base = run_dir / "journal.jsonl"
    # a fresh run: stale journals of an earlier run in this directory (any
    # replica id) would poison the failover harvests, and a stale
    # rendezvous file would answer a ready-wait with a dead address
    for stale in run_dir.glob(f"{journal_base.stem}*{journal_base.suffix}"):
        stale.unlink()
    rendezvous = run_dir / "rendezvous.jsonl"
    if rendezvous.exists():
        rendezvous.unlink()
    fleet_journal = RequestJournal(journal_base)
    worker_cfg = {
        "journal_base": str(journal_base),
        "metrics_path": str(run_dir / "metrics.jsonl") if args.run_dir is not None else None,
        "warmup": args.warmup,
        "model": args.model,
        "seed": args.seed,
        "engine": engine_kwargs(args),
    }
    chaos_env = dict(os.environ)
    clean_env = dict(os.environ)
    # a fault plan arms the initial spawns only: hit counters are per
    # process, and a relaunch armed the same way would die at the same hit
    clean_env.pop("SCALING_TPU_FAULTS", None)

    def spawn(replica_id, env=None):
        cfg = dict(worker_cfg, device=replica_device(args.device, replica_id))
        return spawn_replica_proc(replica_id, cfg, run_dir,
                                  env=clean_env if env is None else env)

    drain_req = {"flag": False}

    def drain_signal(signum, frame):
        drain_req["flag"] = True  # the RPC fan-out runs on the loop

    # installed before the spawns: a drain signal sent at the first ready
    # event must not kill the bench under its workers
    prev = signal.signal(signal.SIGTERM, drain_signal)
    # parallel launch: the workers start up together
    with ThreadPoolExecutor(max_workers=args.replicas_proc) as ex:
        futures = [ex.submit(spawn, r, chaos_env) for r in range(args.replicas_proc)]
    handles = [f.result() for f in futures if f.exception() is None]
    failed = [f.exception() for f in futures if f.exception() is not None]
    if failed:
        with span("serve.fleet.teardown", phase="spawn-failed"):
            for h in handles:
                h.kill()
        signal.signal(signal.SIGTERM, prev)
        raise failed[0]
    print("  placement: " + ", ".join(
        f"replica {r} -> {replica_device(args.device, r)} (pid {h.proc.pid})"
        for r, h in enumerate(handles)), flush=True)
    router = FleetRouter(handles=handles, block_size=args.block_size)
    policy = None
    if args.autoscale:
        policy = AutoscalePolicy(min_replicas=args.min_replicas, max_replicas=args.max_replicas,
                                 sustain_s=args.autoscale_sustain_s,
                                 idle_sustain_s=args.autoscale_idle_s,
                                 cooldown_s=args.autoscale_sustain_s)
    recs: dict = {}  # req_id -> finished record, the newest wins

    def harvest(handle):
        try:
            for rec in handle.poll_finished():
                recs[int(rec["req"])] = rec
        except ReplicaUnreachable:
            pass  # a dead replica: the journal harvest owns its outputs

    sup = FleetSupervisor(router, spawn, journal_base, restart_budget=args.restart_budget,
                          policy=policy, on_drain=harvest)
    pending = sorted(workload, key=lambda w: w[0])
    idx = 0
    shed = 0
    draining = False
    t0 = time.monotonic()
    last_sup = -1.0
    try:
        while True:
            now = time.monotonic() - t0
            if now > args.max_wall_s:
                raise RuntimeError(
                    f"proc fleet bench exceeded --max-wall-s={args.max_wall_s}: "
                    f"{idx}/{len(pending)} submitted, {len(recs)} finished")
            if drain_req["flag"] and not draining:
                draining = True
                logger.log_event("serve-drain", fleet=True, replicas=len(router.live))
                router.begin_drain()
            if now - last_sup >= 0.05:
                last_sup = now
                sup.tick()
                for h in router.replicas:
                    if h.alive and not h.retired:
                        harvest(h)
            if sup.gave_up and not router.live:
                raise RuntimeError("every replica exhausted its restart budget; "
                                   f"{len(sup.orphans)} request(s) stranded")
            while not draining and idx < len(pending) and pending[idx][0] <= now:
                arrival, prompt, olen = pending[idx]
                # the RPC envelope carries the request's trace to its worker
                with trace_context(new_trace_id()):
                    res = router.submit(prompt, olen)
                if isinstance(res, Backpressure):
                    if res.draining:
                        draining = True  # SIGTERM raced this submission
                        break
                    shed += 1
                    get_registry().counter("serve_requests_shed_total").inc()
                    fleet_journal.record_shed(res.reason)
                idx += 1
            if (draining or idx >= len(pending)) and not router.has_work \
                    and not sup.pending_recovery():
                break
            time.sleep(0.002)
        # the autoscale settle: hold the fleet idle long enough for the
        # policy's idle drain, bounded by the wall clock
        if policy is not None and not draining:
            deadline = min(time.monotonic() + (policy.idle_sustain_s + policy.cooldown_s) * 2
                           + 1.0, t0 + args.max_wall_s)
            while (sum(1 for h in router.replicas if h.alive and not h.retired)
                   > policy.min_replicas and policy.drains < policy.drain_budget
                   and time.monotonic() < deadline):
                sup.tick()
                time.sleep(0.02)
        wall_s = time.monotonic() - t0
        for h in router.replicas:
            if h.alive and not h.retired:
                try:
                    h.refresh()
                except ReplicaUnreachable:
                    pass
                harvest(h)
                h.request_shutdown()
        get_fault_plan().fire("serve.fleet.teardown")
        with span("serve.fleet.teardown"):
            for h in router.replicas:
                if h.proc.poll() is None:
                    try:
                        h.proc.wait(timeout=30)
                    except subprocess.TimeoutExpired:
                        logger.warning(f"replica {h.replica_id} ignored shutdown; killing")
                        h.proc.kill()
    finally:
        signal.signal(signal.SIGTERM, prev)
        with span("serve.fleet.teardown", phase="finally"):
            for h in router.replicas:
                if h.proc.poll() is None:
                    h.kill()  # no orphan keeps writing to the run dir

    completed = {r: rec for r, rec in recs.items() if rec["status"] == "completed"}
    # the polled records, and the failover harvest for requests whose
    # replica died after finishing them
    outputs = {int(r): list(t) for r, t in sup.recovered.items()}
    outputs.update({r: list(rec["toks"]) for r, rec in completed.items()})
    timeouts = sup.recovered_timeouts + sum(1 for rec in recs.values()
                                            if rec["status"] == "timeout")
    attempts = shed + timeouts + len(outputs)
    out_tokens = sum(len(rec["toks"]) for rec in recs.values()) + sum(
        len(t) for r, t in sup.recovered.items() if r not in recs)
    ttfts = [rec["ttft_s"] for rec in recs.values() if rec.get("ttft_s") is not None]
    itls = [g for rec in recs.values() for g in rec.get("itls", ())]
    rstats = router.stats()
    agg = dict.fromkeys(("preemptions", "prefix_hit_tokens", "prefilled_tokens",
                         "spec_drafted_tokens", "spec_accepted_tokens", "prefill_compiles"), 0)
    ticks = max_prefills = submit_dups = rpc_retries = 0
    kernel_total, plain_total = Counter(), Counter()
    replica_rows = []
    for h in router.replicas:
        s = h.last_stats
        h_ticks = h.ticks_banked + int(s.get("tick", 0))
        ticks += h_ticks
        for k in agg:
            agg[k] += int(s.get(k, 0))
        max_prefills = max(max_prefills, int(s.get("max_concurrent_prefills", 0)))
        submit_dups += h.last_dups
        rpc_retries += h.rpc_retries
        kernel = h.launches_banked["kernel"] + Counter(s.get("kernel_launches", {}))
        plain = h.launches_banked["plain"] + Counter(s.get("plain_launches", {}))
        kernel_total += kernel
        plain_total += plain
        replica_rows.append({
            "replica": h.replica_id,
            "host": h.host_id,
            "device": replica_device(args.device, h.replica_id),
            "alive": h.alive,
            "retired": h.retired,
            "restarts": h.restarts,
            "dups": h.last_dups,
            "rpc_retries": h.rpc_retries,
            "requests": int(s.get("completed", 0)),
            "output_tokens": int(s.get("output_tokens", 0)),
            "timeouts": int(s.get("timeout_count", 0)),
            "ticks": h_ticks,
            "preemptions": int(s.get("preemptions", 0)),
            "pool_pressure": round(float(s.get("pool_pressure", 0.0)), 4),
            "kernel_launches": dict(kernel),
            "plain_launches": dict(plain),
            "max_loop_age_s": h.max_loop_age_s,
            "max_stats_rtt_s": h.max_rtt_s,
            "exit_code": h.proc.poll(),
            **rstats["per_replica"].get(h.replica_id, {}),
        })
    hit, prefilled = agg["prefix_hit_tokens"], agg["prefilled_tokens"]
    drafted = agg["spec_drafted_tokens"]
    stats = {
        "requests": len(outputs),
        "completed": len(outputs),
        "offered": len(pending),
        "requests_timeout": timeouts,
        "requests_shed": shed,
        "shed_rate": round(shed / attempts, 4) if attempts else 0.0,
        "drained": draining,
        "unsubmitted": len(pending) - idx,
        "wall_s": wall_s,
        "output_tokens": out_tokens,
        "prompt_tokens": sum(int(rec.get("prompt_len", 0)) for rec in recs.values()),
        "tokens_per_s": out_tokens / wall_s if wall_s > 0 else 0.0,
        "ttft_p50_s": _pct(ttfts, 50),
        "ttft_p99_s": _pct(ttfts, 99),
        "itl_p50_s": _pct(itls, 50),
        "itl_p99_s": _pct(itls, 99),
        "preemptions": agg["preemptions"],
        "ticks": ticks,
        "prefill_compiles": agg["prefill_compiles"],
        "max_concurrent_prefills": max_prefills,
        "prefix_hit_tokens": hit,
        "prefix_hit_rate": round(hit / (hit + prefilled), 4) if hit + prefilled else 0.0,
        "prefilled_tokens": prefilled,
        "spec_drafted_tokens": drafted,
        "spec_accepted_tokens": agg["spec_accepted_tokens"],
        "spec_accept_rate": (round(agg["spec_accepted_tokens"] / drafted, 4)
                             if drafted else None),
        "replicas": len(router.replicas),
        "replica_stats": replica_rows,
        "router": rstats,
        "engine": {
            "mp": 1, "replicas": len(router.replicas),
            "num_slots": args.num_slots, "block_size": args.block_size,
            "num_blocks": args.num_blocks, "token_budget": args.token_budget,
            "prefill_chunk": args.prefill_chunk or None, "spec_k": args.spec_k,
        },
        # what obs report's fleet section and --assert-max-replica-restarts read
        "proc_fleet": True,
        "replica_restarts": sup.restarts,
        "replica_spawns": policy.spawns if policy else 0,
        "replica_drains": policy.drains if policy else 0,
        "recovered_requests": len(sup.recovered),
        "redispatched_requests": sup.redispatched,
        "replicas_gave_up": len(sup.gave_up),
        "submit_dups": submit_dups,
        "rpc_retries": rpc_retries,
        "kernel_launches": dict(kernel_total),
        "plain_launches": dict(plain_total),
        "max_loop_age_s": max(h.max_loop_age_s for h in router.replicas),
        "max_stats_rtt_s": max(h.max_rtt_s for h in router.replicas),
        "host_cuda_initialized": torch.cuda.is_initialized(),
    }
    # the event goes without the outputs (events are telemetry, not
    # payloads); the returned stats and --json carry them
    logger.log_event("serve-summary", **stats)
    stats["outputs"] = {str(r): outputs[r] for r in sorted(outputs)}
    get_registry().flush_step(ticks)
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


# flags the JAX bench has whose paths are not ported; each is accepted and
# then refused by name (None: not given)
NOT_PORTED = {
    "hostsfile": "--hostsfile (host mode: replicas spawned over ssh on other hosts, their "
                 "advertised addresses and the control-plane flag rails) is not ported",
    "capacity_dir": "--capacity-dir (the elastic capacity channel with training, "
                    "resilience/capacity.py) is not ported",
    "capacity_publish_s": "--capacity-publish-s belongs to --capacity-dir, which is not "
                          "ported",
}

# the keys of a tuner-emitted serving config that become flag defaults
SERVING_CONFIG_KEYS = ("mp", "replicas", "block_size", "token_budget", "num_slots",
                       "num_blocks", "max_blocks_per_seq")


def apply_serving_config(args, argv: List[str], parser) -> None:
    """Fold a tuner-emitted serving config (``tune --serve --emit-config``)
    into the parsed ``args`` as DEFAULTS: a flag the user passed on the
    command line wins over the file. An ``mp`` or ``replicas`` above 1
    fails by name: the port serves a config of one device."""
    from ..resilience.guards import retry_io

    try:
        cfg = json.loads(retry_io(Path(args.config).read_text, what="serving config read"))
    except (OSError, ValueError) as e:
        parser.error(f"--config {args.config}: unreadable ({e})")
    if not isinstance(cfg, dict):
        parser.error(f"--config {args.config}: not a JSON object")
    for key in ("mp", "replicas"):
        if int(cfg.get(key, 1)) > 1:
            parser.error(f"--config {args.config}: {key}={cfg[key]} (a serving fleet of "
                         "several devices) is not ported; the port serves one device")
    passed = {a[2:].split("=", 1)[0].replace("-", "_") for a in argv if a.startswith("--")}
    for key in SERVING_CONFIG_KEYS:
        if key in cfg and key not in passed:
            setattr(args, key, int(cfg[key]))


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
    p.add_argument("--prefix-families", type=int, default=1,
                   help="distinct shared prefixes for --shared-prefix-len")
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
    # the fleet
    p.add_argument("--replicas", type=int, default=1,
                   help="in-process engine replicas behind the prefix-affinity router, one "
                        "tick thread each; replica r on cuda:(r %% device count)")
    p.add_argument("--mp", type=int, default=1,
                   help="model-parallel shards a replica; only 1 is ported")
    p.add_argument("--replicas-proc", type=int, default=0, metavar="N",
                   help="process fleet: N replica subprocesses behind the router, "
                        "supervised in the run (a dead replica's journal fails over to "
                        "the survivors, it relaunches on a budgeted backoff)")
    p.add_argument("--autoscale", action="store_true",
                   help="with --replicas-proc: spawn a replica under sustained fleet-wide "
                        "pressure, drain one at sustained idle")
    p.add_argument("--min-replicas", type=int, default=1, help="autoscale floor")
    p.add_argument("--max-replicas", type=int, default=4, help="autoscale ceiling")
    p.add_argument("--autoscale-sustain-s", type=float, default=2.0,
                   help="seconds of fleet-wide pressure before a spawn (also the cooldown)")
    p.add_argument("--autoscale-idle-s", type=float, default=5.0,
                   help="seconds of fleet-wide idle before a drain")
    p.add_argument("--restart-budget", type=int, default=3,
                   help="with --replicas-proc: relaunches a replica may take")
    p.add_argument("--hostsfile", metavar="FILE", help="not ported (host mode)")
    p.add_argument("--capacity-dir", metavar="DIR", help="not ported (elastic capacity)")
    p.add_argument("--capacity-publish-s", type=float, default=None,
                   help="not ported (elastic capacity)")
    p.add_argument("--config", metavar="FILE",
                   help="a serving config emitted by `tune --serve --emit-config`: its "
                        "engine shape as defaults, explicit flags win")
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
    for key, why in NOT_PORTED.items():
        if getattr(args, key) is not None:
            p.error(why)
    if args.config:
        apply_serving_config(args, argv, p)
    if args.mp != 1:
        p.error("--mp > 1 (model-parallel replicas) is not ported" if args.mp > 1
                else "--mp must be >= 1")
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
    if args.prefix_families < 1:
        p.error("--prefix-families must be >= 1")
    # the fleet's refusals, as the JAX bench's
    if args.replicas_proc and args.restarts:
        p.error("--replicas-proc supervises its replicas in the run (relaunch and journal "
                "failover); --restarts supervises the in-process bench: pick one")
    if args.replicas < 1:
        p.error("--replicas must be >= 1")
    fleet = args.replicas > 1
    if fleet and sweep_ks is not None:
        p.error("--spec-k-sweep is single-replica (the sweep measures the engine, not the "
                "router)")
    if fleet and args.checkpoint:
        p.error("--replicas > 1 serves --model's random weights only (an in-process fleet "
                "of checkpoint-sized replicas is a dev harness; production runs one "
                "process a replica)")
    if args.replicas_proc < 0:
        p.error("--replicas-proc must be >= 1")
    if args.replicas_proc:
        if fleet:
            p.error("--replicas-proc IS the fleet (subprocess replicas); drop --replicas")
        if args.checkpoint:
            p.error("--replicas-proc serves --model's random weights only (workers build "
                    "the model from the config they are handed)")
        if sweep_ks is not None:
            p.error("--spec-k-sweep is single-replica")
        if args.resume:
            p.error("--replicas-proc recovers in the run (the supervisor harvests dead "
                    "replicas' journals); --resume is the in-process replay")
        if args.no_journal:
            p.error("--replicas-proc needs the journal: failover replays it")
        if args.autoscale and args.min_replicas > args.replicas_proc:
            p.error("--min-replicas exceeds --replicas-proc")
        if args.autoscale and args.max_replicas < args.min_replicas:
            p.error("--max-replicas < --min-replicas")
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

    if args.replicas_proc:
        # the host of the process fleet builds no model and initialises no
        # CUDA; a missing card is refused here, not in every worker
        resolve_device(args.device)
        work = sample_workload(args.requests, args.rate, args.prompt_len, args.output_len,
                               MODELS[args.model]["vocab_size"], args.seed,
                               shared_prefix_len=args.shared_prefix_len,
                               prefix_families=args.prefix_families)
        if args.run_dir is not None:
            stats = _run_fleet_proc(args, work, Path(args.run_dir))
        else:  # the journals and the rendezvous file still need a directory
            with tempfile.TemporaryDirectory(prefix="serve_fleet_") as tmp:
                stats = _run_fleet_proc(args, work, Path(tmp))
        stats["device"] = args.device
        return _report(args, stats, len(work), sweep_ks)
    devices = [resolve_device(replica_device(args.device, r)) for r in range(args.replicas)]
    device = devices[0]
    free = total = None
    if device.type == "cuda":  # what the card offers this process, before the model
        free, total = torch.cuda.mem_get_info(device)
    logger.log_event("serve-start", device=str(device), free_bytes=free, total_bytes=total)
    if args.checkpoint:
        from ..models.transformer import TransformerInferenceModule

        infs = [TransformerInferenceModule.from_checkpoint(args.checkpoint, device=device)]
    else:
        # one model a replica on its own device: the seeded init gives every
        # replica the same weights
        infs = [build_inference(args.model, seed=args.seed, device=d) for d in devices]
    inf = infs[0]
    if args.replicas > 1:
        print("  placement: " + ", ".join(f"replica {r} -> {d}" for r, d in enumerate(devices)),
              flush=True)

    def make_engine(spec_k=None, replica_id=None, inf=inf):
        return ServeEngine(inf, EngineConfig(**engine_kwargs(args, spec_k),
                                             replica_id=replica_id), device=inf.device)

    def warmup_engine(engine):  # off the books: the kernels' first builds
        if args.warmup:
            engine.warmup_mode = True
            engine.submit(list(range(1, args.prompt_len[0] + 1)), args.output_len[0])
            engine.run_until_done()
            engine.warmup_mode = False

    vocab = inf.architecture.vocab_size
    work = sample_workload(args.requests, args.rate, args.prompt_len,
                           args.output_len, vocab, args.seed,
                           shared_prefix_len=args.shared_prefix_len,
                           prefix_families=args.prefix_families)
    offered = len(work)
    if args.replicas > 1:
        stats = _run_fleet(args, infs, work, make_engine, warmup_engine)
    elif sweep_ks is not None:
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
    return _report(args, stats, offered, sweep_ks)


def _report(args, stats: dict, offered: int, sweep_ks) -> int:
    """Print the summary, write ``--json``; 0 when every offered workload
    item completed, timed out, was shed or was left unsubmitted by a
    drain."""
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
    if stats.get("replicas", 1) > 1 or stats.get("proc_fleet"):
        r = stats["router"]
        print(f"  fleet: replicas={stats['replicas']} "
              f"affinity_hits={r['affinity_dispatches']}/{r['dispatches']} "
              f"({r['affinity_hit_rate']:.1%}) retries_elsewhere={r['retries_elsewhere']} "
              f"rejected={r['rejected']}")
        for row in stats["replica_stats"]:
            if row.get("retired"):
                mark = " [drained]"
            elif not row.get("alive", True):
                mark = " [FAILED]"
            else:
                mark = ""
            if row.get("restarts"):
                mark = f" restarts={row['restarts']}" + mark
            print(f"    replica {row['replica']}: device={row['device']} "
                  f"requests={row['requests']} tokens={row['output_tokens']} "
                  f"dispatches={row.get('dispatches', 0)} ticks={row['ticks']} "
                  f"pressure={row['pool_pressure']:.2f} "
                  f"kernel_launches={row['kernel_launches']}" + mark)
    if stats.get("proc_fleet"):
        print(f"  supervision: restarts={stats['replica_restarts']} "
              f"spawns={stats['replica_spawns']} drains={stats['replica_drains']} "
              f"recovered={stats['recovered_requests']} "
              f"redispatched={stats['redispatched_requests']} "
              f"max_loop_age={stats['max_loop_age_s']:.4f}s "
              f"max_stats_rtt={stats['max_stats_rtt_s']:.4f}s "
              f"host_cuda_initialized={stats['host_cuda_initialized']}")
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
        from ..resilience.guards import retry_io

        stats_text = json.dumps(stats, indent=2)
        retry_io(lambda: Path(args.json).write_text(stats_text), what="serve stats write")
    ended = (stats["requests"] + stats["requests_timeout"] + stats["requests_shed"]
             + stats["unsubmitted"])
    return 0 if ended == offered or sweep_ks is not None else 1
