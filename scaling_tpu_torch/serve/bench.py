"""Serving load generator: Poisson arrivals -> engine -> latency report.

``python -m scaling_tpu_torch.serve bench`` (a minimal port of
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

``--run-dir DIR`` records the run as the JAX bench does: events (one
``serve-request`` a request, the spans and a final ``serve-summary``)
into ``DIR/events.jsonl`` through ``SCALING_TPU_EVENTS_PATH`` (unless the
environment already names a file), and the metrics registry's snapshots
into ``DIR/metrics.jsonl``; ``python -m scaling_tpu_torch.obs report DIR``
renders them. Each measured request runs under a trace id of its own,
and each tick in a ``serve.tick`` span. Without ``--run-dir`` the bench
writes no events and no metrics, whatever sinks the process's logger
had, unless ``SCALING_TPU_EVENTS_PATH`` or ``SCALING_TPU_METRICS_PATH``
names a file.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..logging.logger import logger
from ..obs import get_registry, new_trace_id, span, trace_context

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


def run_bench(engine, workload, max_wall_s: float = 600.0) -> dict:
    """Open-loop drive: submit each request when the wall clock crosses
    its arrival offset, tick the engine continuously, drain. Returns the
    summary stats, which also go out as the ``serve-summary`` event,
    followed by a registry flush. Every tick ends in a device->host copy
    of its sampled tokens, so the wall clock covers the device work."""
    t0 = time.monotonic()
    start_tick = engine.tick_index
    start_finished = len(engine.finished)
    pending = sorted(workload, key=lambda w: w[0])
    idx = 0
    while True:
        now = time.monotonic() - t0
        if now > max_wall_s:
            raise RuntimeError(
                f"bench exceeded max_wall_s={max_wall_s}: {idx}/{len(pending)} "
                f"submitted, {len(engine.finished) - start_finished} finished"
            )
        while idx < len(pending) and pending[idx][0] <= now:
            arrival, prompt, olen = pending[idx]
            # one trace a measured request, the origin of its spans and events
            with trace_context(new_trace_id()):
                engine.submit(prompt, olen, arrival_s=t0 + arrival)
            idx += 1
        if engine.scheduler.has_work:
            with span("serve.tick", step=engine.tick_index):
                engine.tick()
        elif idx >= len(pending):
            break
        else:
            wait = pending[idx][0] - (time.monotonic() - t0)
            if wait > 0:
                time.sleep(min(wait, 0.05))
    wall_s = time.monotonic() - t0
    seqs = engine.finished[start_finished:]
    ttfts = [s.first_token_s - s.request.arrival_s for s in seqs]
    itls = [b - a for s in seqs for a, b in zip(s.token_stamps, s.token_stamps[1:])]
    out_tokens = sum(len(s.generated) for s in seqs)
    hit, prefilled = engine.scheduler.prefix_hit_tokens, engine.prefilled_tokens
    stats = {
        "requests": len(pending),
        "completed": len(seqs),
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
        "prefix_hit_tokens": hit,
        # work avoided over work demanded, as the JAX bench reports it
        "prefix_hit_rate": round(hit / (hit + prefilled), 4) if hit + prefilled else 0.0,
        "prefilled_tokens": prefilled,
    }
    logger.log_event("serve-summary", **stats)
    get_registry().flush_step(engine.tick_index)
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
    p = argparse.ArgumentParser(prog="python -m scaling_tpu_torch.serve bench")
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
    p.add_argument("--prefill-chunk", type=int, default=32)
    p.add_argument("--no-prefix-cache", action="store_true")
    p.add_argument("--warmup", type=int, default=1,
                   help="requests served before the measured run (kernel builds)")
    p.add_argument("--max-wall-s", type=float, default=600.0)
    p.add_argument("--json", metavar="FILE", help="also write the stats here")
    p.add_argument("--run-dir", metavar="DIR",
                   help="record events and registry snapshots here, for obs report")
    args = p.parse_args(argv)
    with recording_to(args.run_dir):
        return _bench(args)


def _bench(args) -> int:
    from .engine import EngineConfig, ServeEngine

    device = resolve_device(args.device)
    if args.checkpoint:
        from ..models.transformer import TransformerInferenceModule

        inf = TransformerInferenceModule.from_checkpoint(args.checkpoint, device=device)
    else:
        inf = build_inference(args.model, seed=args.seed, device=device)
    engine = ServeEngine(inf, EngineConfig(
        num_slots=args.num_slots, block_size=args.block_size,
        num_blocks=args.num_blocks, max_blocks_per_seq=args.max_blocks_per_seq,
        token_budget=args.token_budget, kv_dtype=args.kv_dtype,
        prefill_chunk=args.prefill_chunk,
        enable_prefix_cache=not args.no_prefix_cache,
    ), device=device)
    vocab = inf.architecture.vocab_size
    if args.warmup:  # off the books: the kernels' first builds
        engine.warmup_mode = True
        engine.submit(list(range(1, args.prompt_len[0] + 1)), args.output_len[0])
        engine.run_until_done()
        engine.warmup_mode = False
    work = sample_workload(args.requests, args.rate, args.prompt_len,
                           args.output_len, vocab, args.seed,
                           shared_prefix_len=args.shared_prefix_len)
    stats = run_bench(engine, work, max_wall_s=args.max_wall_s)
    stats["device"] = (torch.cuda.get_device_name(device) if device.type == "cuda"
                       else "cpu")
    stats.update(model=args.checkpoint or args.model, kv_dtype=args.kv_dtype)

    def fmt(v):
        return "n/a" if v is None else f"{v:.4f}s"

    print("== serve bench (scaling_tpu_torch) ==")
    print(f"  device={stats['device']} model={stats['model']} kv_dtype={args.kv_dtype}")
    print(f"  requests={stats['requests']} completed={stats['completed']} "
          f"wall={stats['wall_s']:.3f}s ticks={stats['ticks']} "
          f"preemptions={stats['preemptions']} "
          f"prefix_hit_tokens={stats['prefix_hit_tokens']}")
    print(f"  output tokens/s: {stats['tokens_per_s']:.1f} "
          f"({stats['output_tokens']} tokens)")
    print(f"  ttft: p50={fmt(stats['ttft_p50_s'])} p99={fmt(stats['ttft_p99_s'])}")
    print(f"  itl:  p50={fmt(stats['itl_p50_s'])} p99={fmt(stats['itl_p99_s'])}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(stats, f, indent=2)
    return 0 if stats["completed"] == stats["requests"] else 1
