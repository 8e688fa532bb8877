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
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device

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
    summary stats. Every tick ends in a device->host copy of its sampled
    tokens, so the wall clock covers the device work."""
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
            engine.submit(prompt, olen, arrival_s=t0 + arrival)
            idx += 1
        if engine.scheduler.has_work:
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
    return {
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
        "prefix_hit_tokens": engine.scheduler.prefix_hit_tokens,
        "prefilled_tokens": engine.prefilled_tokens,
    }


def main(argv: Optional[List[str]] = None) -> int:
    from .engine import EngineConfig, ServeEngine

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
    args = p.parse_args(argv)

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
    if args.warmup:
        engine.submit(list(range(1, args.prompt_len[0] + 1)), args.output_len[0])
        engine.run_until_done()
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
