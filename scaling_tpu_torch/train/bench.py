"""Training benchmark: the step time of ``bench.py``'s training step.

``python -m scaling_tpu_torch.train bench`` is the port's counterpart of
``bench.py``'s measurement: it builds the model (``--model 0.5b`` is
bench.py's default decoder, hidden 2048, 8 layers, 16 query / 4 KV
heads, vocab 32768, SwiGLU x2.75, fused RMSNorm, flash attention, bf16;
``--model toy`` a small bf16 model with flash attention, for quick runs)
with random weights from
``--seed``, the optimizer of ``bench.py:build`` (AdamW beta 0.9/0.95,
eps 1e-8, clipping 1.0, loss scaler off, LR 3e-4 with 10 warm-up steps
and cosine decay over 1000, weight decay 1e-4), and one synthetic batch
as ``bench.py:synth_batch`` draws it (tokens uniform in [1, vocab),
targets rolled by -1, positions ``arange``, segment ids 0, loss weights
1). After ``--warmup`` steps it times ``--steps`` steps in each of 3
windows and reports the median window's step time, tokens/s and the
PaLM MFU against the H100's 989.4 TFLOP/s bf16 peak, plus the losses.
``--mbs-plan 4,8,16,32`` climbs ``bench.py``'s micro-batch ladder:
each rung measured so, up while tokens/s improves, the winner reported
beside every rung's tokens/s (and, on the card, its peak
``max_memory_allocated``); a rung out of device memory ends the climb.
The kernels' and the plain versions' launches over the run are printed
last.

It runs on the card unless ``--device cpu`` is given; without a card it
raises.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models.transformer import TransformerConfig, init_model, init_optimizer, loss_function
from ..models.transformer.utils.get_tflops import (
    get_model_parameter_count,
    get_palm_mfu,
    moe_parameter_counts,
)
from ..ops import launches
from ..serve import bench as serve_bench

MODELS = {
    "0.5b": serve_bench.MODELS["0.5b"],
    "0.5b-moe": serve_bench.MODELS["0.5b-moe"],
    # the serving toy in bf16 with the flash kernels (which take bf16 only)
    "toy": dict(serve_bench.MODELS["toy"], precision="bfloat16",
                masked_softmax={"kernel": "flash_attention"}),
}

OPTIMIZER = {"gradient_clipping": 1.0, "loss_scaler": {"enable": False}}
LR_SCHEDULE = {"learning_rate": 3e-4, "learning_rate_warmup_steps": 10,
               "learning_rate_decay_iters": 1000}


def build(model: str, seq_len: int, micro_batch_size: int, gas: int = 1,
          remat: str = "none", seed: int = 0, device=None):
    """(config, ParallelModule, Optimizer) of bench.py:build for ``model``."""
    arch = dict(MODELS[model], sequence_length=seq_len)
    topology = {"micro_batch_size": micro_batch_size, "gradient_accumulation_steps": gas}
    if remat != "none":
        topology["activation_checkpointing_type"] = remat
    config = TransformerConfig.from_dict({
        "topology": topology,
        "transformer_architecture": arch,
        "optimizer": OPTIMIZER,
        "learning_rate_scheduler": LR_SCHEDULE,
        "trainer": {"train_iterations": 10, "seed": seed},
    })
    module = init_model(config, device=resolve_device(device))
    return config, module, init_optimizer(config, module.model)


def synth_batch(rng: np.random.Generator, batch: int, seq_len: int, vocab: int, gas: int,
                device) -> Dict[str, torch.Tensor]:
    """bench.py:synth_batch, leaves stacked (gas, batch, seq_len)."""
    tokens = rng.integers(1, vocab, size=(gas, batch, seq_len), dtype=np.int64)
    pos = np.broadcast_to(np.arange(seq_len, dtype=np.int32), (gas, batch, seq_len))
    out = {
        "token_ids": tokens,
        "target_token_ids": np.roll(tokens, -1, axis=-1),
        "position_ids": np.ascontiguousarray(pos),
        "segment_ids": np.zeros((gas, batch, seq_len), np.int32),
        "loss_weights": np.ones((gas, batch, seq_len), np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_windows(step, batch, device, steps: int, windows: int = 3):
    """Seconds per step of each window (each ends in a device sync) and
    the losses of every step."""
    seconds, losses = [], []
    for _ in range(windows):
        sync(device)
        t0 = time.perf_counter()
        window_losses = [step(batch)[0] for _ in range(steps)]
        sync(device)
        seconds.append((time.perf_counter() - t0) / steps)
        losses += [float(x) for x in window_losses]
    return seconds, losses


def climb_mbs_ladder(measure: Callable[[int], dict], mbs_plan: Sequence[int]
                     ) -> Tuple[dict, List[dict]]:
    """``bench.py:climb_mbs_ladder``: measure the plan's first rung, then
    climb while a rung's tokens/s beats the best so far, stopping at the
    first rung that does not. ``measure(mbs)`` returns a record with
    ``tokens_per_s``. A rung that runs out of device memory
    (``torch.cuda.OutOfMemoryError``) ends the climb with the winner kept,
    its tensors freed first; any other error propagates. Returns the
    winner's record and every rung's (an out-of-memory rung as
    ``{"mbs": n, "oom": True}``)."""
    best = measure(mbs_plan[0])
    rungs = [best]
    for mbs in mbs_plan[1:]:
        _release()
        try:
            rec = measure(mbs)
        except torch.cuda.OutOfMemoryError as e:
            what = str(e).splitlines()[0] if str(e) else type(e).__name__
            rungs.append({"mbs": mbs, "oom": True, "error": what})
        else:
            rungs.append(rec)
            if rec["tokens_per_s"] > best["tokens_per_s"]:
                best = rec
                continue
        break
    _release()  # the failed rung's tensors: the exception's frames are gone
    if rungs[-1].get("oom"):
        print(f"# mbs={rungs[-1]['mbs']} rung out of memory ({rungs[-1]['error']}); "
              f"keeping mbs={best['mbs']}", file=sys.stderr)
    return best, rungs


def _release() -> None:
    """Free what the last rung left: its cycles, then the allocator's cache."""
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def measure_rung(args, device: torch.device, mbs: int) -> dict:
    """One rung: build at micro-batch ``mbs``, ``--warmup`` steps, then
    ``--steps`` in each of 3 windows; nothing of the model outlives it."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    config, module, optimizer = build(args.model, args.seq_len, mbs, args.gas, args.remat,
                                      args.seed, device)
    arch = config.transformer_architecture
    step = module.build_train_step(optimizer, loss_function)
    batch = synth_batch(np.random.default_rng(args.seed), mbs, args.seq_len,
                        arch.vocab_size, args.gas, device)
    first = [float(step(batch)[0]) for _ in range(args.warmup)]
    seconds, losses = timed_windows(step, batch, device, args.steps)
    dt = statistics.median(seconds)
    tokens_per_s = mbs * args.gas * args.seq_len / dt
    mfu = None  # a rate of the card's peak: only from a run on the card
    if device.type == "cuda":
        # a MoE model by its parameters, all of them and those a token touches
        counts = (moe_parameter_counts(module.model) if arch.is_moe else
                  (get_model_parameter_count(arch.hidden_size, arch.num_layers,
                                             arch.vocab_size, arch.mlp_factor, glu=True),))
        mfu = [get_palm_mfu(n, arch.num_layers, arch.hidden_size, arch.sequence_length,
                            tokens_per_s) for n in counts]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return {"mbs": mbs, "step_s": dt, "seconds": seconds, "tokens_per_s": tokens_per_s,
            "mfu": mfu, "losses": first + losses, "peak_bytes": peak,
            "params": sum(p.numel() for p in module.model.parameters())}


def mbs_plan(text: str) -> List[int]:
    plan = [int(x) for x in text.split(",") if x.strip()]
    if not plan or min(plan) < 1:
        raise argparse.ArgumentTypeError(f"not a plan of micro-batch sizes: {text!r}")
    return plan


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m scaling_tpu_torch.train bench")
    p.add_argument("--model", choices=sorted(MODELS), default="0.5b")
    p.add_argument("--seq-len", type=int, default=2048)
    rungs = p.add_mutually_exclusive_group()
    rungs.add_argument("--mbs", type=int, default=4, help="micro-batch size (a one-rung plan)")
    rungs.add_argument("--mbs-plan", type=mbs_plan, default=None,
                       help="micro-batch sizes to climb, e.g. 4,8,16,32: up while tokens/s "
                            "improves; a rung out of device memory ends the climb")
    p.add_argument("--gas", type=int, default=1, help="gradient accumulation steps")
    p.add_argument("--steps", type=int, default=10, help="timed steps per window")
    p.add_argument("--warmup", type=int, default=1, help="untimed steps first (kernel builds)")
    p.add_argument("--seed", type=int, default=0, help="weights and batch")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    p.add_argument("--remat", choices=["none", "every_layer", "every_layer_save_dots"],
                   default="none")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    kernel_before = launches.snapshot(launches.KERNEL)
    plain_before = launches.snapshot(launches.PLAIN)
    best, rungs = climb_mbs_ladder(lambda mbs: measure_rung(args, device, mbs),
                                   args.mbs_plan or [args.mbs])
    mfu, losses = best["mfu"], best["losses"]
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"train bench: model={args.model} device={name} seq={args.seq_len} mbs={best['mbs']} "
          f"gas={args.gas} remat={args.remat} params={best['params']}")
    if len(rungs) > 1 or args.mbs_plan:
        print("ladder: " + ", ".join(
            f"mbs={r['mbs']} out of memory" if r.get("oom")
            else f"mbs={r['mbs']} {r['tokens_per_s']:.1f} tokens/s" + (
                "" if r["peak_bytes"] is None else f" peak {r['peak_bytes'] / 1e9:.2f} GB")
            for r in rungs) + f"; winner mbs={best['mbs']}")
    print(f"step: {best['step_s'] * 1e3:.2f} ms (median of windows "
          + " ".join(f"{s * 1e3:.2f}" for s in best["seconds"]) + ")")
    print(f"tokens/s: {best['tokens_per_s']:.1f}  mfu: " + (
        "not measured (no card)" if mfu is None else f"{mfu[0]:.4f}" if len(mfu) == 1
        else f"{mfu[0]:.4f} (N all parameters), {mfu[1]:.4f} (N those a token touches)"))
    print(f"losses: first={losses[0]:.4f} last={losses[-1]:.4f}")
    print("launches: " + json.dumps({
        "kernel": serve_bench.launches_since(launches.KERNEL, kernel_before),
        "plain": serve_bench.launches_since(launches.PLAIN, plain_before)}))
    for r in rungs:
        if not r.get("oom") and not all(np.isfinite(r["losses"])):
            raise RuntimeError(f"non-finite loss at mbs={r['mbs']}: {r['losses']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
