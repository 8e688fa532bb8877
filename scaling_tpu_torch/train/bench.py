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

It runs on the card unless ``--device cpu`` is given; without a card it
raises.
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models.transformer import TransformerConfig, init_model, init_optimizer, loss_function
from ..models.transformer.utils.get_tflops import (
    get_model_parameter_count,
    get_palm_mfu,
    moe_parameter_counts,
)
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


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m scaling_tpu_torch.train bench")
    p.add_argument("--model", choices=sorted(MODELS), default="0.5b")
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--mbs", type=int, default=4, help="micro-batch size")
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
    config, module, optimizer = build(args.model, args.seq_len, args.mbs, args.gas,
                                      args.remat, args.seed, device)
    arch = config.transformer_architecture
    step = module.build_train_step(optimizer, loss_function)
    batch = synth_batch(np.random.default_rng(args.seed), args.mbs, args.seq_len,
                        arch.vocab_size, args.gas, device)
    first = [float(step(batch)[0]) for _ in range(args.warmup)]
    seconds, losses = timed_windows(step, batch, device, args.steps)
    dt = statistics.median(seconds)
    tokens_per_s = args.mbs * args.gas * args.seq_len / dt
    mfu = None  # a rate of the card's peak: only from a run on the card
    if device.type == "cuda":
        # a MoE model by its parameters, all of them and those a token touches
        counts = (moe_parameter_counts(module.model) if arch.is_moe else
                  (get_model_parameter_count(arch.hidden_size, arch.num_layers,
                                             arch.vocab_size, arch.mlp_factor, glu=True),))
        mfu = [get_palm_mfu(n, arch.num_layers, arch.hidden_size, arch.sequence_length,
                            tokens_per_s) for n in counts]
    losses = first + losses
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    n_params = sum(p.numel() for p in module.model.parameters())
    print(f"train bench: model={args.model} device={name} seq={args.seq_len} mbs={args.mbs} "
          f"gas={args.gas} remat={args.remat} params={n_params}")
    print(f"step: {dt * 1e3:.2f} ms (median of windows "
          + " ".join(f"{s * 1e3:.2f}" for s in seconds) + ")")
    print(f"tokens/s: {tokens_per_s:.1f}  mfu: " + (
        "not measured (no card)" if mfu is None else f"{mfu[0]:.4f}" if len(mfu) == 1
        else f"{mfu[0]:.4f} (N all parameters), {mfu[1]:.4f} (N those a token touches)"))
    print(f"losses: first={losses[0]:.4f} last={losses[-1]:.4f}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite loss: {losses}")
    return 0
