"""Standalone evaluation: checkpoint + tokenized dataset -> loss/perplexity
(counterpart of scaling_tpu/models/transformer/evaluate.py).

    python -m scaling_tpu_torch.models.transformer.evaluate \
        --checkpoint .checkpoints/run --data data/val [--batch-size 8] [--device cpu]

Deterministic (no shuffle, sequential packing), so two runs on the same
checkpoint and data give the same number. The loss, accuracy and token
count are weighted sums over the batches divided once at the end, as in
the JAX package; a short last batch is run as it is (the JAX package pads
it with rows of weight 0 to keep its compiled shape). Runs on the card
unless ``device="cpu"``. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from typing import Optional, Union

import torch

from .data.text_dataset import TextDataset
from .inference import TransformerInferenceModule
from .model import per_token_loss


@torch.no_grad()
def evaluate(checkpoint_dir: Union[Path, str], data_prefix: Union[Path, str],
             batch_size: int = 8, max_batches: Optional[int] = None,
             legacy_dataset: bool = False, device=None) -> dict:
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    module = TransformerInferenceModule.from_checkpoint(checkpoint_dir, device=device)
    arch = module.architecture
    dataset = TextDataset(data_prefix, sequence_length=arch.sequence_length, shuffle=False,
                          legacy_dataset=legacy_dataset)
    if len(dataset) == 0:
        raise ValueError(
            f"{data_prefix} packs into 0 sequences of length "
            f"{arch.sequence_length} (wrong prefix or dataset too small)"
        )
    n_batches = math.ceil(len(dataset) / batch_size)
    if max_batches is not None:
        n_batches = min(n_batches, max_batches)
    # loss, correct, weight: f32 sums a batch, added in f64 as the JAX loop adds floats
    sums = torch.zeros(3, dtype=torch.float64, device=module.device)
    for b in range(n_batches):
        items = [dataset[i]
                 for i in range(b * batch_size, min((b + 1) * batch_size, len(dataset)))]
        batch = dataset.collate(items).as_model_input(module.device)
        logits = module._run_layers(module._make_batch(
            batch["token_ids"], batch["position_ids"], batch["segment_ids"]))
        token_loss, correct = per_token_loss(logits, batch["target_token_ids"])
        weights = batch["loss_weights"].float()
        sums += torch.stack([(token_loss * weights).sum(), (correct * weights).sum(),
                             weights.sum()]).double()
    total_loss, total_correct, total_weight = sums.tolist()
    mean_loss = total_loss / max(total_weight, 1.0)
    return {
        "loss": round(mean_loss, 6),
        "perplexity": round(math.exp(min(mean_loss, 80.0)), 4),
        "accuracy": round(total_correct / max(total_weight, 1.0), 6),
        "tokens": int(total_weight),
        "batches": n_batches,
    }


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description="score a checkpoint on a dataset")
    ap.add_argument("--checkpoint", required=True, type=Path)
    ap.add_argument("--data", required=True, type=Path, help="memory-map dataset prefix")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument("--legacy-dataset", action="store_true",
                    help="Megatron .bin/.idx format (MMIDIDX or TNTIDX)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    args = ap.parse_args(argv)
    stats = evaluate(args.checkpoint, args.data, args.batch_size, args.max_batches,
                     args.legacy_dataset, device=args.device)
    print(json.dumps({"checkpoint": str(args.checkpoint), **stats}))


if __name__ == "__main__":
    sys.exit(main())
