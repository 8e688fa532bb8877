#!/usr/bin/env python3
"""Checkpoint save, verify and load of this checkout against an older one,
on one CUDA card, in turns.

The state is the Trainer phase's of ``chip_smoke.py`` (phase 8): the 0.5B
model at full width cut to 2 of its 8 layers, bf16 weights with f32 AdamW
masters and moments after one step, micro-batch 4, seq 2048. Each turn is
a process of its own that imports the port from one checkout and times,
twice, what the Trainer's save and its verified restore run:

- save: the layer files of the weights and the optimizer state in the
  JAX npz layout with their (size, crc32) recorded, the commit (manifest,
  fsync, rename) and ``latest``;
- verify: ``verify_checkpoint`` with every file's crc32;
- load: the weights and the optimizer state back into the card's tensors.

Run from the root of a checkout, with an older checkout unpacked beside it
(``git archive <commit> | tar -x -C .scratch/parent``)::

    python3 ckpt_ab.py --parent .scratch/parent

It prints each turn's seconds and GB/s (turns parent, change, change,
parent, so that a drift over the call weighs on both alike), the card
line, and last one JSON object with the medians.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

TURNS = ("parent", "change", "change", "parent")
REPEATS = 2
LAYERS = 2


def worker(root: str) -> dict:
    """One turn: the port of ``root``, its save/verify/load timed."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from scaling_tpu_torch.checkpoint import (
        load_model_checkpoint,
        load_optimizer_checkpoint,
        save_model_checkpoint,
        save_optimizer_checkpoint,
    )
    from scaling_tpu_torch.models.transformer import loss_function
    from scaling_tpu_torch.resilience import CheckpointCommit, verify_checkpoint
    from scaling_tpu_torch.train import bench

    if not Path(bench.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {bench.__file__}, not the checkout at {root}")
    dev = torch.device("cuda")
    bench.MODELS["0.5b"]["num_layers"] = LAYERS  # this process only
    config, module, optimizer = bench.build("0.5b", 2048, 4, device=dev, seed=0)
    step = module.build_train_step(optimizer, loss_function)
    step(bench.synth_batch(np.random.default_rng(0), 4, 2048, 32768, 1, dev))
    torch.cuda.synchronize()
    keys = module.ckpt_keys()
    named = dict(module.model.named_parameters())
    params = {key: named[name] for name, key in keys.items()}
    times = {"save": [], "verify": [], "load": []}
    base = Path(tempfile.mkdtemp(prefix="ckpt_ab_"))
    try:
        for i in range(REPEATS):
            t0 = time.perf_counter()
            commit = CheckpointCommit(base, i + 1)
            save_model_checkpoint(commit.tmp_dir, params, recorder=commit.record)
            save_optimizer_checkpoint(commit.tmp_dir, optimizer, keys, recorder=commit.record)
            step_dir = commit.finalize()
            commit.update_latest()
            times["save"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            problems = verify_checkpoint(step_dir, deep=True)
            times["verify"].append(time.perf_counter() - t0)
            if problems:
                raise RuntimeError(f"the checkpoint does not verify: {problems}")
            t0 = time.perf_counter()
            load_model_checkpoint(step_dir, params)
            load_optimizer_checkpoint(step_dir, optimizer, keys)
            torch.cuda.synchronize()
            times["load"].append(time.perf_counter() - t0)
        size = sum(f.stat().st_size for f in step_dir.iterdir() if f.suffix == ".npz")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return {"bytes": size, **times}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--parent", help="root of the older checkout")
    p.add_argument("--worker", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("ckpt_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not args.parent:
        p.error("--parent is required")
    roots = {"parent": str(Path(args.parent).resolve()), "change": str(Path.cwd().resolve())}
    results = {"parent": [], "change": []}
    for turn in TURNS:
        proc = subprocess.run([sys.executable, __file__, "--worker", roots[turn]],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            return 1
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        results[turn].append(r)
        gb = r["bytes"] / 1e9
        print(f"  {turn}: {gb:.2f} GB; " + "; ".join(
            f"{op} " + " ".join(f"{s:.2f}s ({gb / s:.2f} GB/s)" for s in r[op])
            for op in ("save", "verify", "load")), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    summary = {kind: {op: statistics.median(s for r in runs for s in r[op])
                      for op in ("save", "verify", "load")}
               for kind, runs in results.items()}
    summary["bytes"] = results["change"][0]["bytes"]
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
