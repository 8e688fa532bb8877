#!/usr/bin/env python3
"""What the serving path's always-on obs costs, on one CUDA card.

Phase 4's native traffic of ``chip_smoke.py`` (the 0.5B model, 32
requests, Poisson at 64 req/s, prompts 128-1024, outputs 64-256) goes
through ``serve bench`` without a run directory, three times in a process,
in processes of three kinds run in mirrored order (P C S P C S S C P):

- P, ``parent``: another checkout of the port, given by ``--parent DIR``
  (say ``git archive <commit>`` unpacked into a directory ``.gitignore``
  lists), the engine from before obs;
- C, ``change``: this checkout;
- S, ``stub``: this checkout with every obs call a no-op
  (``chip_smoke.obs_stubbed``).

One JSON line a bench (tokens/s and wall clock a tick), then each kind's
median wall clock a tick. Run from the root of a checkout:
``python3 obs_cost_ab.py --parent DIR``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ORDER = ("parent", "change", "stub", "parent", "change", "stub", "stub", "change", "parent")
RUNS = 3  # benches a process


def child(kind: str) -> None:
    """Three benches in this process, in the checkout of the working
    directory; one ``AB {...}`` line each."""
    sys.path.insert(0, ".")
    import chip_smoke as cs
    from scaling_tpu_torch.serve.bench import main

    w, s = cs.WORKLOAD, cs.SERVE
    base = ["--model", "0.5b", "--device", "cuda", "--seed", str(w["seed"]),
            "--requests", str(w["n_requests"]), "--rate", str(w["rate"]),
            "--prompt-len", *map(str, w["prompt_len"]),
            "--output-len", *map(str, w["output_len"]),
            "--num-slots", str(s["num_slots"]), "--block-size", str(s["block_size"]),
            "--num-blocks", str(s["num_blocks"]),
            "--max-blocks-per-seq", str(s["max_blocks_per_seq"]),
            "--prefill-chunk", str(s["prefill_chunk"])]
    for i in range(RUNS):
        out = Path(tempfile.mkdtemp()) / "stats.json"
        with cs.obs_stubbed() if kind == "stub" else contextlib.nullcontext():
            if main(base + ["--json", str(out)]) != 0:
                raise SystemExit(f"{kind}: bench {i} failed")
        stats = json.loads(out.read_text())
        print("AB " + json.dumps({"kind": kind, "run": i, "tokens_per_s": stats["tokens_per_s"],
                                  "tick_ms": stats["wall_s"] / stats["ticks"] * 1e3}),
              flush=True)


def main() -> int:
    p = argparse.ArgumentParser(prog="python3 obs_cost_ab.py")
    p.add_argument("--parent", help="the checkout to compare with")
    p.add_argument("--child", choices=("parent", "change", "stub"), help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        child(args.child)
        return 0
    if not args.parent:
        p.error("--parent DIR is required")
    here = Path(__file__).resolve()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    ticks = {kind: [] for kind in dict.fromkeys(ORDER)}
    for kind in ORDER:
        cwd = Path(args.parent) if kind == "parent" else here.parent
        proc = subprocess.run([sys.executable, str(here), "--child", kind], cwd=cwd,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
            return 1
        for line in proc.stdout.splitlines():
            if line.startswith("AB "):
                print(line[3:])
                ticks[kind].append(json.loads(line[3:])["tick_ms"])
    print(json.dumps({kind: {"tick_ms_median": statistics.median(v),
                             "tick_ms": [round(x, 3) for x in v]} for kind, v in ticks.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
