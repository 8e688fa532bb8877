#!/usr/bin/env python3
"""What a second replica buys on one CUDA card, threaded or in processes.

Workload F of ``chip_smoke.py`` phase 14 (the 0.5B model, phase 4's engine,
64 requests, Poisson at 128 req/s, 4 families of a 256-token shared
prefix before 128-1024 random tokens, 64-256 output tokens) goes through
``serve bench`` children without a run directory (no events file in any
arm), one arm after another in mirrored order:

- ``one``: one engine;
- ``threads``: ``--replicas 2``, two engines ticked by two threads of one
  process (one GIL);
- ``threads_si``: the same with ``sys.setswitchinterval`` at
  ``--switch-interval`` (default 0.5 ms, the interpreter's is 5 ms), to
  see how much of the threads' cost is the GIL's hand-over;
- ``procs1``: ``--replicas-proc 1``, the process fleet's RPC and
  supervision around one worker;
- ``procs``: ``--replicas-proc 2``, two workers, two CUDA contexts.

One ``AB {...}`` line a child (tokens/s, ms a tick of a replica, TTFT and
ITL p50/p99), then one JSON line of each arm's medians. Builds the
kernels first, so that no worker builds one. Run from the root of a
checkout: ``python3 fleet_ab.py``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ARMS = ("one", "threads", "threads_si", "procs1", "procs")
EXTRA = {"one": [], "threads": ["--replicas", "2"], "threads_si": ["--replicas", "2"],
         "procs1": ["--replicas-proc", "1"], "procs": ["--replicas-proc", "2"]}
WITH_SWITCH_INTERVAL = ("import sys; sys.setswitchinterval(float(sys.argv[1])); "
                        "from scaling_tpu_torch.serve.bench import main; "
                        "sys.exit(main(sys.argv[2:]))")


def run_arm(arm: str, base: list, switch_interval: float) -> dict:
    out = Path(tempfile.mkdtemp()) / "stats.json"
    args = base + EXTRA[arm] + ["--json", str(out)]
    if arm == "threads_si":
        cmd = [sys.executable, "-c", WITH_SWITCH_INTERVAL, str(switch_interval), *args]
    else:
        cmd = [sys.executable, "-m", "scaling_tpu_torch.serve", "bench", *args]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"{arm}: the bench exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    s = json.loads(out.read_text())
    replicas = s.get("replicas", 1)
    return {"arm": arm, "tokens_per_s": s["tokens_per_s"], "wall_s": s["wall_s"],
            "tick_ms": s["wall_s"] / (s["ticks"] / replicas) * 1e3,
            "ttft_p50_s": s["ttft_p50_s"], "ttft_p99_s": s["ttft_p99_s"],
            "itl_p50_s": s["itl_p50_s"], "itl_p99_s": s["itl_p99_s"],
            "completed": s["completed"], "replicas": replicas}


def main() -> int:
    p = argparse.ArgumentParser(prog="fleet_ab.py")
    p.add_argument("--switch-interval", type=float, default=0.0005)
    p.add_argument("--arms", default=",".join(ARMS), help="comma list, run in mirrored order")
    args = p.parse_args()
    sys.path.insert(0, ".")
    import chip_smoke as cs

    print(cs.card_line(), flush=True)
    print(f"kernels built in {cs.build_kernels():.1f}s", flush=True)
    base = cs.fleet_args("0.5b", "cuda")
    arms = args.arms.split(",")
    rows = []
    for arm in arms + arms[::-1]:
        row = run_arm(arm, base, args.switch_interval)
        if row["completed"] != cs.FLEET["n_requests"]:
            raise SystemExit(f"{arm}: {row['completed']} of {cs.FLEET['n_requests']} completed")
        rows.append(row)
        print("AB " + json.dumps(row), flush=True)
    medians = {arm: {k: statistics.median(r[k] for r in rows if r["arm"] == arm)
                     for k in ("tokens_per_s", "tick_ms", "ttft_p50_s", "ttft_p99_s",
                               "itl_p50_s", "itl_p99_s")} for arm in arms}
    one = medians.get("one", {}).get("tokens_per_s")
    for arm, m in medians.items():
        if one:
            m["tokens_per_s_over_one"] = m["tokens_per_s"] / one
    print(json.dumps({"switch_interval_s": args.switch_interval, "medians": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
