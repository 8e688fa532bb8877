#!/usr/bin/env python3
"""What a fresh process pays at its first ``torch.utils.checkpoint`` call.

Starts one process, then four at once (as a layout's worker processes
start), each of which imports torch, initialises CUDA, and runs one
non-reentrant ``torch.utils.checkpoint`` forward and backward on the card,
printing the seconds of each and whether ``torch._dynamo`` was imported by
then (the first call imports it). The four-at-once case is the first step
of four worker processes under a remat mode, which is why the port remats
through its own autograd Function (``parallel_module.Remat``) and keeps
``torch.utils.checkpoint`` for ``every_layer_save_dots`` alone (PERF.md
"PR 19"). Prints the card (name and power limit) first and one JSON line
last. Run from the root of a checkout: ``python3 remat_probe.py``.
"""

from __future__ import annotations

import json
import subprocess
import sys

CHILD = r'''
import json, sys, time
t0 = time.time()
import torch
t1 = time.time()
torch.cuda.init()
x = torch.randn(8, 8, device="cuda", requires_grad=True)
t2 = time.time()
from torch.utils.checkpoint import checkpoint
checkpoint(lambda a: (a * 2).sin(), x, use_reentrant=False).sum().backward()
torch.cuda.synchronize()
t3 = time.time()
print(json.dumps({"import_torch_s": t1 - t0, "cuda_init_s": t2 - t1,
                  "first_checkpoint_s": t3 - t2, "dynamo": "torch._dynamo" in sys.modules}))
'''


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    out = {}
    for n in (1, 4):
        procs = [subprocess.Popen([sys.executable, "-c", CHILD], stdout=subprocess.PIPE,
                                  text=True) for _ in range(n)]
        rows = [json.loads(p.communicate(timeout=300)[0]) for p in procs]
        for row in rows:
            print(f"{n} process(es) at once: import torch {row['import_torch_s']:.2f}s, cuda "
                  f"init {row['cuda_init_s']:.2f}s, first checkpoint "
                  f"{row['first_checkpoint_s']:.2f}s (torch._dynamo imported: {row['dynamo']})")
        out[f"processes_{n}"] = rows
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
