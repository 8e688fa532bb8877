#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives two ranks sharing one CUDA card can run.

For each collective of ``COLLECTIVES``, starts two worker processes of
itself on ``cuda:0`` with the gloo backend, runs that collective once on
CUDA tensors, checks its result, and records ``ok``, the first line of the
error it raised, or how the process died (gloo hands some device pointers
straight to its TCP transport, and the process aborts). Then, in another
pair of processes, tries the NCCL backend with both ranks on the same
device and records what it said. Every process is killed at its limit.

The gloo table decides whether ``scaling_tpu_torch/parallel/collectives.py``
can run its collectives on the CUDA tensors of ranks that share a card
(it can: PERF.md). Prints the card (name and power
limit) first and one JSON line last. Run from the root of a checkout:
``python3 dist_probe.py``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

COLLECTIVES = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
               "reduce_scatter", "reduce_scatter_tensor", "reduce", "gather", "scatter",
               "all_to_all_single", "send_recv", "barrier")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_one(name: str, rank: int, world: int, dev):
    import torch
    import torch.distributed as dist
    x = torch.full((4,), float(rank + 1), device=dev)
    if name == "all_reduce":
        dist.all_reduce(x)
        return x.tolist() == [3.0] * 4
    if name == "broadcast":
        dist.broadcast(x, 0)
        return x.tolist() == [1.0] * 4
    if name == "all_gather":
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x)
        return [o[0].item() for o in out] == [1.0, 2.0]
    if name == "all_gather_into_tensor":
        out = torch.empty(world * 4, device=dev)
        dist.all_gather_into_tensor(out, x)
        return out.tolist() == [1.0] * 4 + [2.0] * 4
    if name == "reduce_scatter":
        out = torch.empty_like(x)
        dist.reduce_scatter(out, [x.clone() for _ in range(world)])
        return out.tolist() == [3.0] * 4
    if name == "reduce_scatter_tensor":
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, x)
        return out.tolist() == [3.0] * 2
    if name == "reduce":
        dist.reduce(x, 0)
        return rank != 0 or x.tolist() == [3.0] * 4
    if name == "gather":
        out = [torch.empty_like(x) for _ in range(world)] if rank == 0 else None
        dist.gather(x, out, dst=0)
        return rank != 0 or [o[0].item() for o in out] == [1.0, 2.0]
    if name == "scatter":
        out = torch.empty_like(x)
        src = [torch.full((4,), float(r + 10), device=dev) for r in range(world)]
        dist.scatter(out, src if rank == 0 else None, src=0)
        return out[0].item() == 10.0 + rank
    if name == "all_to_all_single":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out.tolist() == [1.0, 1.0, 2.0, 2.0]
    if name == "send_recv":
        if rank == 0:
            dist.send(x, 1)
            return True
        dist.recv(x, 0)
        return x.tolist() == [1.0] * 4
    if name == "barrier":
        dist.barrier()
        return True
    raise ValueError(name)


def worker(backend: str, name: str) -> None:
    import torch
    import torch.distributed as dist
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{os.environ['MASTER_PORT']}",
                            rank=rank, world_size=world)
    result = {}
    try:
        ok = run_one(name, rank, world, dev)
        torch.cuda.synchronize()
        result[name] = "ok" if ok else "wrong result"
    except Exception as e:  # the probe records every refusal
        result[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    if rank == 0:
        print("RESULT " + json.dumps(result), flush=True)
    dist.destroy_process_group()


def launch(backend: str, name: str, timeout: float) -> dict:
    port = free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": "2", "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen([sys.executable, __file__, "--worker", backend, name], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    timed_out = False
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            timed_out = True
            for q in procs:
                q.kill()
            out, err = p.communicate()
        outs.append((p.returncode, out, err))
    rc0, out0, err0 = outs[0]
    for line in out0.splitlines():
        if line.startswith("RESULT "):
            return {"rcs": [o[0] for o in outs], "result": json.loads(line[7:])}
    tail = [line for _, _, e in outs for line in e.splitlines() if line.strip()][-6:]
    return {"rcs": [o[0] for o in outs], "timed_out": timed_out, "stderr_tail": tail}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} devices "
          f"{torch.cuda.device_count()}")
    print("gloo on CUDA tensors, two ranks on cuda:0:")
    gloo = {}
    for name in COLLECTIVES:
        gloo[name] = launch("gloo", name, 60)
        res = gloo[name]
        verdict = res["result"][name] if "result" in res else (
            f"process died, rcs {res['rcs']}: {' | '.join(res['stderr_tail'][-2:])[:200]}")
        print(f"  {name:24s} {verdict}", flush=True)
    nccl = launch("nccl", "all_reduce", 90)
    print(f"nccl, two ranks on cuda:0: {json.dumps(nccl)[:1200]}")
    print(json.dumps({"gloo_cuda": gloo, "nccl_shared_device": nccl}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        worker(sys.argv[2], sys.argv[3])
        sys.exit(0)
    sys.exit(main())
