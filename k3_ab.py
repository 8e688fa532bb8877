#!/usr/bin/env python3
"""K3, the RMSNorm backward, against an older checkout's K3 on one CUDA card.

``--parent DIR`` is another checkout of the port (say ``git archive
<commit>`` unpacked into a directory ``.gitignore`` lists) whose
``scaling_tpu_torch/ops/_rms_norm_bwd_triton.py`` holds the Triton K3 this
checkout's CUDA K3 (``csrc/rms_norm_bwd.cu``) replaced. At the training
rows of ``chip_smoke.py`` ((8192, 2048) bf16, seed 2), in one process:

1. both against the plain version (dx within ``chip_smoke.KERNEL_TOL``,
   dw within ``K3_DW_TOL`` of its largest value);
2. turns in the order old, new, new, old: each turn the device ms a call
   by kernel (``torch.profiler``, 20 calls after 20 traced and dropped, as
   ``chip_smoke.time_ms``) and the ms a call from CUDA events around 200
   back-to-back calls; the new kernel's dx-only variant in the new turns;
3. the medians of each side beside the bound (``chip_smoke.k3_bound_ms``),
   with the bytes a call moves over its device time, and the f32
   partials' bytes of each design.

Prints the card (name and power limit) first and one JSON line last. Run
from the root of a checkout: ``python3 k3_ab.py --parent DIR``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

import torch

ORDER = ("old", "new", "new", "old")
SHAPE = (8192, 2048)
EVENT_CALLS = 200


def load_old(parent: Path):
    """The parent's Triton K3 module, loaded from its file."""
    path = parent / "scaling_tpu_torch" / "ops" / "_rms_norm_bwd_triton.py"
    spec = importlib.util.spec_from_file_location("parent_rms_norm_bwd_triton", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def event_ms(fn, calls: int = EVENT_CALLS) -> float:
    """ms a call: CUDA events around ``calls`` back-to-back calls."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ".")
    import chip_smoke as cs
    from scaling_tpu_torch.ops import cuda_build, rms_norm_bwd, rms_norm_bwd_plain
    from scaling_tpu_torch.ops.rms_norm import plan_bwd

    card = cs.card_line()
    print(f"== card: {card}")
    old = load_old(args.parent)
    cuda_build.load("rms_norm_bwd")
    for r in cs.kernel_resources(cuda_build.build_log("rms_norm_bwd")):
        print(f"  ptxas {r['kernel']} registers={r['registers']} spill={r['spill']} bytes")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    n, d = SHAPE
    x = torch.randn(n, d, generator=gen, device=dev).bfloat16()
    w = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).bfloat16()
    g = torch.randn(n, d, generator=gen, device=dev).bfloat16()
    dx_old, dw_old = torch.empty_like(x), torch.empty_like(w)

    def run_old():
        old.launch(x, w, g, dx_old, dw_old, 1e-5)

    def run_new():
        return rms_norm_bwd(x, w, g, 1e-5)

    def run_dx_only():
        return rms_norm_bwd(x, w, g, 1e-5, need_dw=False)

    ref_dx, ref_dw = rms_norm_bwd_plain(x, w, g, 1e-5)
    run_old()
    dx_new, dw_new = run_new()
    torch.cuda.synchronize()
    for name, dx, dw in (("old", dx_old, dw_old), ("new", dx_new, dw_new)):
        torch.testing.assert_close(dx.float(), ref_dx.float(), atol=cs.KERNEL_TOL,
                                   rtol=cs.KERNEL_TOL)
        dw_err = cs.rel_err(dw, ref_dw)
        if not dw_err <= cs.K3_DW_TOL:
            raise AssertionError(f"{name}: dw disagrees: {dw_err}")
        print(f"  {name}: dx max_abs_err={(dx.float() - ref_dx.float()).abs().max().item():.3e}"
              f" dw max_err/max|dw|={dw_err:.3e}")

    turns = []
    for i, side in enumerate(ORDER):
        fns = {"old": (run_old,), "new": (run_new, run_dx_only)}[side]
        for fn, variant in zip(fns, ("dx_dw", "dx_only")):
            parts = cs.device_ms_by_kernel(fn)
            turn = {"turn": i, "side": side, "variant": variant, "by_kernel": parts,
                    "device_ms": sum(parts.values()) if parts else None,
                    "event_ms": event_ms(fn)}
            turns.append(turn)
            print("  turn " + json.dumps(turn))

    bound_ms = cs.k3_bound_ms(x)[0]
    summary = {"card": card, "shape": list(SHAPE), "dtype": "bfloat16", "bound_ms": bound_ms,
               "bound_ms_dx_only": cs.k3_bound_ms(x, need_dw=False)[0]}
    for side, variant in (("old", "dx_dw"), ("new", "dx_dw"), ("new", "dx_only")):
        mine = [t for t in turns if t["side"] == side and t["variant"] == variant]
        dev_ms = [t["device_ms"] for t in mine if t["device_ms"] is not None]
        med = statistics.median(dev_ms) if dev_ms else None
        key = side if variant == "dx_dw" else "new_dx_only"
        b = summary["bound_ms_dx_only"] if variant == "dx_only" else bound_ms
        summary[key] = {
            "device_ms": dev_ms, "event_ms": [t["event_ms"] for t in mine],
            "median_device_ms": med,
            "share_of_bound": None if med is None else b / med,
            "gbps": None if med is None else b / med * cs.HBM_BYTES_PER_S / 1e9,
        }
    programs, _ = old.programs_for(n, d, dev)
    plan = plan_bwd(n, d, 2, 2, torch.cuda.get_device_properties(dev).multi_processor_count)
    summary["partial_bytes"] = {"old": programs * d * 4, "new": plan.partial_bytes(d)}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
