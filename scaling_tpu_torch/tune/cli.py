"""CLI: ``python -m scaling_tpu_torch.tune`` — rank layouts, emit a config
(counterpart of ``scaling_tpu/tune/cli.py``).

Exit codes: 0 clean, 1 golden drift (``--check-golden``), 2 usage error
(a device count or an option the port does not run yet included).

Calibration resolution (printed with the report):

1. ``--run-dir DIR``: mean MFU of that port obs run dir's step records.
2. ``--mfu X``: a measured MFU handed in (a train bench's or
   ``chip_smoke.py``'s). The JAX tuner's step 2, its bench capture
   (``benchmarks/artifacts/LAST_GOOD.json``), is the TPU's: the port never
   reads it, and its own benchmark's capture is not there yet.
3. The newest port obs run dir under ``--obs-root``.
4. An explicit default (efficiency 0.5) that says it is uncalibrated.

The port trains and serves on one device: ``--devices`` above 1, ``--lower``
and ``--serve-hostsfile`` fail by name until it runs on several.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional, Tuple

GOLDEN_DIR = Path(__file__).resolve().parent / "goldens"

# golden scores compare within this band (pure-python floats are
# deterministic; the band absorbs deliberate small constant tweaks
# without re-pinning the world)
GOLDEN_RTOL = 0.02


def _newest_run_dir(obs_root: Path) -> Optional[Path]:
    """The run dir under ``obs_root`` whose telemetry is newest: the
    directory holding the most recently modified ``*.jsonl``."""
    newest: Tuple[float, Optional[Path]] = (-1.0, None)
    try:
        for p in obs_root.rglob("*.jsonl"):
            try:
                mtime = p.stat().st_mtime
            except OSError:
                continue
            if mtime > newest[0]:
                newest = (mtime, p.parent)
    except OSError:
        return None
    return newest[1]


def resolve_calibration(run_dir: Optional[str], obs_root: Optional[str],
                        mfu: Optional[float] = None):
    """The calibration of the module docstring's order, or None for the
    plain default."""
    from .costmodel import Calibration

    if run_dir:
        cal = Calibration.from_run_dir(run_dir)
        if cal is None:
            print(
                f"# tune: {run_dir} has no MFU step records; falling back",
                file=sys.stderr,
            )
        else:
            return cal
    if mfu is not None:
        return Calibration.from_mfu(mfu, f"measured mfu {mfu} (--mfu)")
    if obs_root:
        newest = _newest_run_dir(Path(obs_root))
        if newest is not None:
            cal = Calibration.from_run_dir(newest)
            if cal is not None:
                return cal
        print(f"# tune: no obs run dir under {obs_root} offered MFU records; "
              "scoring with the uncalibrated default efficiency",
              file=sys.stderr)
    return None


def golden_path(devices: int, model_name: str) -> Path:
    return GOLDEN_DIR / f"tune_{devices}dev_{model_name}.json"


def check_golden(payload: dict, path: Path) -> list:
    if not path.is_file():
        return [f"no golden at {path} (run --repin-golden)"]
    golden = json.loads(path.read_text())
    drift = []
    g_rank = [(r["label"], r["predicted_step_s"]) for r in golden["ranked"]]
    c_rank = [
        (r["label"], r["predicted_step_s"]) for r in payload["ranked"]
    ]
    if [l for l, _ in g_rank] != [l for l, _ in c_rank]:
        drift.append(
            f"ranking order changed: golden {[l for l, _ in g_rank][:5]}... "
            f"!= current {[l for l, _ in c_rank][:5]}..."
        )
    for (gl, gs), (cl, cs) in zip(g_rank, c_rank):
        if gl == cl and gs and abs(cs - gs) > GOLDEN_RTOL * gs:
            drift.append(
                f"{gl}: predicted {gs:.6f}s -> {cs:.6f}s "
                f"(> {GOLDEN_RTOL:.0%} band)"
            )
    return drift


def _parse_model(name: str):
    """Resolve --model to a ModelSpec (shared by the training and
    serving modes); returns (model, model_name) or (None, error)."""
    from .layouts import BENCH_MODELS, ModelSpec

    if name in BENCH_MODELS:
        return BENCH_MODELS[name], name
    try:
        parts = [float(x) for x in name.split(",")]
        model = ModelSpec(
            hidden_size=int(parts[0]), num_layers=int(parts[1]),
            num_attention_heads=int(parts[2]), num_kv_heads=int(parts[3]),
            sequence_length=int(parts[4]), vocab_size=int(parts[5]),
            mlp_factor=parts[6] if len(parts) > 6 else 2.75,
        )
        return model, "custom"
    except (ValueError, IndexError):
        return None, name


def serve_main(args) -> int:
    """``--serve``: rank (mp, replicas, block_size, token_budget) serving
    points by predicted fleet tokens/s; golden-pinned like the training
    ranking, ``--emit-config`` writes a dict ``serve bench --config``
    runs directly."""
    from .costmodel import Calibration, SliceTopology
    from .serving import (
        K1_HEAD_DIMS,
        ServeCalibration,
        check_serve_golden,
        enumerate_serving_points,
        rank_serving_points,
        serve_golden_path,
    )

    model, model_name = _parse_model(args.model)
    if model is None:
        print(f"error: unknown --model {model_name!r}", file=sys.stderr)
        return 2
    head = model.hidden_size // model.num_attention_heads
    if head not in K1_HEAD_DIMS:
        print(f"error: head dim {head}: the paged kernel K1 is built for "
              f"{K1_HEAD_DIMS}", file=sys.stderr)
        return 2
    try:
        block_sizes = [
            int(x) for x in args.serve_block_sizes.split(",") if x.strip()
        ]
        budgets = [
            int(x) for x in args.serve_token_budgets.split(",") if x.strip()
        ]
    except ValueError:
        block_sizes = budgets = []
    if (not block_sizes or not budgets
            or any(v < 1 for v in block_sizes + budgets)):
        print("error: bad --serve-block-sizes / --serve-token-budgets "
              "(want comma lists of ints >= 1)", file=sys.stderr)
        return 2
    topo = SliceTopology(
        chips=args.devices, nvlink_domain=args.nvlink_domain,
        generation=args.generation,
    )
    pinning = args.check_golden or args.repin_golden
    calibration = (
        Calibration.default() if pinning
        else resolve_calibration(args.run_dir, args.obs_root, args.mfu)
    )
    serve_cal = None
    if args.serve_calibrate_from and not pinning:
        serve_cal = ServeCalibration.from_run_dir(
            args.serve_calibrate_from, model, topo, calibration
        )
        if serve_cal is None:
            print(
                f"# tune: {args.serve_calibrate_from} has no serve spans "
                "or engine facts; predictions uncalibrated",
                file=sys.stderr,
            )
    points = enumerate_serving_points(
        args.devices, model, block_sizes=block_sizes,
        token_budgets=budgets, num_slots=args.serve_num_slots,
    )
    if not points:
        print("error: no valid serving point (does any mp divide both "
              "the chip count and the q/kv heads?)", file=sys.stderr)
        return 2
    ranked = rank_serving_points(model, points, topo, calibration,
                                 serve_cal)
    if not ranked:
        print(f"error: no serving point fits {args.generation} memory for "
              "this model", file=sys.stderr)
        return 2
    cal = calibration or Calibration.default()
    best = ranked[0]
    payload = {
        "mode": "serve",
        "devices": args.devices,
        "model": model_name,
        "slice_topology": topo.to_dict(),
        "calibration": cal.to_dict(),
        "serve_calibration": serve_cal.to_dict() if serve_cal else None,
        "ranked": [s.to_dict() for s in ranked],
        "serving_config": best.point.to_config(model),
        "dropped_over_memory": len(points) - len(ranked),
    }
    print(f"tune --serve: {len(ranked)} feasible serving point(s) of "
          f"{model_name} on {args.devices} device(s) [{topo.generation}, "
          f"nvlink_domain={topo.domain}; {payload['dropped_over_memory']} "
          f"dropped over memory]")
    print(f"calibration: efficiency={cal.compute_efficiency:.3f} "
          f"({cal.source})"
          + (f"; serve tick factor {serve_cal.factor:.3f} "
             f"({serve_cal.source})" if serve_cal else ""))
    header = (f"{'rank':>4} {'layout':<24} {'tokens/s':>10} {'tick_s':>9} "
              f"{'comm_s':>9} {'mem_GB':>7} link")
    print(header)
    for i, s in enumerate(ranked[: args.top]):
        print(
            f"{i + 1:>4} {s.point.label:<24} {s.tokens_per_s:>10.0f} "
            f"{s.tick_s:>9.5f} {s.comm_s:>9.5f} {s.memory_gb:>7.2f} "
            f"{s.link}"
        )
    print(f"best: {best.point.label} predicted {best.tokens_per_s:.0f} "
          f"fleet tokens/s, a tick {best.tick_s * 1e3:.3f}ms (run: python -m "
          f"scaling_tpu_torch.serve bench --config <emitted>)")
    if args.emit_config:
        Path(args.emit_config).write_text(
            json.dumps(payload["serving_config"], indent=1) + "\n"
        )
    if args.json:
        Path(args.json).write_text(json.dumps(payload, indent=1) + "\n")
    gpath = serve_golden_path(args.devices, model_name)
    if args.repin_golden:
        gpath.parent.mkdir(parents=True, exist_ok=True)
        gpath.write_text(json.dumps(
            {
                "calibration": "pinned-default",
                "ranked": [
                    {"label": s.to_dict()["label"],
                     "tokens_per_s": s.to_dict()["tokens_per_s"]}
                    for s in ranked
                ],
            },
            indent=1,
        ) + "\n")
        print(f"serving golden repinned -> {gpath}")
    elif args.check_golden:
        drift = check_serve_golden(payload, gpath)
        for line in drift:
            print(f"DRIFT: {line}")
        print(f"golden: {'OK' if not drift else 'DRIFT'}")
        return 1 if drift else 0
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m scaling_tpu_torch.tune",
        description="layout tuner: rank training micro-batches or serving "
                    "points on the card, emit a runnable config",
    )
    parser.add_argument("--devices", type=int, default=1,
                        help="device count (the port runs on 1)")
    parser.add_argument("--model", default="0.5b",
                        help="bench model name (0.5b|1b) or "
                        "hidden,layers,heads,kv,seq,vocab[,mlp_factor]")
    parser.add_argument("--global-batch", type=int, default=64,
                        help="global batch size in sequences")
    parser.add_argument("--mbs", type=int, default=8,
                        help="micro batch size (the search's fixed one "
                        "unless --mbs-ladder widens it)")
    parser.add_argument("--mbs-ladder", metavar="LIST",
                        help="comma list of additional micro-batch sizes to "
                        "enumerate and score alongside --mbs (global batch "
                        "fixed, so gas scales inversely). On one device the "
                        "ladder IS the space, so golden pinning keeps it")
    parser.add_argument("--generation", default="h100_sxm",
                        choices=["h100_sxm"])
    parser.add_argument("--nvlink-domain", type=int, default=None,
                        help="devices per NVLink domain (default: all)")
    parser.add_argument("--top", type=int, default=10,
                        help="rows to print (the JSON always carries all)")
    parser.add_argument("--json", metavar="FILE",
                        help="write the machine-readable report")
    parser.add_argument("--run-dir", help="port obs run dir to calibrate "
                        "compute efficiency from (mean MFU)")
    parser.add_argument("--mfu", type=float, default=None,
                        help="a measured MFU to calibrate from (after "
                        "--run-dir, before --obs-root)")
    parser.add_argument("--obs-root",
                        help="root to search for the newest obs run dir")
    parser.add_argument("--correct-from-runs", metavar="ROOT",
                        help="accumulate tuner-prediction vs span-measured "
                        "pairs from every run dir under ROOT and apply the "
                        "per-axis multiplicative correction to the ranking")
    parser.add_argument("--emit-config", metavar="FILE",
                        help="write the best layout's TopologyConfig dict "
                        "(with --serve: the serving config)")
    parser.add_argument("--record-events", metavar="FILE",
                        help="append a tuner-prediction event for the best "
                        "layout to this events JSONL (an obs run dir file)")
    parser.add_argument("--lower", type=int, metavar="K", default=0,
                        help="not ported: the JAX tuner's cross-check of the "
                        "top K layouts against the lowered multi-device step")
    parser.add_argument("--check-golden", action="store_true",
                        help="compare against the pinned ranking (forces "
                        "the default calibration)")
    parser.add_argument("--repin-golden", action="store_true",
                        help="rewrite the pinned ranking from this run "
                        "(forces the default calibration)")
    # ---- serving points ----
    parser.add_argument("--serve", action="store_true",
                        help="rank SERVING points instead: (mp, "
                        "replicas=devices/mp, block_size, token_budget) "
                        "scored by fleet tokens/s, the KV pool gated against "
                        "the card's memory")
    parser.add_argument("--serve-block-sizes", default="8,16,32",
                        metavar="LIST", help="KV block sizes to sweep")
    parser.add_argument("--serve-token-budgets", default="128,256,512",
                        metavar="LIST",
                        help="per-tick token budgets to sweep")
    parser.add_argument("--serve-num-slots", type=int, default=8,
                        help="decode slots per replica (fixed across the "
                        "sweep)")
    parser.add_argument("--serve-hostsfile", metavar="FILE",
                        help="not ported: the JAX tuner's placement of the "
                        "best point's replicas over a hostsfile")
    parser.add_argument("--serve-calibrate-from", metavar="RUN_DIR",
                        help="scale predicted tick time by the measured "
                        "serve.mixed/serve.decode spans of this port serve "
                        "bench run dir (its serve-summary carries the "
                        "engine shape)")
    args = parser.parse_args(argv)
    if args.devices > 1:
        parser.error(f"--devices {args.devices}: the port trains and serves on one "
                     "device; layouts of several wait for its several-device runs")
    if args.devices < 1:
        parser.error("--devices must be >= 1")
    if args.lower:
        parser.error("--lower (the cross-check against the lowered multi-device "
                     "step) is not ported: it waits for several-device training")
    if args.serve_hostsfile:
        parser.error("--serve-hostsfile (replica placement over hosts) is not "
                     "ported: it waits for several-host serving")
    if args.serve:
        return serve_main(args)

    from .costmodel import (
        AxisCorrection,
        Calibration,
        SliceTopology,
        rank_layouts,
    )
    from .layouts import BENCH_MODELS, enumerate_layouts

    model, model_name = _parse_model(args.model)
    if model is None:
        print(f"error: unknown --model {model_name!r} "
              f"(names: {sorted(BENCH_MODELS)})", file=sys.stderr)
        return 2

    topo = SliceTopology(
        chips=args.devices, nvlink_domain=args.nvlink_domain,
        generation=args.generation,
    )
    pinning = args.check_golden or args.repin_golden
    calibration = (
        Calibration.default() if pinning
        else resolve_calibration(args.run_dir, args.obs_root, args.mfu)
    )
    ladder = None
    if args.mbs_ladder:
        try:
            ladder = [int(x) for x in args.mbs_ladder.split(",") if x.strip()]
        except ValueError:
            ladder = None
        if not ladder or any(m < 1 for m in ladder):
            print(f"error: bad --mbs-ladder {args.mbs_ladder!r} "
                  "(want a comma list of ints >= 1)", file=sys.stderr)
            return 2
    layouts = enumerate_layouts(
        args.devices, model, global_batch_size=args.global_batch,
        micro_batch_size=args.mbs, mbs_ladder=ladder,
    )
    if not layouts:
        print("error: no valid layouts for this model/device count",
              file=sys.stderr)
        return 2
    correction = None
    if args.correct_from_runs and not pinning:
        correction = AxisCorrection.from_run_dirs(args.correct_from_runs)
        if correction is None:
            print(
                f"correction: no tuner prediction/measured pairs under "
                f"{args.correct_from_runs}; ranking uncorrected",
                file=sys.stderr,
            )
    ranked = rank_layouts(model, layouts, topo, calibration,
                          correction=correction)
    cal = calibration or Calibration.default()

    best = ranked[0]
    prediction = {
        "label": best.layout.label,
        "predicted_step_s": round(best.predicted_step_s, 6),
        "world_size": best.layout.world,
        "source": cal.source,
        "collectives_source": best.collectives_source,
    }
    payload = {
        "devices": args.devices,
        "model": model_name,
        "model_spec": {
            "hidden_size": model.hidden_size,
            "num_layers": model.num_layers,
            "num_attention_heads": model.num_attention_heads,
            "num_kv_heads": model.num_kv_heads,
            "sequence_length": model.sequence_length,
            "vocab_size": model.vocab_size,
            "mlp_factor": model.mlp_factor,
            "parameter_count": model.parameter_count,
        },
        "global_batch_size": args.global_batch,
        "micro_batch_size": args.mbs,
        "slice_topology": topo.to_dict(),
        "calibration": cal.to_dict(),
        "axis_correction": correction.to_dict() if correction else None,
        "ranked": [s.to_dict() for s in ranked],
        "topology_config": best.layout.topology_dict(),
        "prediction": prediction,
    }

    print(f"tune: {len(ranked)} valid layout(s) of {model_name} on "
          f"{args.devices} device(s) [{topo.generation}, nvlink_domain="
          f"{topo.domain}]")
    print(f"calibration: efficiency={cal.compute_efficiency:.3f} "
          f"({cal.source})")
    if correction is not None:
        facs = " ".join(
            f"{a}={f:.3f}" for a, f in sorted(correction.factors.items())
        )
        print(f"axis correction: {facs or '(none)'} "
              f"[{correction.pairs} pair(s), {correction.source}]")
    header = (f"{'rank':>4} {'layout':<28} {'step_s':>9} {'tok/s':>10} "
              f"{'bubble':>7} {'comm_s':>8} {'mem_GB':>7} links")
    print(header)
    for i, s in enumerate(ranked[: args.top]):
        links = ",".join(
            f"{ax}:{rec['link']}" for ax, rec in sorted(s.comm_by_axis.items())
        )
        print(
            f"{i + 1:>4} {s.layout.label:<28} {s.predicted_step_s:>9.4f} "
            f"{s.tokens_per_s:>10.0f} {s.bubble_fraction:>6.1%} "
            f"{s.comm_s:>8.4f} {s.memory_gb:>7.2f} {links}"
        )
    print(f"best: {best.layout.label} predicted {best.predicted_step_s:.4f}"
          f"s/step ({best.tokens_per_s:.0f} tokens/s)")
    print("export " + "SCALING_TPU_TUNER_PREDICTION='"
          + json.dumps(prediction) + "'")

    if args.emit_config:
        Path(args.emit_config).write_text(
            json.dumps(payload["topology_config"], indent=1) + "\n"
        )
    if args.record_events:
        from ..logging.logger import append_jsonl_line

        append_jsonl_line(
            args.record_events,
            json.dumps(
                {"event": "tuner-prediction", "ts": time.time(), **prediction},
                sort_keys=True,
            ),
        )
    if args.json:
        Path(args.json).write_text(json.dumps(payload, indent=1) + "\n")

    gpath = golden_path(args.devices, model_name)
    if args.repin_golden:
        gpath.parent.mkdir(parents=True, exist_ok=True)
        gpath.write_text(json.dumps(
            {
                "calibration": "pinned-default",
                "mbs_ladder": ladder,
                "ranked": [
                    {"label": s.to_dict()["label"],
                     "predicted_step_s": s.to_dict()["predicted_step_s"]}
                    for s in ranked
                ],
            },
            indent=1,
        ) + "\n")
        print(f"golden repinned -> {gpath}")
    elif args.check_golden:
        drift = check_golden(payload, gpath)
        for line in drift:
            print(f"DRIFT: {line}")
        print(f"golden: {'OK' if not drift else 'DRIFT'}")
        return 1 if drift else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
