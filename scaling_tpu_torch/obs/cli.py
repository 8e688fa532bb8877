"""CLI: ``python -m scaling_tpu_torch.obs report <run_dir>`` (the port's
copy of scaling_tpu/obs/cli.py: the same flags, gates and exit codes).

Renders the health report on stdout; ``--json`` additionally writes the
machine-readable payload. Exit codes: 0 clean, 1 a ``--assert-*`` gate
fired, 2 the run dir held no parseable telemetry at all.

``python -m scaling_tpu_torch.obs trace <run_dir>`` delegates to the
distributed-trace analyzer (:mod:`.trace`), which owns its own flag set
— the two commands share only the run-dir loader and exit-code
contract.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .report import (
    check_gates,
    load_run_dir,
    mfu_section,
    render_report,
    tuner_section,
)


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "trace":
        # the trace analyzer owns its own argparse (different flags,
        # same exit-code contract) — dispatch before parsing so its
        # --help renders its flags, not the report's
        from .trace import main as trace_main

        return trace_main(argv[1:])
    parser = argparse.ArgumentParser(
        prog="python -m scaling_tpu_torch.obs",
        description="run-dir telemetry analyzer (docs/OBSERVABILITY.md)",
    )
    parser.add_argument("command", choices=["report", "trace"])
    parser.add_argument("run_dir", help="directory holding the run's "
                        "events/metrics JSONL files (searched recursively)")
    parser.add_argument("--json", metavar="FILE",
                        help="also write a machine-readable report")
    parser.add_argument("--assert-mfu", type=float, metavar="FLOOR",
                        help="fail (exit 1) when mean MFU is below FLOOR")
    parser.add_argument("--assert-step-time", type=float, metavar="CEIL",
                        help="fail (exit 1) when p50 step time exceeds "
                        "CEIL seconds")
    parser.add_argument("--assert-tuner-calibration", type=float,
                        metavar="CEIL",
                        help="fail (exit 1) when the tuner's relative "
                        "prediction error vs measured step time exceeds "
                        "CEIL (docs/TUNING.md calibration loop)")
    parser.add_argument("--assert-serve-throughput", type=float,
                        metavar="FLOOR",
                        help="fail (exit 1) when serving output tokens/s "
                        "is below FLOOR (docs/SERVING.md gates)")
    parser.add_argument("--assert-ttft", type=float, metavar="CEIL",
                        help="fail (exit 1) when serving p99 "
                        "time-to-first-token exceeds CEIL seconds")
    parser.add_argument("--assert-spec-accept-rate", type=float,
                        metavar="FLOOR",
                        help="fail (exit 1) when the speculative-decoding "
                        "accept rate is below FLOOR, or the run recorded "
                        "no speculation telemetry (docs/SERVING.md)")
    parser.add_argument("--assert-max-resizes", type=int, metavar="CEIL",
                        help="fail (exit 1) when a supervised run resized "
                        "(downsize OR elastic upsize) more than CEIL "
                        "times, or the run dir holds no supervisor "
                        "telemetry at all (docs/RESILIENCE.md elastic "
                        "capacity); the flap drill's zero-churn gate")
    parser.add_argument("--assert-max-downsizes", type=int, metavar="CEIL",
                        help="alias of --assert-max-resizes (predates "
                        "elastic upsizing; counts BOTH directions so a "
                        "flapping host cannot pass on a technicality)")
    parser.add_argument("--assert-max-shed-rate", type=float,
                        metavar="CEIL",
                        help="fail (exit 1) when the serving shed rate "
                        "exceeds CEIL, or the run dir holds no shed "
                        "telemetry at all (docs/SERVING.md resilience)")
    parser.add_argument("--assert-max-serve-timeouts", type=int,
                        metavar="CEIL",
                        help="fail (exit 1) when more than CEIL serving "
                        "requests hit their deadline, or the run dir "
                        "holds no timeout telemetry at all")
    parser.add_argument("--assert-max-replica-skew", type=float,
                        metavar="CEIL",
                        help="fail (exit 1) when the fleet's per-replica "
                        "completed-request skew (max/min) exceeds CEIL, "
                        "or the run dir holds no replica telemetry at "
                        "all (docs/SERVING.md the fleet)")
    parser.add_argument("--assert-max-replica-restarts", type=int,
                        metavar="CEIL",
                        help="fail (exit 1) when the process fleet's "
                        "supervisor performed more than CEIL relaunches, "
                        "or the run dir holds no fleet supervision "
                        "telemetry at all (docs/SERVING.md process mode)")
    args = parser.parse_args(argv)

    run_dir = Path(args.run_dir)
    if not run_dir.is_dir():
        print(f"error: {run_dir} is not a directory", file=sys.stderr)
        return 2
    data = load_run_dir(run_dir)
    if not data.events and not data.steps and not data.registry:
        print(
            f"error: no telemetry records under {run_dir} "
            f"({data.files} jsonl file(s), {data.bad_lines} unparseable "
            "line(s)) — was the run launched with a log_dir / "
            "SCALING_TPU_EVENTS_PATH?",
            file=sys.stderr,
        )
        return 2
    print(render_report(data, run_dir), end="")

    _, tuner_stats = tuner_section(data)
    failures = check_gates(
        data, assert_mfu=args.assert_mfu,
        assert_step_time=args.assert_step_time,
        assert_tuner_calibration=args.assert_tuner_calibration,
        tuner_stats=tuner_stats,
        assert_serve_throughput=args.assert_serve_throughput,
        assert_ttft=args.assert_ttft,
        assert_spec_accept_rate=args.assert_spec_accept_rate,
        assert_max_downsizes=args.assert_max_downsizes,
        assert_max_resizes=args.assert_max_resizes,
        assert_max_shed_rate=args.assert_max_shed_rate,
        assert_max_serve_timeouts=args.assert_max_serve_timeouts,
        assert_max_replica_skew=args.assert_max_replica_skew,
        assert_max_replica_restarts=args.assert_max_replica_restarts,
    )
    if (args.assert_mfu is not None or args.assert_step_time is not None
            or args.assert_tuner_calibration is not None
            or args.assert_serve_throughput is not None
            or args.assert_ttft is not None
            or args.assert_spec_accept_rate is not None
            or args.assert_max_downsizes is not None
            or args.assert_max_resizes is not None
            or args.assert_max_shed_rate is not None
            or args.assert_max_serve_timeouts is not None
            or args.assert_max_replica_skew is not None
            or args.assert_max_replica_restarts is not None):
        print("== gates ==")
        if failures:
            for f in failures:
                print(f"  FAIL {f}")
        else:
            print("  PASS")

    if args.json:
        from .report import serving_section

        _, stats = mfu_section(data)
        stats = {**stats, **tuner_stats, **serving_section(data)[1]}
        payload = {
            "files": data.files,
            "bad_lines": data.bad_lines,
            "events": len(data.events),
            "step_records": len(data.steps),
            "registry_records": len(data.registry),
            "stats": stats,
            "gate_failures": failures,
        }
        # stays raw: obs cannot import resilience's retry_io without
        # inverting the layering (resilience wraps its I/O in obs spans),
        # and a failed report write already fails the CLI loudly
        Path(args.json).write_text(  # sta: disable=STA011
            json.dumps(payload, indent=1) + "\n"
        )
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
