"""Distributed-trace reassembly + critical-path analyzer (the port's
copy of scaling_tpu/obs/trace.py, equal in what it renders).

``python -m scaling_tpu_torch.obs trace <run_dir>`` reads the SAME event
stream the report reads (docs/OBSERVABILITY.md "Tracing") and regroups
it per trace: every record stamped with a ``trace`` id — or carrying
the id in a batch span's ``traces`` / ``chunk_traces`` list — belongs
to the request (or lease / commit) that originated it, no matter which
host's events file it landed in. Per-host timestamps are aligned with
the control plane's skew-immune ``clock-offset`` probes before any
cross-host ordering is derived, so a failover trace that dies on host 1
and resumes on host 0 still reads as one finite, ordered timeline.

Per trace the analyzer attributes wall time into phases:

- ``queue_wait`` — submission until the first compute span touches it;
- ``rpc``        — ``serve.replica.rpc_client`` time under the trace;
- ``prefill``    — ``serve.prefill`` / ``serve.prefill_chunk`` plus the
  chunk share of ``serve.mixed`` ticks (``chunk_traces``);
- ``decode``     — ``serve.decode`` plus the decode share of
  ``serve.mixed`` (``traces``);
- ``failover``   — positive gaps where consecutive host-stamped records
  of the trace jump hosts (replica death + re-dispatch, or a
  backpressure retry elsewhere); zero for a healthy single-replica
  trace;
- ``other``      — the unattributed residual of end-to-end time.

Batch spans serve many requests at once, so a span's full duration is
attributed to EVERY trace riding it — phase seconds answer "how long
did this request sit in phase X", not "how much device time did it
consume"; concurrent requests legitimately share the same wall time.

The critical path of a trace is its largest phase; the fleet-wide
breakdown counts traces per winning phase so "the fleet is queue-bound"
is one line, not a spreadsheet. CI gates: ``--assert-trace-coverage``
(missing data FAILS — a run that stamped nothing must not pass a
coverage floor by silence) and ``--assert-critical-path PHASE:SECONDS``
(no trace may spend more than the ceiling in that phase).

Pure stdlib + deterministic rendering, like the report: exit 0 clean,
1 a gate fired, 2 no parseable telemetry at all.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

from .report import RunData, load_run_dir

SCHEMA_VERSION = 1

PHASES = ("queue_wait", "rpc", "prefill", "decode", "failover", "other")

# span name -> phase it feeds (mixed is split by which list carries the
# trace id, so it is handled out of band)
_RPC_SPANS = ("serve.replica.rpc_client",)
_PREFILL_SPANS = ("serve.prefill", "serve.prefill_chunk")
_DECODE_SPANS = ("serve.decode",)
_MIXED_SPAN = "serve.mixed"
# spans that mark "the engine is working on this request" — the end of
# queue_wait is the first of these; admit/rpc are submission machinery
_COMPUTE_SPANS = set(_PREFILL_SPANS + _DECODE_SPANS + (_MIXED_SPAN,))


# ------------------------------------------------------------ assembly
def clock_offsets(data: RunData) -> Dict[int, float]:
    """Per-host clock offset (seconds AHEAD of the shared reference)
    from the ``clock-offset`` events each host emits at control-plane
    construction. Latest probe per host wins; a host that never probed
    aligns at 0 — single-host runs have nothing to align."""
    out: Dict[int, float] = {}
    for e in data.lifecycle:
        if e.get("event") != "clock-offset":
            continue
        try:
            out[int(e["host"])] = float(e["offset_s"])
        except (KeyError, TypeError, ValueError):
            continue
    return out


def _rec_trace_ids(rec: dict) -> List[str]:
    """Every trace id a record belongs to: the scalar ``trace`` stamp
    plus batch-span membership lists."""
    out: List[str] = []
    tid = rec.get("trace")
    if isinstance(tid, str):
        out.append(tid)
    for key in ("traces", "chunk_traces"):
        ids = rec.get(key)
        if isinstance(ids, list):
            out.extend(t for t in ids if isinstance(t, str) and t not in out)
    return out


def _aligned(rec: dict, offsets: Dict[int, float]) -> Optional[float]:
    """Record end timestamp on the shared clock (host offset removed)."""
    ts = rec.get("ts")
    if ts is None:
        return None
    host = rec.get("host")
    off = offsets.get(int(host), 0.0) if isinstance(host, int) else 0.0
    return float(ts) - off


def _start(rec: dict, end: float) -> float:
    """Span records carry their END ts; the interval starts dur_s
    earlier. Point events start where they end."""
    return end - float(rec.get("dur_s") or 0.0)


def assemble_traces(data: RunData) -> Dict[str, List[dict]]:
    """trace id -> its records, each annotated with aligned ``_end`` /
    ``_start`` floats, ordered by start time."""
    offsets = clock_offsets(data)
    by_trace: Dict[str, List[dict]] = defaultdict(list)
    for rec in data.events:
        ids = _rec_trace_ids(rec)
        if not ids:
            continue
        end = _aligned(rec, offsets)
        if end is None:
            continue
        annotated = dict(rec, _end=end, _start=_start(rec, end))
        for tid in ids:
            by_trace[tid].append(annotated)
    for recs in by_trace.values():
        recs.sort(key=lambda r: (r["_start"], r["_end"]))
    return dict(by_trace)


def trace_phases(tid: str, recs: List[dict]) -> Dict[str, float]:
    """Attribute one trace's wall time into the PHASES buckets."""
    t0 = min(r["_start"] for r in recs)
    t1 = max(r["_end"] for r in recs)
    phases = {p: 0.0 for p in PHASES}
    first_compute: Optional[float] = None
    for r in recs:
        name = r.get("span")
        dur = float(r.get("dur_s") or 0.0)
        if name in _RPC_SPANS:
            phases["rpc"] += dur
        elif name in _PREFILL_SPANS:
            phases["prefill"] += dur
        elif name in _DECODE_SPANS:
            phases["decode"] += dur
        elif name == _MIXED_SPAN:
            # one mixed tick serves chunked prefills AND decodes: the
            # list the id rides in says which side this trace was on
            if tid in (r.get("chunk_traces") or ()):
                phases["prefill"] += dur
            if tid in (r.get("traces") or ()):
                phases["decode"] += dur
        if name in _COMPUTE_SPANS and (first_compute is None
                                       or r["_start"] < first_compute):
            first_compute = r["_start"]
    if first_compute is not None:
        phases["queue_wait"] = max(0.0, first_compute - t0)
    # failover: the trace's host-stamped records jump hosts only when a
    # replica died (journal re-dispatch) or the router retried elsewhere
    # — the positive gap between the hosts is time the request spent
    # stranded. Router-side records carry no host and are skipped.
    hosted = [r for r in recs if isinstance(r.get("host"), int)]
    for prev, cur in zip(hosted, hosted[1:]):
        if prev["host"] != cur["host"]:
            phases["failover"] += max(0.0, cur["_start"] - prev["_end"])
    e2e = max(0.0, t1 - t0)
    attributed = sum(phases[p] for p in PHASES if p != "other")
    phases["other"] = max(0.0, e2e - attributed)
    phases["e2e"] = e2e
    return phases


def critical_phase(phases: Dict[str, float]) -> str:
    """The phase that dominated this trace — deterministic tie-break on
    PHASES order."""
    return max(PHASES, key=lambda p: (phases.get(p, 0.0),
                                      -PHASES.index(p)))


# ------------------------------------------------------------ analysis
def analyze(data: RunData,
            traces: Optional[Dict[str, List[dict]]] = None) -> dict:
    """The full machine-readable payload the renderer + gates read."""
    if traces is None:
        traces = assemble_traces(data)
    reqs = [e for e in data.lifecycle if e.get("event") == "serve-request"]
    completed = [r for r in reqs if r.get("status") == "completed"]
    per_trace: Dict[str, dict] = {}
    for tid, recs in traces.items():
        phases = trace_phases(tid, recs)
        hosts = sorted({r["host"] for r in recs
                        if isinstance(r.get("host"), int)})
        per_trace[tid] = {
            "records": len(recs),
            "hosts": hosts,
            "phases": {k: round(v, 6) for k, v in phases.items()},
            "critical_phase": critical_phase(phases),
            "req": next((r.get("req") for r in recs
                         if r.get("event") == "serve-request"), None),
            "status": next((r.get("status") for r in recs
                            if r.get("event") == "serve-request"), None),
        }
    # coverage: of the requests the engine says completed, how many are
    # reconstructable — trace-stamped AND backed by at least one compute
    # span record. An untraced or span-less request drags coverage down;
    # that is the point of the gate.
    covered = 0
    for r in completed:
        tid = r.get("trace")
        if not isinstance(tid, str):
            continue
        recs = traces.get(tid) or []
        if any(rec.get("span") in _COMPUTE_SPANS or
               rec.get("span") in _RPC_SPANS or
               rec.get("span") == "serve.admit" for rec in recs):
            covered += 1
    coverage = covered / len(completed) if completed else None
    sheds = sum(1 for e in data.lifecycle if e.get("event") == "serve-shed")
    fleet = {p: 0.0 for p in PHASES}
    winners = {p: 0 for p in PHASES}
    for t in per_trace.values():
        for p in PHASES:
            fleet[p] += t["phases"].get(p, 0.0)
        winners[t["critical_phase"]] += 1
    return {
        "schema_version": SCHEMA_VERSION,
        "traces": len(per_trace),
        "requests_completed": len(completed),
        "requests_total": len(reqs),
        "sheds": sheds,
        "coverage": coverage,
        "clock_offsets": {str(h): round(v, 6)
                          for h, v in sorted(clock_offsets(data).items())},
        "fleet_phase_seconds": {p: round(fleet[p], 6) for p in PHASES},
        "critical_path_counts": winners,
        "per_trace": per_trace,
    }


# ----------------------------------------------------------- rendering
def _fmt_s(v: float) -> str:
    return f"{v:.3f}s"


def render(payload: dict, traces: Dict[str, List[dict]],
           slowest: int) -> str:
    lines = ["== traces =="]
    cov = payload["coverage"]
    lines.append(
        f"  traces={payload['traces']} "
        f"completed_requests={payload['requests_completed']} "
        f"sheds={payload['sheds']} coverage="
        + (f"{cov:.1%}" if cov is not None else "(no completed requests)")
    )
    if payload["clock_offsets"]:
        lines.append("  clock offsets: " + " ".join(
            f"host{h}={o:+.3f}s"
            for h, o in payload["clock_offsets"].items()
        ))
    per = payload["per_trace"]
    if not per:
        lines.append("  (no trace-stamped records — pre-tracing run dir, "
                     "or only warmup traffic)")
        return "\n".join(lines) + "\n"
    fleet = payload["fleet_phase_seconds"]
    grand = sum(fleet.values()) or 1.0
    winners = payload["critical_path_counts"]
    lines.append("== fleet phase breakdown ==")
    for p in PHASES:
        lines.append(
            f"  {p:<10} {_fmt_s(fleet[p]):>10}  {fleet[p] / grand:6.1%}  "
            f"critical for {winners[p]} trace(s)"
        )
    ranked = sorted(per.items(), key=lambda kv: -kv[1]["phases"]["e2e"])
    lines.append(f"== slowest {min(slowest, len(ranked))} trace(s) ==")
    for tid, t in ranked[:slowest]:
        hosts = ",".join(map(str, t["hosts"])) or "-"
        lines.append(
            f"  {tid} req={t['req']} status={t['status']} "
            f"e2e={_fmt_s(t['phases']['e2e'])} hosts=[{hosts}] "
            f"critical={t['critical_phase']} "
            + " ".join(f"{p}={_fmt_s(t['phases'][p])}" for p in PHASES)
        )
        recs = traces[tid]
        t0 = min(r["_start"] for r in recs)
        for r in recs[:20]:
            name = r.get("span") or r.get("event")
            host = r.get("host")
            detail = f" ({_fmt_s(float(r['dur_s']))})" if r.get("dur_s") \
                else ""
            lines.append(
                f"    +{r['_start'] - t0:8.4f}s "
                + (f"host{host} " if host is not None else "       ")
                + f"{name}{detail}"
            )
        if len(recs) > 20:
            lines.append(f"    ... {len(recs) - 20} more record(s)")
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------- gates
def check_gates(payload: dict,
                assert_trace_coverage: Optional[float] = None,
                assert_critical_path: Optional[List[str]] = None
                ) -> List[str]:
    """Failure messages (empty == pass). Missing data FAILS a requested
    gate, mirroring the report's gate contract."""
    failures: List[str] = []
    if assert_trace_coverage is not None:
        cov = payload["coverage"]
        if cov is None:
            failures.append(
                "assert-trace-coverage: no completed serve-request "
                "events in the run dir — nothing to measure coverage "
                "over (crashed before any completion, or not a serving "
                "run?)"
            )
        elif cov < assert_trace_coverage:
            failures.append(
                f"assert-trace-coverage: {cov:.3f} < floor "
                f"{assert_trace_coverage:.3f} "
                f"({payload['requests_completed']} completed request(s), "
                "untraced or span-less ones drag this down — a producer "
                "stopped stamping, or events were lost)"
            )
    for spec in assert_critical_path or []:
        try:
            phase, raw = spec.split(":", 1)
            ceiling = float(raw)
        except ValueError:
            failures.append(
                f"assert-critical-path: malformed spec {spec!r} "
                "(expected PHASE:SECONDS)"
            )
            continue
        if phase not in PHASES:
            failures.append(
                f"assert-critical-path: unknown phase {phase!r} "
                f"(one of {', '.join(PHASES)})"
            )
            continue
        per = payload["per_trace"]
        if not per:
            failures.append(
                f"assert-critical-path: no traces in the run dir to "
                f"check {phase} against"
            )
            continue
        worst_tid = max(per, key=lambda t: per[t]["phases"].get(phase, 0.0))
        worst = per[worst_tid]["phases"].get(phase, 0.0)
        if worst > ceiling:
            failures.append(
                f"assert-critical-path: {phase} {worst:.3f}s > ceiling "
                f"{ceiling:.3f}s (trace {worst_tid}, "
                f"req={per[worst_tid]['req']})"
            )
    return failures


# ----------------------------------------------------------------- cli
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m scaling_tpu_torch.obs trace",
        description="per-trace timeline + critical-path analyzer "
        "(docs/OBSERVABILITY.md Tracing)",
    )
    parser.add_argument("run_dir", help="directory holding the run's "
                        "events JSONL files (searched recursively)")
    parser.add_argument("--slowest", type=int, default=5, metavar="N",
                        help="render the N slowest trace timelines "
                        "(default 5)")
    parser.add_argument("--json", metavar="FILE",
                        help="also write the machine-readable payload")
    parser.add_argument("--assert-trace-coverage", type=float,
                        metavar="FLOOR",
                        help="fail (exit 1) when the fraction of "
                        "completed requests reconstructable as traces "
                        "is below FLOOR, or no completions exist at all")
    parser.add_argument("--assert-critical-path", action="append",
                        metavar="PHASE:SECONDS",
                        help="fail (exit 1) when any trace spent more "
                        "than SECONDS in PHASE (one of "
                        + ", ".join(PHASES) + "); repeatable")
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
    traces = assemble_traces(data)
    payload = analyze(data, traces)
    print(render(payload, traces, args.slowest), end="")

    failures = check_gates(
        payload,
        assert_trace_coverage=args.assert_trace_coverage,
        assert_critical_path=args.assert_critical_path,
    )
    if (args.assert_trace_coverage is not None
            or args.assert_critical_path):
        print("== gates ==")
        if failures:
            for f in failures:
                print(f"  FAIL {f}")
        else:
            print("  PASS")
    if args.json:
        # stays raw, same rationale as the report CLI: obs cannot
        # import resilience's retry_io without inverting the layering
        Path(args.json).write_text(  # sta: disable=STA011
            json.dumps(payload, indent=1, sort_keys=True) + "\n"
        )
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
