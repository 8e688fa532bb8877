"""Run-dir analyzer: events + metrics JSONL -> health report.

The port's copy of scaling_tpu/obs/report.py, equal in what it renders,
so that a run directory written by either package renders the same
report through either package's CLI.

``python -m scaling_tpu_torch.obs report <run_dir>`` walks every ``*.jsonl``
under the run directory (however the launcher named them — per-host
``host0_events.jsonl``, ``metrics_rank_0.jsonl``, one shared file —
records classify themselves), and renders:

- step-time percentiles per host + straggler verdict;
- MFU / achieved-TFLOPs / throughput summary;
- barrier-wait attribution per barrier and per host (the host that
  waits ~0 arrived last — it made everyone else wait), the offline
  echo of the live ``_on_step_stall`` straggler table;
- checkpoint commit latency breakdown per step
  (stage / manifest / rename / commit-barrier / latest);
- the restart / preemption timeline from the supervision events;
- optional CI-style gates (``--assert-mfu``, ``--assert-step-time``).

Pure stdlib + deterministic rendering: the golden-report test pins the
exact output for a canned run dir, so keep formatting changes deliberate.
"""

from __future__ import annotations

import dataclasses
import json
import math
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

# lifecycle events the timeline renders (everything except the
# high-frequency span records); unknown event names still render — a new
# subsystem's events must not be invisible to post-mortems
SPAN_EVENT = "span"

CKPT_PHASES = (
    "trainer.save", "ckpt.stage", "ckpt.manifest", "ckpt.rename",
    "ckpt.commit_barrier", "ckpt.latest",
)


@dataclasses.dataclass
class RunData:
    events: List[dict]
    steps: List[dict]
    registry: List[dict]
    files: int
    bad_lines: int

    @property
    def spans(self) -> List[dict]:
        return [e for e in self.events if e.get("event") == SPAN_EVENT]

    @property
    def lifecycle(self) -> List[dict]:
        return [e for e in self.events if e.get("event") != SPAN_EVENT]


def load_run_dir(run_dir: Path | str, recursive: bool = True) -> RunData:
    """Parse every JSONL under ``run_dir``; tolerant of torn tails (a
    SIGKILLed host's last line) and foreign files — unparseable lines
    are counted, never fatal. ``recursive=False`` reads only the
    directory's own files (callers that walk subdirectories themselves
    would otherwise double-count them)."""
    run_dir = Path(run_dir)
    events: List[dict] = []
    steps: List[dict] = []
    registry: List[dict] = []
    files = 0
    bad = 0
    glob = run_dir.rglob if recursive else run_dir.glob
    for path in sorted(glob("*.jsonl")):
        files += 1
        try:
            # stays raw: the report reader is already fault-tolerant by
            # design — an unreadable file counts as bad and the report
            # proceeds (torn tails are data, not errors, post-crash)
            text = path.read_text()  # sta: disable=STA011
        except OSError:
            bad += 1
            continue
        for line in text.splitlines():
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                bad += 1
                continue
            if not isinstance(rec, dict):
                bad += 1
                continue
            if "event" in rec:
                events.append(rec)
            elif rec.get("kind") == "step":
                steps.append(rec)
            elif rec.get("kind") == "registry":
                registry.append(rec)
            else:
                bad += 1
    events.sort(key=lambda r: r.get("ts", 0.0))
    steps.sort(key=lambda r: (r.get("step", 0), r.get("host", 0)))
    return RunData(events=events, steps=steps, registry=registry,
                   files=files, bad_lines=bad)


# ------------------------------------------------------------------ math
def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation)."""
    assert values
    s = sorted(values)
    idx = max(0, min(len(s) - 1, math.ceil(q / 100.0 * len(s)) - 1))
    return s[idx]


def _fmt_s(v: float) -> str:
    return f"{v:.3f}s"


# -------------------------------------------------------------- sections
def step_time_section(data: RunData) -> List[str]:
    by_host: Dict[int, List[float]] = defaultdict(list)
    for rec in data.steps:
        dur = rec.get("metrics", {}).get("step_duration")
        if dur is not None:
            by_host[int(rec.get("host", 0))].append(float(dur))
    lines = ["== step time =="]
    if not by_host:
        lines.append("  (no step records)")
        return lines
    p50s: Dict[int, float] = {}
    for host in sorted(by_host):
        vals = by_host[host]
        p50s[host] = percentile(vals, 50)
        lines.append(
            f"  host {host}: n={len(vals)} p50={_fmt_s(percentile(vals, 50))} "
            f"p90={_fmt_s(percentile(vals, 90))} "
            f"p99={_fmt_s(percentile(vals, 99))} max={_fmt_s(max(vals))}"
        )
    if len(p50s) > 1:
        fastest = min(p50s.values())
        slowest_host = max(p50s, key=lambda h: p50s[h])
        ratio = p50s[slowest_host] / fastest if fastest > 0 else float("inf")
        if ratio > 1.2:
            lines.append(
                f"  straggler: host {slowest_host} "
                f"(p50 {ratio:.2f}x the fastest host)"
            )
        else:
            lines.append(f"  stragglers: none (p50 spread {ratio:.2f}x)")
    return lines


def mfu_section(data: RunData) -> Tuple[List[str], Dict[str, float]]:
    """Render + return the summary stats the gates check."""
    mfus: List[float] = []
    tflops: List[float] = []
    tokens: List[float] = []
    step_times: List[float] = []
    for rec in data.steps:
        m = rec.get("metrics", {})
        v = m.get("mfu", m.get("palm_mfu"))
        if v is not None:
            mfus.append(float(v))
        if m.get("achieved_tflops") is not None:
            tflops.append(float(m["achieved_tflops"]))
        if m.get("tokens_per_second") is not None:
            tokens.append(float(m["tokens_per_second"]))
        if m.get("step_duration") is not None:
            step_times.append(float(m["step_duration"]))
    lines = ["== mfu / throughput =="]
    stats: Dict[str, float] = {}
    if step_times:
        stats["step_time_p50"] = percentile(step_times, 50)
    if mfus:
        stats["mfu_mean"] = sum(mfus) / len(mfus)
        lines.append(
            f"  mfu: mean={stats['mfu_mean']:.4f} "
            f"p50={percentile(mfus, 50):.4f} min={min(mfus):.4f} "
            f"max={max(mfus):.4f}"
        )
    else:
        lines.append("  mfu: (not recorded — configure trainer.telemetry)")
    if tflops:
        lines.append(
            f"  achieved_tflops: mean={sum(tflops) / len(tflops):.1f} "
            f"max={max(tflops):.1f}"
        )
    if tokens:
        lines.append(
            f"  tokens_per_second: mean={sum(tokens) / len(tokens):.0f} "
            f"max={max(tokens):.0f}"
        )
    return lines, stats


def _epoch_key(rec: dict) -> Tuple:
    """Attribution key prefix: a relaunched pod re-waits the same barrier
    and re-saves the same step in a later supervisor epoch, and merging
    those incidents would corrupt the arrived-last verdict. Spans without
    an epoch (single-epoch runs, old files) sort first unchanged."""
    epoch = rec.get("epoch")
    return (epoch is not None, epoch if epoch is not None else 0)


def _epoch_label(key: Tuple) -> str:
    has_epoch, epoch = key
    return f"epoch {epoch} " if has_epoch else ""


def barrier_section(data: RunData) -> List[str]:
    """Per-barrier wait attribution (per supervisor epoch). The LAST
    host to arrive waits ~0 and is the one every peer waited on;
    per-host blame aggregates the time it cost its peers."""
    waits: Dict[Tuple, Dict[int, float]] = defaultdict(lambda: defaultdict(float))
    ok_waits: Dict[Tuple, Dict[int, float]] = defaultdict(lambda: defaultdict(float))
    failed: Dict[Tuple, str] = {}
    for sp in data.spans:
        if sp.get("span") != "barrier.wait":
            continue
        key = _epoch_key(sp) + (str(sp.get("barrier", "?")),)
        host = int(sp.get("host", 0))
        waits[key][host] += float(sp.get("dur_s", 0.0))
        if sp.get("ok", True):
            ok_waits[key][host] += float(sp.get("dur_s", 0.0))
        else:
            failed[key] = str(sp.get("error", "error"))
    lines = ["== barrier wait attribution =="]
    if not waits:
        lines.append("  (no barrier spans)")
        return lines
    blame: Dict[int, float] = defaultdict(float)
    blame_barriers: Dict[int, int] = defaultdict(int)
    for key in sorted(waits):
        per_host = waits[key]
        label = _epoch_label(key[:2]) + key[2]
        rendered = " ".join(
            f"host{h}={_fmt_s(per_host[h])}" for h in sorted(per_host)
        )
        suffix = ""
        # the arrived-last verdict only makes sense over SUCCESSFUL
        # waits: when the barrier failed, the culprit is whoever never
        # produced a span (the dead/hung host) — blaming the survivor
        # whose timeout was marginally shorter misattributes the cost
        succeeded = ok_waits.get(key, {})
        if len(succeeded) > 1:
            last = min(succeeded, key=lambda h: succeeded[h])
            cost = sum(v for h, v in succeeded.items() if h != last)
            blame[last] += cost
            blame_barriers[last] += 1
            suffix = f" -> host {last} arrived last"
        if key in failed:
            suffix += f" [FAILED: {failed[key]}]"
        lines.append(f"  {label}: {rendered}{suffix}")
    for host in sorted(blame):
        lines.append(
            f"  blame: host {host} kept peers waiting "
            f"{_fmt_s(blame[host])} across {blame_barriers[host]} barrier(s)"
        )
    return lines


def checkpoint_section(data: RunData) -> List[str]:
    by_step: Dict[Tuple, Dict[str, float]] = defaultdict(dict)
    for sp in data.spans:
        name = sp.get("span")
        if name not in CKPT_PHASES or "step" not in sp:
            continue
        # per (epoch, step): a relaunched pod re-saves the same step
        key = _epoch_key(sp) + (int(sp["step"]),)
        # multihost: keep the slowest host's phase time (the pod-wide cost)
        prev = by_step[key].get(name, 0.0)
        by_step[key][name] = max(prev, float(sp.get("dur_s", 0.0)))
    lines = ["== checkpoint commits =="]
    if not by_step:
        lines.append("  (no checkpoint spans)")
        return lines
    for key in sorted(by_step):
        phases = by_step[key]
        parts = [
            f"{phase.split('.', 1)[-1]}={_fmt_s(phases[phase])}"
            for phase in CKPT_PHASES if phase in phases
        ]
        lines.append(
            f"  {_epoch_label(key[:2])}step {key[2]}: " + " ".join(parts)
        )
    return lines


def step_span_sums(spans: List[dict], names: Tuple[str, ...],
                   drop_earliest_step: bool = True
                   ) -> Dict[int, Dict[int, Dict[str, float]]]:
    """Per-host, per-step summed durations of the given span names —
    the ONE aggregation both the report's pipeline section and the
    schedule simulator's profile calibration
    (``parallel.pipeline_schedule._durations_from_run_dir``) read, so
    the compile-step-drop policy cannot diverge between them. With
    ``drop_earliest_step`` (default), each host's earliest step is
    removed when later steps exist — it carries the jit compile."""
    by_host: Dict[int, Dict[int, Dict[str, float]]] = defaultdict(dict)
    for sp in spans:
        name = sp.get("span")
        if name not in names or "step" not in sp:
            continue
        rec = by_host[int(sp.get("host", 0))].setdefault(int(sp["step"]), {})
        rec[name] = rec.get(name, 0.0) + float(sp.get("dur_s", 0.0))
    if drop_earliest_step:
        for host, steps in by_host.items():
            if len(steps) > 1:
                del steps[min(steps)]
    return dict(by_host)


def step_compute_samples(
    by_host: Dict[int, Dict[int, Dict[str, float]]]
) -> List[float]:
    """Per-host AMORTIZED per-step compute seconds from fwdbwd/sync sums.

    Under ``log_interval > 1`` the trainer skips the device sync on most
    steps: their records carry only the ~ms ``step.fwdbwd`` dispatch,
    and the next synced step's ``step.sync`` drains the whole backlog.
    A per-step percentile would read dispatch latency as compute, so the
    sample is per host: (sum of all kept fwdbwd + sync) / kept steps —
    the same amortization the trainer's own ``step_duration`` uses."""
    samples: List[float] = []
    for steps in by_host.values():
        if not steps:
            continue
        total = sum(sum(rec.get(n, 0.0) for n in ("step.fwdbwd", "step.sync"))
                    for rec in steps.values())
        samples.append(total / len(steps))
    return samples


def _pipeline_tick_counts(pp: int, virtual: int, slices: int,
                          gas: int) -> Tuple[str, int, int]:
    """(schedule label, work ticks, total ticks) of the spatial executor
    (parallel/pipeline.py) — closed-form, mirroring the schedule DSL's
    simulator without importing the pipeline modules here."""
    if virtual > 1:
        return f"interleaved(v={virtual})", gas * virtual, gas * virtual + pp - 1
    if slices > 1:
        return f"token-slice(S={slices})", gas * slices, gas * slices + pp - 1
    return "fill-drain", gas, gas + pp - 1


def pipeline_section(data: RunData) -> List[str]:
    """Pipeline bubble attribution: the schedule shape comes from the
    trainer's ``pipeline-config`` event; the measured step compute from
    the ``step.fwdbwd`` (dispatch) + ``step.sync`` (drain) spans. The
    schedule's tick counts attribute that measured time into busy vs
    fill/drain-idle seconds, next to the same attribution for the naive
    fill-drain schedule on the same shape. Rendered only for pipelined
    runs (no event -> no section, so single-path run dirs are
    unchanged)."""
    cfgs = [e for e in data.lifecycle if e.get("event") == "pipeline-config"]
    if not cfgs:
        return []
    cfg = cfgs[-1]
    pp = int(cfg.get("pp", 1))
    virtual = int(cfg.get("virtual", 1))
    slices = int(cfg.get("token_slices", 1))
    gas = int(cfg.get("gas", 1))
    label, work, total = _pipeline_tick_counts(pp, virtual, slices, gas)
    bubble = (total - work) / total if total else 0.0
    _, fd_work, fd_total = _pipeline_tick_counts(pp, 1, 1, gas)
    fd_bubble = (fd_total - fd_work) / fd_total if fd_total else 0.0
    lines = ["== pipeline =="]
    lines.append(
        f"  schedule: {label} pp={pp} gas={gas} "
        f"({work} work ticks / {total} total per pass)"
    )
    lines.append(
        f"  predicted bubble: {bubble:.1%} "
        f"(fill-drain on this shape: {fd_bubble:.1%})"
    )
    by_host = step_span_sums(data.spans, ("step.fwdbwd", "step.sync"))
    samples = step_compute_samples(by_host)
    if not samples:
        lines.append("  measured: (no step.fwdbwd/step.sync spans)")
        return lines
    p50 = percentile(samples, 50)
    n_steps = sum(len(steps) for steps in by_host.values())
    idle_s = p50 * bubble
    lines.append(
        f"  measured step compute (fwdbwd+sync amortized over {n_steps} "
        f"steps): {_fmt_s(p50)}"
    )
    lines.append(
        f"  attributed: per-tick {_fmt_s(p50 / total)}, "
        f"fill/drain idle {_fmt_s(idle_s)}/step ({bubble:.1%} of compute)"
    )
    return lines


def tuner_section(data: RunData) -> Tuple[List[str], Dict[str, float]]:
    """Prediction-vs-measured for the auto-sharding tuner (docs/TUNING.md
    "calibration loop"): the ``tuner-prediction`` event carries the cost
    model's predicted step seconds for the layout this run executes; the
    measured side is the span-measured step compute (fwdbwd+sync — the
    window the cost model actually prices), falling back to the
    ``step_duration`` metric when the run recorded no spans. The relative
    calibration error is returned for the ``--assert-tuner-calibration``
    gate. Rendered only when a prediction event exists, so run dirs from
    untuned launches (and the committed golden reports) are unchanged."""
    preds = [
        e for e in data.lifecycle if e.get("event") == "tuner-prediction"
    ]
    if not preds:
        return [], {}
    pred = preds[-1]
    lines = ["== tuner =="]
    stats: Dict[str, float] = {}
    label = pred.get("label", "?")
    source = pred.get("source", "?")
    try:
        predicted = float(pred["predicted_step_s"])
    except (KeyError, TypeError, ValueError):
        lines.append(
            f"  prediction event for {label} carries no predicted_step_s"
        )
        return lines, stats
    stats["tuner_predicted_step_s"] = predicted
    lines.append(
        f"  layout {label}: predicted {_fmt_s(predicted)}/step "
        f"(calibration: {source})"
    )
    samples = step_compute_samples(
        step_span_sums(data.spans, ("step.fwdbwd", "step.sync"))
    )
    if samples:
        measured = percentile(samples, 50)
        measured_how = "span-measured compute (fwdbwd+sync p50)"
    else:
        durs = [
            float(r["metrics"]["step_duration"]) for r in data.steps
            if r.get("metrics", {}).get("step_duration") is not None
        ]
        if not durs:
            lines.append("  measured: (no spans or step_duration records)")
            return lines, stats
        measured = percentile(durs, 50)
        measured_how = "step_duration p50 (no spans in this run dir)"
    stats["tuner_measured_step_s"] = measured
    err = (predicted - measured) / measured if measured > 0 else math.inf
    stats["tuner_calibration_error"] = err
    lines.append(f"  measured: {_fmt_s(measured)}/step [{measured_how}]")
    lines.append(
        f"  calibration error: {err:+.1%} (predicted vs measured; the cost "
        f"model {'over' if err > 0 else 'under'}-prices this layout)"
    )
    return lines, stats


def serving_section(data: RunData) -> Tuple[List[str], Dict[str, float]]:
    """Serving-engine health (docs/SERVING.md): per-request
    ``serve-request`` events carry TTFT / ITL / preemption counts, the
    final ``serve-summary`` carries wall-clock throughput. Percentiles
    are computed over the per-request events (exact, not histogram
    buckets); throughput comes from the summary event when present and
    falls back to tokens/wall derived from the request events. Rendered
    only when serve events exist, so training run dirs (and the
    committed golden reports) are unchanged. The returned stats feed the
    ``--assert-serve-throughput`` / ``--assert-ttft`` gates."""
    reqs = [e for e in data.lifecycle if e.get("event") == "serve-request"]
    summaries = [
        e for e in data.lifecycle if e.get("event") == "serve-summary"
    ]
    if not reqs and not summaries:
        return [], {}
    lines = ["== serving =="]
    stats: Dict[str, float] = {}
    ttfts = sorted(
        float(e["ttft_s"]) for e in reqs if e.get("ttft_s") is not None
    )
    if summaries:
        s = summaries[-1]
        try:
            stats["serve_tokens_per_s"] = float(s["tokens_per_s"])
            lines.append(
                f"  throughput: {stats['serve_tokens_per_s']:.1f} output "
                f"tokens/s ({int(s.get('output_tokens', 0))} tokens over "
                f"{float(s.get('wall_s', 0.0)):.3f}s, "
                f"{int(s.get('requests', 0))} request(s))"
            )
        except (KeyError, TypeError, ValueError):
            lines.append("  throughput: (summary event carries no "
                         "tokens_per_s)")
        lines.append(
            f"  engine: ticks={int(s.get('ticks', 0))} "
            f"preemptions={int(s.get('preemptions', 0))} "
            f"prefill_compiles={int(s.get('prefill_compiles', 0))}"
        )
        # raw-speed rails (docs/SERVING.md "Raw speed"): shared-prefix
        # reuse and self-drafting speculation report their win here —
        # the artifacts a prefix/spec perf claim is judged on
        hit = s.get("prefix_hit_tokens")
        if hit:
            stats["serve_prefix_hit_rate"] = float(
                s.get("prefix_hit_rate") or 0.0
            )
            lines.append(
                f"  prefix cache: {int(hit)} tokens hit, "
                f"{int(s.get('prefilled_tokens', 0))} prefilled "
                f"({int(s.get('prompt_tokens', 0))} prompt tokens "
                f"submitted; hit rate "
                f"{stats['serve_prefix_hit_rate']:.1%})"
            )
        if s.get("spec_accept_rate") is not None:
            stats["serve_spec_accept_rate"] = float(s["spec_accept_rate"])
            lines.append(
                f"  speculation: accepted "
                f"{int(s.get('spec_accepted_tokens', 0))}/"
                f"{int(s.get('spec_drafted_tokens', 0))} drafts "
                f"(accept rate {stats['serve_spec_accept_rate']:.1%})"
            )
        # resilience rails (docs/SERVING.md "Resilience"): overload
        # sheds, deadline timeouts, supervised restarts, drain state —
        # the artifacts the --assert-max-shed-rate /
        # --assert-max-serve-timeouts gates read. Only rendered when
        # the summary carries the fields, so pre-resilience run dirs
        # (and committed golden reports) are unchanged.
        if "requests_shed" in s or "requests_timeout" in s:
            shed = int(s.get("requests_shed", 0))
            timeouts = int(s.get("requests_timeout", 0))
            rate = float(s.get("shed_rate") or 0.0)
            # the supervisor logs serve-restart per relaunch — even one
            # that crashed before journaling anything (a serve-resume
            # is only emitted once a replay has content); a manual
            # `--resume` run has no supervisor, so fall back to its
            # serve-resume events
            restarts = sum(
                1 for e in data.lifecycle
                if e.get("event") == "serve-restart"
            ) or sum(
                1 for e in data.lifecycle if e.get("event") == "serve-resume"
            )
            stats["serve_shed_rate"] = rate
            stats["serve_timeouts"] = float(timeouts)
            stats["serve_restarts"] = float(restarts)
            line = (f"  resilience: shed={shed} (rate {rate:.1%}) "
                    f"timeouts={timeouts} restarts={restarts}")
            if s.get("drained"):
                line += (f" [drained; {int(s.get('unsubmitted', 0))} "
                         "unsubmitted]")
            lines.append(line)
        # fleet rows (docs/SERVING.md "The fleet"): per-replica load /
        # completion split plus the router's dispatch-policy stats —
        # what the --assert-max-replica-skew gate reads. Only rendered
        # when the summary carries replica_stats, so single-engine run
        # dirs (and committed goldens) are unchanged.
        reps = s.get("replica_stats")
        if isinstance(reps, list) and reps:
            router = s.get("router") or {}
            counts = [int(r.get("requests", 0)) for r in reps]
            if min(counts) > 0:
                skew = max(counts) / min(counts)
            elif max(counts) > 0:
                skew = math.inf
            else:
                skew = 1.0
            stats["serve_replicas"] = float(len(reps))
            stats["serve_replica_skew"] = skew
            affinity = int(router.get("affinity_dispatches", 0))
            dispatches = int(router.get("dispatches", 0))
            stats["serve_affinity_hit_rate"] = float(
                router.get("affinity_hit_rate") or 0.0
            )
            lines.append(
                f"  fleet: replicas={len(reps)} dispatches={dispatches} "
                f"affinity_hits={affinity} "
                f"({stats['serve_affinity_hit_rate']:.1%}) "
                f"retries_elsewhere={int(router.get('retries_elsewhere', 0))}"
                f" rejected={int(router.get('rejected', 0))} "
                f"skew={'inf' if skew == math.inf else format(skew, '.2f')}"
            )
            for r in reps:
                row = (
                    f"    replica {r.get('replica')}: "
                    f"requests={int(r.get('requests', 0))} "
                    f"tokens={int(r.get('output_tokens', 0))} "
                    f"dispatches={int(r.get('dispatches', 0))} "
                    f"timeouts={int(r.get('timeouts', 0))} "
                    f"pressure={float(r.get('pool_pressure', 0.0)):.2f}"
                )
                if r.get("host") is not None:
                    row += f" host={r['host']}"
                if not r.get("alive", True):
                    row += " [FAILED]"
                lines.append(row)
        # host-mode attribution (docs/SERVING.md "Host mode"): which
        # hosts the placement plan expected vs which actually published
        # a rendezvous record. A planned host that never reported is a
        # machine the fleet silently ran without — the
        # --assert-max-replica-restarts gate fails on it loudly.
        hosts_planned = s.get("fleet_hosts")
        if isinstance(hosts_planned, list) and hosts_planned:
            reported = {int(h) for h in (s.get("hosts_reported") or [])}
            missing = [h for h in hosts_planned if int(h) not in reported]
            stats["serve_fleet_hosts"] = float(len(hosts_planned))
            stats["serve_hosts_missing"] = float(len(missing))
            line = (f"  hosts: planned={hosts_planned} "
                    f"reported={sorted(reported)} "
                    f"submit_dups={int(s.get('submit_dups', 0))} "
                    f"rpc_retries={int(s.get('rpc_retries', 0))}")
            if missing:
                line += f" MISSING={missing}"
            lines.append(line)
        if s.get("spec_k_sweep"):
            # the --spec-k-sweep arm: every draft length's measured
            # tokens/s + accept rate, best-k first-class
            lines.append(
                f"  spec-k sweep: best k={s.get('spec_k_best')} of "
                + ", ".join(
                    f"k={row.get('spec_k')}:"
                    f"{float(row.get('tokens_per_s', 0.0)):.1f}t/s"
                    for row in s["spec_k_sweep"]
                )
            )
    elif reqs:
        # crashed/partial run: derive throughput from what finished
        tokens = sum(int(e.get("output_tokens", 0)) for e in reqs)
        ts = [float(e["ts"]) for e in reqs if e.get("ts") is not None]
        wall = max(ts) - min(ts) if len(ts) > 1 else 0.0
        if wall > 0:
            stats["serve_tokens_per_s"] = tokens / wall
            lines.append(
                f"  throughput: {stats['serve_tokens_per_s']:.1f} output "
                f"tokens/s ({tokens} tokens, derived from "
                f"{len(reqs)} request events — no serve-summary)"
            )
        else:
            lines.append(
                f"  throughput: ({tokens} tokens over {len(reqs)} "
                "request(s); too few events to derive a rate)"
            )
    # process-fleet supervision timeline (docs/SERVING.md "Process
    # mode"): every replica lifecycle event — readiness, deaths,
    # relaunches, autoscale spawns/drains, give-ups — in wall order,
    # plus the restart tally the --assert-max-replica-restarts gate
    # reads. Rendered only when replica lifecycle events exist, so
    # non-fleet run dirs (and committed goldens) are unchanged.
    fleet_events = sorted(
        (
            e for e in data.lifecycle
            if str(e.get("event", "")).startswith("serve-replica-")
            and e.get("ts") is not None
        ),
        key=lambda e: float(e["ts"]),
    )
    if fleet_events:
        def count(name):
            return sum(1 for e in fleet_events if e["event"] == name)

        restarts = count("serve-replica-restart")
        stats["serve_replica_restarts"] = float(restarts)
        stats["serve_replica_spawns"] = float(count("serve-replica-spawn"))
        stats["serve_replica_drains"] = float(count("serve-replica-drain"))
        lines.append(
            f"  fleet timeline: restarts={restarts} "
            f"spawns={int(stats['serve_replica_spawns'])} "
            f"drains={int(stats['serve_replica_drains'])} "
            f"dead={count('serve-replica-dead')} "
            f"hung={count('serve-replica-hung')} "
            f"gave_up={count('serve-replica-give-up')}"
        )
        # per-host attribution (host mode): where the deaths and
        # relaunches actually happened — a whole-host failure reads as
        # one host absorbing every dead/restart while the others stay
        # clean
        by_host: dict = {}
        for e in fleet_events:
            if e.get("host") is not None:
                by_host.setdefault(int(e["host"]), []).append(e["event"])
        if by_host:
            lines.append("  fleet timeline by host: " + "; ".join(
                f"host {h}: "
                f"ready={by_host[h].count('serve-replica-ready')} "
                f"dead={by_host[h].count('serve-replica-dead')} "
                f"restarts={by_host[h].count('serve-replica-restart')}"
                for h in sorted(by_host)
            ))
        t0 = float(fleet_events[0]["ts"])
        shown = fleet_events[:30]
        for e in shown:
            what = e["event"][len("serve-replica-"):]
            who = e.get("replica")
            detail = " ".join(
                f"{k}={e[k]}" for k in (
                    "host", "rc", "attempt", "budget", "backoff_s",
                    "recovered", "redispatch", "redispatched", "stranded",
                    "attempts", "hb_age_s", "loop_age_s", "restarts",
                )
                if e.get(k) is not None
            )
            lines.append(
                f"    +{float(e['ts']) - t0:7.3f}s "
                + (f"replica {who}" if who is not None else "fleet")
                + f" {what}" + (f" ({detail})" if detail else "")
            )
        if len(fleet_events) > len(shown):
            lines.append(
                f"    ... {len(fleet_events) - len(shown)} more event(s)"
            )
    if ttfts:
        stats["serve_ttft_p50_s"] = percentile(ttfts, 50)
        stats["serve_ttft_p99_s"] = percentile(ttfts, 99)
        lines.append(
            f"  ttft: p50={_fmt_s(stats['serve_ttft_p50_s'])} "
            f"p99={_fmt_s(stats['serve_ttft_p99_s'])} "
            f"max={_fmt_s(max(ttfts))} (n={len(ttfts)})"
        )
    if reqs:
        itls = sorted(
            float(e["itl_mean_s"]) for e in reqs
            if e.get("itl_mean_s") is not None
        )
        if itls:
            lines.append(
                f"  itl (per-request mean): p50={_fmt_s(percentile(itls, 50))} "
                f"p99={_fmt_s(percentile(itls, 99))}"
            )
        preempted = sum(1 for e in reqs if int(e.get("preemptions", 0)) > 0)
        if preempted:
            lines.append(
                f"  preempted-and-resumed: {preempted} of {len(reqs)} "
                "request(s)"
            )
    # distributed-trace summary (docs/OBSERVABILITY.md "Tracing"): one
    # line when the run stamped traces — coverage plus the phase that
    # dominates the most traces' critical paths, pointing at
    # ``obs trace`` for the full timelines. Absent when no request
    # carries a trace, so pre-tracing run dirs (and the committed
    # golden reports) stay byte-identical.
    if any("trace" in e for e in reqs):
        from .trace import PHASES, analyze  # local: trace imports report

        t = analyze(data)
        cov = t["coverage"]
        if cov is not None:
            stats["serve_trace_coverage"] = cov
        counts = t["critical_path_counts"]
        top = max(PHASES, key=lambda p: (counts.get(p, 0),
                                         -PHASES.index(p)))
        lines.append(
            f"  traces: {t['traces']} reconstructed, coverage "
            + (f"{cov:.1%}" if cov is not None else "n/a")
            + f", top critical-path phase: {top} "
            f"({counts.get(top, 0)} trace(s)) — see `obs trace`"
        )
    # tick-time attribution: where the engine's device time actually went
    # (serve.prefill_chunk = chunked prefill, serve.prefill = whole-prompt
    # buckets, serve.decode = the per-tick decode step). This is the rail
    # a prefill/decode-mix perf claim is judged on — a chunking change
    # that quietly starves decode shows up here, not in averages.
    phases = (
        ("mixed", "serve.mixed"),
        ("decode", "serve.decode"),
        ("prefill-chunk", "serve.prefill_chunk"),
        ("prefill", "serve.prefill"),
        ("draft", "serve.draft"),
    )
    sums: Dict[str, Tuple[float, int]] = {}
    for sp in data.spans:
        for label, name in phases:
            if sp.get("span") == name and sp.get("dur_s") is not None:
                total, count = sums.get(label, (0.0, 0))
                sums[label] = (total + float(sp["dur_s"]), count + 1)
    if sums:
        grand = sum(t for t, _ in sums.values())
        parts = []
        for label, _ in phases:
            if label not in sums:
                continue
            t, count = sums[label]
            share = t / grand if grand > 0 else 0.0
            stats[f"serve_{label.replace('-', '_')}_s"] = t
            parts.append(f"{label} {share:.0%} ({t:.3f}s/{count})")
        lines.append("  tick time: " + "  ".join(parts))
    return lines, stats


def world_size_transitions(data: RunData) -> List[str]:
    """World-size transitions of an elastic run, as ``old->new`` labels:
    supervisor ``downsize`` / ``upsize`` events (the replan decisions,
    both directions) and trainer ``ckpt-reshard`` events (a restore that
    actually crossed mesh shapes). Deduplicated consecutively — N hosts
    restoring the same transition is one transition."""
    out: List[str] = []
    for e in data.lifecycle:
        if e.get("event") in ("downsize", "upsize"):
            label = (f"{e.get('old_world', '?')}->{e.get('new_world', '?')}"
                     f" ({e['event']}/{e.get('source', '?')})")
        elif e.get("event") == "ckpt-reshard":
            label = (f"{e.get('saved_world', '?')}->"
                     f"{e.get('restoring_world', '?')} (reshard "
                     f"{e.get('saved', '?')} -> {e.get('restoring', '?')})")
        else:
            continue
        if not out or out[-1] != label:
            out.append(label)
    return out


def timeline_section(data: RunData) -> List[str]:
    lines = ["== restart / preemption timeline =="]
    lifecycle = data.lifecycle
    if not lifecycle:
        lines.append("  (no lifecycle events)")
        return lines
    t0 = lifecycle[0].get("ts", 0.0)
    for e in lifecycle:
        fields = {
            k: v for k, v in sorted(e.items()) if k not in ("event", "ts")
        }
        rendered = " ".join(f"{k}={v}" for k, v in fields.items())
        offset = e.get("ts", t0) - t0
        lines.append(f"  +{offset:8.1f}s {e['event']}" +
                     (f" {rendered}" if rendered else ""))
    restarts = sum(1 for e in lifecycle if e["event"] == "relaunch")
    preempts = sum(
        1 for e in lifecycle
        if e["event"] in ("preempt-broadcast", "preempt-relay")
    )
    stalls = sum(1 for e in lifecycle if e["event"] == "step-stall")
    downsizes = sum(1 for e in lifecycle if e["event"] == "downsize")
    upsizes = sum(1 for e in lifecycle if e["event"] == "upsize")
    totals = (
        f"  totals: restarts={restarts} preemptions={preempts} "
        f"stalls={stalls}"
    )
    if downsizes:
        # appended only for elastic runs so committed golden reports
        # from non-elastic runs stay byte-identical
        totals += f" downsizes={downsizes}"
    if upsizes:
        totals += f" upsizes={upsizes}"
    lines.append(totals)
    transitions = world_size_transitions(data)
    if transitions:
        lines.append("  world-size transitions: " + ", ".join(transitions))
    return lines


def render_report(data: RunData, run_dir: Path | str = "") -> str:
    hosts = sorted(
        {int(r.get("host", 0)) for r in data.steps}
        | {int(e["host"]) for e in data.events if isinstance(e.get("host"), int)}
    )
    steps = [r.get("step", 0) for r in data.steps]
    header = [
        "== run summary ==",
        f"  dir: {run_dir}",
        f"  files={data.files} events={len(data.events)} "
        f"step_records={len(data.steps)} registry_records={len(data.registry)} "
        f"unparseable_lines={data.bad_lines}",
        f"  hosts: {', '.join(map(str, hosts)) if hosts else '(none)'}",
        f"  steps: {min(steps)}..{max(steps)}" if steps else "  steps: (none)",
    ]
    mfu_lines, _ = mfu_section(data)
    tuner_lines, _ = tuner_section(data)
    serving_lines, _ = serving_section(data)
    sections = [
        header,
        step_time_section(data),
        mfu_lines,
        pipeline_section(data),  # empty (omitted) for non-pipelined runs
        tuner_lines,  # empty (omitted) for untuned runs
        serving_lines,  # empty (omitted) for non-serving runs
        barrier_section(data),
        checkpoint_section(data),
        timeline_section(data),
    ]
    return "\n".join("\n".join(s) for s in sections if s) + "\n"


def check_gates(data: RunData, assert_mfu: Optional[float] = None,
                assert_step_time: Optional[float] = None,
                assert_tuner_calibration: Optional[float] = None,
                tuner_stats: Optional[Dict[str, float]] = None,
                assert_serve_throughput: Optional[float] = None,
                assert_ttft: Optional[float] = None,
                assert_spec_accept_rate: Optional[float] = None,
                assert_max_downsizes: Optional[int] = None,
                assert_max_resizes: Optional[int] = None,
                assert_max_shed_rate: Optional[float] = None,
                assert_max_serve_timeouts: Optional[int] = None,
                assert_max_replica_skew: Optional[float] = None,
                assert_max_replica_restarts: Optional[int] = None
                ) -> List[str]:
    """CI-style regression gates; returns failure messages (empty ==
    pass). Missing data FAILS a requested gate — a run that recorded no
    MFU must not pass an MFU floor by silence. ``tuner_stats`` lets a
    caller that already rendered the tuner section pass its stats in
    instead of re-aggregating the spans."""
    _, stats = mfu_section(data)
    failures: List[str] = []
    serving_gates = (assert_serve_throughput is not None
                     or assert_ttft is not None
                     or assert_spec_accept_rate is not None
                     or assert_max_shed_rate is not None
                     or assert_max_serve_timeouts is not None
                     or assert_max_replica_skew is not None
                     or assert_max_replica_restarts is not None)
    if serving_gates:
        _, sstats = serving_section(data)
        if assert_max_shed_rate is not None:
            rate = sstats.get("serve_shed_rate")
            if rate is None:
                failures.append(
                    "assert-max-shed-rate: no shed telemetry in the run "
                    "dir (serve-summary carries no requests_shed — "
                    "pre-resilience bench, or no summary at all?)"
                )
            elif rate > assert_max_shed_rate:
                failures.append(
                    f"assert-max-shed-rate: shed rate {rate:.3f} > "
                    f"ceiling {assert_max_shed_rate:.3f}"
                )
        if assert_max_serve_timeouts is not None:
            timeouts = sstats.get("serve_timeouts")
            if timeouts is None:
                failures.append(
                    "assert-max-serve-timeouts: no timeout telemetry in "
                    "the run dir (serve-summary carries no "
                    "requests_timeout)"
                )
            elif timeouts > assert_max_serve_timeouts:
                failures.append(
                    f"assert-max-serve-timeouts: {int(timeouts)} "
                    f"deadline timeout(s) > ceiling "
                    f"{assert_max_serve_timeouts}"
                )
        if assert_max_replica_skew is not None:
            skew = sstats.get("serve_replica_skew")
            if skew is None:
                failures.append(
                    "assert-max-replica-skew: no fleet telemetry in the "
                    "run dir (serve-summary carries no replica_stats — "
                    "single-engine bench, or no summary at all?)"
                )
            elif skew > assert_max_replica_skew:
                failures.append(
                    f"assert-max-replica-skew: completed-request skew "
                    f"{'inf' if math.isinf(skew) else format(skew, '.2f')}"
                    f" > ceiling {assert_max_replica_skew:.2f} (a replica "
                    "is starved or dead — check the router rows)"
                )
        if assert_max_replica_restarts is not None:
            restarts = sstats.get("serve_replica_restarts")
            if restarts is None:
                failures.append(
                    "assert-max-replica-restarts: no fleet supervision "
                    "telemetry in the run dir (no serve-replica-* "
                    "lifecycle events — was the bench run with "
                    "--replicas-proc?)"
                )
            elif restarts > assert_max_replica_restarts:
                failures.append(
                    f"assert-max-replica-restarts: {int(restarts)} "
                    f"supervised relaunch(es) > ceiling "
                    f"{assert_max_replica_restarts} (replicas are "
                    "crash-looping — check the fleet timeline)"
                )
            missing = sstats.get("serve_hosts_missing")
            if missing:
                # a planned host with no rendezvous record is a silent
                # capacity loss no restart count would surface
                failures.append(
                    f"assert-max-replica-restarts: {int(missing)} "
                    f"planned host(s) never rendezvoused (of "
                    f"{int(sstats.get('serve_fleet_hosts', 0))} in the "
                    "placement plan) — the fleet ran without them; "
                    "check the hosts line and ssh reachability"
                )
        if assert_spec_accept_rate is not None:
            rate = sstats.get("serve_spec_accept_rate")
            if rate is None:
                failures.append(
                    "assert-spec-accept-rate: no speculative-decoding "
                    "telemetry in the run dir (serve-summary carries no "
                    "spec_accept_rate — was the bench run with --spec-k?)"
                )
            elif rate < assert_spec_accept_rate:
                failures.append(
                    f"assert-spec-accept-rate: accept rate {rate:.3f} "
                    f"< floor {assert_spec_accept_rate:.3f}"
                )
        if assert_serve_throughput is not None:
            tps = sstats.get("serve_tokens_per_s")
            if tps is None:
                has_serve_events = any(
                    e.get("event") in ("serve-request", "serve-summary")
                    for e in data.lifecycle
                )
                failures.append(
                    "assert-serve-throughput: "
                    + ("no serve-summary and too few serve-request events "
                       "to derive a rate (crashed/short run?)"
                       if has_serve_events else
                       "no serving telemetry in the run dir (no "
                       "serve-summary / serve-request events)")
                )
            elif tps < assert_serve_throughput:
                failures.append(
                    f"assert-serve-throughput: {tps:.1f} output tokens/s "
                    f"< floor {assert_serve_throughput:.1f}"
                )
        if assert_ttft is not None:
            p99 = sstats.get("serve_ttft_p99_s")
            if p99 is None:
                failures.append(
                    "assert-ttft: no per-request TTFT samples in the run "
                    "dir (no serve-request events)"
                )
            elif p99 > assert_ttft:
                failures.append(
                    f"assert-ttft: p99 TTFT {p99:.4f}s > ceiling "
                    f"{assert_ttft:.4f}s"
                )
    if assert_tuner_calibration is not None:
        tstats = (
            tuner_stats if tuner_stats is not None
            else tuner_section(data)[1]
        )
        err = tstats.get("tuner_calibration_error")
        if err is None or not math.isfinite(err):
            failures.append(
                "assert-tuner-calibration: no tuner prediction + measured "
                "step time pair in the run dir"
            )
        elif abs(err) > assert_tuner_calibration:
            failures.append(
                f"assert-tuner-calibration: |calibration error| "
                f"{abs(err):.3f} > ceiling {assert_tuner_calibration:.3f} "
                f"(predicted {tstats['tuner_predicted_step_s']:.3f}s vs "
                f"measured {tstats['tuner_measured_step_s']:.3f}s)"
            )
    if assert_max_resizes is not None or assert_max_downsizes is not None:
        # one resize gate, both directions: ``--assert-max-downsizes``
        # predates elastic upsizing and is kept as an alias with the
        # same (resize-counting) semantics — a flapping host that
        # churns the pod up AND down must not pass a downsize-only
        # ceiling on a technicality. Tightest requested ceiling wins.
        flag = ("assert-max-resizes" if assert_max_resizes is not None
                else "assert-max-downsizes")
        ceiling = min(
            c for c in (assert_max_resizes, assert_max_downsizes)
            if c is not None
        )
        # the gate only means something for a SUPERVISED run: without
        # supervisor lifecycle events the absence of resize events is
        # silence, not health — missing data fails, like every gate
        supervised = any(
            e.get("event") == "epoch-start" for e in data.lifecycle
        )
        resizes = sum(
            1 for e in data.lifecycle
            if e.get("event") in ("downsize", "upsize")
        )
        if not supervised:
            failures.append(
                f"{flag}: no supervisor telemetry in the run "
                "dir (no epoch-start events — was the run launched with "
                "runner.supervise?)"
            )
        elif resizes > ceiling:
            failures.append(
                f"{flag}: {resizes} resize(s) > ceiling "
                f"{ceiling} (world-size transitions: "
                f"{', '.join(world_size_transitions(data)) or 'none'})"
            )
    if assert_mfu is not None:
        mean = stats.get("mfu_mean")
        if mean is None:
            failures.append("assert-mfu: no MFU samples in the run dir")
        elif mean < assert_mfu:
            failures.append(
                f"assert-mfu: mean MFU {mean:.4f} < floor {assert_mfu:.4f}"
            )
    if assert_step_time is not None:
        p50 = stats.get("step_time_p50")
        if p50 is None:
            failures.append(
                "assert-step-time: no step_duration samples in the run dir"
            )
        elif p50 > assert_step_time:
            failures.append(
                f"assert-step-time: p50 step time {p50:.3f}s > ceiling "
                f"{assert_step_time:.3f}s"
            )
    return failures
