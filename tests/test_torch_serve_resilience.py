"""The port's serving resilience against the JAX package's: the request
journal (the same kinds and fields for the same calls, each package's
``replay_journal`` reading the other's journal, the torn tail), the fault
points firing at the same records and calls, deadline expiry and
shedding statuses equal to the JAX engine's on one trace under one
clock, and the toy bench in child processes on the CPU: a crash replayed
by ``--restarts`` to a fault-free run's tokens, a wedged tick killed by
the watchdog and recovered, and SIGTERM drains, direct and relayed by
the supervisor."""

import json
import os
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import scaling_tpu.serve.engine as jax_engine_module  # noqa: E402
from scaling_tpu.ops.rms_norm import force_rms_interpret  # noqa: E402
from scaling_tpu.resilience import faults as jax_faults  # noqa: E402
from scaling_tpu.serve import journal as jax_journal  # noqa: E402
from scaling_tpu.serve.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from scaling_tpu.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from scaling_tpu.serve.scheduler import Request as JaxRequest  # noqa: E402
import scaling_tpu_torch.serve.engine as port_engine_module  # noqa: E402
from scaling_tpu_torch.resilience import faults as port_faults  # noqa: E402
from scaling_tpu_torch.serve import journal as port_journal  # noqa: E402
from scaling_tpu_torch.serve import Backpressure, EngineConfig, ServeEngine  # noqa: E402
from scaling_tpu_torch.serve.scheduler import Request  # noqa: E402

from .test_torch_parity_helpers import inference_pair  # noqa: E402
from .test_torch_serve import ARCH, ENGINE, workload  # noqa: E402
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
PACKAGES = {"jax": (jax_journal, jax_faults), "port": (port_journal, port_faults)}


@pytest.fixture(scope="module")
def models():
    return inference_pair(ARCH, seed=0)


@pytest.fixture(autouse=True)
def clean_fault_plans():
    for _, faults in PACKAGES.values():
        faults.set_fault_plan(faults.FaultPlan(""))
    yield
    for _, faults in PACKAGES.values():
        faults.set_fault_plan(None)


def journal_calls(journal, request_cls):
    """One of each record, as an engine writes them."""
    req = request_cls(req_id=3, prompt=[5, 6, 7], max_new_tokens=4, eos_token_id=2,
                      temperature=0.5, top_k=8, top_p=0.9, deadline_ms=50.0,
                      ttft_deadline_ms=None, trace_id="abc")
    journal.record_submit(req)
    journal.record_tokens(3, [9])
    journal.record_tokens_batch({3: [10, 11], 1: [4], 2: []})
    journal.record_shed("queue-depth")
    journal.record_finish(3, "completed", tokens=[12])
    journal.record_finish(1, "timeout")


def test_journal_lines_equal_jax_for_the_same_calls(tmp_path):
    texts = {}
    for name, request_cls in (("jax", JaxRequest), ("port", Request)):
        module, _ = PACKAGES[name]
        journal_calls(module.RequestJournal(tmp_path / name / "journal.jsonl"), request_cls)
        texts[name] = (tmp_path / name / "journal.jsonl").read_text()
    assert texts["port"] == texts["jax"]
    kinds = [json.loads(line)["kind"] for line in texts["port"].splitlines()]
    assert kinds == ["serve-submit", "serve-tokens", "serve-tokens", "serve-tokens",
                     "serve-shed", "serve-tokens", "serve-finish", "serve-finish"]


def replay_fields(replay):
    return (replay.submits, replay.tokens, replay.status, replay.shed_count,
            replay.bad_lines, replay.offered_count, replay.next_req_id,
            replay.completed, [r["req"] for r in replay.incomplete], replay.timeout_count)


def run_engine(engine, work, journal):
    engine.attach_journal(journal)
    for prompt, n in work:
        engine.submit(prompt, n)
    done = engine.run_until_done()
    return {s.request.req_id: list(s.generated) for s in done}


def test_each_package_replays_the_others_journal(models, tmp_path):
    """A journal written by either engine (temperature 0) reads the same
    through both packages' ``replay_journal``, and its completed tokens are
    the engines' outputs; with a torn tail too."""
    jax_inf, port_inf = models
    work = workload()
    port_path, jax_path = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    port_tokens = run_engine(ServeEngine(port_inf, EngineConfig(**ENGINE), device="cpu"),
                             work, port_journal.RequestJournal(port_path))
    with force_rms_interpret():
        jax_tokens = run_engine(JaxEngine(jax_inf, JaxEngineConfig(**ENGINE)), work,
                                jax_journal.RequestJournal(jax_path))
    assert port_tokens == jax_tokens
    assert port_path.read_text() == jax_path.read_text()
    for path in (port_path, jax_path):
        ours, theirs = port_journal.replay_journal(path), jax_journal.replay_journal(path)
        assert replay_fields(ours) == replay_fields(theirs)
        assert ours.completed == port_tokens and not ours.incomplete
    # a SIGKILL mid-append: the torn tail is one bad line, the rest intact
    with open(port_path, "a") as f:
        f.write('{"kind": "serve-tokens", "req": 0, "to')
    ours, theirs = port_journal.replay_journal(port_path), jax_journal.replay_journal(port_path)
    assert ours.bad_lines == theirs.bad_lines == 1
    assert replay_fields(ours) == replay_fields(theirs) and ours.completed == port_tokens


def test_fault_points_fire_at_the_same_records(models, tmp_path):
    """``serve.journal=fail@N`` stops both engines at the same record (the
    same journal bytes before it), and over a whole run ``serve.tick``,
    ``serve.admit``, ``serve.pool`` and ``serve.journal`` are hit as often
    in the port as in the JAX engine."""
    jax_inf, port_inf = models
    work = workload()
    engines = {
        "jax": lambda: JaxEngine(jax_inf, JaxEngineConfig(**ENGINE)),
        "port": lambda: ServeEngine(port_inf, EngineConfig(**ENGINE), device="cpu"),
    }
    texts, hits = {}, {}
    for name, make in engines.items():
        module, faults = PACKAGES[name]
        faults.set_fault_plan(faults.FaultPlan("serve.journal=fail@9"))
        path = tmp_path / f"{name}_fail.jsonl"
        with force_rms_interpret(), pytest.raises(faults.InjectedFault):
            run_engine(make(), work, module.RequestJournal(path))
        texts[name] = path.read_text()
        plan = faults.FaultPlan("")
        faults.set_fault_plan(plan)
        with force_rms_interpret():
            run_engine(make(), work, module.RequestJournal(tmp_path / f"{name}.jsonl"))
        hits[name] = {p: plan.hits(p) for p in ("serve.tick", "serve.admit", "serve.pool",
                                                "serve.journal")}
    assert texts["port"] == texts["jax"] and len(texts["port"].splitlines()) >= 8
    assert hits["port"] == hits["jax"] and min(hits["port"].values()) > 0


class Clock:
    """``time.monotonic`` of both engine modules: it moves only when told."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


def test_deadline_and_shed_statuses_equal_jax(models, monkeypatch):
    """One trace under one clock that advances 10 ms a tick: the same
    submissions shed (the queue cap, then pool pressure with its
    hysteresis), the same requests timed out (total and first-token
    deadlines) and the rest completed with the JAX engine's tokens."""
    jax_inf, port_inf = models
    rng = np.random.default_rng(7)
    trace = [(tick, rng.integers(1, 128, size=int(rng.integers(4, 30))).tolist(),
              int(rng.integers(3, 12)), float(rng.choice([np.nan, 40.0, 120.0])),
              float(rng.choice([np.nan, 30.0])))
             for tick in range(0, 40, 2) for _ in range(int(rng.integers(1, 4)))]
    cfg = dict(ENGINE, num_slots=3, num_blocks=20, max_waiting=4, shed_high_watermark=0.8,
               shed_low_watermark=0.5)
    out = {}
    for name, module, make in (
            ("jax", jax_engine_module, lambda: JaxEngine(jax_inf, JaxEngineConfig(**cfg))),
            ("port", port_engine_module,
             lambda: ServeEngine(port_inf, EngineConfig(**cfg), device="cpu"))):
        clock = Clock()
        monkeypatch.setattr(module, "time", types.SimpleNamespace(monotonic=clock.monotonic))
        engine, shed = make(), []
        with force_rms_interpret():
            for tick in range(200):
                for i, (at, prompt, n, deadline, ttft) in enumerate(trace):
                    if at == tick:
                        res = engine.submit(prompt, n, arrival_s=clock.now,
                                            deadline_ms=None if np.isnan(deadline) else deadline,
                                            ttft_deadline_ms=None if np.isnan(ttft) else ttft)
                        if not hasattr(res, "request"):
                            shed.append((i, res.reason, res.pool_pressure, res.waiting))
                if tick > 40 and not engine.scheduler.has_work:
                    break
                engine.tick()
                clock.now += 0.010
        out[name] = (shed, {s.request.req_id: (s.finish_status, list(s.generated))
                            for s in engine.finished},
                     engine.shed_count, engine.timeout_count)
    assert out["port"] == out["jax"]
    shed, finished, shed_count, timeouts = out["port"]
    statuses = [status for status, _ in finished.values()]
    assert shed_count == len(shed) > 0 and timeouts > 0 and "completed" in statuses
    assert {reason for _, reason, _, _ in shed} == {"queue-depth", "pool-pressure"}
    assert len(shed) + len(finished) == len(trace)


def test_drain_refuses_new_work_and_finishes_what_runs(models):
    _, port_inf = models
    engine = ServeEngine(port_inf, EngineConfig(**ENGINE), device="cpu")
    first = engine.submit([1, 2, 3, 4], 5)
    engine.tick()
    engine.begin_drain()
    bp = engine.submit([5, 6, 7], 3)
    assert isinstance(bp, Backpressure) and bp.draining and bp.reason == "draining"
    assert engine.shed_count == 0  # shutdown, not overload
    engine.run_until_done()
    assert first.finish_status == "completed" and len(first.generated) == 5
    forced = engine.submit([5, 6, 7], 3, force=True)  # replayed recovery work
    engine.run_until_done()
    assert forced.finish_status == "completed"


def test_drain_handler_chains_the_handler_before_it(models):
    from scaling_tpu_torch.serve import install_drain_handler

    seen = []
    prev = signal.signal(signal.SIGTERM, lambda signum, frame: seen.append(signum))
    try:
        engine = ServeEngine(models[1], EngineConfig(**ENGINE), device="cpu")
        install_drain_handler(engine)
        os.kill(os.getpid(), signal.SIGTERM)
        assert engine.draining and seen == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_bench_puts_the_sigterm_handler_back(tmp_path):
    """An in-process bench drains on SIGTERM while it runs and leaves the
    handler it found: its own would hold its engine (and the model) for
    the life of the process."""
    from scaling_tpu_torch.serve.bench import main

    def before(signum, frame):
        pass

    prev = signal.signal(signal.SIGTERM, before)
    try:
        assert main(["--device", "cpu", "--model", "toy", "--requests", "2", "--rate", "100",
                     "--prompt-len", "3", "6", "--output-len", "2", "3", "--num-slots", "2",
                     "--block-size", "4", "--num-blocks", "16", "--max-blocks-per-seq", "8",
                     "--run-dir", str(tmp_path)]) == 0
        assert signal.getsignal(signal.SIGTERM) is before
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_replica_id_labels_the_serving_series_as_in_jax(models, tmp_path, monkeypatch):
    """``replica_id``: a ``replica`` field on the serve-request events and a
    ``replica`` label on the registry's serving series, the same series as
    the JAX engine's for the same run."""
    from scaling_tpu.obs import get_registry as jax_registry
    from scaling_tpu_torch.obs import get_registry as port_registry

    jax_inf, port_inf = models
    monkeypatch.setenv("SCALING_TPU_EVENTS_PATH", str(tmp_path / "events.jsonl"))
    series = {}
    for name, registry, make in (
            ("jax", jax_registry, lambda: JaxEngine(jax_inf, JaxEngineConfig(
                **ENGINE, replica_id=1))),
            ("port", port_registry, lambda: ServeEngine(port_inf, EngineConfig(
                **ENGINE, replica_id=1), device="cpu"))):
        registry().reset()
        with force_rms_interpret():
            engine = make()
            engine.submit([1, 2, 3, 4, 5], 3)
            engine.run_until_done()
        snapshot = registry().snapshot()
        series[name] = {kind: sorted(k for k in snapshot[kind] if k.startswith("serve_"))
                        for kind in ("counters", "gauges")}
    assert series["port"] == series["jax"]
    counters = series["port"]["counters"]
    assert counters and all(k.endswith("{replica=1}") for k in counters)
    requests = [json.loads(line) for line in (tmp_path / "events.jsonl").read_text().splitlines()
                if '"serve-request"' in line]
    assert [e["replica"] for e in requests] == [1, 1]


def test_spec_k_sweep_reports_every_arm(tmp_path):
    """``--spec-k-sweep 0,2``: the workload once per k on a fresh engine and
    a final summary carrying both arms and the best."""
    from scaling_tpu_torch.serve.bench import main

    assert main(["--device", "cpu", "--model", "toy", "--requests", "3", "--rate", "100",
                 "--prompt-len", "4", "8", "--output-len", "4", "6", "--num-slots", "2",
                 "--block-size", "4", "--num-blocks", "32", "--max-blocks-per-seq", "8",
                 "--spec-k-sweep", "0,2", "--json", str(tmp_path / "stats.json")]) == 0
    stats = json.loads((tmp_path / "stats.json").read_text())
    assert [arm["spec_k"] for arm in stats["spec_k_sweep"]] == [0, 2]
    assert stats["spec_k_best"] in (0, 2) and stats["requests"] == 3


# ------------------------------------------------- the bench, child processes
BENCH = ["--device", "cpu", "--model", "toy", "--requests", "10", "--rate", "40",
         "--prompt-len", "4", "24", "--output-len", "6", "14", "--num-slots", "4",
         "--block-size", "4", "--num-blocks", "96", "--max-blocks-per-seq", "16",
         "--prefill-chunk", "8", "--warmup", "0"]  # the faults count measured ticks


def bench_env(faults=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("SCALING_TPU_FAULTS", "SCALING_TPU_EVENTS_PATH",
                        "SCALING_TPU_METRICS_PATH")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    if faults:
        env["SCALING_TPU_FAULTS"] = faults
    return env


def bench_cmd(run_dir, *extra):
    return [sys.executable, "-m", "scaling_tpu_torch.serve", "bench", *BENCH,
            "--run-dir", str(run_dir), "--json", str(run_dir / "stats.json"), *extra]


def start_bench_process(run_dir, *extra, faults=None):
    """The bench in a session of its own, so that ``reap`` also ends the
    children a supervised bench leaves when it is killed."""
    return subprocess.Popen(bench_cmd(run_dir, *extra), cwd=REPO, env=bench_env(faults),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def reap(proc):
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def run_bench_process(run_dir, *extra, faults=None):
    proc = start_bench_process(run_dir, *extra, faults=faults)
    try:
        _, err = proc.communicate(timeout=240)
    finally:
        reap(proc)
    assert proc.returncode == 0, err[-3000:]
    return json.loads((run_dir / "stats.json").read_text())


def events(run_dir):
    return [json.loads(line) for line in (run_dir / "events.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def fault_free(tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("fault_free")
    stats = run_bench_process(run_dir)
    return stats, port_journal.replay_journal(run_dir / "journal.jsonl")


def test_crash_replay_gives_the_fault_free_tokens(fault_free, tmp_path):
    """``serve.tick=kill@6`` SIGKILLs the first child mid-run; the
    supervisor relaunches it with ``--resume``: exit 0, every offered
    request completed once, and the same tokens as a run without the
    fault."""
    stats = run_bench_process(tmp_path, "--restarts", "2", faults="serve.tick=kill@6")
    replay = port_journal.replay_journal(tmp_path / "journal.jsonl")
    gold = fault_free[1]
    assert replay.offered_count == 10 and not replay.incomplete
    assert replay.completed == gold.completed and len(gold.completed) == 10
    assert stats["resumed"] and stats["requests"] == 10 and stats["offered"] == 10
    restarts = [e for e in events(tmp_path) if e["event"] == "serve-restart"]
    assert [(e["attempt"], e["rc"]) for e in restarts] == [(1, -signal.SIGKILL)]


def test_wedged_tick_is_killed_and_recovered(fault_free, tmp_path):
    """``serve.tick=hang@6`` wedges the first child's tick; the watchdog
    (10 s) logs ``serve-stall`` and SIGKILLs it, and the relaunch completes
    every request with the fault-free tokens."""
    run_bench_process(tmp_path, "--restarts", "1", "--tick-timeout-s", "10",
                      faults="serve.tick=hang@6")
    names = [e["event"] for e in events(tmp_path)]
    assert "serve-stall" in names
    restart = next(e for e in events(tmp_path) if e["event"] == "serve-restart")
    assert restart["rc"] == -signal.SIGKILL
    replay = port_journal.replay_journal(tmp_path / "journal.jsonl")
    assert replay.completed == fault_free[1].completed and not replay.incomplete


@pytest.mark.parametrize("supervised", [False, True], ids=["direct", "supervisor"])
def test_sigterm_drains_and_exits_zero(tmp_path, supervised):
    """SIGTERM once a request has been served (to the bench, or to its
    supervisor, which relays it): exit 0, ``drained``, some of the workload
    left unsubmitted, and every submitted request ended in the journal."""
    extra = ["--rate", "4", "--restarts", "1"] if supervised else ["--rate", "4"]
    proc = start_bench_process(tmp_path, *extra)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            path = tmp_path / "events.jsonl"
            if path.is_file() and '"serve-request"' in path.read_text():
                break
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    finally:
        reap(proc)
    assert proc.returncode == 0, err[-3000:]
    stats = json.loads((tmp_path / "stats.json").read_text())
    assert stats["drained"] and stats["unsubmitted"] > 0
    replay = port_journal.replay_journal(tmp_path / "journal.jsonl")
    assert not replay.incomplete and replay.offered_count == 10 - stats["unsubmitted"]
    assert "serve-drain" in [e["event"] for e in events(tmp_path)]
