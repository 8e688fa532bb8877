"""The serving fleet end to end on the CPU, held against the JAX package
and against one engine:

- the launch counters stay exact when threads update them together;
- two JAX engines and two port engines on the same weights behind each
  package's ``FleetRouter``: the same replica for every request and the
  same greedy tokens (all submitted, then ticked in turn, no threads);
- ``serve bench --replicas 2``: both replicas serve, the tokens are the
  single engine's on the same workload, ``obs report
  --assert-max-replica-skew`` passes, and a SIGTERM drains to exit 0;
- ``serve bench --replicas-proc 2``: a replica SIGKILLed mid-stream
  (``serve.replica.kill=kill@3@host=1``) fails over to the survivor and
  relaunches, and every request ends once with a fault-free run's tokens;
  the fleet timeline and the restart gate in ``obs report``; a SIGTERM
  drains both workers to exit 0; ``--autoscale`` grows and shrinks it;
- the flags whose paths are not ported fail by name.

The tests hold tokens and counts, never a ratio of tokens/s."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import scaling_tpu.serve.router as jax_router  # noqa: E402
from scaling_tpu.ops.rms_norm import force_rms_interpret  # noqa: E402
from scaling_tpu.serve.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from scaling_tpu.serve.engine import ServeEngine as JaxEngine  # noqa: E402
import scaling_tpu_torch.serve.router as port_router  # noqa: E402
from scaling_tpu_torch.ops import launches  # noqa: E402
from scaling_tpu_torch.serve import EngineConfig, ServeEngine  # noqa: E402
from scaling_tpu_torch.serve.journal import replay_journal  # noqa: E402

from .test_torch_parity_helpers import inference_pair  # noqa: E402
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401
from .test_torch_serve import ARCH, ENGINE  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def test_launch_counters_are_exact_under_threads():
    """Sixteen threads (more than the cores) add to KERNEL and PLAIN at once
    under a shortened switch interval: no count is lost, and each thread's
    ``tally`` holds its own launches only."""
    launches.reset()
    n, per = 16, 5000
    tallies = {}
    start = threading.Barrier(n)

    def hammer(i):
        with launches.tally() as t:
            start.wait()
            for _ in range(per):
                launches.add(launches.KERNEL, "paged_attention")
                launches.add(launches.PLAIN, "rms_norm")
                launches.add(launches.WIDTHS, ("paged_attention", 1))
            tallies[i] = t

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and len(tallies) == n
    assert launches.snapshot(launches.KERNEL) == {"paged_attention": n * per}
    assert launches.snapshot(launches.PLAIN) == {"rms_norm": n * per}
    assert launches.snapshot(launches.WIDTHS) == {("paged_attention", 1): n * per}
    assert all(t["kernel"] == {"paged_attention": per} and t["plain"] == {"rms_norm": per}
               for t in tallies.values())
    launches.reset()


# ------------------------------------------------- in-process parity with JAX
@pytest.mark.parametrize("prefix_len,families", [(0, 1), (8, 1), (8, 3), (0, 2)])
def test_workload_draws_equal_jax(prefix_len, families):
    """``sample_workload`` with prefix families draws the JAX bench's
    arrivals, prompts and budgets."""
    from scaling_tpu.serve.bench import sample_workload as jax_sample
    from scaling_tpu_torch.serve.bench import sample_workload

    args = (20, 64.0, (4, 30), (2, 9), 512, 5)
    ours = sample_workload(*args, shared_prefix_len=prefix_len, prefix_families=families)
    assert ours == jax_sample(*args, shared_prefix_len=prefix_len, prefix_families=families)
    if prefix_len:
        heads = {tuple(p[:prefix_len]) for _, p, _ in ours}
        assert len(heads) == families


def family_workload(seed=2):
    """Nine requests over three shared 8-token prefixes (two full blocks of
    the engine's 4), so the routers' prefix affinity takes part."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(1, 128, size=8).tolist() for _ in range(3)]
    return [(prefixes[i % 3] + rng.integers(1, 128, size=int(rng.integers(3, 12))).tolist(),
             int(rng.integers(4, 9))) for i in range(9)]


def fleet_run(engines, router_mod, work):
    router = router_mod.FleetRouter(engines)
    for prompt, n in work:
        router.submit(prompt, n)
    while any(e.scheduler.has_work for e in engines):
        for e in engines:  # in turn, no threads: deterministic
            if e.scheduler.has_work:
                e.tick()
    out = {s.request.req_id: (r, list(s.generated))
           for r, e in enumerate(engines) for s in e.finished}
    return out, router.stats()


def test_fleet_tokens_and_dispatch_equal_jax(one_torch_thread):
    jax_inf, port_inf = inference_pair(ARCH, seed=0)
    work = family_workload()
    port = fleet_run([ServeEngine(port_inf, EngineConfig(**ENGINE, replica_id=r), device="cpu")
                      for r in range(2)], port_router, work)
    with force_rms_interpret():
        ref = fleet_run([JaxEngine(jax_inf, JaxEngineConfig(**ENGINE, replica_id=r))
                         for r in range(2)], jax_router, work)
    assert port == ref
    tokens, stats = port
    assert sorted(tokens) == list(range(9))
    assert {r for r, _ in tokens.values()} == {0, 1} and stats["affinity_dispatches"] > 0


# ----------------------------------------------------- the bench, children
BENCH = ["--device", "cpu", "--model", "toy", "--prompt-len", "4", "16", "--output-len", "6",
         "12", "--num-slots", "2", "--block-size", "4", "--num-blocks", "96",
         "--max-blocks-per-seq", "16", "--prefill-chunk", "4", "--token-budget", "64"]


def bench_env(faults=None):
    env = {k: v for k, v in os.environ.items() if not k.startswith("SCALING_TPU_")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    if faults:
        env["SCALING_TPU_FAULTS"] = faults
    return env


def start_bench(run_dir, *extra, faults=None):
    """The bench in a session of its own, so ``reap`` ends its workers too."""
    run_dir.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", "scaling_tpu_torch.serve", "bench", *BENCH,
           "--run-dir", str(run_dir), "--json", str(run_dir / "stats.json"), *extra]
    return subprocess.Popen(cmd, cwd=REPO, env=bench_env(faults), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)


def reap(proc):
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def run_bench(run_dir, *extra, faults=None):
    proc = start_bench(run_dir, *extra, faults=faults)
    try:
        out, err = proc.communicate(timeout=240)
    finally:
        reap(proc)
    assert proc.returncode == 0, out[-2000:] + err[-3000:]
    return json.loads((run_dir / "stats.json").read_text()), out


def obs_report(run_dir, *gates):
    return subprocess.run([sys.executable, "-m", "scaling_tpu_torch.obs", "report",
                           str(run_dir), *gates], cwd=REPO, env=bench_env(),
                          capture_output=True, text=True, timeout=120)


def events(run_dir):
    return [json.loads(line) for line in (run_dir / "events.jsonl").read_text().splitlines()]


def sigterm_after_first_request(proc, run_dir):
    deadline = time.monotonic() + 120
    path = run_dir / "events.jsonl"
    while time.monotonic() < deadline:
        if path.is_file() and '"serve-request"' in path.read_text():
            break
        assert proc.poll() is None, proc.communicate()[1][-3000:]
        time.sleep(0.05)
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, out[-2000:] + err[-3000:]
    return json.loads((run_dir / "stats.json").read_text())


THREADED = ["--requests", "10", "--rate", "100000", "--seed", "3",
            "--shared-prefix-len", "8", "--prefix-families", "2"]


def completed_tokens(run_dir, names):
    """Workload index -> tokens. The ids count up from the first measured
    request: the single engine's warm-up request took id 0, the router
    numbers the fleet's from 0."""
    out = {}
    for name in names:
        out.update(replay_journal(run_dir / name).completed)
    return {i: out[r] for i, r in enumerate(sorted(out))}


def test_threaded_fleet_serves_the_single_engines_tokens(tmp_path):
    single, _ = run_bench(tmp_path / "single", *THREADED)
    fleet, out = run_bench(tmp_path / "fleet", *THREADED, "--replicas", "2")
    assert "placement: replica 0 -> cpu, replica 1 -> cpu" in out
    assert fleet["replicas"] == 2 and fleet["requests"] == single["requests"] == 10
    rows = fleet["replica_stats"]
    assert all(r["requests"] > 0 and r["dispatches"] > 0 for r in rows)
    assert fleet["router"]["affinity_dispatches"] > 0
    # each replica's own launches (its tick thread's), the plain versions here
    assert all(r["plain_launches"].get("paged_attention", 0) > 0 for r in rows)
    assert sum(r["plain_launches"]["paged_attention"] for r in rows) == \
        fleet["plain_launches"]["paged_attention"]
    assert fleet["engine"]["replicas"] == 2
    gold = completed_tokens(tmp_path / "single", ["journal.jsonl"])
    got = completed_tokens(tmp_path / "fleet", ["journal_r0.jsonl", "journal_r1.jsonl"])
    assert got == gold and len(gold) == 10
    report = obs_report(tmp_path / "fleet", "--assert-max-replica-skew", "10")
    assert report.returncode == 0, report.stdout[-2000:]
    assert "fleet: replicas=2" in report.stdout


def test_threaded_fleet_drains_on_sigterm(tmp_path):
    proc = start_bench(tmp_path, "--replicas", "2", "--requests", "200", "--rate", "4")
    try:
        stats = sigterm_after_first_request(proc, tmp_path)
    finally:
        reap(proc)
    assert stats["drained"] and stats["unsubmitted"] > 0
    assert (tmp_path / "journal_r0.jsonl").is_file()
    for name in ("journal_r0.jsonl", "journal_r1.jsonl"):
        if (tmp_path / name).is_file():
            assert not replay_journal(tmp_path / name).incomplete


PROC = ["--requests", "8", "--rate", "50", "--seed", "7", "--replicas-proc", "2"]


@pytest.fixture(scope="module")
def chaos_pair(tmp_path_factory):
    """The same seeded workload on a two-process fleet, fault-free and
    with replica 1 SIGKILLed at its third tick with work."""
    tmp = tmp_path_factory.mktemp("proc_fleet")
    clean, _ = run_bench(tmp / "clean", *PROC)
    chaos, out = run_bench(tmp / "chaos", *PROC, faults="serve.replica.kill=kill@3@host=1")
    return tmp, clean, chaos, out


def test_a_killed_replica_fails_over_token_exact(chaos_pair):
    tmp, clean, chaos, out = chaos_pair
    assert clean["replica_restarts"] == 0 and chaos["replica_restarts"] == 1
    assert chaos["redispatched_requests"] + chaos["recovered_requests"] >= 1
    assert chaos["replicas_gave_up"] == 0
    assert clean["requests"] == chaos["requests"] == 8
    assert clean["requests_timeout"] == chaos["requests_timeout"] == 0
    assert chaos["outputs"] == clean["outputs"] and len(clean["outputs"]) == 8
    assert chaos["host_cuda_initialized"] is False and clean["host_cuda_initialized"] is False
    assert all(r["dispatches"] > 0 for r in clean["replica_stats"])
    # every worker that was running at the end shut down cleanly
    assert [r["exit_code"] for r in chaos["replica_stats"]] == [0, 0]
    dead = [e for e in events(tmp / "chaos") if e["event"] == "serve-replica-dead"]
    assert [(e["replica"], e["rc"]) for e in dead] == [(1, -signal.SIGKILL)]
    assert "supervision: restarts=1" in out


def test_the_fleet_timeline_and_the_restart_gate(chaos_pair):
    tmp = chaos_pair[0]
    p = obs_report(tmp / "chaos", "--assert-max-replica-restarts", "1")
    assert p.returncode == 0, p.stdout[-2000:]
    assert "fleet timeline:" in p.stdout
    for what in ("dead", "restart", "failover", "restored"):
        assert what in p.stdout
    p = obs_report(tmp / "chaos", "--assert-max-replica-restarts", "0")
    assert p.returncode == 1 and "crash-looping" in p.stdout


def test_the_process_fleet_drains_on_sigterm(tmp_path):
    proc = start_bench(tmp_path, "--replicas-proc", "2", "--requests", "200", "--rate", "4")
    try:
        stats = sigterm_after_first_request(proc, tmp_path)
    finally:
        reap(proc)
    assert stats["drained"] and stats["unsubmitted"] > 0 and stats["replicas_gave_up"] == 0
    assert [r["exit_code"] for r in stats["replica_stats"]] == [0, 0]


def test_autoscale_grows_and_shrinks_the_fleet(tmp_path):
    stats, _ = run_bench(tmp_path, "--replicas-proc", "1", "--autoscale", "--min-replicas", "1",
                         "--max-replicas", "2", "--autoscale-sustain-s", "0.3",
                         "--autoscale-idle-s", "0.5", "--requests", "60", "--rate", "500",
                         "--output-len", "8", "16")
    assert stats["replica_spawns"] == 1 and stats["replica_drains"] == 1
    assert stats["requests"] == 60 and len(stats["outputs"]) == 60
    names = [e["event"] for e in events(tmp_path)]
    assert "serve-replica-spawn" in names and "serve-replica-drain" in names


@pytest.mark.parametrize("args,message", [
    (["--replicas-proc", "2", "--hostsfile", "hosts"], "--hostsfile"),
    (["--replicas-proc", "2", "--capacity-dir", "cap"], "--capacity-dir"),
    (["--capacity-publish-s", "1"], "--capacity-publish-s"),
    (["--replicas", "2", "--mp", "2"], "--mp > 1"),
    (["--config", "serving.json"], "--config"),
    (["--replicas", "2", "--checkpoint", "ckpt"], "--replicas > 1 serves"),
    (["--replicas-proc", "2", "--checkpoint", "ckpt"], "--replicas-proc serves"),
    (["--replicas", "2", "--spec-k-sweep", "0,2"], "single-replica"),
    (["--replicas-proc", "2", "--restarts", "1", "--run-dir", "r"], "pick one"),
    (["--replicas-proc", "2", "--no-journal"], "needs the journal"),
    (["--replicas-proc", "2", "--resume", "--run-dir", "r"], "recovers in the run"),
    (["--replicas-proc", "2", "--replicas", "2"], "drop --replicas"),
    (["--replicas-proc", "1", "--autoscale", "--min-replicas", "2"], "--min-replicas"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_refused_flags_fail_by_name(args, message, capsys):
    from scaling_tpu_torch.serve.bench import main

    with pytest.raises(SystemExit) as ei:
        main(["--device", "cpu", *args])
    assert ei.value.code == 2 and message in capsys.readouterr().err


def test_the_xla_paged_kernel_fails_by_name():
    """``paged_kernel='xla'`` stays refused: on the card it would run K1's
    plain version. The engine config and the bench both say so."""
    from scaling_tpu_torch.serve.bench import main

    with pytest.raises(NotImplementedError, match="paged_kernel='xla' is not ported"):
        EngineConfig(paged_kernel="xla")
    with pytest.raises(NotImplementedError, match="paged_kernel='xla' is not ported"):
        main(["--device", "cpu", "--paged-kernel", "xla", "--requests", "1"])
