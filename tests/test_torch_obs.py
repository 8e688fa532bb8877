"""The port's observability against the JAX package's, on the CPU.

The same calls go to ``scaling_tpu.obs`` / ``scaling_tpu.logging`` and to
``scaling_tpu_torch.obs`` / ``scaling_tpu_torch.logging``, and the records
must be equal with timestamps and durations masked (span ids renumbered
in order of appearance); the registry's snapshot and Prometheus textfile
renders must be byte-equal. Random values come from numpy seeds stated at
each use; every comparison is exact unless a tolerance is stated.

Beside the parity: ``obs report`` reproduces the JAX goldens byte for
byte, a toy Trainer run and a toy ``serve bench --run-dir`` render the
same report through both packages, the telemetry path makes no device
sync (the sync primitives are trapped, as the JAX package's
``test_step_path.py`` traps ``jax.block_until_ready``), the profiler's
observations follow the JAX schema, and TensorBoard writes event files.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import scaling_tpu.obs as jax_obs
import scaling_tpu.obs.report as jax_report
import scaling_tpu_torch.obs as port_obs
import scaling_tpu_torch.obs.report as port_report
from scaling_tpu.logging.logger import LoggerConfig as JaxLoggerConfig
from scaling_tpu.logging.logger import _Logger as JaxLogger
from scaling_tpu.obs.registry import MetricsRegistry as JaxRegistry
from scaling_tpu_torch.logging import Logger, LoggerConfig, append_jsonl_line
from scaling_tpu_torch.obs.registry import MetricsRegistry as PortRegistry
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "core" / "test_obs" / "fixtures"
PACKAGES = {"jax": (jax_obs, JaxRegistry), "torch": (port_obs, PortRegistry)}


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for var in ("SCALING_TPU_EVENTS_PATH", "SCALING_TPU_METRICS_PATH", "SCALING_TPU_HOST_ID",
                "SCALING_TPU_COORD_EPOCH", "SCALING_TPU_METRICS_TEXTFILE"):
        monkeypatch.delenv(var, raising=False)


def read_jsonl(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


def masked(records: list) -> list:
    """Records without ``ts`` and ``dur_s``; span ids renumbered in order of
    appearance, so that two runs' random ids compare by structure."""
    ids = {}
    out = []
    for r in records:
        r = {k: v for k, v in r.items() if k not in ("ts", "dur_s")}
        for key in ("span_id", "parent_span_id"):
            if key in r:
                r[key] = ids.setdefault(r[key], f"id{len(ids)}")
        out.append(r)
    return out


def both(fn, tmp_path, monkeypatch) -> dict:
    """``fn(obs, Registry, events_path)`` once per package, each with its own
    events file (through ``SCALING_TPU_EVENTS_PATH``); returns
    {package: (fn's result, the events file's records)}."""
    out = {}
    for name, (obs, registry_cls) in PACKAGES.items():
        events = tmp_path / f"{name}_events.jsonl"
        monkeypatch.setenv("SCALING_TPU_EVENTS_PATH", str(events))
        result = fn(obs, registry_cls, events)
        out[name] = (result, read_jsonl(events) if events.is_file() else [])
    return out


# --------------------------------------------------------------- registry
def drive_registry(registry_cls, metrics_path: Path, textfile: Path):
    """Counters, gauges and histograms with and without labels, a NaN gauge,
    custom buckets, and 70 label sets on one name (past the 64-series
    guard). Values from numpy seed 0."""
    rng = np.random.default_rng(0)
    reg = registry_cls()
    reg.configure(metrics_path=str(metrics_path), textfile_path=str(textfile))
    reg.counter("train_steps_total").inc()
    reg.counter("train_steps_total").inc(np.float32(4.0))  # a numpy scalar is coerced
    for host in range(3):
        reg.counter("retries_total", {"host": host, "kind": "io"}).inc(float(rng.integers(1, 9)))
    reg.gauge("mfu").set(float(rng.random()))
    reg.gauge("device_bytes_in_use", {"device": "0"}).set(int(rng.integers(1 << 30)))
    reg.gauge("broken").set(float("nan"))
    for v in rng.exponential(0.2, size=50):
        reg.histogram("span_seconds", {"span": "step.sync"}).observe(float(v))
    for v in rng.exponential(2.0, size=20):
        reg.histogram("barrier_wait_seconds", buckets=(0.5, 1.0, 4.0)).observe(float(v))
    for i in range(70):
        reg.counter("requests_total", {"req": str(i)}).inc()
    with pytest.raises(TypeError):  # a gauge's name asked for as a counter
        reg.counter("mfu")
    with pytest.raises(ValueError):
        reg.counter("train_steps_total").inc(-1)
    reg.flush_step(3)
    return reg


def test_registry_snapshot_textfile_and_flush_equal_jax(tmp_path):
    regs = {name: drive_registry(cls, tmp_path / f"{name}_m.jsonl", tmp_path / f"{name}.prom")
            for name, (_, cls) in PACKAGES.items()}
    # through JSON: the NaN gauge compares by its rendering
    assert json.dumps(regs["torch"].snapshot()) == json.dumps(regs["jax"].snapshot())
    assert regs["torch"].render_textfile() == regs["jax"].render_textfile()
    assert (tmp_path / "torch.prom").read_bytes() == (tmp_path / "jax.prom").read_bytes()
    (jax_rec,), (port_rec,) = (read_jsonl(tmp_path / f"{n}_m.jsonl") for n in ("jax", "torch"))
    assert masked([port_rec]) == masked([jax_rec])
    assert port_rec["kind"] == "registry" and port_rec["gauges"].get("broken", 0) is None


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_overflow_guard_folds_series_past_64(package):
    reg = PACKAGES[package][1]()
    for i in range(70):
        reg.counter("requests_total", {"req": str(i)}).inc(2.0)
    counters = reg.snapshot()["counters"]
    assert len(counters) == 65
    assert counters["requests_total{__overflow__=true}"] == 12.0  # 6 series folded, 2 each
    assert sum(counters.values()) == 140.0


def test_registry_flush_falls_back_to_the_loggers_metrics_path(tmp_path, monkeypatch):
    """Without an explicit sink the flush goes where ``log_metrics`` writes:
    ``SCALING_TPU_METRICS_PATH`` here, as in the JAX registry."""
    for name, (_, cls) in PACKAGES.items():
        monkeypatch.setenv("SCALING_TPU_METRICS_PATH", str(tmp_path / f"{name}.jsonl"))
        reg = cls()
        reg.gauge("g").set(2.5)
        reg.flush_step(9)
    assert masked(read_jsonl(tmp_path / "torch.jsonl")) == masked(read_jsonl(tmp_path /
                                                                             "jax.jsonl"))



def test_registry_flush_leaves_a_removed_logger_directory_alone(tmp_path):
    """The logger's sink directory is the logger's to make: ``configure``
    makes that of ``metrics_path``, a fallback flush writes there, and once
    the directory is removed under the config a flush writes nothing and
    does not recreate it. An explicit sink's directory is still made."""
    from scaling_tpu_torch.logging import logger

    before = logger.config
    reg = PortRegistry()
    reg.gauge("g").set(1.0)
    try:
        logger.configure(LoggerConfig(metrics_path=str(tmp_path / "logs" / "m.jsonl")))
        reg.flush_step(1)
        assert [r["step"] for r in read_jsonl(tmp_path / "logs" / "m.jsonl")] == [1]
        shutil.rmtree(tmp_path / "logs")
        reg.flush_step(2)
        assert not (tmp_path / "logs").exists()
    finally:
        logger.configure(before)
    reg.configure(metrics_path=str(tmp_path / "explicit" / "m.jsonl"))
    reg.flush_step(3)
    assert [r["step"] for r in read_jsonl(tmp_path / "explicit" / "m.jsonl")] == [3]


# ------------------------------------------------------------------ spans
def drive_spans(obs, registry_cls, events):
    """Nesting, an exception, annotate, a trace context with a parent span
    id, a step and extra fields, host and epoch from the environment."""
    reg = registry_cls()
    with obs.span("step.data", step=1, registry=reg, backend="npz"):
        pass
    with obs.span("outer", registry=reg) as sp:
        sp.annotate(bytes=12)
        with obs.span("inner", step=2, registry=reg, level="info"):
            assert obs.current_span().name == "inner"
    with pytest.raises(ValueError):
        with obs.span("risky", registry=reg):
            raise ValueError("boom")
    with obs.trace_context("0123456789abcdef", "feedbeef"):
        assert obs.current_trace() == {"trace_id": "0123456789abcdef",
                                       "parent_span_id": "feedbeef"}
        with obs.span("serve.admit", registry=reg, req=4):
            with obs.span("serve.mixed", registry=reg):
                assert obs.current_trace_id() == "0123456789abcdef"
    assert obs.current_trace() is None and obs.current_span() is None
    os.environ["SCALING_TPU_HOST_ID"], os.environ["SCALING_TPU_COORD_EPOCH"] = "3", "2"
    try:
        with obs.span("ckpt.rename", step=6, registry=reg):
            pass
    finally:
        del os.environ["SCALING_TPU_HOST_ID"], os.environ["SCALING_TPU_COORD_EPOCH"]
    snap = reg.snapshot()["histograms"]
    return {name: h["count"] for name, h in snap.items()}, obs.derive_trace_id("ckpt", 3, "0")


def test_span_records_equal_jax(tmp_path, monkeypatch):
    out = both(drive_spans, tmp_path, monkeypatch)
    (port_counts, port_tid), port_events = out["torch"]
    (jax_counts, jax_tid), jax_events = out["jax"]
    assert port_counts == jax_counts and port_tid == jax_tid
    assert masked(port_events) == masked(jax_events)
    by_name = {e["span"]: e for e in port_events}
    assert by_name["inner"]["parent"] == "outer" and by_name["risky"]["error"] == "ValueError"
    assert by_name["serve.mixed"]["parent_span_id"] == by_name["serve.admit"]["span_id"]
    assert (by_name["ckpt.rename"]["host"], by_name["ckpt.rename"]["epoch"]) == (3, 2)


def drive_writer_thread(obs, registry_cls, events):
    """A span on another thread while the main thread is inside a traced
    span, as the asynchronous checkpoint writer's ``ckpt.*`` spans run."""
    reg = registry_cls()
    with obs.trace_context("aaaaaaaaaaaaaaaa"):
        with obs.span("trainer.save", step=3, registry=reg):
            worker = threading.Thread(target=writer_thread_spans, args=(obs, reg))
            worker.start()
            worker.join()


def writer_thread_spans(obs, reg):
    with obs.span("ckpt.manifest", step=3, registry=reg):
        pass
    with obs.span("ckpt.rename", step=3, registry=reg):
        with obs.span("ckpt.latest", step=3, registry=reg):
            pass


def test_span_on_another_thread_has_no_parent_from_the_main_thread(tmp_path, monkeypatch):
    out = both(drive_writer_thread, tmp_path, monkeypatch)
    port_events, jax_events = out["torch"][1], out["jax"][1]
    assert masked(port_events) == masked(jax_events)
    by_name = {e["span"]: e for e in port_events}
    assert "parent" not in by_name["ckpt.manifest"] and "trace" not in by_name["ckpt.manifest"]
    assert by_name["ckpt.latest"]["parent"] == "ckpt.rename"
    assert by_name["trainer.save"]["trace"] == "a" * 16


# ------------------------------------------------------------------ logger
def drive_events(logger, trace_context):
    logger.log_event("step-stall", step=5, elapsed_s=120.5, verdict="local-stall",
                     dead_hosts=[], host=0)
    logger.log_event("span", _level="debug", _fsync=False, span="x", ok=True)
    logger.log_event("ckpt-reshard", step=None, path=Path("/ckpt/global_step3"))
    with trace_context("1111222233334444"):
        logger.log_event("serve-request", _level="debug", req=1)
        logger.log_event("serve-request", _level="debug", req=2, trace="explicit")


def test_log_event_records_equal_jax(tmp_path):
    jax_logger, port_logger = JaxLogger(), Logger()
    jax_logger.configure(JaxLoggerConfig(events_path=str(tmp_path / "jax.jsonl")))
    port_logger.configure(LoggerConfig(events_path=str(tmp_path / "torch.jsonl")))
    drive_events(jax_logger, jax_obs.trace_context)
    drive_events(port_logger, port_obs.trace_context)
    port_events = read_jsonl(tmp_path / "torch.jsonl")
    assert masked(port_events) == masked(read_jsonl(tmp_path / "jax.jsonl"))
    assert [e.get("trace") for e in port_events[-2:]] == ["1111222233334444", "explicit"]


def test_the_environment_overrides_the_configured_events_path(tmp_path, monkeypatch):
    for logger, config in ((JaxLogger(), JaxLoggerConfig), (Logger(), LoggerConfig)):
        name = "jax" if isinstance(logger, JaxLogger) else "torch"
        logger.configure(config(events_path=str(tmp_path / f"{name}_config.jsonl")))
        logger.log_event("a")
        monkeypatch.setenv("SCALING_TPU_EVENTS_PATH", str(tmp_path / f"{name}_env.jsonl"))
        logger.log_event("b")
        monkeypatch.delenv("SCALING_TPU_EVENTS_PATH")
    for name in ("jax", "torch"):
        assert [e["event"] for e in read_jsonl(tmp_path / f"{name}_config.jsonl")] == ["a"]
        assert [e["event"] for e in read_jsonl(tmp_path / f"{name}_env.jsonl")] == ["b"]


def test_log_event_fsyncs_lifecycle_events_only(tmp_path, monkeypatch):
    synced = []
    monkeypatch.setattr(os, "fsync", lambda fd: synced.append(fd))
    logger = Logger(LoggerConfig(events_path=str(tmp_path / "e.jsonl")))
    logger.log_event("relaunch", epoch=1)
    logger.log_event("span", _fsync=False, span="step.sync")
    assert len(synced) == 1 and len(read_jsonl(tmp_path / "e.jsonl")) == 2


def test_step_records_and_tensorboard_scalars_equal_jax(tmp_path):
    """``log_metrics`` writes the JAX logger's records (non-finite values as
    null) and, with ``use_tensorboard``, the same scalars to
    ``<log_dir>/tensorboard``. Values from numpy seed 1."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    rng = np.random.default_rng(1)
    steps = [{"loss": float(v), "step_duration": float(d), "bad": float("inf")}
             for v, d in zip(rng.random(4) * 10, rng.random(4))]
    loggers = {"jax": (JaxLogger(), JaxLoggerConfig), "torch": (Logger(), LoggerConfig)}
    for name, (logger, config) in loggers.items():
        logger.configure(config(log_dir=str(tmp_path / name), use_tensorboard=True))
        for i, m in enumerate(steps, 1):
            logger.log_metrics(m, i)
        logger._tb_writer.flush()
    recs = {n: read_jsonl(tmp_path / n / "metrics_rank_0.jsonl") for n in loggers}
    assert masked(recs["torch"]) == masked(recs["jax"])
    assert recs["torch"][0]["metrics"]["bad"] is None
    scalars = {}
    for name in loggers:
        assert list((tmp_path / name / "tensorboard").glob("events.out.tfevents.*"))
        acc = EventAccumulator(str(tmp_path / name / "tensorboard"))
        acc.Reload()
        scalars[name] = {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
                         for tag in acc.Tags()["scalars"]}
    assert scalars["torch"] == scalars["jax"] and len(scalars["torch"]["loss"]) == 4
    loggers["torch"][0].configure(LoggerConfig())  # closes the writer


def test_wandb_stays_refused_by_name():
    with pytest.raises(NotImplementedError, match="use_wandb"):
        LoggerConfig(use_wandb=True)


def test_append_jsonl_line_keeps_each_record_whole_across_threads(tmp_path):
    """8 threads append 40 records of ~20 KB each to one file (above a
    buffered file's 8 KiB buffer): every line parses, none interleaves."""
    path = tmp_path / "m.jsonl"

    def writer(t):
        for i in range(40):
            append_jsonl_line(path, json.dumps({"t": t, "i": i, "pad": "x" * 20_000}))

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    recs = read_jsonl(path)
    assert sorted((r["t"], r["i"]) for r in recs) == [(t, i) for t in range(8) for i in range(40)]


# ---------------------------------------------------- hardware, telemetry
def test_hardware_gauges_have_the_jax_names_on_the_cpu():
    """On the CPU both give zero memory records; the port's one device's
    gauges are among the JAX package's (which sees the tests' 8 virtual
    CPU devices), under the same names, with ``live_arrays`` beside them."""
    port_reg, jax_reg = PortRegistry(), JaxRegistry()
    port_summary = port_obs.update_hardware_gauges(port_reg)
    jax_summary = jax_obs.update_hardware_gauges(jax_reg)
    assert port_obs.device_memory_snapshot() == [{"device": 0, "platform": "cpu",
                                                  "bytes_in_use": 0, "peak_bytes_in_use": 0,
                                                  "bytes_limit": 0}]
    assert set(jax_obs.device_memory_snapshot()[0]) == set(port_obs.device_memory_snapshot()[0])
    assert set(port_summary) == set(jax_summary)
    port_gauges, jax_gauges = port_reg.snapshot()["gauges"], jax_reg.snapshot()["gauges"]
    assert set(port_gauges) <= set(jax_gauges) and "live_arrays" in port_gauges
    assert port_gauges["device_bytes_in_use{device=0}"] == 0



def test_hardware_gauges_query_the_allocator_once_a_device(monkeypatch):
    """On the card each gauge update takes one ``memory_stats`` dict a
    device and reads both the memory and the live-allocation gauges from
    it; the device's total memory is asked once per process. The two
    devices' allocator stats are made up here (the CPU has none)."""
    from scaling_tpu_torch.obs import hardware

    stats = {0: {"allocated_bytes.all.current": 5, "allocated_bytes.all.peak": 9,
                 "active.all.current": 3},
             1: {"allocated_bytes.all.current": 7, "allocated_bytes.all.peak": 8,
                 "active.all.current": 4}}
    calls = {"memory_stats": 0, "properties": 0}

    def memory_stats(d):
        calls["memory_stats"] += 1
        return stats[d]

    def properties(d):
        calls["properties"] += 1
        return type("Props", (), {"total_memory": 100 + d})()

    monkeypatch.setattr(hardware, "_cuda_devices", lambda: [0, 1])
    monkeypatch.setattr(torch.cuda, "memory_stats", memory_stats)
    monkeypatch.setattr(torch.cuda, "get_device_properties", properties)
    hardware._total_memory.cache_clear()
    reg = PortRegistry()
    try:
        for _ in range(3):
            summary = hardware.update_hardware_gauges(reg)
    finally:
        hardware._total_memory.cache_clear()
    assert calls == {"memory_stats": 6, "properties": 2}
    assert summary == {"device_bytes_in_use": 7, "device_peak_bytes_in_use": 9,
                       "live_arrays": 7}
    gauges = reg.snapshot()["gauges"]
    assert gauges["device_bytes_in_use{device=1}"] == 7 and gauges["live_arrays"] == 7


def test_step_time_ema_tflops_and_mfu_equal_jax():
    rng = np.random.default_rng(2)
    durations = rng.random(10) + 0.05
    emas = {}
    for name, (obs, _) in PACKAGES.items():
        ema = obs.StepTimeEMA(0.2)
        emas[name] = [ema.update(float(d)) for d in durations]
    assert emas["torch"] == emas["jax"]
    args = (81715200.0, 8192.0, 0.08)
    assert port_obs.achieved_tflops(*args) == jax_obs.achieved_tflops(*args)
    assert port_obs.mfu(400.0, 1, 989.4) == jax_obs.mfu(400.0, 1, 989.4)


def drive_telemetry(obs, registry_cls):
    """``configure`` then fetched steps with gaps (log_interval 10), an
    unfetched one (no duration), and a flush. Durations from numpy seed 3."""
    rng = np.random.default_rng(3)
    reg = registry_cls()
    t = obs.StepTelemetry(registry=reg, ema_alpha=0.3)
    t.configure(flops_per_token=6.0 * 495_110_144 + 12.0 * 8 * 2048 * 2048,
                tokens_per_step=4 * 2048, world_size=1, peak_tflops=989.4)
    derived = [t.on_step(step, float(d)) for step, d in zip((1, 11, 21), rng.random(3) + 0.05)]
    derived.append(t.on_step(22, None))
    snap = reg.snapshot()
    for key in list(snap["gauges"]):  # per-device and live-allocation values differ by backend
        if key.startswith(("device_", "live_arrays")):
            del snap["gauges"][key]
    return derived, snap


def test_step_telemetry_equals_jax():
    port, jax = drive_telemetry(port_obs, PortRegistry), drive_telemetry(jax_obs, JaxRegistry)
    assert port == jax
    derived, snap = port
    assert snap["counters"]["train_steps_total"] == 22.0
    assert derived[0]["mfu"] == derived[0]["achieved_tflops"] / 989.4
    assert "mfu" not in derived[-1]


def test_telemetry_flush_failure_warns_and_never_raises(monkeypatch):
    t = port_obs.StepTelemetry(registry=PortRegistry())

    def full_disk(step):
        raise OSError("no space left on device")

    monkeypatch.setattr(t.registry, "flush_step", full_disk)
    t.flush(7)


@pytest.fixture()
def no_syncs(monkeypatch):
    """Every primitive that waits for a device, trapped."""

    def boom(*a, **k):  # firing is the failure
        raise AssertionError("device sync on the telemetry step path")

    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    for name in ("item", "cpu", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, boom)


def test_telemetry_and_spans_make_no_device_sync(tmp_path, monkeypatch, no_syncs):
    monkeypatch.setenv("SCALING_TPU_EVENTS_PATH", str(tmp_path / "events.jsonl"))
    reg = PortRegistry()
    reg.configure(metrics_path=str(tmp_path / "metrics.jsonl"))
    t = port_obs.StepTelemetry(registry=reg)
    t.configure(flops_per_token=81715200.0, tokens_per_step=1024, peak_tflops=989.4)
    loss = torch.ones(4, 4).sum()  # a step's output, never read by telemetry
    with port_obs.span("step.fwdbwd", step=1, registry=reg):
        pass
    with port_obs.span("step.sync", step=1, registry=reg) as sp:
        sp.wait_for({"loss": loss, "rest": [loss, 3]})  # CPU tensors: nothing to wait for
    derived = t.on_step(1, 0.5)
    t.flush(1)
    assert derived["mfu"] == pytest.approx(81715200.0 * 1024 / 0.5 / 1e12 / 989.4, rel=1e-12)
    assert [r["kind"] for r in read_jsonl(tmp_path / "metrics.jsonl")] == ["registry"]
    assert [e["span"] for e in read_jsonl(tmp_path / "events.jsonl")] == ["step.fwdbwd",
                                                                         "step.sync"]


def test_no_tpu_peak_in_the_port():
    """The telemetry's MFU is declared with the H100's 989.4 TFLOP/s; no TPU
    peak table is named anywhere in the package."""
    sources = "\n".join(p.read_text() for p in (REPO / "scaling_tpu_torch").rglob("*.py"))
    assert "TPU_V" not in sources and "HardwareType.TPU" not in sources
    train = (REPO / "scaling_tpu_torch/models/transformer/train.py").read_text()
    assert "peak_tflops=H100_BF16_TFLOPS" in train


# ---------------------------------------------------------------- profiler
def drive_profiler(profiler_module, config_cls, out: Path):
    """Steps 0-5 with a window at 2-3; data and step times from numpy seed 4."""
    rng = np.random.default_rng(4)
    prof = profiler_module.Profiler(config_cls(profile_steps=2, profile_start_at_step=2,
                                               profiler_output=str(out)))
    for step, (d, s) in enumerate(rng.random((6, 2))):
        prof.begin_step(step)
        prof.record(step, {"data_load": float(d), "step_time": float(s)})
        prof.end_step(step)
    prof.close()
    return [prof.enabled_at(step) for step in range(6)]


def test_profiler_observations_equal_jax(tmp_path):
    import scaling_tpu.profiler as jax_profiler
    import scaling_tpu_torch.profiler as port_profiler

    port = drive_profiler(port_profiler, port_profiler.ProfilerConfig, tmp_path / "p" / "o.json")
    jax = drive_profiler(jax_profiler, jax_profiler.ProfilerConfig, tmp_path / "j" / "o.json")
    assert port == jax == [False, False, True, True, False, False]
    obs = json.loads((tmp_path / "p" / "o.json").read_text())
    assert obs == json.loads((tmp_path / "j" / "o.json").read_text())
    assert [set(o) for o in obs] == [{"step", "data_load", "step_time"}] * 2


def test_profiler_close_mid_window_keeps_the_partial_window(tmp_path):
    from scaling_tpu_torch.profiler import Profiler, ProfilerConfig

    prof = Profiler(ProfilerConfig(profile_steps=4, profile_start_at_step=0,
                                   profiler_output=str(tmp_path / "o.json"),
                                   capture_xla_trace=True))
    prof.begin_step(0)
    prof.record(0, {"data_load": 0.1, "step_time": 0.2})
    prof.close()  # the run died at step 1
    assert json.loads((tmp_path / "o.json").read_text()) == [
        {"step": 0, "data_load": 0.1, "step_time": 0.2}]
    assert prof.trace_path is not None and prof.trace_path.parent.name == "xla_trace"
    prof.close()  # idempotent


def test_profiler_window_exports_a_torch_trace(tmp_path):
    """``capture_xla_trace`` traces the window with ``torch.profiler`` into
    ``<profiler_output parent>/xla_trace/``: a Chrome trace naming the ops
    the window ran."""
    from scaling_tpu_torch.profiler import Profiler, ProfilerConfig, SynchronizedTimer

    prof = Profiler(ProfilerConfig(profile_steps=2, profile_start_at_step=1,
                                   profiler_output=str(tmp_path / "prof" / "o.json"),
                                   capture_xla_trace=True))
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(5))
    for step in range(4):
        prof.begin_step(step)
        with SynchronizedTimer("step") as timer:
            x = torch.tanh(x @ x)
        prof.record(step, {"data_load": 0.0, "step_time": timer.durations[-1]})
        prof.end_step(step)
    (trace,) = (tmp_path / "prof" / "xla_trace").glob("*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "aten::mm" in names and "aten::tanh" in names
    assert [o["step"] for o in json.loads((tmp_path / "prof" / "o.json").read_text())] == [1, 2]


# ------------------------------------------------------------------ report
@pytest.mark.parametrize("name", ["single", "pod"])
def test_obs_report_reproduces_the_jax_goldens(tmp_path, name):
    shutil.copytree(FIXTURES / f"rundir_{name}", tmp_path / "RUNDIR")
    proc = subprocess.run([sys.executable, "-m", "scaling_tpu_torch.obs", "report", "RUNDIR"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == (FIXTURES / f"golden_{name}.txt").read_text()


GATES = [
    (["--assert-mfu", "0.1"], 0), (["--assert-mfu", "0.99"], 1),
    (["--assert-step-time", "0.1"], 1), (["--assert-step-time", "5"], 0),
    (["--assert-serve-throughput", "1"], 1),
]


@pytest.mark.parametrize("flags,rc", GATES, ids=[" ".join(f) for f, _ in GATES])
def test_obs_report_gates_exit_as_in_jax(tmp_path, capsys, flags, rc):
    from scaling_tpu.obs.cli import main as jax_main
    from scaling_tpu_torch.obs.cli import main as port_main

    argv = ["report", str(FIXTURES / "rundir_single"), *flags]
    assert port_main(argv + ["--json", str(tmp_path / "p.json")]) == rc
    port_out = capsys.readouterr().out
    assert jax_main(argv + ["--json", str(tmp_path / "j.json")]) == rc
    assert port_out == capsys.readouterr().out
    assert json.loads((tmp_path / "p.json").read_text()) == json.loads(
        (tmp_path / "j.json").read_text())


def test_obs_report_without_telemetry_exits_2(tmp_path):
    from scaling_tpu_torch.obs.cli import main

    assert main(["report", str(tmp_path)]) == 2
    assert main(["report", str(tmp_path / "nothing")]) == 2
    assert main(["trace", str(tmp_path)]) == 2


def render_both(run_dir: Path) -> tuple:
    return (port_report.render_report(port_report.load_run_dir(run_dir), "RUNDIR"),
            jax_report.render_report(jax_report.load_run_dir(run_dir), "RUNDIR"))


@pytest.fixture(scope="module")
def token_data(tmp_path_factory):
    from scaling_tpu_torch.data import MemoryMapDatasetBuilder

    root = tmp_path_factory.mktemp("obs_tokens")
    rng = np.random.default_rng(6)
    out = {}
    for name, docs in (("a", 30), ("valid", 10)):
        with MemoryMapDatasetBuilder(root / name, dtype=np.uint16) as builder:
            for _ in range(docs):
                builder.add(np.append(rng.integers(1, 96, size=rng.integers(8, 80)), 0))
        out[name] = str(root / name)
    return out


def toy_config(token_data, run_dir: Path, **trainer) -> dict:
    return {
        "topology": {"micro_batch_size": 2, "gradient_accumulation_steps": 1},
        "transformer_architecture": {
            "vocab_size": 96, "hidden_size": 64, "num_layers": 2, "num_attention_heads": 4,
            "attention_num_kv_heads": 2, "attention_qkv_in_one": False,
            "sequence_length": 32, "precision": "float32", "mlp_type": "swiglu",
            "mlp_factor": 2.0, "norm_type": "rms", "layernorm": {"optimization_type": "fused"},
            "weight_tying": False},
        "trainer": {"train_iterations": 4, "save_dir": str(run_dir.parent / "ckpt"),
                    "save_interval": 2, "eval_interval": 2, "eval_iterations": 1, "seed": 3,
                    **trainer},
        "data": {"data_prefixes": [token_data["a"]],
                 "validation_data_prefixes": [token_data["valid"]]},
        "logger": {"log_dir": str(run_dir / "logs"),
                   "events_path": str(run_dir / "events.jsonl")},
    }


@pytest.mark.parametrize("async_save", [False, True], ids=["sync_save", "async_save"])
def test_toy_trainer_run_dir_renders_the_same_through_both_reports(token_data, tmp_path,
                                                                   async_save):
    """A toy Trainer run on the CPU with the events file on: its run
    directory renders the same report through both packages, with step
    records, registry snapshots, the step spans and each save's
    ``ckpt.*`` spans. On an asynchronous save the writer thread's spans
    have no parent; a synchronous save's are children of ``trainer.save``."""
    from scaling_tpu_torch.models.transformer import TransformerConfig
    from scaling_tpu_torch.models.transformer.train import main

    run_dir = tmp_path / "run"
    main(TransformerConfig.from_dict(toy_config(token_data, run_dir,
                                                save_checkpoint_async=async_save)),
         device="cpu")
    port_text, jax_text = render_both(run_dir)
    assert port_text == jax_text
    # 4 step records and 2 of eval
    assert "step_records=6" in port_text and "host 0: n=4 " in port_text
    commits = [line for line in port_text.splitlines() if line.startswith("  step ")]
    assert [line.split(":")[0] for line in commits] == ["  step 2", "  step 4"]
    assert all("stage=" in line and "rename=" in line and "latest=" in line for line in commits)
    spans = [e for e in read_jsonl(run_dir / "events.jsonl") if e["event"] == "span"]
    assert {"step.data", "step.fwdbwd", "step.sync", "trainer.eval"} <= {e["span"] for e in spans}
    parents = {e.get("parent") for e in spans if e["span"] in ("ckpt.manifest", "ckpt.rename",
                                                               "ckpt.latest")}
    assert parents == ({None} if async_save else {"trainer.save"})
    kinds = {r["kind"] for r in read_jsonl(run_dir / "logs" / "metrics_rank_0.jsonl")}
    assert kinds == {"step", "registry"}


def test_cpu_run_records_no_mfu_and_the_cards_peak_gives_palm_mfu(token_data, tmp_path):
    """A CPU run declares no peak, so its records carry no ``mfu``; with the
    H100's peak declared (as on the card) each record's ``mfu`` equals its
    ``achieved_tflops`` over 989.4 and lies within 1e-6 of PaLM MFU from
    the record's own tokens/s."""
    from scaling_tpu_torch.models.transformer import TransformerConfig
    from scaling_tpu_torch.models.transformer.train import build_trainer
    from scaling_tpu_torch.models.transformer.utils.get_tflops import (
        get_model_parameter_count,
        get_palm_mfu,
    )

    run_dir = tmp_path / "run"
    config = TransformerConfig.from_dict(toy_config(token_data, run_dir, save_dir=None,
                                                    train_iterations=2))
    trainer = build_trainer(config, device="cpu")
    assert trainer.telemetry.peak_tflops is None and trainer.telemetry.flops_per_token
    trainer.telemetry.configure(peak_tflops=989.4)
    trainer.run_training()
    steps = [r["metrics"] for r in read_jsonl(run_dir / "logs" / "metrics_rank_0.jsonl")
             if r["kind"] == "step" and "loss" in r["metrics"]]
    n = get_model_parameter_count(64, 2, 96, 2.0, glu=True)
    for m in steps:
        assert m["mfu"] == pytest.approx(m["achieved_tflops"] / 989.4, rel=1e-12)
        assert m["mfu"] == pytest.approx(get_palm_mfu(n, 2, 64, 32, m["tokens_per_second"]),
                                         rel=1e-6)
    assert len(steps) == 2


@pytest.fixture(scope="module")
def serve_run_dir(tmp_path_factory):
    from scaling_tpu_torch.serve.bench import main

    run_dir = tmp_path_factory.mktemp("serve") / "run"
    rc = main(["--device", "cpu", "--model", "toy", "--requests", "4", "--rate", "100",
               "--prompt-len", "3", "9", "--output-len", "2", "4", "--num-slots", "2",
               "--block-size", "4", "--num-blocks", "16", "--max-blocks-per-seq", "8",
               "--run-dir", str(run_dir), "--json", str(run_dir.parent / "stats.json")])
    assert rc == 0
    return run_dir


def test_toy_serve_bench_run_dir_renders_the_same_through_both_reports(serve_run_dir):
    port_text, jax_text = render_both(serve_run_dir)
    assert port_text == jax_text
    stats = json.loads((serve_run_dir.parent / "stats.json").read_text())
    assert f"{stats['tokens_per_s']:.1f} output tokens/s" in port_text
    assert ", 4 request(s))" in port_text and "traces: 4 reconstructed" in port_text
    events = read_jsonl(serve_run_dir / "events.jsonl")
    assert sum(e["event"] == "serve-request" for e in events) == 4
    assert all("ttft_s" in e and "trace" in e for e in events if e["event"] == "serve-request")
    spans = {e["span"] for e in events if e["event"] == "span"}
    assert {"serve.tick", "serve.mixed", "serve.admit"} <= spans
    counters = read_jsonl(serve_run_dir / "metrics.jsonl")[-1]["counters"]
    assert counters["serve_requests_completed_total"] >= 4
    assert "SCALING_TPU_EVENTS_PATH" not in os.environ  # put back after the run



def test_serve_bench_without_run_dir_writes_nothing_after_a_configured_logger(tmp_path):
    """A bench without ``--run-dir`` after the process logger was given an
    events file and a log directory (as a Trainer run leaves it), which
    are then removed: no event, no registry snapshot and no directory
    appears, and the logger's config and the registry's sink are put back
    after the bench."""
    from scaling_tpu_torch.logging import logger
    from scaling_tpu_torch.obs import get_registry
    from scaling_tpu_torch.serve.bench import main

    before = logger.config
    stale = LoggerConfig(log_dir=str(tmp_path / "gone" / "logs"),
                         events_path=str(tmp_path / "gone" / "events.jsonl"))
    logger.configure(stale)
    shutil.rmtree(tmp_path / "gone")
    sink = get_registry()._metrics_path
    try:
        rc = main(["--device", "cpu", "--model", "toy", "--requests", "3", "--rate", "100",
                   "--prompt-len", "3", "9", "--output-len", "2", "4", "--num-slots", "2",
                   "--block-size", "4", "--num-blocks", "16", "--max-blocks-per-seq", "8",
                   "--json", str(tmp_path / "stats.json")])
        assert rc == 0 and logger.config == stale
        assert get_registry()._metrics_path == sink
    finally:
        logger.configure(before)
    assert sorted(f.name for f in tmp_path.iterdir()) == ["stats.json"]


def test_obs_trace_equals_jax_on_a_serve_run_dir(serve_run_dir, capsys):
    from scaling_tpu.obs.cli import main as jax_main
    from scaling_tpu_torch.obs.cli import main as port_main

    assert port_main(["trace", str(serve_run_dir)]) == 0
    port_out = capsys.readouterr().out
    assert jax_main(["trace", str(serve_run_dir)]) == 0
    assert port_out == capsys.readouterr().out and "4 trace(s)" in port_out
