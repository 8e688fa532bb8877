"""The port's tuner (``scaling_tpu_torch.tune``) against the JAX package's:
``ModelSpec``'s counts against both packages' estimators; the cost and
serving math on hand-built 8-device layouts and serving points equal to
JAX's within 1e-9 relative, with JAX's ``tpu_v5e`` table entries put into
the port's tables for the test (the port's own tables describe the H100);
the serving calibration read from a port ``serve bench --run-dir``
directory equal to JAX's reading of it; the refusals by name; the
emitted config through ``serve bench --config``; the ``tuner-prediction``
event through a port Trainer run into ``obs report``; both goldens."""

import dataclasses
import json
import math

import numpy as np
import pytest

from scaling_tpu_torch import tune
from scaling_tpu_torch.tune import cli, costmodel, layouts, serving
from .test_torch_parity_helpers import one_torch_thread  # noqa: F401

REL = 1e-9
MODELS = ("0.5b", "1b")


def close(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=REL, abs_tol=1e-300)


# ------------------------------------------------------------ model counts
@pytest.mark.parametrize("name", MODELS)
def test_modelspec_counts_equal_jax_and_the_ports_estimators(name):
    from scaling_tpu.tune.layouts import BENCH_MODELS as JAX_MODELS
    from scaling_tpu_torch.models.transformer.utils.get_tflops import (
        get_flops_per_token,
        get_model_parameter_count,
    )

    m, j = layouts.BENCH_MODELS[name], JAX_MODELS[name]
    assert dataclasses.asdict(m) == dataclasses.asdict(j)
    n = get_model_parameter_count(m.hidden_size, m.num_layers, m.vocab_size, m.mlp_factor,
                                  glu=m.glu)
    assert m.parameter_count == j.parameter_count == n
    assert m.flops_per_token == j.flops_per_token == get_flops_per_token(
        n, m.num_layers, m.hidden_size, m.sequence_length)
    assert m.attention_flops_fraction == j.attention_flops_fraction


def test_modelspec_from_the_ports_architecture_config():
    from scaling_tpu.tune.layouts import ModelSpec as JaxModelSpec
    from scaling_tpu_torch.models.transformer import TransformerArchitectureConfig
    from scaling_tpu_torch.serve.bench import MODELS as SERVE_MODELS

    arch = TransformerArchitectureConfig.from_dict(SERVE_MODELS["0.5b"])
    m = layouts.ModelSpec.from_arch(arch)
    assert m == layouts.BENCH_MODELS["0.5b"]
    assert dataclasses.asdict(m) == dataclasses.asdict(JaxModelSpec.from_arch(SERVE_MODELS["0.5b"]))


# ------------------------------------------------ the math against JAX's
@pytest.fixture
def jax_entry(monkeypatch):
    """JAX's tpu_v5e table entries in the port's tables, for this test."""
    from scaling_tpu.tune import costmodel as jcost
    from scaling_tpu.tune import serving as jserv

    monkeypatch.setitem(costmodel._GENERATIONS, "tpu_v5e", jcost._GENERATIONS["tpu_v5e"])
    monkeypatch.setitem(serving.HBM_GB, "tpu_v5e", jserv.HBM_GB["tpu_v5e"])
    monkeypatch.setattr(serving, "PAGED_BLOCK_OVERHEAD", jserv.PAGED_BLOCK_OVERHEAD)
    return jcost, jserv


def topologies(jcost, domain):
    jt = jcost.SliceTopology(chips=8, ici_domain=domain, generation="tpu_v5e")
    pt = costmodel.SliceTopology(chips=8, nvlink_domain=domain, generation="tpu_v5e",
                                 nic_gbytes_per_s=jt.dcn_gbytes_per_s,
                                 nvlink_latency_s=jt.ici_latency_s,
                                 nic_latency_s=jt.dcn_latency_s)
    return jt, pt


def eight_device_layouts():
    """JAX's enumeration of the 0.5B on 8 devices (every pp/dp/cp/mp,
    zero, virtual-stage and token-slice arm), as port ``Layout`` s."""
    from scaling_tpu.tune.layouts import BENCH_MODELS, enumerate_layouts

    jl = enumerate_layouts(8, BENCH_MODELS["0.5b"], global_batch_size=64, micro_batch_size=8,
                           mbs_ladder=[4])
    return jl, [layouts.Layout(**dataclasses.asdict(x)) for x in jl]


@pytest.mark.parametrize("domain", [None, 4, 2])
def test_score_layout_equals_jax_on_8_device_layouts(jax_entry, domain):
    jcost, _ = jax_entry
    jt, pt = topologies(jcost, domain)
    from scaling_tpu.tune.layouts import BENCH_MODELS

    jm, pm = BENCH_MODELS["0.5b"], layouts.BENCH_MODELS["0.5b"]
    jls, pls = eight_device_layouts()
    assert len(pls) > 50 and {x.pp for x in pls} == {1, 2, 4, 8}
    jcal = jcost.Calibration.from_mfu(0.41, "t")
    pcal = costmodel.Calibration.from_mfu(0.41, "t")
    for jl, pl in zip(jls, pls):
        assert pl.label == jl.label and pl.topology_dict() == jl.topology_dict()
        assert costmodel.analytic_collectives(pm, pl) == jcost.analytic_collectives(jm, jl)
        j, p = jcost.score_layout(jm, jl, jt, jcal), costmodel.score_layout(pm, pl, pt, pcal)
        for field in ("predicted_step_s", "compute_s", "comm_s", "bubble_fraction",
                      "memory_gb", "tokens_per_s"):
            assert close(getattr(p, field), getattr(j, field)), (pl.label, field)
        assert set(p.comm_by_axis) == set(j.comm_by_axis)
        for axis, rec in j.comm_by_axis.items():
            got = p.comm_by_axis[axis]
            assert got["bytes"] == rec["bytes"] and close(got["seconds"], rec["seconds"])
            assert got["link"] == {"ici": "nvlink", "dcn": "nic"}[rec["link"]]
    ranked_j = jcost.rank_layouts(jm, jls, jt, jcal)
    ranked_p = costmodel.rank_layouts(pm, pls, pt, pcal)
    assert [s.layout.label for s in ranked_p] == [s.layout.label for s in ranked_j]


@pytest.mark.parametrize("domain", [None, 2])
def test_serving_math_equals_jax_on_8_device_points(jax_entry, domain):
    jcost, jserv = jax_entry
    jt, pt = topologies(jcost, domain)
    from scaling_tpu.tune.layouts import BENCH_MODELS

    jm, pm = BENCH_MODELS["1b"], layouts.BENCH_MODELS["1b"]
    jps = jserv.enumerate_serving_points(8, jm, block_sizes=(8, 16, 32),
                                         token_budgets=(128, 512, 32768), num_slots=16)
    pps = serving.enumerate_serving_points(8, pm, block_sizes=(8, 16, 32),
                                           token_budgets=(128, 512, 32768), num_slots=16)
    assert [dataclasses.asdict(p) for p in pps] == [dataclasses.asdict(p) for p in jps]
    assert {p.mp for p in pps} == {1, 2, 4}
    for jp, pp in zip(jps, pps):
        j, p = jserv.predict_tick_seconds(jm, jp, jt), serving.predict_tick_seconds(pm, pp, pt)
        for key in ("compute_s", "comm_s", "tick_s"):
            assert close(p[key], j[key]), (pp.label, key)
        assert close(serving.serving_memory_gb(pm, pp), jserv.serving_memory_gb(jm, jp))
        assert pp.to_config(pm) == jp.to_config(jm)
    jcal = jserv.ServeCalibration(factor=7.5, source="t")
    pcal = serving.ServeCalibration(factor=7.5, source="t")
    rj = jserv.rank_serving_points(jm, jps, jt, None, jcal)
    rp = serving.rank_serving_points(pm, pps, pt, None, pcal)
    assert [s.point.label for s in rp] == [s.point.label for s in rj]
    assert len(rp) < len(pps)  # 32768-token budgets at mp 1 overflow the 16 GB entry
    for a, b in zip(rp, rj):
        assert close(a.tokens_per_s, b.tokens_per_s) and close(a.tick_s, b.tick_s)


def test_serve_calibration_from_a_port_run_dir_equals_jax(jax_entry, tmp_path):
    jcost, jserv = jax_entry
    from scaling_tpu.tune.layouts import ModelSpec as JaxModelSpec
    from scaling_tpu_torch.serve.bench import MODELS as SERVE_MODELS
    from scaling_tpu_torch.serve.bench import main

    run = tmp_path / "run"
    assert main(["--device", "cpu", "--model", "toy", "--requests", "4", "--rate", "100",
                 "--prompt-len", "4", "12", "--output-len", "3", "6", "--num-slots", "2",
                 "--block-size", "8", "--num-blocks", "32", "--token-budget", "64",
                 "--run-dir", str(run)]) == 0
    jt, pt = topologies(jcost, None)
    pm = layouts.ModelSpec.from_arch(SERVE_MODELS["toy"])
    jm = JaxModelSpec.from_arch(SERVE_MODELS["toy"])
    p = serving.ServeCalibration.from_run_dir(run, pm, pt)
    j = jserv.ServeCalibration.from_run_dir(run, jm, jt)
    assert p is not None and j is not None
    assert p.ticks == j.ticks > 0 and close(p.factor, j.factor)
    (tmp_path / "empty").mkdir()
    assert serving.ServeCalibration.from_run_dir(tmp_path / "empty", pm, pt) is None


def test_prediction_from_env_equals_jax(monkeypatch):
    from scaling_tpu import tune as jtune

    assert tune.PREDICTION_ENV == jtune.PREDICTION_ENV
    for raw in ('{"predicted_step_s": "0.5", "label": "x", "world_size": "1", "junk": 1}',
                '{"label": "x"}', "[1]", "not json", ""):
        monkeypatch.setenv(tune.PREDICTION_ENV, raw)
        assert tune.prediction_from_env() == jtune.prediction_from_env()


# ------------------------------------------------------------ one device
def test_one_device_space_is_the_micro_batch_ladder():
    model = layouts.BENCH_MODELS["0.5b"]
    space = layouts.enumerate_layouts(1, model, 64, 8, mbs_ladder=[4, 16, 32])
    assert [x.micro_batch_size for x in space] == [4, 8, 16, 32]
    assert all(x.validate() is None and x.world == 1 for x in space)
    assert [x.gradient_accumulation_steps for x in space] == [16, 8, 4, 2]
    best, ranked = tune.best_layout("0.5b")
    assert best.world == 1 and len(ranked) == 1
    assert costmodel.SliceTopology(chips=1).peak_tflops == 989.4


def test_more_devices_raise_by_name():
    model = layouts.BENCH_MODELS["0.5b"]
    with pytest.raises(NotImplementedError, match="one device"):
        layouts.enumerate_layouts(2, model, 64, 8)
    with pytest.raises(NotImplementedError, match="one device"):
        tune.best_layout("0.5b", costmodel.SliceTopology(chips=8))
    # the port's topology takes data, model and pipeline parallelism (virtual
    # stages too), not token slices
    piped = layouts.Layout(pp=2, dp=1, cp=1, mp=1, micro_batch_size=8,
                           gradient_accumulation_steps=4)
    assert piped.validate() is None
    assert layouts.Layout(pp=2, dp=2, cp=1, mp=1, micro_batch_size=8,
                          gradient_accumulation_steps=4, vpp=2).validate() is None
    assert "token slices" in layouts.Layout(pp=2, dp=1, cp=1, mp=1, micro_batch_size=8,
                                            gradient_accumulation_steps=4,
                                            token_slices=2).validate()
    assert layouts.Layout(pp=1, dp=2, cp=1, mp=2, micro_batch_size=8,
                          gradient_accumulation_steps=4).validate() is None


@pytest.mark.parametrize("args,message", [
    (["--devices", "2"], "--devices 2"),
    (["--serve", "--devices", "8"], "--devices 8"),
    (["--lower", "2"], "--lower"),
    (["--serve", "--serve-hostsfile", "hosts"], "--serve-hostsfile"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_cli_refuses_what_is_not_ported_by_name(args, message, capsys):
    with pytest.raises(SystemExit) as ei:
        cli.main(args)
    assert ei.value.code == 2 and message in capsys.readouterr().err


# ------------------------------------------------------------ config flow
def test_emitted_config_runs_through_serve_bench(tmp_path, capsys):
    from scaling_tpu_torch.serve.bench import main

    emitted = tmp_path / "serving.json"
    assert cli.main(["--serve", "--emit-config", str(emitted)]) == 0
    cfg = json.loads(emitted.read_text())
    best = capsys.readouterr().out.split("best: ", 1)[1].split(" ", 1)[0]
    assert best == f"mp1·r1·bs{cfg['block_size']}·tb{cfg['token_budget']}"

    def served(*extra):
        out = tmp_path / f"stats{len(extra)}.json"
        assert main(["--device", "cpu", "--model", "toy", "--requests", "3", "--rate", "100",
                     "--prompt-len", "4", "12", "--output-len", "2", "4", "--warmup", "0",
                     "--config", str(emitted), "--json", str(out), *extra]) == 0
        return json.loads(out.read_text())["engine"]

    engine = served()
    for key in ("block_size", "token_budget", "num_slots", "num_blocks"):
        assert engine[key] == cfg[key], key
    engine = served("--num-slots", "2", "--block-size=8")
    assert (engine["num_slots"], engine["block_size"]) == (2, 8)
    assert (engine["token_budget"], engine["num_blocks"]) == (cfg["token_budget"],
                                                              cfg["num_blocks"])


@pytest.mark.parametrize("key", ["mp", "replicas"])
def test_a_config_of_several_devices_fails_by_name(tmp_path, capsys, key):
    from scaling_tpu_torch.serve.bench import main

    path = tmp_path / "serving.json"
    path.write_text(json.dumps({key: 2, "block_size": 16}))
    with pytest.raises(SystemExit) as ei:
        main(["--device", "cpu", "--config", str(path)])
    assert ei.value.code == 2 and f"{key}=2" in capsys.readouterr().err


def test_tuner_prediction_reaches_the_ports_obs_report(tmp_path, monkeypatch, capsys):
    """The CLI's exported prediction, in the environment of a port Trainer
    run with an events file: the trainer logs ``tuner-prediction``, and
    the port's ``obs report`` prints the tuner section with its
    calibration error and gates on it."""
    from scaling_tpu_torch.data import MemoryMapDatasetBuilder
    from scaling_tpu_torch.models.transformer import TransformerConfig
    from scaling_tpu_torch.models.transformer.train import main as train_main
    from scaling_tpu_torch.obs.report import load_run_dir, tuner_section
    from scaling_tpu_torch.obs.cli import main as obs_main
    from scaling_tpu_torch.serve.bench import MODELS as SERVE_MODELS

    assert cli.main(["--mbs-ladder", "2", "--mfu", "0.3"]) == 0
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("export SCALING_TPU_TUNER_PREDICTION=")][0]
    prediction = json.loads(line.split("=", 1)[1].strip("'"))
    assert prediction["source"] == "measured mfu 0.3 (--mfu)"
    monkeypatch.setenv(tune.PREDICTION_ENV, json.dumps(prediction))

    rng = np.random.default_rng(0)
    with MemoryMapDatasetBuilder(tmp_path / "tokens", dtype=np.uint16) as builder:
        for _ in range(20):
            builder.add(np.append(rng.integers(1, 512, size=rng.integers(16, 100)), 0))
    run = tmp_path / "run"
    run.mkdir()
    train_main(TransformerConfig.from_dict({
        "topology": {"micro_batch_size": 2, "gradient_accumulation_steps": 1},
        "transformer_architecture": dict(SERVE_MODELS["toy"], sequence_length=32),
        "trainer": {"train_iterations": 3},
        "data": {"data_prefixes": [str(tmp_path / "tokens")]},
        "logger": {"log_dir": str(run / "logs"), "events_path": str(run / "events.jsonl")},
    }), device="cpu")
    events = [json.loads(x) for x in (run / "events.jsonl").read_text().splitlines()]
    logged = [e for e in events if e.get("event") == "tuner-prediction"]
    assert len(logged) == 1 and logged[0]["predicted_step_s"] == prediction["predicted_step_s"]
    lines, stats = tuner_section(load_run_dir(run))
    assert stats["tuner_predicted_step_s"] == prediction["predicted_step_s"]
    assert "tuner_calibration_error" in stats and lines[0] == "== tuner =="
    capsys.readouterr()
    assert obs_main(["report", str(run), "--assert-tuner-calibration", "1e9"]) == 0
    assert "== tuner ==" in capsys.readouterr().out
    assert obs_main(["report", str(run), "--assert-tuner-calibration", "0"]) == 1


def test_record_events_appends_the_prediction(tmp_path):
    path = tmp_path / "events.jsonl"
    assert cli.main(["--record-events", str(path)]) == 0
    rec = json.loads(path.read_text())
    assert rec["event"] == "tuner-prediction" and rec["world_size"] == 1


# ------------------------------------------------------------ goldens
@pytest.mark.parametrize("serve", [False, True], ids=["train", "serve"])
def test_golden_holds_and_a_seeded_drift_fails(tmp_path, monkeypatch, serve):
    args = (["--serve"] if serve else ["--mbs-ladder", "4,8,16,32"]) + ["--check-golden"]
    assert cli.main(args) == 0
    name = "tune_serve_1dev_0.5b.json" if serve else "tune_1dev_0.5b.json"
    golden = json.loads((cli.GOLDEN_DIR / name).read_text())
    key = "tokens_per_s" if serve else "predicted_step_s"
    golden["ranked"][0][key] *= 1.5
    (tmp_path / name).write_text(json.dumps(golden))
    monkeypatch.setattr(cli, "GOLDEN_DIR", tmp_path)
    monkeypatch.setattr(serving, "GOLDEN_DIR", tmp_path)
    assert cli.main(args) == 1
