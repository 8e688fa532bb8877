"""The port's Determined glue (``scaling_tpu_torch.determined``) against the
JAX package's: a fake ``determined`` SDK records every call each glue
makes, both glues are driven through the same hook calls on a stub
trainer (the JAX glue is not driven through a JAX training run), and the
recorded SDK calls are equal. Then a port Trainer run under the fake SDK
reports its metrics, uploads its checkpoint and stops at the preemption
step, and a second run restores the experiment's latest checkpoint, which
wins over ``load_dir``. Without the SDK (as on the card's machine)
``detect()`` returns None in both packages."""

import contextlib
import signal
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from .test_torch_parity_helpers import one_torch_thread  # noqa: F401


def fake_sdk(restore_dir=None, preempt_at=None, latest="ckpt-uuid"):
    """A ``determined`` module whose calls land in ``sdk.calls``."""
    sdk = types.ModuleType("determined")
    sdk.calls = []
    polls = {"n": 0}

    class Preempt:
        def should_preempt(self):
            polls["n"] += 1
            sdk.calls.append(("should_preempt",))
            return preempt_at is not None and polls["n"] >= preempt_at

    class Train:
        def report_training_metrics(self, steps_completed, metrics):
            sdk.calls.append(("report", steps_completed, sorted(metrics.items())))

    class Checkpoint:
        def upload(self, path, metadata, **kw):
            sdk.calls.append(("upload", Path(path).name, metadata, sorted(kw.items())))

        @contextlib.contextmanager
        def restore_path(self, storage_id):
            sdk.calls.append(("restore_path", storage_id))
            yield restore_dir

    class Context:
        preempt, train, checkpoint = Preempt(), Train(), Checkpoint()

        def __enter__(self):
            sdk.calls.append(("enter",))
            return self

        def __exit__(self, *exc):
            sdk.calls.append(("exit",))

    sdk.get_cluster_info = lambda: types.SimpleNamespace(latest_checkpoint=latest)
    sdk.core = types.SimpleNamespace(init=lambda: Context())
    return sdk


class StubTrainer:
    def __init__(self):
        self.external_preemption = None
        self.metrics_hooks = []
        self.checkpoint_hooks = []


def drive(glue_cls, sdk, monkeypatch):
    """One glue through detect, attach and every hook the trainer calls."""
    monkeypatch.setitem(sys.modules, "determined", sdk)
    glue = glue_cls.detect()
    trainer = StubTrainer()
    glue.attach(trainer)
    polls = [trainer.external_preemption() for _ in range(3)]
    metrics = {"loss": 2.5, "step_duration": np.float32(0.125), "lr": np.float64(3e-4),
               "vector": np.ones(3), "name": "toy", "count": 7}
    for step in (1, 2):
        for hook in trainer.metrics_hooks:
            hook(metrics, step)
    for hook in trainer.checkpoint_hooks:
        hook(Path("/ckpt/global_step2"), 2)
    with glue.latest_checkpoint() as path:
        restored = path
    glue.close()
    return polls, restored, list(sdk.calls)


def test_both_glues_make_the_same_sdk_calls(monkeypatch, tmp_path):
    from scaling_tpu.determined import DeterminedGlue as JaxGlue
    from scaling_tpu_torch.determined import DeterminedGlue as PortGlue

    got = drive(PortGlue, fake_sdk(tmp_path, preempt_at=2), monkeypatch)
    want = drive(JaxGlue, fake_sdk(tmp_path, preempt_at=2), monkeypatch)
    assert got == want
    polls, restored, calls = got
    assert polls == [False, True, True] and restored == tmp_path
    assert ("upload", "global_step2", {"steps_completed": 2}, []) in calls
    assert calls.count(("exit",)) == 1
    reports = [c for c in calls if c[0] == "report"]
    assert [r[1] for r in reports] == [1, 2]
    assert dict(reports[0][2]) == {"loss": 2.5, "step_duration": 0.125,
                                   "lr": pytest.approx(3e-4), "count": 7.0}


def test_sdk_failures_never_abort_training(monkeypatch):
    """A broken master is logged and survived in both packages alike."""
    from scaling_tpu.determined import DeterminedGlue as JaxGlue
    from scaling_tpu_torch.determined import DeterminedGlue as PortGlue

    for glue_cls in (PortGlue, JaxGlue):
        sdk = fake_sdk()

        def boom(*a, **k):
            raise RuntimeError("master unreachable")

        sdk.core.init().preempt.should_preempt = boom
        ctx = sdk.core.init()
        type(ctx).train.report_training_metrics = boom
        type(ctx).checkpoint.upload = boom
        monkeypatch.setitem(sys.modules, "determined", sdk)
        glue = glue_cls.detect()
        assert glue.should_preempt() is False
        glue.report_metrics({"loss": 1.0}, 1)
        glue.upload_checkpoint("/x", 1)


@pytest.mark.parametrize("case", ["no_sdk", "no_cluster", "init_fails"])
def test_detect_returns_none_off_cluster_as_in_jax(monkeypatch, case):
    from scaling_tpu.determined import DeterminedGlue as JaxGlue
    from scaling_tpu_torch.determined import DeterminedGlue as PortGlue

    if case == "no_sdk":
        monkeypatch.setitem(sys.modules, "determined", None)
    else:
        sdk = fake_sdk()
        if case == "no_cluster":
            sdk.get_cluster_info = lambda: None
        else:
            def boom():
                raise RuntimeError("no master")
            sdk.core = types.SimpleNamespace(init=boom)
        monkeypatch.setitem(sys.modules, "determined", sdk)
    assert PortGlue.detect() is None and JaxGlue.detect() is None


def token_data(root: Path) -> str:
    from scaling_tpu_torch.data import MemoryMapDatasetBuilder

    rng = np.random.default_rng(0)
    with MemoryMapDatasetBuilder(root / "tokens", dtype=np.uint16) as builder:
        for _ in range(30):
            builder.add(np.append(rng.integers(1, 512, size=rng.integers(16, 100)), 0))
    return str(root / "tokens")


def config(root: Path, prefix: str, **trainer):
    from scaling_tpu_torch.models.transformer import TransformerConfig
    from scaling_tpu_torch.serve.bench import MODELS

    return TransformerConfig.from_dict({
        "topology": {"micro_batch_size": 2, "gradient_accumulation_steps": 1},
        "transformer_architecture": dict(MODELS["toy"], sequence_length=32),
        "trainer": {"train_iterations": 6, "save_dir": str(root / "ckpt"), **trainer},
        "data": {"data_prefixes": [prefix]},
        "logger": {"log_dir": str(root / "logs")},
        "determined_experiment_id": 17, "determined_trial_id": 3,
    })


def test_a_port_trainer_run_reports_uploads_and_stops_at_preemption(monkeypatch, tmp_path,
                                                                     one_torch_thread):
    from scaling_tpu_torch.models.transformer.train import main

    prefix = token_data(tmp_path)
    cfg = config(tmp_path, prefix)
    assert (cfg.determined_experiment_id, cfg.determined_trial_id) == (17, 3)
    sdk = fake_sdk(preempt_at=3, latest=None)
    monkeypatch.setitem(sys.modules, "determined", sdk)
    handler = signal.getsignal(signal.SIGTERM)
    try:
        trainer = main(cfg, device="cpu")
    finally:
        signal.signal(signal.SIGTERM, handler)
    assert trainer.context.iterations == 3  # polled after each step: preempted at 3
    reports = [c for c in sdk.calls if c[0] == "report"]
    assert [r[1] for r in reports] == [1, 2, 3]
    assert all(np.isfinite(dict(r[2])["loss"]) for r in reports)
    uploads = [c for c in sdk.calls if c[0] == "upload"]
    assert uploads == [("upload", "global_step3", {"steps_completed": 3}, [])]
    assert (tmp_path / "ckpt" / "global_step3").is_dir()
    assert sdk.calls[0] == ("enter",) and sdk.calls[-1] == ("exit",)

    # the restart: the experiment's latest checkpoint wins over load_dir
    other = tmp_path / "other"
    other.mkdir()
    sdk2 = fake_sdk(restore_dir=tmp_path / "ckpt" / "global_step3")
    monkeypatch.setitem(sys.modules, "determined", sdk2)
    resumed = main(config(tmp_path / "second", prefix, load_dir=str(other)), device="cpu")
    assert ("restore_path", "ckpt-uuid") in sdk2.calls
    assert resumed.context.iterations == 6
    assert [c[1] for c in sdk2.calls if c[0] == "report"] == [4, 5, 6]
    assert torch.isfinite(torch.tensor(dict(
        [c for c in sdk2.calls if c[0] == "report"][-1][2])["loss"]))
