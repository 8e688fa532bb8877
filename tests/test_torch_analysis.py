"""The port's static analysis (``scaling_tpu_torch.analysis``) against the
JAX package's: the same findings on JAX's lint fixtures for every rule
whose subject is not JAX, the re-aimed rules (STA003, STA004, STA006,
STA010) firing on torch fixtures written here, the clean-tree gate over
``scaling_tpu_torch/`` (one shared ``analysis all`` run), the protocol
and dispatch-audit goldens and a seeded drift failing each, and the
faults the gate found in the port, each repaired with a test that fails
without the repair."""

import json
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from scaling_tpu_torch.analysis import dispatch_audit
from scaling_tpu_torch.analysis.lint import RULES, lint_paths, parse_suppressions
from .test_torch_parity_helpers import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "core" / "test_analysis" / "fixtures"

# rules whose subject is not JAX: both packages' analyzers must agree
AGNOSTIC = ("STA005", "STA007", "STA009", "STA011", "STA012", "STA013", "STA014",
            "STA015", "STA016")
# rules re-aimed at PyTorch (or with no eager counterpart)
REAIMED = {"STA001", "STA002", "STA003", "STA004", "STA006", "STA008", "STA010"}


@pytest.fixture(scope="module")
def both_lints_on_jax_fixtures():
    from scaling_tpu.analysis.lint import lint_paths as jax_lint_paths

    return jax_lint_paths([FIXTURES], root=REPO), lint_paths([FIXTURES], root=REPO)


def _keyed(findings, rule):
    out = set()
    for f in findings:
        if f.rule != rule:
            continue
        if rule == "STA015":
            # a disable naming only re-aimed rules is live for JAX's
            # analyzer and stale for the port's, by design
            rules = parse_suppressions((REPO / f.path).read_text()).get(f.line)
            if rules and rules <= REAIMED:
                continue
        out.add((f.path, f.line, f.rule, f.suppressed))
    return out


@pytest.mark.parametrize("rule", AGNOSTIC)
def test_port_lint_equals_jax_lint_on_jax_fixtures(both_lints_on_jax_fixtures, rule):
    jax_findings, port_findings = both_lints_on_jax_fixtures
    want = _keyed(jax_findings, rule)
    assert want, f"JAX's fixtures seed no {rule}"
    assert _keyed(port_findings, rule) == want


def test_rules_without_an_eager_counterpart_never_fire_but_stay_listed(
        both_lints_on_jax_fixtures):
    _, port = both_lints_on_jax_fixtures
    for rule in ("STA001", "STA002", "STA008"):
        assert rule in RULES and "never fires" in RULES[rule][1]
        assert not [f for f in port if f.rule == rule]


# ----------------------------------------------------------- torch fixtures
TORCH_FIXTURES = {
    "ops/wrappers.py": '''
        import torch
        from . import launches


        def kernel_wrapper(q, out, sm_scale, scale_k=None):
            quantized = scale_k is not None
            n = int(q.shape[0])
            total = q.sum().item()
            launches.add(launches.KERNEL, "k")
            return out, float(sm_scale), int(quantized), n, total


        def clean_wrapper(q, out, eps):
            launches.add(launches.KERNEL, "k")
            return q.data_ptr() % 16, float(eps), int(q.size(0))


        def plain_version(q):
            launches.add(launches.PLAIN, "k")
            return q.sum().item()


        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return float(x.sum())

            @staticmethod
            def backward(ctx, g):
                torch.cuda.synchronize()
                return g.tolist()
    ''',
    "nn/drops.py": '''
        import torch


        def reused(shape, seed):
            g = torch.Generator()
            g.manual_seed(seed)
            a = torch.rand(shape, generator=g)
            b = torch.rand(shape, generator=g)
            return a, b


        def reseeded(shape, seed):
            g = torch.Generator()
            g.manual_seed(seed)
            a = torch.rand(shape, generator=g)
            g.manual_seed(seed + 1)
            b = torch.rand(shape, generator=g)
            return a, b


        def same_seed_twice(shape, key):
            g = torch.Generator()
            g.manual_seed(site_seed(key, "attn"))
            a = torch.rand(shape, generator=g)
            h = torch.Generator()
            h.manual_seed(site_seed(key, "attn"))
            return a, torch.rand(shape, generator=h)


        def one_branch_each(shape, g, flag):
            if flag:
                return torch.rand(shape, generator=g)
            else:
                return torch.randn(shape, generator=g)
    ''',
    "nn/dtypes.py": '''
        import torch


        def f(x):
            y = x.to(torch.float16)
            z = torch.zeros(3, dtype=torch.float64)
            return y.double(), z, x.to(torch.bfloat16)
    ''',
    "models/dtypes_elsewhere.py": '''
        import torch

        HALF = torch.float16
    ''',
    "serve/engine.py": '''
        import numpy as np
        import torch


        class ServeEngine:
            def tick(self):
                logits = self._forward()
                self._land(logits)
                n = int(logits.shape[0])
                host = logits.cpu().numpy()  # sta: disable=STA010
                return n, int(host[0])

            def _forward(self):
                return torch.zeros(4)

            def _land(self, logits):
                torch.cuda.synchronize()
                first = logits.max().item()
                probs = torch.softmax(logits, 0)
                ids = probs.argmax().tolist()
                count = int(probs.sum())
                moved = logits.to("cpu")
                return first, ids, count, moved, [1, 2].copy(), np.zeros(2).tolist()
    ''',
}

EXPECTED_TORCH = {
    ("ops/wrappers.py", 8, "STA003"),    # .item() in a kernel wrapper
    ("ops/wrappers.py", 26, "STA003"),   # float() on a tensor in forward
    ("ops/wrappers.py", 30, "STA003"),   # torch.cuda.synchronize in backward
    ("ops/wrappers.py", 31, "STA003"),   # .tolist() on a tensor in backward
    ("nn/drops.py", 8, "STA004"),        # generator g drawn twice
    ("nn/drops.py", 26, "STA004"),       # one seed expression seeded twice
    ("nn/dtypes.py", 5, "STA006"),       # torch.float16
    ("nn/dtypes.py", 6, "STA006"),       # torch.float64
    ("nn/dtypes.py", 7, "STA006"),       # .double()
    ("serve/engine.py", 17, "STA010"),   # torch.cuda.synchronize under the tick
    ("serve/engine.py", 18, "STA010"),   # .item()
    ("serve/engine.py", 20, "STA010"),   # .tolist() on a device value
    ("serve/engine.py", 21, "STA010"),   # int() on a device value
    ("serve/engine.py", 22, "STA010"),   # .to("cpu")
}


def test_reaimed_rules_fire_on_torch_fixtures(tmp_path):
    for rel, src in TORCH_FIXTURES.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src).lstrip("\n"))
    findings = lint_paths([tmp_path], root=tmp_path)
    got = {(f.path, f.line, f.rule) for f in findings
           if f.rule in ("STA003", "STA004", "STA006", "STA010") and not f.suppressed}
    assert got == EXPECTED_TORCH
    # the deliberate pull, suppressed, still reported; no stale annotation
    assert [(f.path, f.line, f.rule) for f in findings if f.suppressed] == [
        ("serve/engine.py", 10, "STA010")]
    assert not [f for f in findings if f.rule == "STA015"]


def test_dropout_sites_draw_once_per_seed_and_a_second_draw_fires(tmp_path):
    """``nn/base_layer.py``'s mask source seeds one generator a draw from
    ``site_seed(key, site)``: clean. A second draw from that generator,
    seeded into a copy, fires STA004 at its line."""
    src = (REPO / "scaling_tpu_torch" / "nn" / "base_layer.py").read_text()
    (tmp_path / "nn").mkdir()
    (tmp_path / "nn" / "base_layer.py").write_text(src)
    assert not [f for f in lint_paths([tmp_path], root=tmp_path, program=False)
                if f.rule == "STA004"]
    anchor = "    return torch.rand(tuple(shape), generator=gen, device=device) < keep\n"
    assert anchor in src
    doctored = src.replace(anchor, "    again = torch.rand(tuple(shape), generator=gen, "
                           "device=device)\n" + anchor)
    (tmp_path / "nn" / "base_layer.py").write_text(doctored)
    line = doctored.splitlines().index(anchor.rstrip("\n")) + 1
    hits = [f for f in lint_paths([tmp_path], root=tmp_path, program=False)
            if f.rule == "STA004"]
    assert [(f.line, f.suppressed) for f in hits] == [(line, False)]


# ----------------------------------------------------------- the clean tree
@pytest.fixture(scope="module")
def gate_run(tmp_path_factory):
    """ONE ``python -m scaling_tpu_torch.analysis all --json`` over the
    port's tree (lint, protocol, audit), shared by the gate tests."""
    from scaling_tpu_torch.analysis.cli import main

    out = tmp_path_factory.mktemp("gate") / "report.json"
    rc = main(["all", "--device", "cpu", "--json", str(out)])
    return rc, json.loads(out.read_text())


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_the_audit_asks_for_the_card_unless_told_cpu():
    """Without ``--device`` the audit runs on the card, as every entry point
    of the port does: without one it raises through ``resolve_device``."""
    from scaling_tpu_torch.analysis.cli import main

    with pytest.raises(RuntimeError, match="CUDA device"):
        main(["audit", "--sections", "train_single"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        dispatch_audit.run_audit(["train_single"])


def test_the_ported_tree_passes_its_gate(gate_run):
    rc, payload = gate_run
    assert rc == 0 and payload["exit_code"] == 0 and payload["schema_version"] == 3
    lint = payload["lint"]
    assert lint["unsuppressed"] == 0
    assert [r["rule"] for r in lint["rules"]] == sorted(RULES)
    by_rule = {r["rule"]: r for r in lint["rules"]}
    for rule in ("STA001", "STA002", "STA008"):
        assert by_rule[rule]["findings"] == 0
    # every suppression is live: the stale-annotation rule finds nothing
    assert by_rule["STA015"]["findings"] == 0
    # the deliberate syncs of the step and the tick are suppressed, with
    # their reasons on the lines above, and nothing else syncs there
    syncs = {(f["path"], f["line"]) for f in lint["findings"] if f["rule"] == "STA010"}
    files = {p for p, _ in syncs}
    assert files == {"scaling_tpu_torch/trainer/trainer.py",
                     "scaling_tpu_torch/serve/engine.py", "scaling_tpu_torch/obs/spans.py",
                     "scaling_tpu_torch/parallel/collectives.py"}
    assert payload["protocol"]["drift"] == [] and payload["audit"]["drift"] == []


def test_protocol_golden_drift_fails(gate_run, tmp_path):
    from scaling_tpu_torch.analysis.protocol import compare_inventory

    inv = gate_run[1]["protocol"]["inventory"]
    golden = json.loads((REPO / "scaling_tpu_torch" / "analysis" / "goldens"
                         / "protocol.json").read_text())
    assert compare_inventory(inv) == []
    ops = golden["rpc"]["scaling_tpu_torch.serve.replica_proc"]["ops"]
    ops.pop("drain")
    (tmp_path / "protocol.json").write_text(json.dumps(golden))
    drift = compare_inventory(inv, tmp_path)
    assert drift and any("drain" in line for line in drift)


@pytest.mark.parametrize("section", sorted(dispatch_audit.SECTIONS))
def test_audit_golden_holds_and_a_seeded_drift_fails(gate_run, tmp_path, section):
    report = gate_run[1]["audit"]["sections"][section]
    assert dispatch_audit.compare_to_golden(section, report) == []
    golden = json.loads(dispatch_audit.golden_path(section).read_text())
    golden["host_syncs"] += 1
    golden["ops"]["aten.mm"] = golden["ops"].get("aten.mm", 0) + 1
    dispatch_audit.write_golden(section, golden, tmp_path)
    drift = dispatch_audit.compare_to_golden(section, report, tmp_path)
    assert any(".host_syncs" in d for d in drift) and any("aten.mm" in d for d in drift)


def test_audit_counts_what_the_sections_run(gate_run):
    sections = gate_run[1]["audit"]["sections"]
    train, tick, decode = (sections["train_single"], sections["serve_decode"],
                           sections["decode_fused"])
    layers = 2  # the toy's
    # on the CPU the wrappers run their plain versions, as often as the
    # card launches the kernels: K2 and K3 2L+1, K4 and K5 L a step
    assert train["launches"] == {"kernel": {}, "plain": {
        "flash_attention_bwd": layers, "flash_attention_fwd": layers,
        "rms_norm": 2 * layers + 1, "rms_norm_bwd": 2 * layers + 1}}
    assert train["host_syncs"] == 0 and train["rng_ops"] == 0
    assert tick["launches"]["plain"] == {"paged_attention": layers, "rms_norm": 2 * layers + 1}
    assert tick["distinct_forward_shapes"] == 1 and tick["forward_shapes"] == [["mixed", 2, 8, 4]]
    # the fused decode checks its rows every 8 steps: one host sync in 10 tokens
    assert decode["host_syncs"] == 1


# --------------------------------------------- faults the gate found, repaired
def _fail_once(monkeypatch, method: str, name: str):
    """Make ``Path.<method>`` raise OSError once for a file named ``name``."""
    orig = getattr(Path, method)
    state = {"failed": 0}

    def flaky(self, *a, **k):
        if self.name == name and not state["failed"]:
            state["failed"] += 1
            raise OSError(f"transient failure of {name}")
        return orig(self, *a, **k)

    monkeypatch.setattr(Path, method, flaky)
    return state


def test_latest_pointer_read_is_retried(tmp_path, monkeypatch):
    """The ``latest`` read in ``checkpoint_candidates`` rides ``retry_io``
    as the JAX package's ``restore.checkpoint_candidates`` does: a
    transient failure no longer skips the pointer (or raises)."""
    from scaling_tpu_torch.resilience.commit import checkpoint_candidates

    for step in (3, 6):
        (tmp_path / f"global_step{step}").mkdir()
    (tmp_path / "latest").write_text("global_step3")
    state = _fail_once(monkeypatch, "read_text", "latest")
    assert checkpoint_candidates(tmp_path)[0] == tmp_path / "global_step3"
    assert state["failed"] == 1


def test_pruned_manifest_rewrite_is_retried(tmp_path, monkeypatch):
    """``prune_manifest_entries`` rewrites MANIFEST.json through
    ``retry_io`` as JAX's does: a transient write failure leaves the
    pruned manifest, not an exception in the save path."""
    from scaling_tpu_torch.resilience.manifest import (
        MANIFEST_NAME,
        prune_manifest_entries,
        read_manifest,
        write_manifest,
    )

    step_dir = tmp_path / "global_step2"
    step_dir.mkdir()
    for name in ("model.npz", "optimizer.npz"):
        (step_dir / name).write_bytes(b"x" * 16)
    write_manifest(step_dir, 2)
    assert set(read_manifest(step_dir)["files"]) == {"model.npz", "optimizer.npz"}
    state = _fail_once(monkeypatch, "write_text", MANIFEST_NAME)
    prune_manifest_entries(step_dir, ["optimizer.npz"])
    assert state["failed"] == 1
    manifest = read_manifest(step_dir)
    assert set(manifest["files"]) == {"model.npz"} and manifest["optimizer_pruned"]


def test_serve_bench_stats_write_is_retried(tmp_path, monkeypatch, one_torch_thread):
    """``serve bench --json`` writes its stats through ``retry_io`` as the
    JAX bench does."""
    from scaling_tpu_torch.serve.bench import main

    out = tmp_path / "stats.json"
    state = _fail_once(monkeypatch, "write_text", out.name)
    rc = main(["--device", "cpu", "--model", "toy", "--requests", "2", "--rate", "100",
               "--prompt-len", "3", "5", "--output-len", "2", "3", "--warmup", "0",
               "--json", str(out)])
    assert rc == 0 and state["failed"] == 1
    assert json.loads(out.read_text())["completed"] == 2


def test_a_second_initialize_stops_the_running_prefetch_worker(tmp_path, one_torch_thread):
    """``dataloader`` is lock-free by design (``# sta: lock(dataloader)``):
    it is published to the prefetch worker by the thread's start and must
    not be replaced while the worker reads it. A second ``initialize``
    rebuilt the loaders under a live worker; it now stops the worker
    first, and the new worker serves the rebuilt loader."""
    from scaling_tpu_torch.data import MemoryMapDatasetBuilder
    from scaling_tpu_torch.models.transformer import TransformerConfig
    from scaling_tpu_torch.models.transformer.train import build_trainer
    from scaling_tpu_torch.serve.bench import MODELS

    rng = np.random.default_rng(0)
    with MemoryMapDatasetBuilder(tmp_path / "tokens", dtype=np.uint16) as builder:
        for _ in range(20):
            builder.add(np.append(rng.integers(1, 512, size=rng.integers(16, 100)), 0))
    config = TransformerConfig.from_dict({
        "topology": {"micro_batch_size": 2, "gradient_accumulation_steps": 1},
        "transformer_architecture": dict(MODELS["toy"], sequence_length=32),
        "trainer": {"train_iterations": 2, "dataloader_prefetch_factor": 2},
        "data": {"data_prefixes": [str(tmp_path / "tokens")]},
        "logger": {"log_dir": str(tmp_path / "logs")}})
    trainer = build_trainer(config, device="cpu")
    try:
        first = trainer._prefetch_thread
        assert first is not None and first.is_alive()
        trainer.initialize(load_checkpoint=False)
        assert not first.is_alive()
        assert trainer._prefetch_thread is not first and trainer._prefetch_thread.is_alive()
        trainer.run_training()
        assert trainer.context.iterations == 2
    finally:
        trainer.stop_prefetch()
