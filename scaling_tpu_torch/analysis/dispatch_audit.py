"""Dispatch audit: what one step of a section asks of the device
(counterpart of ``scaling_tpu/analysis/hlo_audit.py``).

PyTorch has no lowered program to read, so the audit runs the section's
step once under a ``TorchDispatchMode`` and records, op by op, what the
JAX audit reads from the StableHLO text:

- ``ops``: the aten op inventory (``aten.mm``: 12, ...);
- ``bf16_to_f32_matmul_upcasts``: matmul-family ops with an operand that
  was cast from bf16 to f32 (directly or through views) — the counterpart
  of ``stablehlo_precision_audit``;
- ``host_syncs``: ``aten._local_scalar_dense`` (``.item()``, ``float()``,
  ``int()``, ``bool()`` on a tensor) and, on the card, the ops whose
  output shape waits on device data (``nonzero``, ``masked_select``,
  ``unique``); ``device_to_host_copies``: copies from a CUDA tensor into
  host memory (none on the CPU);
- ``rng_ops``: random draws;
- ``launches``: the hand-written kernels' launches and their plain
  versions' runs (``ops.launches``) — the counterpart of
  ``_count_pallas_custom_calls``; the kernels are invisible to the
  dispatcher (ctypes and Triton), so their counters say it;
- ``shape_signature``: the counterpart of ``recompile_signature`` — a
  hash over the step's input shapes and the section's static config; for
  ``serve_decode`` also the distinct forward shapes the scheduler
  produced over the section's traffic, which is the number of CUDA graphs
  the tick would need.

Sections run on the CPU at toy widths and are pinned exactly in
``analysis/goldens/``. The library functions (``audit_train_step``,
``audit_engine_tick``, ``record_forward_shapes``) take any step or
engine, and so run the card's own paths.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import weakref
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence

GOLDEN_DIR = Path(__file__).resolve().parent / "goldens"

_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "linear", "dot",
            "mv", "addmv", "_scaled_dot_product_flash_attention",
            "_scaled_dot_product_efficient_attention",
            "_scaled_dot_product_cudnn_attention"}
# ops that carry an upcast operand's values on unchanged
_VIEWS = {"view", "_unsafe_view", "t", "transpose", "permute", "expand", "reshape",
          "contiguous", "clone", "slice", "select", "unsqueeze", "squeeze",
          "as_strided", "alias", "detach", "_reshape_alias", "flatten", "unflatten"}
_RNG = ("rand", "bernoulli", "normal", "uniform", "multinomial", "exponential",
        "randperm", "random_", "poisson", "native_dropout", "cauchy", "geometric",
        "log_normal")
# ops whose output shape waits on device values (a sync on the card)
_DATA_DEPENDENT = {"nonzero", "masked_select", "unique", "_unique", "_unique2",
                   "unique_consecutive", "unique_dim"}


def _op_name(func) -> str:
    """``aten.mm`` for ``aten.mm.default``."""
    packet = func.overloadpacket
    return f"{packet._qualified_op_name.replace('::', '.')}"


def _audit_mode():
    """A dispatch mode that tallies what the ops it sees ask of the device
    (the class is built here: torch is imported only when an audit runs)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Mode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops: Counter = Counter()
            self.matmuls = 0
            self.upcasts = 0
            self.host_syncs = 0
            self.d2h = 0
            self.rng = 0
            # id -> weakref of each tensor cast from bf16 to f32 (or a
            # view of one); tensors compare elementwise, so no set
            self._upcast: Dict[int, weakref.ref] = {}

        def _is_upcast(self, t) -> bool:
            ref = self._upcast.get(id(t))
            return ref is not None and ref() is t

        def _mark(self, t) -> None:
            self._upcast[id(t)] = weakref.ref(t)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = _op_name(func)
            short = name.split(".", 1)[-1]
            self.ops[name] += 1
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
            if short == "_to_copy" and ins and outs:
                src, dst = ins[0], outs[0]
                if src.dtype == torch.bfloat16 and dst.dtype == torch.float32:
                    self._mark(dst)
                if src.device.type == "cuda" and dst.device.type == "cpu":
                    self.d2h += 1
            elif short == "copy_" and len(ins) >= 2:
                if ins[1].device.type == "cuda" and ins[0].device.type == "cpu":
                    self.d2h += 1
            elif short in _VIEWS and ins and self._is_upcast(ins[0]):
                for t in outs:
                    self._mark(t)
            if short in _MATMULS:
                self.matmuls += 1
                if any(self._is_upcast(t) for t in ins):
                    self.upcasts += 1
            if short == "_local_scalar_dense":
                self.host_syncs += 1
            elif short in _DATA_DEPENDENT and ins and ins[0].device.type == "cuda":
                self.host_syncs += 1
            if any(r in short for r in _RNG):
                self.rng += 1
            return out

    return Mode()


@contextlib.contextmanager
def audited() -> Iterator[dict]:
    """Run the block under the dispatch mode; the yielded dict is filled
    with the report's op fields and the launches made inside the block
    when it exits."""
    from ..ops import launches

    kernel0 = launches.snapshot(launches.KERNEL)
    plain0 = launches.snapshot(launches.PLAIN)
    mode = _audit_mode()
    report: dict = {}
    with mode:
        yield report
    kernel = Counter(launches.snapshot(launches.KERNEL))
    kernel.subtract(kernel0)
    plain = Counter(launches.snapshot(launches.PLAIN))
    plain.subtract(plain0)
    report.update({
        "ops": dict(sorted(mode.ops.items())),
        "op_count": sum(mode.ops.values()),
        "matmul_ops": mode.matmuls,
        "bf16_to_f32_matmul_upcasts": mode.upcasts,
        "host_syncs": mode.host_syncs,
        "device_to_host_copies": mode.d2h,
        "rng_ops": mode.rng,
        "launches": {"kernel": {k: v for k, v in sorted(kernel.items()) if v},
                     "plain": {k: v for k, v in sorted(plain.items()) if v}},
    })


def shape_signature(inputs: Dict[str, object], static: dict) -> dict:
    """The counterpart of ``recompile_signature``: a hash over the input
    leaves' shapes and dtypes plus the section's static config."""
    leaves = {k: [list(getattr(v, "shape", ())), str(getattr(v, "dtype", type(v).__name__))]
              for k, v in sorted(inputs.items())}
    blob = json.dumps({"leaves": leaves, "static": static}, sort_keys=True)
    return {"hash": "sha256:" + hashlib.sha256(blob.encode()).hexdigest()[:16],
            "leaves": len(leaves), "static": static}


# ------------------------------------------------------------ library
def audit_train_step(step: Callable, batch: Dict[str, object], *args,
                     static: Optional[dict] = None) -> dict:
    """One call of a train step (``ParallelModule.build_train_step``'s)
    under the audit."""
    with audited() as report:
        step(batch, *args)
    report["shape_signature"] = shape_signature(batch, dict(static or {"kind": "train_step"}))
    return report


@contextlib.contextmanager
def record_forward_shapes(engine) -> Iterator[set]:
    """The forward shapes ``engine`` runs inside the block: ``("mixed",
    rows, width, sample_width)`` for each paged forward (the mixed tick,
    the separate chunk and decode forwards) and ``("bucket", n)`` for each
    whole-prompt prefill bucket."""
    shapes: set = set()
    inner = engine._forward_mixed
    own = engine.__dict__.get("_forward_mixed")  # a wrapper already installed
    before = set(engine._prefill_shapes)

    def forward(inp, sample_width=None):
        rows, width = inp.tokens.shape
        sw = engine.config.sample_width if sample_width is None else sample_width
        shapes.add(("mixed", int(rows), int(width), int(sw)))
        return inner(inp) if sample_width is None else inner(inp, sample_width)

    engine._forward_mixed = forward
    try:
        yield shapes
    finally:
        if own is None:
            del engine._forward_mixed  # the bound method again
        else:
            engine._forward_mixed = own
        shapes.update(s for s in engine._prefill_shapes - before if s[0] == "bucket")


def audit_engine_tick(engine) -> dict:
    """One ``engine.tick()`` under the audit."""
    with audited() as report:
        engine.tick()
    cfg = engine.config
    report["shape_signature"] = shape_signature({}, {
        "kind": "serve_tick", "num_slots": cfg.num_slots, "block_size": cfg.block_size,
        "max_blocks_per_seq": cfg.max_blocks_per_seq, "kv_dtype": cfg.kv_dtype,
        "prefill_chunk": cfg.prefill_chunk, "spec_k": cfg.spec_k,
        "mixed_width": cfg.mixed_width, "sample_width": cfg.sample_width,
        "fused": cfg.fused,
    })
    return report


# ------------------------------------------------------------ sections
def audit_train_section(device: str = "cuda", seq: int = 128, mbs: int = 2) -> dict:
    """One optimizer step of the train bench's toy model (bf16, fused
    RMSNorm, flash attention, 2 layers), after one unaudited step (the
    optimizer's state exists from then on, as on every later step)."""
    import numpy as np

    from .. import resolve_device
    from ..models.transformer import loss_function
    from ..nn.base_layer import dropout_key
    from ..train.bench import build, synth_batch

    dev = resolve_device(device)
    config, module, optimizer = build("toy", seq, mbs, device=dev, seed=0)
    step = module.build_train_step(optimizer, loss_function)
    batch = synth_batch(np.random.default_rng(0), mbs, seq,
                        config.transformer_architecture.vocab_size, 1, dev)
    step(batch, dropout_key(0, 0))
    arch = config.transformer_architecture
    return audit_train_step(step, batch, dropout_key(0, 1), static={
        "kind": "train_step", "layers": arch.num_layers, "hidden": arch.hidden_size,
        "seq": seq, "mbs": mbs, "precision": str(arch.precision),
    })


def audit_decode_section(device: str = "cuda", prompt_len: int = 4,
                         max_tokens: int = 10) -> dict:
    """``generate`` with the fused decode (done checked every
    ``DONE_CHECK_EVERY`` = 8 steps) on the serving toy, 10 tokens so one
    check falls inside: a per-step sync sneaking into the decode loop
    shows as host syncs here."""
    import torch

    from ..serve.bench import build_inference

    inf = build_inference("toy", seed=0, device=device)
    prompt = torch.arange(1, prompt_len + 1, dtype=torch.int64)[None]
    with audited() as report:
        inf.generate(prompt, max_tokens=max_tokens, fused_decode=True)
    report["shape_signature"] = shape_signature({"prompt": prompt}, {
        "kind": "fused_decode", "prompt_len": prompt_len, "max_tokens": max_tokens})
    return report


def audit_serve_decode_section(device: str = "cuda") -> dict:
    """The serving engine's mixed tick on the toy: three requests (prompts
    of 5, 9 and 3 tokens, 4 new tokens each) through 2 slots; the fourth
    tick (decode and prefill-chunk rows together) is audited, and the
    forward shapes of every tick over the traffic are recorded."""
    from ..serve.bench import build_inference
    from ..serve.engine import EngineConfig, ServeEngine

    engine = ServeEngine(build_inference("toy", seed=0, device=device), EngineConfig(
        num_slots=2, block_size=4, num_blocks=9, max_blocks_per_seq=4, token_budget=64,
        prefill_chunk=8, spec_k=3), device=device)
    for i, (plen, new) in enumerate(((5, 4), (9, 4), (3, 4))):
        engine.submit([1 + (7 * i + j) % 500 for j in range(plen)], new)
    report = None
    with record_forward_shapes(engine) as shapes:
        for t in range(64):
            if not engine.scheduler.has_work:
                break
            if t == 3:
                report = audit_engine_tick(engine)
            else:
                engine.tick()
    report["forward_shapes"] = sorted(list(s) for s in shapes)
    report["distinct_forward_shapes"] = len(shapes)
    return report


SECTIONS = {
    "train_single": audit_train_section,
    "decode_fused": audit_decode_section,
    "serve_decode": audit_serve_decode_section,
}


def run_audit(sections: Optional[Sequence[str]] = None, device: str = "cuda") -> dict:
    names = list(sections) if sections else list(SECTIONS)
    unknown = [n for n in names if n not in SECTIONS]
    if unknown:
        raise ValueError(f"unknown audit sections {unknown}; have {list(SECTIONS)}")
    return {name: SECTIONS[name](device=device) for name in names}


def format_report(report: dict) -> List[str]:
    """The human lines ``analysis audit`` prints for one section."""
    top = sorted(report["ops"].items(), key=lambda kv: (-kv[1], kv[0]))[:8]
    lines = [
        f"ops={report['op_count']} ({len(report['ops'])} kinds; top "
        + ", ".join(f"{k}={v}" for k, v in top) + ")",
        f"matmuls={report['matmul_ops']} bf16->f32 matmul upcasts="
        f"{report['bf16_to_f32_matmul_upcasts']} host syncs={report['host_syncs']} "
        f"device->host copies={report['device_to_host_copies']} rng ops={report['rng_ops']}",
        f"launches kernel={report['launches']['kernel']} plain={report['launches']['plain']}",
        f"shape signature {report['shape_signature']['hash']} "
        f"({report['shape_signature']['leaves']} leaves)",
    ]
    if "forward_shapes" in report:
        lines.append(f"forward shapes over the traffic: {report['distinct_forward_shapes']} "
                     f"{report['forward_shapes']}")
    return lines


# ------------------------------------------------------------ goldens
def golden_path(name: str, golden_dir: Optional[Path] = None) -> Path:
    return (golden_dir or GOLDEN_DIR) / f"{name}.json"


def compare_to_golden(name: str, report: dict,
                      golden_dir: Optional[Path] = None) -> List[str]:
    """Drift lines (empty == clean). Every field compares exactly: the
    CPU's dispatch is deterministic for a fixed torch."""
    path = golden_path(name, golden_dir)
    if not path.is_file():
        return [f"{name}: no golden at {path} (run audit --repin)"]
    golden = json.loads(path.read_text())
    drift: List[str] = []
    for field in sorted(set(golden) | set(report)):
        g, c = golden.get(field), report.get(field)
        if field == "ops" and isinstance(g, dict) and isinstance(c, dict):
            for op in sorted(set(g) | set(c)):
                if g.get(op) != c.get(op):
                    drift.append(f"{name}.ops.{op}: golden {g.get(op)} != current {c.get(op)}")
        elif g != c:
            drift.append(f"{name}.{field}: golden {g!r} != current {c!r}")
    return drift


def write_golden(name: str, report: dict, golden_dir: Optional[Path] = None) -> Path:
    path = golden_path(name, golden_dir)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=1, sort_keys=True) + "\n")
    return path
