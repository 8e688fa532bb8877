"""Checkpoints in the JAX package's on-disk layout (counterpart of
scaling_tpu/checkpoint/checkpoint.py, npz backend, written synchronously).

- one ``model_state_layer_{i}_{Class}.npz`` per layer, its entries the
  JAX parameter names (``attention.query.weight``);
- one ``optimizer_state_layer_{i}.npz`` per layer with
  ``{master,exp_avg,exp_avg_sq}.{name}`` entries, and
  ``optimizer_state.json`` with the step and the loss scaler's state. The
  loader also reads the older layout of one
  ``optimizer_state_layer_{i}_{field}.npz`` per layer and field, keyed by
  the bare parameter name, as the JAX loader does;
- matrices in the JAX layout, ``(in, out)``: the port's linears are
  transposed on the way out and back (``transposed_in_jax``; the
  embedding table is the same on both sides);
- bf16 stored as float32, a lossless widening; the loader casts back;
- a frozen parameter (no optimizer state) has ``(0,)`` float32
  placeholders in the optimizer files, as the JAX optimizer keeps them.

Parameters are matched by their JAX key (``layer_{i}_{Class}.{name}``,
``ParallelModule.ckpt_keys``), so a checkpoint of either package loads
in the other. Non-strict loading follows ``enforce_allow_lists``.
"""

from __future__ import annotations

import io
import json
import os
import re
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Set, Tuple, Union

import numpy as np
import torch

from ..optimizer import Optimizer
from ..parallel.parallel_module import transposed_in_jax
from ..resilience.guards import retry_io
from ..resilience.manifest import crc32_bytes

PathLike = Union[Path, str]
Recorder = Callable[[Path, int, str], None]
OPT_FIELDS = ("master", "exp_avg", "exp_avg_sq")
_KEY_RE = re.compile(r"layer_(\d+)_([A-Za-z0-9]+)\.(.+)")


def _split_key(key: str) -> Tuple[int, str, str]:
    """``layer_3_TransformerLayer.attention.query.weight`` -> (3,
    ``TransformerLayer``, ``attention.query.weight``)."""
    m = _KEY_RE.fullmatch(key)
    if m is None:
        raise ValueError(f"not a checkpoint key: {key}")
    return int(m.group(1)), m.group(2), m.group(3)


def _to_numpy(key: str, t: torch.Tensor) -> np.ndarray:
    """A tensor in the JAX layout and a dtype numpy can store."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    if transposed_in_jax(key, t.ndim):
        t = t.t().contiguous()
    return t.cpu().numpy()


def _from_numpy(key: str, arr: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.asarray(arr))
    return t.t() if transposed_in_jax(key, t.ndim) else t


def _write_npz(path: Path, arrays: Dict[str, np.ndarray],
               recorder: Optional[Recorder] = None) -> None:
    """Serialise once in memory (the manifest's digest is of the intended
    bytes), then write and fsync, retried on a transient error."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    data = buf.getvalue()
    if recorder is not None:
        recorder(path, len(data), crc32_bytes(data))

    def put():
        with open(path, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())

    retry_io(put, what=f"checkpoint write {path.name}")


def save_model_checkpoint(dir: PathLike, params: Mapping[str, torch.Tensor],
                          recorder: Optional[Recorder] = None) -> None:
    """One npz per layer. ``params`` maps JAX keys to the port's tensors."""
    path = Path(dir)
    path.mkdir(parents=True, exist_ok=True)
    groups: Dict[Tuple[int, str], Dict[str, np.ndarray]] = {}
    for key, t in params.items():
        index, cls, name = _split_key(key)
        groups.setdefault((index, cls), {})[name] = _to_numpy(key, t)
    for (index, cls), arrays in groups.items():
        _write_npz(path / f"model_state_layer_{index}_{cls}.npz", arrays, recorder)


def _compile(patterns: Optional[List[str]]) -> list:
    return [re.compile(p) for p in (patterns or [])]


def _matches_any(key: str, patterns: list) -> bool:
    return any(p.search(key) for p in patterns)


def enforce_allow_lists(model_keys, available_keys, allowed_missing: list,
                        allowed_unexpected: list) -> None:
    """Model keys absent from the checkpoint must match ``allowed_missing``,
    checkpoint keys the model lacks ``allowed_unexpected`` (compiled
    regexes, searched); anything else raises KeyError."""
    model_set, available_set = set(model_keys), set(available_keys)
    missing = sorted(k for k in model_set - available_set
                     if not _matches_any(k, allowed_missing))
    unexpected = sorted(k for k in available_set - model_set
                        if not _matches_any(k, allowed_unexpected))
    if missing:
        raise KeyError(f"checkpoint missing parameters: {missing[:8]}"
                       f"{'...' if len(missing) > 8 else ''}")
    if unexpected:
        raise KeyError(f"checkpoint has unexpected parameters: {unexpected[:8]}"
                       f"{'...' if len(unexpected) > 8 else ''}")


@torch.no_grad()
def load_model_checkpoint(dir: PathLike, params: Mapping[str, torch.Tensor],
                          allowed_missing_keys: Optional[List[str]] = None,
                          allowed_unexpected_keys: Optional[List[str]] = None,
                          ignore_keys: Optional[List[str]] = None,
                          restored_keys: Optional[Set[str]] = None) -> None:
    """Copy the checkpoint's values into ``params`` (JAX key -> tensor), in
    place, cast to each tensor's dtype. Missing or unexpected keys raise
    unless an allow list matches them; ``ignore_keys`` keeps the current
    values. The keys taken from the checkpoint are added to
    ``restored_keys`` when it is a set."""
    path = Path(dir)
    available: Dict[str, Tuple[Path, str]] = {}
    for f in sorted(path.glob("model_state_layer_*.npz")):
        m = re.match(r"model_state_layer_(\d+)_(.+)", f.stem)
        layer_class = m.group(2).split("__")[0]  # a PEFT suffix follows a double underscore
        with np.load(f) as z:
            for name in z.files:
                available[f"layer_{int(m.group(1))}_{layer_class}.{name}"] = (f, name)
    enforce_allow_lists(params, available, _compile(allowed_missing_keys),
                        _compile(allowed_unexpected_keys))
    ignore = _compile(ignore_keys)
    opened: Dict[Path, np.lib.npyio.NpzFile] = {}
    try:
        for key, t in params.items():
            if key not in available or _matches_any(key, ignore):
                continue
            f, name = available[key]
            if f not in opened:
                opened[f] = np.load(f)
            value = _from_numpy(key, opened[f][name])
            if tuple(value.shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch for {key}: checkpoint "
                                 f"{tuple(value.shape)} vs model {tuple(t.shape)}")
            t.copy_(value)
            if restored_keys is not None:
                restored_keys.add(key)
    finally:
        for z in opened.values():
            z.close()


def save_optimizer_checkpoint(dir: PathLike, optimizer: Optimizer, keys: Mapping[str, str],
                              recorder: Optional[Recorder] = None) -> None:
    """One ``optimizer_state_layer_{i}.npz`` per layer and
    ``optimizer_state.json``. ``keys`` maps the port's parameter names to
    their JAX keys; parameters without optimizer state get ``(0,)``
    placeholders."""
    path = Path(dir)
    path.mkdir(parents=True, exist_ok=True)
    state = optimizer.state
    per_layer: Dict[int, Dict[str, np.ndarray]] = {}
    for name, key in keys.items():
        index, _, pname = _split_key(key)
        bucket = per_layer.setdefault(index, {})
        for field in OPT_FIELDS:
            tensors = getattr(state, field)
            bucket[f"{field}.{pname}"] = (_to_numpy(key, tensors[name]) if name in tensors
                                          else np.zeros((0,), np.float32))
    for index, arrays in per_layer.items():
        _write_npz(path / f"optimizer_state_layer_{index}.npz", arrays, recorder)
    ls = state.loss_scaler
    scalars = {"step": int(state.step),
               "loss_scaler": {"current_scale": float(ls.current_scale),
                               "current_hysteresis": float(ls.current_hysteresis),
                               "no_overflow_steps": int(ls.no_overflow_steps)}}
    text = json.dumps(scalars)
    retry_io(lambda: (path / "optimizer_state.json").write_text(text),
             what="optimizer scalar state write")


@torch.no_grad()
def load_optimizer_checkpoint(dir: PathLike, optimizer: Optimizer,
                              keys: Mapping[str, str]) -> None:
    """Load masters, moments, the step and the loss scaler's state into
    ``optimizer``, in place. Raises FileNotFoundError when the checkpoint
    has no optimizer state (pruned or never written)."""
    path = Path(dir)
    scalars = json.loads((path / "optimizer_state.json").read_text())
    opened: Dict[Path, np.lib.npyio.NpzFile] = {}

    def entry(field: str, index: int, pname: str) -> np.ndarray:
        f = path / f"optimizer_state_layer_{index}.npz"
        legacy = path / f"optimizer_state_layer_{index}_{field}.npz"
        for file, name in ((f, f"{field}.{pname}"), (legacy, pname)):
            if file in opened or file.exists():
                if file not in opened:
                    opened[file] = np.load(file)
                return opened[file][name]
        raise FileNotFoundError(f"optimizer checkpoint file missing: {f}")

    state = optimizer.state
    try:
        for name in optimizer.optimized:
            key = keys[name]
            index, _, pname = _split_key(key)
            for field in OPT_FIELDS:
                target = getattr(state, field)[name]
                value = _from_numpy(key, entry(field, index, pname))
                if tuple(value.shape) != tuple(target.shape):
                    raise ValueError(f"optimizer {field} shape mismatch for {key}: checkpoint "
                                     f"{tuple(value.shape)} vs {tuple(target.shape)}")
                target.copy_(value)
    finally:
        for z in opened.values():
            z.close()
    state.step = int(scalars["step"])
    ls = scalars["loss_scaler"]
    state.loss_scaler.current_scale = float(ls["current_scale"])
    state.loss_scaler.current_hysteresis = float(ls["current_hysteresis"])
    state.loss_scaler.no_overflow_steps = int(ls["no_overflow_steps"])
