"""Checkpoints in the JAX package's on-disk layout (counterpart of
scaling_tpu/checkpoint/checkpoint.py, npz backend).

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
  embedding table is the same on both sides), convolution kernels
  permuted between ``(out, in, kh, kw)`` and ``(kh, kw, in, out)``
  (``to_jax_layout``);
- bf16 stored as float32, a lossless widening; the loader casts back;
- a frozen parameter (no optimizer state) has ``(0,)`` float32
  placeholders in the optimizer files, as the JAX optimizer keeps them.

Parameters are matched by their JAX key (``layer_{i}_{Class}.{name}``,
``ParallelModule.ckpt_keys``), so a checkpoint of either package loads
in the other. Non-strict loading follows ``enforce_allow_lists``.

Over several ranks a checkpoint is still JAX's merged layout: each leaf is
gathered whole (``gather``: the ranks' slices put together on every rank
of the groups, the whole leaf handed back on the writing rank and None on
the others) and only the writing rank writes; a load gives each rank its
slice of the merged arrays (``shard``), read from views of the mapped
files. Both go leaf by leaf, so the host holds one layer at a time.

Every save takes its own host copy of each tensor before it returns
(``_to_numpy``); with an ``AsyncCheckpointWriter`` the serialisation,
crc32 and write of each file then run on the writer's thread while the
training loop goes on updating the tensors in place.
"""

from __future__ import annotations

import io
import json
import logging
import math
import mmap
import os
import re
import struct
import zipfile
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Set, Tuple, Union

import numpy as np
import torch

from ..optimizer import Optimizer
from ..parallel.parallel_module import from_jax_layout, to_jax_layout
from ..resilience.faults import get_fault_plan
from ..resilience.guards import retry_io
from ..resilience.manifest import crc32_combine

PathLike = Union[Path, str]
Recorder = Callable[[Path, int, str], None]
# (JAX key, this rank's tensor) -> the whole leaf on the writing rank, else None
Gather = Callable[[str, torch.Tensor], Optional[torch.Tensor]]
# (JAX key, the whole leaf in the port's layout) -> this rank's slice
Shard = Callable[[str, torch.Tensor], torch.Tensor]
OPT_FIELDS = ("master", "exp_avg", "exp_avg_sq")
_KEY_RE = re.compile(r"layer_(\d+)_([A-Za-z0-9]+)\.(.+)")

_log = logging.getLogger("scaling_tpu_torch")


class AsyncCheckpointWriter:
    """Runs checkpoint writes on one background thread, in submission order.

    ``submit`` applies backpressure past ``max_queued`` unfinished tasks,
    which bounds the host memory held by queued copies at a few files'
    worth. Once a task fails, every later task is skipped (so the commit
    and ``latest`` of a save never land on a partly written checkpoint),
    and the first failure re-raises from ``wait()`` only, never on the
    submitting thread. ``wait()`` returns when every submitted task has
    finished.
    """

    def __init__(self, max_queued: int = 4) -> None:
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending: List[Future] = []
        self._max_queued = max_queued
        # the first failure of the save in flight; tasks record it here, so
        # the futures never carry an exception
        self._first_error: Optional[BaseException] = None

    def submit(self, fn: Callable, *args) -> None:
        def run():
            if self._first_error is not None:
                return
            try:
                fn(*args)
            except BaseException as e:  # re-raised from wait()
                self._first_error = e
                _log.error(f"checkpoint writer task failed: {e!r}")

        while len([f for f in self._pending if not f.done()]) >= self._max_queued:
            self._pending.pop(0).result()  # backpressure; a failure stays recorded
        self._pending.append(self._pool.submit(run))

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()  # tasks never raise: a completion barrier
        err, self._first_error = self._first_error, None
        if err is not None:
            raise err

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)


def _split_key(key: str) -> Tuple[int, str, str]:
    """``layer_3_TransformerLayer.attention.query.weight`` -> (3,
    ``TransformerLayer``, ``attention.query.weight``)."""
    m = _KEY_RE.fullmatch(key)
    if m is None:
        raise ValueError(f"not a checkpoint key: {key}")
    return int(m.group(1)), m.group(2), m.group(3)


def _to_numpy(key: str, t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` in the JAX layout and a dtype numpy can store,
    complete when this returns. Always a new array: the optimizer updates
    the tensors in place while an asynchronous save is still writing, and
    on the CPU ``.cpu().numpy()`` would be the live tensor itself."""
    t = to_jax_layout(key, t.detach())
    dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    if t.is_cuda:  # transpose and widen on the card: the host copy is then one memcpy
        t = t.to(dtype).contiguous()
    out = torch.empty(t.shape, dtype=dtype)
    out.copy_(t)  # into pageable host memory: synchronous
    return out.numpy()


def _from_numpy(key: str, arr: np.ndarray, device=None) -> torch.Tensor:
    """The stored array on ``device`` in the port's layout. It goes to the
    device as stored (one contiguous copy) and is transposed there: a
    transposing copy on the host runs at a fraction of the memory's rate."""
    t = torch.from_numpy(np.asarray(arr))
    if device is not None:
        t = t.to(device)
    return from_jax_layout(key, t)


def _copy_in(target: torch.Tensor, key: str, arr: np.ndarray, what: str,
             shard: Optional[Shard] = None) -> None:
    """``target`` takes the stored ``arr`` (in the JAX layout), or with
    ``shard`` its slice of it, in place; nothing keeps a view of ``arr``
    once this returns."""
    if shard is None:
        value = _from_numpy(key, arr, target.device)
    else:  # the slice of the mapped array goes to the device, not the whole
        value = shard(key, from_jax_layout(key, torch.from_numpy(np.asarray(arr))))
        value = value.to(target.device)
    if tuple(value.shape) != tuple(target.shape):
        raise ValueError(f"{what} shape mismatch for {key}: checkpoint "
                         f"{tuple(value.shape)} vs model {tuple(target.shape)}")
    target.copy_(value)


def _savez(f, arrays: Dict[str, np.ndarray]) -> Tuple[int, str]:
    """``np.savez``'s bytes (stored zip64 members ``{name}.npy``) written
    into ``f``, an open seekable file that can be read back; returns their
    (size, crc32 hex). The crc32 is put together from the members' crcs,
    which the zip writer takes as it writes, and the headers: the arrays'
    bytes pass through one crc32 and are never copied into a buffer."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for name, value in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as member:
                np.lib.format.write_array(member, np.asanyarray(value), allow_pickle=False)
        members, start_dir = zf.infolist(), zf.start_dir
    size = f.tell()
    f.seek(start_dir)
    tail = f.read()  # the central directory and its end records
    crc, pos = 0, 0
    for zinfo in members:
        header = zinfo.FileHeader(True)  # the header as the writer patched it in
        if zinfo.header_offset != pos:
            raise RuntimeError(f"unexpected zip layout at {zinfo.filename}")
        crc = crc32_combine(zlib.crc32(header, crc), zinfo.CRC, zinfo.compress_size)
        pos += len(header) + zinfo.compress_size
    if pos != start_dir or start_dir + len(tail) != size:
        raise RuntimeError("unexpected zip layout at the central directory")
    return size, f"{zlib.crc32(tail, crc) & 0xFFFFFFFF:08x}"


def _write_npz(path: Path, arrays: Dict[str, np.ndarray],
               recorder: Optional[Recorder] = None) -> None:
    """Serialise straight into the file and fsync it, retried on a
    transient error; the manifest's digest is of the bytes written."""
    def put():
        act = get_fault_plan().fire("ckpt.write", path=path)
        with open(path, "w+b") as f:
            written = _savez(f, arrays)
            f.flush()
            os.fsync(f.fileno())
        if act == "corrupt":
            get_fault_plan().corrupt_file(path)
        return written

    size, digest = retry_io(put, what=f"checkpoint write {path.name}")
    if recorder is not None:
        recorder(path, size, digest)


class _NpzReader:
    """The arrays of an npz file, read in place: the file is mapped, each
    stored member's array is a view of the mapping at the offset the zip
    directory gives, its crc32 checked against the directory's as
    ``np.load`` checks it. ``np.load`` copies each member through the zip
    reader's buffers first; a compressed member (not written by either
    package) still goes through it. Close it once the views are copied."""

    def __init__(self, path: PathLike) -> None:
        self._file = open(path, "rb")
        try:
            self._zip = zipfile.ZipFile(self._file)
            self._members = {z.filename[:-len(".npy")]: z for z in self._zip.infolist()
                             if z.filename.endswith(".npy")}
            self._map = (mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_COPY)
                         if os.fstat(self._file.fileno()).st_size else None)
        except BaseException:
            self._file.close()
            raise

    @property
    def files(self) -> List[str]:
        return list(self._members)

    def __getitem__(self, name: str) -> np.ndarray:
        zinfo = self._members[name]
        if zinfo.compress_type != zipfile.ZIP_STORED:
            with self._zip.open(zinfo) as member:
                return np.lib.format.read_array(member, allow_pickle=False)
        # the local header: 30 bytes, then the name and the extra field
        start = zinfo.header_offset
        name_len, extra_len = struct.unpack_from("<HH", self._map, start + 26)
        start += 30 + name_len + extra_len
        with memoryview(self._map) as whole:
            data = whole[start:start + zinfo.file_size]
        if zlib.crc32(data) != zinfo.CRC:
            data.release()
            raise zipfile.BadZipFile(f"Bad CRC-32 for file {zinfo.filename!r}")
        header = io.BytesIO(data[:min(len(data), 1 << 16)])
        read_header = {(1, 0): np.lib.format.read_array_header_1_0,
                       (2, 0): np.lib.format.read_array_header_2_0}.get(
                           np.lib.format.read_magic(header))
        if read_header is None:  # a newer .npy version: numpy's own reader
            with self._zip.open(zinfo) as member:
                return np.lib.format.read_array(member, allow_pickle=False)
        shape, fortran, dtype = read_header(header)
        if dtype.hasobject:
            raise ValueError(f"{zinfo.filename}: object arrays are not loaded")
        array = np.frombuffer(data, dtype=dtype, count=math.prod(shape), offset=header.tell())
        return array.reshape(shape[::-1]).T if fortran else array.reshape(shape)

    def close(self) -> None:
        if self._map is not None:
            try:
                self._map.close()
            except BufferError:  # a view lives on (in a traceback): it frees the map
                pass
        self._zip.close()
        self._file.close()


def _open_artifact(path: Path) -> _NpzReader:
    """One checkpoint npz opened for a restore. Fires the
    ``restore.assemble`` fault point first, once per artifact: an injected
    failure is an ``OSError``, which the Trainer's bounded retry retries
    and which, when it persists, demotes the checkpoint to the next valid
    one."""
    get_fault_plan().fire("restore.assemble", path=path)
    return _NpzReader(path)


def _emit(writer: Optional[AsyncCheckpointWriter], path: Path, arrays: Dict[str, np.ndarray],
          recorder: Optional[Recorder]) -> None:
    if writer is None:
        _write_npz(path, arrays, recorder)
    else:
        writer.submit(_write_npz, path, arrays, recorder)


def _whole(gather: Optional[Gather], key: str, t: torch.Tensor) -> Optional[torch.Tensor]:
    return t if gather is None else gather(key, t)


def save_model_checkpoint(dir: Optional[PathLike], params: Mapping[str, torch.Tensor],
                          recorder: Optional[Recorder] = None,
                          writer: Optional[AsyncCheckpointWriter] = None,
                          gather: Optional[Gather] = None) -> None:
    """One npz per layer. ``params`` maps JAX keys to the port's tensors;
    with ``writer`` the files are written on its thread. With ``gather``
    every rank calls this, and a rank whose ``gather`` hands back None
    (``dir`` None there) writes nothing."""
    path = None if dir is None else Path(dir)
    if path is not None:
        path.mkdir(parents=True, exist_ok=True)
    groups: Dict[Tuple[int, str], Dict[str, str]] = {}
    for key in params:
        index, cls, name = _split_key(key)
        groups.setdefault((index, cls), {})[name] = key
    for (index, cls), names in groups.items():  # host copies one layer at a time
        whole = {name: _whole(gather, key, params[key]) for name, key in names.items()}
        if path is None:
            continue
        arrays = {name: _to_numpy(names[name], t) for name, t in whole.items()}
        _emit(writer, path / f"model_state_layer_{index}_{cls}.npz", arrays, recorder)


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
                          restored_keys: Optional[Set[str]] = None,
                          shard: Optional[Shard] = None,
                          other_stages: Optional[Set[str]] = None) -> None:
    """Copy the checkpoint's values into ``params`` (JAX key -> tensor), in
    place, cast to each tensor's dtype; with ``shard``, each tensor's slice
    of the stored leaf. Missing or unexpected keys raise
    unless an allow list matches them; ``ignore_keys`` keeps the current
    values; ``other_stages``: the keys other pipe stages load, neither
    expected nor unexpected here. The keys taken from the checkpoint are
    added to ``restored_keys`` when it is a set."""
    path = Path(dir)
    available: Dict[str, Tuple[Path, str]] = {}
    for f in sorted(path.glob("model_state_layer_*.npz")):
        m = re.match(r"model_state_layer_(\d+)_(.+)", f.stem)
        layer_class = m.group(2).split("__")[0]  # a PEFT suffix follows a double underscore
        with zipfile.ZipFile(f) as z:
            for member in z.namelist():
                if member.endswith(".npy"):
                    name = member[:-len(".npy")]
                    available[f"layer_{int(m.group(1))}_{layer_class}.{name}"] = (f, name)
    for key in other_stages or ():
        available.pop(key, None)
    enforce_allow_lists(params, available, _compile(allowed_missing_keys),
                        _compile(allowed_unexpected_keys))
    ignore = _compile(ignore_keys)
    opened: Dict[Path, _NpzReader] = {}
    try:
        for key, t in params.items():
            if key not in available or _matches_any(key, ignore):
                continue
            f, name = available[key]
            if f not in opened:
                opened[f] = _open_artifact(f)
            _copy_in(t, key, opened[f][name], "parameter", shard)
            if restored_keys is not None:
                restored_keys.add(key)
    finally:
        for z in opened.values():
            z.close()


def save_optimizer_checkpoint(dir: Optional[PathLike], optimizer: Optimizer,
                              keys: Mapping[str, str], recorder: Optional[Recorder] = None,
                              writer: Optional[AsyncCheckpointWriter] = None,
                              gather: Optional[Gather] = None) -> None:
    """One ``optimizer_state_layer_{i}.npz`` per layer (on ``writer``'s
    thread when given) and ``optimizer_state.json``. ``keys`` maps the
    port's parameter names to their JAX keys; parameters without optimizer
    state get ``(0,)`` placeholders. ``gather`` and ``dir`` None: as in
    ``save_model_checkpoint``; ``gather`` is called for every key, with None
    where this rank keeps no state for it (another pipe stage's leaf, or a
    frozen one), and hands back None where no rank does."""
    path = None if dir is None else Path(dir)
    if path is not None:
        path.mkdir(parents=True, exist_ok=True)
    state = optimizer.state
    per_layer: Dict[int, List[Tuple[str, str]]] = {}
    for name, key in keys.items():
        per_layer.setdefault(_split_key(key)[0], []).append((name, key))
    for index, members in per_layer.items():  # host copies one layer at a time
        arrays = {}
        for name, key in members:
            for field in OPT_FIELDS:
                tensors = getattr(state, field)
                whole = (_whole(gather, key, tensors.get(name))
                         if name in tensors or gather is not None else None)
                if path is not None:
                    arrays[f"{field}.{_split_key(key)[2]}"] = (
                        np.zeros((0,), np.float32) if whole is None else _to_numpy(key, whole))
        if path is not None:
            _emit(writer, path / f"optimizer_state_layer_{index}.npz", arrays, recorder)
    if path is None:
        return
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
                              keys: Mapping[str, str], shard: Optional[Shard] = None) -> None:
    """Load masters, moments, the step and the loss scaler's state into
    ``optimizer``, in place (with ``shard``, each state's slice). Raises
    FileNotFoundError when the checkpoint has no optimizer state (pruned
    or never written)."""
    path = Path(dir)
    scalars = json.loads((path / "optimizer_state.json").read_text())
    opened: Dict[Path, _NpzReader] = {}

    def entry(field: str, index: int, pname: str) -> np.ndarray:
        f = path / f"optimizer_state_layer_{index}.npz"
        legacy = path / f"optimizer_state_layer_{index}_{field}.npz"
        for file, name in ((f, f"{field}.{pname}"), (legacy, pname)):
            if file in opened or file.exists():
                if file not in opened:
                    opened[file] = _open_artifact(file)
                return opened[file][name]
        raise FileNotFoundError(f"optimizer checkpoint file missing: {f}")

    state = optimizer.state
    try:
        for name in optimizer.optimized:
            key = keys[name]
            index, _, pname = _split_key(key)
            for field in OPT_FIELDS:
                _copy_in(getattr(state, field)[name], key, entry(field, index, pname),
                         f"optimizer {field}", shard)
    finally:
        for z in opened.values():
            z.close()
    state.step = int(scalars["step"])
    ls = scalars["loss_scaler"]
    state.loss_scaler.current_scale = float(ls["current_scale"])
    state.loss_scaler.current_hysteresis = float(ls["current_hysteresis"])
    state.loss_scaler.no_overflow_steps = int(ls["no_overflow_steps"])
