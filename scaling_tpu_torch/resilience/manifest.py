"""Checkpoint integrity manifest: write, verify, prune (the port's copy of
the subset of scaling_tpu/resilience/manifest.py the trainer uses).

``MANIFEST.json`` sits in every committed ``global_stepN/`` directory and
records each file's size and crc32, the step, a config fingerprint and a
schema version, in the JAX package's format: each package's verifier
accepts the other's checkpoints. It is written last, inside the staging
directory; the digests of npz files are those of the bytes the writer
meant to write, so corruption at or after the write is caught on load.
A checkpoint without a manifest is accepted as legacy, unverified.
"""

from __future__ import annotations

import json
import logging
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

MANIFEST_NAME = "MANIFEST.json"
SCHEMA_VERSION = 1
_CHUNK = 1 << 20
_VERIFY_THREADS = 4

_log = logging.getLogger("scaling_tpu_torch")


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint failed integrity verification (or was unreadable)."""


def _is_optimizer_artifact(rel: str) -> bool:
    return Path(rel).as_posix().startswith("optimizer_state")


def crc32_file(path: Path) -> Tuple[int, str]:
    """(size, crc32 hex) of a file, streamed."""
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while chunk := f.read(_CHUNK):
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return size, f"{crc & 0xFFFFFFFF:08x}"


_CRC_POLY = 0xEDB88320  # reflected CRC-32


def _multmodp(a: int, b: int) -> int:
    """a * b modulo the CRC-32 polynomial (reflected bit order)."""
    m, p = 1 << 31, 0
    while m:
        if a & m:
            p ^= b
        b = (b >> 1) ^ _CRC_POLY if b & 1 else b >> 1
        m >>= 1
    return p


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """The crc32 of ``A + B`` from ``crc1`` of A, ``crc2`` of B and B's
    length (zlib's ``crc32_combine``): ``crc1`` shifted over ``len2``
    zero bytes, xored with ``crc2``."""
    shift, x2n, n = 1 << 31, 1 << 30, len2 * 8  # x^0, x^1; n bits
    while n:
        if n & 1:
            shift = _multmodp(x2n, shift)
        x2n = _multmodp(x2n, x2n)
        n >>= 1
    return _multmodp(shift, crc1) ^ crc2


def write_manifest(step_dir: Path, step: int,
                   recorded: Optional[Dict[str, Tuple[int, str]]] = None,
                   config_fingerprint: Optional[str] = None) -> Path:
    """Scan ``step_dir`` and write its manifest. ``recorded`` maps a
    relative path to the (size, crc32) the writer took from the bytes in
    memory; other files are digested from disk."""
    step_dir = Path(step_dir)
    files: Dict[str, dict] = {}
    for p in sorted(step_dir.rglob("*")):
        if not p.is_file() or p.name == MANIFEST_NAME:
            continue
        rel = p.relative_to(step_dir).as_posix()
        size, digest = (recorded or {}).get(rel) or crc32_file(p)
        files[rel] = {"size": size, "crc32": digest}
    payload = {"schema_version": SCHEMA_VERSION, "step": step,
               "config_fingerprint": config_fingerprint, "files": files}
    out = step_dir / MANIFEST_NAME
    out.write_text(json.dumps(payload, indent=1, sort_keys=True))
    return out


def read_manifest(step_dir: Path) -> Optional[dict]:
    """The parsed manifest, or None when there is none. Raises
    CheckpointCorruptionError for an unparseable or newer one."""
    f = Path(step_dir) / MANIFEST_NAME
    if not f.is_file():
        return None
    try:
        payload = json.loads(f.read_text())
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointCorruptionError(f"{f}: unreadable manifest ({e})") from e
    if payload.get("schema_version", 0) > SCHEMA_VERSION:
        raise CheckpointCorruptionError(
            f"{f}: manifest schema {payload.get('schema_version')} is newer than "
            f"this build understands ({SCHEMA_VERSION})")
    return payload


def verify_checkpoint(step_dir: Path, deep: bool = True) -> List[str]:
    """The integrity problems of ``step_dir`` ([] means loadable): every
    listed file present with its size and, with ``deep``, its crc32. An
    optimizer file listed but absent was pruned, not corrupted."""
    step_dir = Path(step_dir)
    if not step_dir.is_dir():
        return [f"{step_dir}: not a directory"]
    try:
        manifest = read_manifest(step_dir)
    except CheckpointCorruptionError as e:
        return [str(e)]
    if manifest is None:
        if not (any(step_dir.glob("model_state_layer_*.npz"))
                or (step_dir / "context.json").is_file()):
            return [f"{step_dir}: no manifest and no recognizable checkpoint files"]
        _log.warning(f"{step_dir}: no {MANIFEST_NAME} (legacy checkpoint); integrity "
                     "not verified")
        return []
    problems: List[str] = []
    digest: List[Tuple[str, str]] = []
    for rel, meta in manifest.get("files", {}).items():
        p = step_dir / rel
        if not p.is_file():
            if _is_optimizer_artifact(rel):
                _log.warning(f"{step_dir}: optimizer artifact {rel} pruned")
                continue
            problems.append(f"{rel}: listed in manifest but missing")
            continue
        size = p.stat().st_size
        if size != meta["size"]:
            problems.append(f"{rel}: size {size} != manifest {meta['size']} (truncated?)")
            continue
        if deep:
            digest.append((rel, meta["crc32"]))
    # the crc32s file by file on several threads: reads and zlib release the GIL
    with ThreadPoolExecutor(max_workers=_VERIFY_THREADS) as pool:
        found = list(pool.map(lambda rel: crc32_file(step_dir / rel)[1], [r for r, _ in digest]))
    for (rel, expected), got in zip(digest, found):
        if got != expected:
            problems.append(f"{rel}: crc32 {got} != manifest {expected} (bit rot / torn write)")
    return problems


def prune_manifest_entries(step_dir: Path, removed: Iterable[str]) -> None:
    """Drop deliberately deleted files (past optimizer states) from an
    older checkpoint's manifest, so it still verifies."""
    step_dir = Path(step_dir)
    manifest = read_manifest(step_dir)
    if manifest is None:
        return
    removed = {Path(r).as_posix() for r in removed}
    files = manifest.get("files", {})
    kept = {rel: meta for rel, meta in files.items() if rel not in removed}
    if len(kept) == len(files):
        return
    manifest["files"] = kept
    manifest["optimizer_pruned"] = True
    from .guards import retry_io

    text = json.dumps(manifest, indent=1, sort_keys=True)
    retry_io(lambda: (step_dir / MANIFEST_NAME).write_text(text),
             what="pruned manifest rewrite")
