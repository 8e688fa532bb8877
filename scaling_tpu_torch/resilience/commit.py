"""Atomic checkpoint commit and the candidates of a restore (the port's
copy of the subset of scaling_tpu/resilience/commit.py and restore.py the
trainer uses).

A save is written into ``.tmp-global_stepN`` (which no ``global_step*``
glob sees), then the manifest is written, every staged file and directory
fsynced, the staging directory renamed onto ``global_stepN``, and only
then ``latest`` replaced through its own temporary file. A kill at any
point leaves the previous committed checkpoint, or the new one.

On load, ``checkpoint_candidates`` lists the ``latest``-pointed directory
first, then every other ``global_step*`` newest first; the trainer takes
the first that verifies and loads, ``select_checkpoint`` the first that
verifies.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

from ..obs.spans import span
from .faults import get_fault_plan
from .manifest import CheckpointCorruptionError, verify_checkpoint, write_manifest

TMP_PREFIX = ".tmp-global_step"
LATEST_NAME = "latest"
_STEP_RE = re.compile(r"^global_step(\d+)$")

_log = logging.getLogger("scaling_tpu_torch")


def _fsync_path(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointCommit:
    """One save's staging directory and commit sequence."""

    def __init__(self, base: Union[Path, str], step: int,
                 config_fingerprint: Optional[str] = None):
        self.base = Path(base)
        self.step = step
        self.config_fingerprint = config_fingerprint
        self.final_dir = self.base / f"global_step{step}"
        self.tmp_dir = self.base / f"{TMP_PREFIX}{step}"
        self._recorded: Dict[str, Tuple[int, str]] = {}
        for stale in self.base.glob(f"{TMP_PREFIX}*"):  # debris of crashed saves
            _log.warning(f"removing stale checkpoint staging dir {stale}")
            shutil.rmtree(stale, ignore_errors=True)
        self.tmp_dir.mkdir(parents=True)

    def record(self, path: Union[Path, str], size: int, crc32_hex: str) -> None:
        """The intended (size, crc32) of a file written under the staging
        directory, for the manifest."""
        rel = Path(path).resolve().relative_to(self.tmp_dir.resolve()).as_posix()
        self._recorded[rel] = (size, crc32_hex)

    def finalize(self) -> Path:
        """Manifest, fsync, atomic rename; returns the final directory.

        Traced as ``ckpt.manifest`` (digest and manifest write) and
        ``ckpt.rename`` (the fsync walk and the rename). On an
        asynchronous save these run on the writer thread, whose spans
        have no parent from the main thread."""
        plan = get_fault_plan()
        plan.fire("ckpt.manifest", path=self.tmp_dir)
        with span("ckpt.manifest", step=self.step):
            write_manifest(self.tmp_dir, self.step, recorded=self._recorded,
                           config_fingerprint=self.config_fingerprint)
        with span("ckpt.rename", step=self.step):
            for p in sorted(self.tmp_dir.rglob("*")):  # npz files fsync as they are written
                if p.is_dir() or p.suffix != ".npz":
                    _fsync_path(p)
            _fsync_path(self.tmp_dir)
            plan.fire("ckpt.rename", path=self.final_dir)
            if self.final_dir.exists():  # a rerun reached this step again
                shutil.rmtree(self.final_dir)
            os.replace(self.tmp_dir, self.final_dir)
            _fsync_path(self.base)
        return self.final_dir

    def update_latest(self) -> None:
        """Point ``latest`` at the committed step, atomically."""
        tmp = self.base / f"{LATEST_NAME}.tmp"
        tmp.write_text(self.final_dir.name)
        _fsync_path(tmp)
        os.replace(tmp, self.base / LATEST_NAME)
        _fsync_path(self.base)


def scan_step_dirs(base: Union[Path, str]) -> List[Tuple[int, Path]]:
    """``(step, directory)`` of every ``global_stepN`` under ``base``,
    newest first."""
    base = Path(base)
    return sorted(((int(m.group(1)), d) for d in (base.iterdir() if base.is_dir() else [])
                   if (m := _STEP_RE.match(d.name)) and d.is_dir()), reverse=True)


def checkpoint_candidates(base: Union[Path, str]) -> List[Path]:
    """Step directories under ``base`` in restore order: the one
    ``latest`` names (when it exists), then every other ``global_step*``
    newest first; ``base`` itself when it is a step directory."""
    base = Path(base)
    cands: List[Path] = []
    latest = base / LATEST_NAME
    if latest.is_file():
        from .guards import retry_io

        pointed = base / retry_io(latest.read_text, what="latest pointer read").strip()
        if pointed.is_dir():
            cands.append(pointed)
        else:
            _log.warning(f"latest names {pointed.name!r} but no such directory exists "
                         f"under {base}; falling back to a scan")
    cands += [d for _, d in scan_step_dirs(base) if d not in cands]
    if not cands and ((base / "context.json").is_file()
                      or any(base.glob("model_state_layer_*.npz"))):
        cands.append(base)
    return cands


def select_checkpoint(base: Union[Path, str], strict: bool = False, deep: bool = True
                      ) -> Tuple[Optional[Path], List[str]]:
    """The first of ``checkpoint_candidates`` that verifies against its
    manifest (None when none does), and one line for each candidate
    skipped, saying why. ``strict`` raises CheckpointCorruptionError at
    the first invalid candidate instead."""
    skipped: List[str] = []
    for cand in checkpoint_candidates(base):
        problems = verify_checkpoint(cand, deep=deep)
        if not problems:
            if skipped:
                _log.warning(f"restored from {cand} after skipping {len(skipped)} invalid "
                             "checkpoint(s): " + " | ".join(skipped))
            return cand, skipped
        line = f"{cand.name}: {'; '.join(problems)}"
        if strict:
            raise CheckpointCorruptionError(f"checkpoint verification failed (strict mode): {line}")
        _log.warning(f"skipping invalid checkpoint {line}")
        skipped.append(line)
    return None, skipped
