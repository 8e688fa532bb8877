"""The C++ pack-index builder and its plain version (the port's copy of
scaling_tpu/native/).

``pack_index.cpp`` has a plain C interface. It is compiled at first use
with ``g++ -O3 -shared -fPIC`` into ``scaling_tpu_torch/_build/`` (listed
in ``.gitignore``), named by a hash of the source, the flags and the
compiler, and loaded with ctypes. There is no quiet fallback: a compiler
that is missing or fails, or a library that does not load, raises with
the compiler's message. ``build_pack_index_plain`` is the Python loop the
C++ builder is held against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np

SOURCE = Path(__file__).resolve().parent / "pack_index.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_LIBS: Dict[Path, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_I64P = ctypes.POINTER(ctypes.c_int64)


def library_path(build_dir: Union[Path, str, None] = None, compiler: str = "g++") -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join([compiler, *CXX_FLAGS]).encode())
    return Path(build_dir or BUILD_DIR) / f"libpack_index-{digest.hexdigest()[:16]}.so"


def load(build_dir: Union[Path, str, None] = None, compiler: str = "g++") -> ctypes.CDLL:
    """The loaded builder, compiled first when its library is missing."""
    lib = library_path(build_dir, compiler)
    with _LOCK:
        if lib in _LIBS:
            return _LIBS[lib]
        if not lib.is_file():
            lib.parent.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            try:
                proc = subprocess.run([compiler, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                      capture_output=True, text=True, timeout=300)
            except FileNotFoundError as e:
                raise RuntimeError(f"cannot build {SOURCE}: no compiler {compiler!r}") from e
            if proc.returncode != 0:
                raise RuntimeError(f"{compiler} failed ({proc.returncode}) building {SOURCE}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib)  # atomic: another process never loads half a library
        cdll = ctypes.CDLL(str(lib))
        cdll.build_pack_index.restype = ctypes.c_int64
        cdll.build_pack_index.argtypes = [_I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                          _I64P, _I64P, ctypes.c_int64]
        _LIBS[lib] = cdll
        return cdll


def _checked_sizes(doc_sizes, sequence_length: int, every_n: int) -> np.ndarray:
    sizes = np.ascontiguousarray(doc_sizes, dtype=np.int64)
    if sizes.ndim != 1 or (sizes < 0).any():
        raise ValueError("document sizes must be a 1-D array of non-negative counts")
    if sequence_length < 1 or every_n < 0:
        raise ValueError(f"sequence_length {sequence_length} must be >= 1 and "
                         f"allow_incomplete_every_n {every_n} >= 0")
    return sizes


def build_pack_index(doc_sizes, sequence_length: int, allow_incomplete_every_n: int,
                     build_dir: Union[Path, str, None] = None, compiler: str = "g++"
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(starts, ends), int64: the ``only_full_sequences`` windows over
    documents of ``doc_sizes`` tokens, by the C++ builder."""
    L, every_n = int(sequence_length), int(allow_incomplete_every_n)
    sizes = _checked_sizes(doc_sizes, L, every_n)
    lib = load(build_dir, compiler)
    # at most one span a document boundary and one a mid-document cut
    max_spans = len(sizes) + int(sizes.sum()) // L + 2
    starts = np.empty(max_spans, dtype=np.int64)
    ends = np.empty(max_spans, dtype=np.int64)
    n = lib.build_pack_index(sizes.ctypes.data_as(_I64P), len(sizes), L, every_n,
                             starts.ctypes.data_as(_I64P), ends.ctypes.data_as(_I64P), max_spans)
    return starts[:n].copy(), ends[:n].copy()


def build_pack_index_plain(doc_sizes, sequence_length: int, allow_incomplete_every_n: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """The same spans by the JAX package's Python loop. Whole documents
    are packed greedily into [start, end) windows; a window closes at the
    first document that does not fit, and every
    ``allow_incomplete_every_n``-th window may cut a document."""
    L, every_n = int(sequence_length), int(allow_incomplete_every_n)
    sizes = _checked_sizes(doc_sizes, L, every_n)
    total_tokens = int(sizes.sum())
    spans: List[tuple] = []
    doc_offsets = np.concatenate([[0], np.cumsum(sizes)])
    window_start = 0
    since_cut = 0
    for d in range(len(sizes)):
        doc_start = int(doc_offsets[d])
        doc_end = int(doc_offsets[d + 1])
        if doc_end - window_start <= L:
            continue  # the document fits into the open window
        if every_n > 0 and since_cut + 1 >= every_n:
            # the every-n exception: cut mid-document, windows of L+1
            # tokens overlapping by one, so the boundary token is the
            # target of one window and the first input of the next
            while doc_end - window_start > L:
                spans.append((window_start, window_start + L + 1))
                window_start += L
            since_cut = 0
            continue
        if doc_start > window_start:  # close the open window at this document
            spans.append((window_start, doc_start))
            since_cut += 1
        window_start = doc_start
        if doc_end - window_start > L:
            # an over-long document: full windows, the <L-token tail
            # dropped so the next window starts at a document
            while doc_end - window_start > L:
                spans.append((window_start, window_start + L + 1))
                window_start += L
                since_cut = 0
            window_start = doc_end
    if total_tokens - window_start >= 2:
        spans.append((window_start, total_tokens))
    spans = [(s, e) for s, e in spans if e - s >= 2 and s + 2 <= total_tokens]
    return (np.asarray([s for s, _ in spans], dtype=np.int64),
            np.asarray([e for _, e in spans], dtype=np.int64))


__all__ = ["BUILD_DIR", "SOURCE", "build_pack_index", "build_pack_index_plain", "library_path",
           "load"]
