"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each source in ``scaling_tpu_torch/csrc/`` has a plain C interface and is
compiled on its own into a shared library under
``scaling_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash
of the source and the flags so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing here includes PyTorch's
headers: a file with a C interface builds in seconds, where one that
includes ``torch/extension.h`` takes minutes.

The build happens at first use (``load``), or ahead of it and in
parallel for several sources (``start`` for each, then ``load``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into the log
]

_LIBS: Dict[str, ctypes.CDLL] = {}
_PENDING: Dict[str, subprocess.Popen] = {}
# one build at a time: the threaded serving fleet's tick threads may reach
# a kernel's first use together
_BUILD_LOCK = threading.Lock()


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, /usr/local/cuda, or PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
        Path("/usr/local/cuda/bin/nvcc")
    ]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from source at first use"
        )
    return found


def _paths(name: str):
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def start(name: str) -> None:
    """Start building ``csrc/<name>.cu`` in the background (no-op when the
    library is built, loaded or already building)."""
    if name in _LIBS or name in _PENDING:
        return
    src, lib = _paths(name)
    if lib.is_file():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    log = open(lib.with_suffix(".log"), "w")
    try:
        _PENDING[name] = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT,
        )
    finally:
        log.close()


def build_log(name: str) -> str:
    """What nvcc printed for the current build of ``name`` (ptxas -v)."""
    log = _paths(name)[1].with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed.
    Raises if the build fails: there is no other path to the kernel."""
    lib_obj = _LIBS.get(name)
    if lib_obj is not None:
        return lib_obj
    with _BUILD_LOCK:
        return _load_locked(name)


def _load_locked(name: str) -> ctypes.CDLL:
    lib_obj = _LIBS.get(name)
    if lib_obj is not None:
        return lib_obj
    src, lib = _paths(name)
    if not lib.is_file():
        start(name)
        proc = _PENDING.pop(name)
        rc = proc.wait()
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        if rc != 0:
            raise RuntimeError(
                f"nvcc failed ({rc}) building {src}:\n{build_log(name)}"
            )
        os.replace(tmp, lib)  # atomic: a reader never sees half a library
    lib_obj = ctypes.CDLL(str(lib))
    _LIBS[name] = lib_obj
    return lib_obj
