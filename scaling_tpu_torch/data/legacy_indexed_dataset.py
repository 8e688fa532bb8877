"""Megatron-format indexed datasets (the port's copy of
scaling_tpu/data/legacy_indexed_dataset.py; numpy only).

Both public Megatron-LM layouts store a flat ``.bin`` of concatenated
token arrays and an ``.idx``:

- **MMIDIDX** (the mmap layout): 9-byte magic ``MMIDIDX\\x00\\x00``,
  version u64, dtype code u8, sequence count u64, document count u64,
  then sizes i32[count], pointers i64[count] (byte offsets into the
  ``.bin``), doc_idx i64[docs].
- **TNTIDX** (the cached layout): 8-byte magic ``TNTIDX\\x00\\x00``,
  version u64, (dtype code, element size) u64 pair, (count, size
  entries) u64 pair, document count u64, then dim_offsets i64[count+1],
  data_offsets i64[count+1] (element offsets), sizes i64[size entries],
  doc_idx i64[docs].

All integers little-endian. :class:`LegacyIndexedDataset` reads either
and has the document-store interface of ``MemoryMapDataset`` (``sizes``,
``__getitem__``, ``read_span``), so ``TextDataset`` packs legacy data
as it packs a memory map. :class:`LegacyMMapIndexWriter` writes the
MMIDIDX layout byte for byte as the JAX package's writer does.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Union

import numpy as np

PathLike = Union[Path, str]

DTYPES = {
    1: np.uint8,
    2: np.int8,
    3: np.int16,
    4: np.int32,
    5: np.int64,
    6: np.float32,
    7: np.float64,
    8: np.uint16,
}
MMAP_MAGIC = b"MMIDIDX\x00\x00"
CACHED_MAGIC = b"TNTIDX\x00\x00"


def _dtype(code: int, path: Path) -> np.dtype:
    if code not in DTYPES:
        raise ValueError(f"{path}: unknown dtype code {code}")
    return np.dtype(DTYPES[code])


def _check_version(version: int, path: Path) -> None:
    if version != 1:
        raise ValueError(f"{path}: unsupported index version {version}")


class LegacyIndexedDataset:
    """Either Megatron layout, by the ``.idx`` file's magic; the documents
    are the items."""

    def __init__(self, prefix: PathLike, load_index_to_memory: bool = False):
        self.prefix = Path(prefix)
        idx_path = self.prefix.with_suffix(".idx")
        with open(idx_path, "rb") as f:
            head = f.read(9)
        if head == MMAP_MAGIC:
            self._read_mmap_index(idx_path)
        elif head[:8] == CACHED_MAGIC:
            self._read_cached_index(idx_path)
        else:
            raise ValueError(f"{idx_path}: not a Megatron indexed dataset")
        self._data = np.memmap(self.prefix.with_suffix(".bin"), dtype=self.dtype, mode="r")
        if load_index_to_memory:
            self._sizes = np.array(self._sizes)
            self._element_starts = np.array(self._element_starts)

    def _read_mmap_index(self, path: Path) -> None:
        with open(path, "rb") as f:
            f.read(len(MMAP_MAGIC))
            (version,) = struct.unpack("<Q", f.read(8))
            _check_version(version, path)
            (code,) = struct.unpack("<B", f.read(1))
            self.dtype = _dtype(code, path)
            count, doc_count = struct.unpack("<QQ", f.read(16))
            offset = f.tell()
        buf = np.memmap(path, mode="r")
        self._sizes = np.frombuffer(buf, np.int32, count=count, offset=offset)
        offset += self._sizes.nbytes
        pointers = np.frombuffer(buf, np.int64, count=count, offset=offset)
        self._element_starts = pointers // self.dtype.itemsize  # bytes -> elements
        self.doc_idx = np.frombuffer(buf, np.int64, count=doc_count,
                                     offset=offset + pointers.nbytes)

    def _read_cached_index(self, path: Path) -> None:
        with open(path, "rb") as f:
            f.read(len(CACHED_MAGIC))
            (version,) = struct.unpack("<Q", f.read(8))
            _check_version(version, path)
            code, element_size = struct.unpack("<QQ", f.read(16))
            self.dtype = _dtype(code, path)
            if self.dtype.itemsize != element_size:
                raise ValueError(f"{path}: element size {element_size} does not match "
                                 f"dtype {self.dtype}")
            count, n_sizes = struct.unpack("<QQ", f.read(16))
            (doc_count,) = struct.unpack("<Q", f.read(8))
            dim_offsets = np.fromfile(f, np.int64, count + 1)
            data_offsets = np.fromfile(f, np.int64, count + 1)  # in elements
            sizes = np.fromfile(f, np.int64, n_sizes)
            self.doc_idx = np.fromfile(f, np.int64, doc_count)
        # an item's tokens: the product of its dims (one dim a document as a rule)
        if count and not (np.diff(dim_offsets) > 0).all():
            raise ValueError(f"{path}: an item without dimensions")
        self._sizes = (np.multiply.reduceat(sizes, dim_offsets[:-1]) if count
                       else np.zeros(0, np.int64))
        self._element_starts = data_offsets[:-1]

    def sizes(self) -> np.ndarray:
        return np.asarray(self._sizes, dtype=np.int64)

    def __len__(self) -> int:
        return len(self._sizes)

    def __getitem__(self, index: int) -> np.ndarray:
        start = int(self._element_starts[index])
        return np.asarray(self._data[start:start + int(self._sizes[index])])

    def read_span(self, start: int, n: int) -> np.ndarray:
        """``n`` tokens of the concatenated document stream from ``start``."""
        return np.asarray(self._data[start:start + n])


class LegacyMMapIndexWriter:
    """Writes the MMIDIDX layout: ``add`` each document, then ``close``
    (or use it as a context manager)."""

    def __init__(self, prefix: PathLike, dtype=np.uint16):
        self.prefix = Path(prefix)
        self.dtype = np.dtype(dtype)
        codes = {np.dtype(v): k for k, v in DTYPES.items()}
        if self.dtype not in codes:
            raise ValueError(f"no MMIDIDX dtype code for {self.dtype}")
        self._code = codes[self.dtype]
        self._sizes: list = []
        self._bin = open(self.prefix.with_suffix(".bin"), "wb")

    def add(self, tokens: np.ndarray) -> None:
        arr = np.asarray(tokens, dtype=self.dtype)
        self._bin.write(arr.tobytes(order="C"))
        self._sizes.append(len(arr))

    def __enter__(self) -> "LegacyMMapIndexWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._bin.close()
        sizes = np.asarray(self._sizes, np.int64)
        pointers = (np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)
                    * self.dtype.itemsize if len(sizes) else np.zeros(0, np.int64))
        doc_idx = np.arange(len(sizes) + 1, dtype=np.int64)  # one sequence a document
        with open(self.prefix.with_suffix(".idx"), "wb") as f:
            f.write(MMAP_MAGIC)
            f.write(struct.pack("<QBQQ", 1, self._code, len(sizes), len(doc_idx)))
            f.write(sizes.astype(np.int32).tobytes())
            f.write(pointers.tobytes())
            f.write(doc_idx.tobytes())
