"""Memory-mapped token datasets (the port's copy of
scaling_tpu/data/memory_map.py).

On-disk format, the same as the JAX package's: ``<prefix>.bin`` raw item
values, ``<prefix>.idx`` int pairs ``(start_index, size)`` per document,
``<prefix>.meta.json`` with ``{dtype, index_dtype, document_count}``. A
dataset written by either package's builder is byte for byte the one the
other writes, and each reads the other's.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, Optional, Tuple, Union

import numpy as np

PathLike = Union[Path, str]


class DocumentIndex:
    """The meta file and the document index of a ``.bin/.idx/.meta.json``
    triple."""

    def __init__(self, prefix_path: PathLike, load_index_to_memory: bool = True):
        self.prefix_path = Path(prefix_path)
        for p in (self.file_path_data, self.file_path_index, self.file_path_meta):
            if not p.is_file():
                raise FileNotFoundError(f"cannot initialize memory map, file not found: {p}")
        meta = json.loads(self.file_path_meta.read_text())
        self.dtype = np.dtype(meta["dtype"])
        self.index_dtype = np.dtype(meta["index_dtype"])
        self.document_count = int(meta["document_count"])
        index = np.memmap(self.file_path_index, mode="r", dtype=self.index_dtype).reshape(
            self.document_count, 2)
        self._index = np.array(index) if load_index_to_memory else index

    @property
    def file_path_data(self) -> Path:
        return Path(str(self.prefix_path) + ".bin")

    @property
    def file_path_index(self) -> Path:
        return Path(str(self.prefix_path) + ".idx")

    @property
    def file_path_meta(self) -> Path:
        return Path(str(self.prefix_path) + ".meta.json")

    def sizes(self, idx: Optional[int] = None) -> np.ndarray:
        if idx is None:
            return self._index[:, 1]
        return self._index[idx, 1]

    def span(self, idx: int) -> Tuple[int, int]:
        if idx < 0 or idx >= self.document_count:
            raise IndexError(
                f"cannot retrieve document idx {idx} from {self.document_count} documents")
        start, size = (int(v) for v in self._index[idx])
        return start, size


class MemoryMapDataset:
    """Random access to variable-length documents in a flat binary file."""

    def __init__(self, prefix_path: PathLike, load_index_to_memory: bool = True):
        self._layout = DocumentIndex(prefix_path, load_index_to_memory=load_index_to_memory)
        self.prefix_path = self._layout.prefix_path
        self.dtype = self._layout.dtype
        self.index_dtype = self._layout.index_dtype
        self.document_count = self._layout.document_count
        self._data = np.memmap(self._layout.file_path_data, mode="r", dtype=self.dtype)

    def sizes(self, idx: Optional[int] = None) -> np.ndarray:
        return self._layout.sizes(idx)

    def __len__(self) -> int:
        return self.document_count

    def __getitem__(self, idx: int) -> np.ndarray:
        start, size = self._layout.span(idx)
        return np.asarray(self._data[start:start + size])

    def read_span(self, start_token: int, num_tokens: int) -> np.ndarray:
        """A flat token span irrespective of document boundaries."""
        return np.asarray(self._data[start_token:start_token + num_tokens])

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self[i]


class MemoryMapDatasetBuilder:
    """Streaming writer of the ``.bin``/``.idx``/``.meta.json`` triple."""

    def __init__(self, prefix_path: PathLike, dtype: np.dtype = np.dtype(np.int32),
                 index_dtype: np.dtype = np.dtype(np.int64)):
        self.prefix_path = Path(prefix_path)
        self.dtype = np.dtype(dtype)
        self.index_dtype = np.dtype(index_dtype)
        data_path = Path(str(self.prefix_path) + ".bin")
        index_path = Path(str(self.prefix_path) + ".idx")
        for p in (data_path, index_path):
            if p.is_file():
                raise FileExistsError(f"dataset file already exists: {p}")
        data_path.parent.mkdir(parents=True, exist_ok=True)
        self._data_file = open(data_path, "wb")
        self._index_file = open(index_path, "wb")
        self._cursor = 0
        self.document_count = 0

    def add(self, array: np.ndarray) -> None:
        array = np.asarray(array)
        if array.ndim != 1:
            raise ValueError("cannot add arrays of more than one dimension")
        array = array.astype(self.dtype, copy=False)
        self._data_file.write(array.tobytes())
        self._index_file.write(
            np.array([self._cursor, array.size], dtype=self.index_dtype).tobytes())
        self._cursor += array.size
        self.document_count += 1

    def finalize(self) -> None:
        self._data_file.close()
        self._index_file.close()
        meta = {"dtype": self.dtype.name, "index_dtype": self.index_dtype.name,
                "document_count": self.document_count}
        Path(str(self.prefix_path) + ".meta.json").write_text(json.dumps(meta))

    def __enter__(self) -> "MemoryMapDatasetBuilder":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> bool:
        if exc_type is None:
            self.finalize()
        else:  # no meta for a torn dataset: a reader refuses it
            self._data_file.close()
            self._index_file.close()
        return False
