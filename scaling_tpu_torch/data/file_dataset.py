"""Documents read with seeks instead of a memory map (the port's copy of
scaling_tpu/data/file_dataset.py).

The same ``.bin/.idx/.meta.json`` triple as ``MemoryMapDataset``, read
through one open file handle: for file systems where ``mmap`` misbehaves
(some network mounts).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

from .memory_map import DocumentIndex


class FileDataset:
    def __init__(self, prefix_path: Union[Path, str]):
        self.prefix_path = Path(prefix_path)
        self._layout = DocumentIndex(self.prefix_path)
        self._data_file = open(self._layout.file_path_data, "rb")

    @property
    def dtype(self) -> np.dtype:
        return self._layout.dtype

    @property
    def document_count(self) -> int:
        return self._layout.document_count

    def __len__(self) -> int:
        return self._layout.document_count

    def sizes(self, idx: Optional[int] = None) -> np.ndarray:
        return self._layout.sizes(idx)

    def __getitem__(self, idx: int) -> np.ndarray:
        start, size = self._layout.span(idx)
        itemsize = self._layout.dtype.itemsize
        self._data_file.seek(start * itemsize)
        return np.frombuffer(self._data_file.read(size * itemsize), dtype=self._layout.dtype)

    def close(self) -> None:
        self._data_file.close()
