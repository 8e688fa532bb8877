"""Dataset contracts (the port's copy of scaling_tpu/data/base_dataset.py).

A batch is a set of numpy arrays on the host; the trainer moves it to
the device in one copy per step.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Generic, List, Optional, TypeVar

import numpy as np

T = TypeVar("T")
TBatch = TypeVar("TBatch")


class BaseDatasetItem:
    """Marker base class for single dataset items."""


class BaseDatasetBatch(ABC):
    """A batch of collated items: numpy arrays, one attribute each, named
    as the constructor's arguments."""

    @classmethod
    def stack(cls, batches: List["BaseDatasetBatch"]) -> "BaseDatasetBatch":
        """The batches stacked along a new leading axis (the trainer's
        gradient-accumulation axis)."""
        return cls(**{k: np.stack([vars(b)[k] for b in batches]) for k in vars(batches[0])})


class BaseDataset(ABC, Generic[T, TBatch]):
    """Seeded, shuffleable dataset yielding items collatable into batches."""

    def __init__(self, seed: int, shuffle: bool = True):
        self.seed: Optional[int] = None
        self.set_seed(seed=seed, shuffle=shuffle)

    @abstractmethod
    def ident(self) -> str:
        """Stable identity string (the blended index's cache key)."""

    @abstractmethod
    def __len__(self) -> int: ...

    @abstractmethod
    def __getitem__(self, index: int) -> T: ...

    @abstractmethod
    def set_seed(self, seed: int, shuffle: bool = True) -> None:
        """Reshuffle the dataset deterministically for a new epoch."""

    @abstractmethod
    def collate(self, batch: List[T]) -> TBatch: ...

    def __repr__(self) -> str:
        return self.__class__.__name__
