"""Deterministic, resumable data loading (the port's copy of
scaling_tpu/data/dataloader.py at data-parallel size 1).

The sample-order contract is the JAX package's:

- each epoch reshuffles the dataset with ``seed + epoch``;
- within an epoch the loader reads indices ``consumed_in_epoch + i``;
- ``consumed_samples`` advances by ``micro_batch_size`` per micro-batch,
  so a resume from a checkpoint's ``consumed_samples`` continues the
  stream exactly;
- trailing samples that do not fill a micro-batch are dropped.

The port trains on one device, so the data-parallel stride of the JAX
loader is 1 here (its topology refuses a larger ``data_parallel_size``).
"""

from __future__ import annotations

from typing import Any, Generator, List

import numpy as np

from ..resilience.faults import get_fault_plan
from ..resilience.guards import DEFAULT_RETRY_ATTEMPTS, DEFAULT_RETRY_BACKOFF_SECONDS, retry_io
from .base_dataset import BaseDataset


class RandomSampler:
    """Yields the index list of each micro-batch, resumable."""

    def __init__(self, dataset: BaseDataset, seed: int, consumed_samples: int,
                 micro_batch_size: int, shuffle: bool = True):
        self.dataset = dataset
        self.seed = seed
        self.consumed_samples = consumed_samples
        self.micro_batch_size = micro_batch_size
        self.shuffle = shuffle
        self.total_samples = len(dataset)
        self.usable_total_samples = (self.total_samples // micro_batch_size) * micro_batch_size
        if self.usable_total_samples <= 0:
            raise ValueError("no usable samples; the dataset is smaller than one micro-batch")
        if consumed_samples % micro_batch_size != 0:
            raise ValueError(
                f"consumed_samples ({consumed_samples}) must be a multiple of "
                f"micro_batch_size ({micro_batch_size}); a checkpoint of this trainer "
                "always satisfies this")

    def __len__(self) -> int:
        """Micro-batches per epoch."""
        return self.usable_total_samples // self.micro_batch_size

    def __iter__(self) -> Generator[List[int], None, None]:
        mbs = self.micro_batch_size
        while True:  # epochs chain, each with a fresh shuffle
            epoch = self.consumed_samples // self.usable_total_samples
            in_epoch = self.consumed_samples % self.usable_total_samples
            self.dataset.set_seed(seed=self.seed + epoch, shuffle=self.shuffle)
            indices = np.arange(in_epoch, self.usable_total_samples, dtype=np.int64)
            for m in range(len(indices) // mbs):
                self.consumed_samples += mbs
                yield indices[m * mbs:(m + 1) * mbs].tolist()


class DataLoader:
    """Infinite iterator over micro-batches; ``next(loader)`` gives the
    dataset's collated batch."""

    def __init__(self, seed: int, consumed_samples: int, dataset: BaseDataset,
                 micro_batch_size: int, shuffle: bool = True,
                 retry_attempts: int = DEFAULT_RETRY_ATTEMPTS,
                 retry_backoff: float = DEFAULT_RETRY_BACKOFF_SECONDS):
        if len(dataset) < micro_batch_size:
            raise ValueError(f"cannot instantiate data loader with micro_batch_size "
                             f"{micro_batch_size} because dataset has only length "
                             f"{len(dataset)}")
        self.consumed_samples = consumed_samples
        self.dataset = dataset
        self.retry_attempts = retry_attempts
        self.retry_backoff = retry_backoff
        self._sampler = RandomSampler(dataset, seed, consumed_samples, micro_batch_size,
                                      shuffle)
        self._iter = iter(self._sampler)

    def _read_batch(self, indices: List[int]) -> Any:
        # the fault point and the index-based reads retry together: a retry
        # reads the same samples again
        get_fault_plan().fire("data.read")
        return self.dataset.collate([self.dataset[i] for i in indices])

    def __next__(self) -> Any:
        indices = next(self._iter)  # the sampler is not retried: it would skip samples
        batch = retry_io(lambda: self._read_batch(indices), attempts=self.retry_attempts,
                         base_delay=self.retry_backoff,
                         what=f"dataloader read ({len(indices)} samples)")
        self.consumed_samples = self._sampler.consumed_samples
        return batch

    def __iter__(self):
        return self
