"""Deterministic, resumable data loading (the port's copy of
scaling_tpu/data/dataloader.py).

The sample-order contract is the JAX package's:

- each epoch reshuffles the dataset with ``seed + epoch``;
- within an epoch data rank ``r`` of ``dp`` reads indices
  ``consumed_in_epoch + i * dp + r``;
- ``consumed_samples`` (global) advances by ``micro_batch_size * dp`` per
  micro-batch, so a resume from a checkpoint's ``consumed_samples``
  continues the stream exactly;
- trailing samples that do not fill a micro-batch x dp grid are dropped.

The JAX loader returns every data rank's rows stacked, rank ``r`` at rows
``[r * mbs, (r + 1) * mbs)``, which its mesh then splits; each of the
port's data ranks reads its own rows (``dp_rank``), the same samples.
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
                 micro_batch_size: int, shuffle: bool = True, data_parallel_size: int = 1,
                 dp_rank: int = 0):
        self.dataset = dataset
        self.seed = seed
        self.consumed_samples = consumed_samples
        self.micro_batch_size = micro_batch_size
        self.shuffle = shuffle
        self.dp, self.dp_rank = data_parallel_size, dp_rank
        self.total_samples = len(dataset)
        grid = micro_batch_size * data_parallel_size
        self.usable_total_samples = (self.total_samples // micro_batch_size
                                     // data_parallel_size) * grid
        if self.usable_total_samples <= 0:
            raise ValueError("no usable samples; the dataset is smaller than one micro-batch "
                             "on each data rank")
        if consumed_samples % grid != 0:
            raise ValueError(
                f"consumed_samples ({consumed_samples}) must be a multiple of "
                f"micro_batch_size * data_parallel_size ({grid}); a checkpoint of this "
                "trainer always satisfies this")

    def __len__(self) -> int:
        """Micro-batches per epoch."""
        return self.usable_total_samples // (self.micro_batch_size * self.dp)

    def __iter__(self) -> Generator[List[int], None, None]:
        mbs, dp = self.micro_batch_size, self.dp
        while True:  # epochs chain, each with a fresh shuffle
            epoch = self.consumed_samples // self.usable_total_samples
            in_epoch = self.consumed_samples % self.usable_total_samples
            self.dataset.set_seed(seed=self.seed + epoch, shuffle=self.shuffle)
            per_rank = (self.usable_total_samples - in_epoch) // dp
            indices = np.arange(per_rank, dtype=np.int64) * dp + self.dp_rank + in_epoch
            for m in range(per_rank // mbs):
                self.consumed_samples += mbs * dp
                yield indices[m * mbs:(m + 1) * mbs].tolist()


class DataLoader:
    """Infinite iterator over micro-batches; ``next(loader)`` gives the
    dataset's collated batch."""

    def __init__(self, seed: int, consumed_samples: int, dataset: BaseDataset,
                 micro_batch_size: int, shuffle: bool = True,
                 retry_attempts: int = DEFAULT_RETRY_ATTEMPTS,
                 retry_backoff: float = DEFAULT_RETRY_BACKOFF_SECONDS,
                 data_parallel_size: int = 1, dp_rank: int = 0):
        if len(dataset) < micro_batch_size:
            raise ValueError(f"cannot instantiate data loader with micro_batch_size "
                             f"{micro_batch_size} because dataset has only length "
                             f"{len(dataset)}")
        self.consumed_samples = consumed_samples
        self.dataset = dataset
        self.retry_attempts = retry_attempts
        self.retry_backoff = retry_backoff
        self._sampler = RandomSampler(dataset, seed, consumed_samples, micro_batch_size,
                                      shuffle, data_parallel_size, dp_rank)
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
