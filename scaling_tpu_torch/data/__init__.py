"""Token datasets and the resumable loader (counterpart of scaling_tpu/data/)."""

from .base_dataset import BaseDataset, BaseDatasetBatch, BaseDatasetItem
from .blended_dataset import (
    BaseBlendedDataset,
    BlendedDatasetConfig,
    interleave_counts,
    weights_by_num_docs,
    weights_examples_proportional,
)
from .dataloader import DataLoader, RandomSampler
from .memory_map import MemoryMapDataset, MemoryMapDatasetBuilder

__all__ = [
    "BaseBlendedDataset",
    "BaseDataset",
    "BaseDatasetBatch",
    "BaseDatasetItem",
    "BlendedDatasetConfig",
    "DataLoader",
    "MemoryMapDataset",
    "MemoryMapDatasetBuilder",
    "RandomSampler",
    "interleave_counts",
    "weights_by_num_docs",
    "weights_examples_proportional",
]
