"""The transformer's datasets (counterpart of scaling_tpu/models/transformer/data/)."""

from .text_dataset import TextBlendedDataset, TextDataset, TextDatasetBatch, TextDatasetItem

__all__ = ["TextBlendedDataset", "TextDataset", "TextDatasetBatch", "TextDatasetItem"]
