"""The transformer's datasets (counterpart of scaling_tpu/models/transformer/data/)."""

from .finetuning import (
    FinetuningChatBlendedDataset,
    FinetuningChatDataset,
    FinetuningItem,
    FinetuningTextBlendedDataset,
    FinetuningTextDataset,
)
from .text_dataset import TextBlendedDataset, TextDataset, TextDatasetBatch, TextDatasetItem

__all__ = ["FinetuningChatBlendedDataset", "FinetuningChatDataset", "FinetuningItem",
           "FinetuningTextBlendedDataset", "FinetuningTextDataset", "TextBlendedDataset",
           "TextDataset", "TextDatasetBatch", "TextDatasetItem"]
