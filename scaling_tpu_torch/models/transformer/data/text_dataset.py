"""Pretraining text dataset: packed fixed-length windows over memory-mapped
documents (counterpart of scaling_tpu/models/transformer/data/text_dataset.py).

Token documents in a ``MemoryMapDataset`` (or, with ``legacy_dataset``,
a Megatron ``.bin/.idx`` pair) are packed into items of
``sequence_length + 1`` tokens (input and target shifted by one). The
pack index is a pure function of the documents' sizes and the sequence
length, built by the C++ builder of ``scaling_tpu_torch.native``. EOD
tokens start a new segment id; positions restart at each segment.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ....data import BaseDataset, BaseDatasetBatch, BaseDatasetItem
from ....data.blended_dataset import BaseBlendedDataset
from ....data.legacy_indexed_dataset import LegacyIndexedDataset
from ....data.memory_map import MemoryMapDataset
from ....native import build_pack_index
from ....nn.seq_packing import get_position_ids_from_segments, get_segment_ids

# the order of the fields in the one host-to-device copy of a batch
_FIELDS = ("token_ids", "target_token_ids", "position_ids", "segment_ids", "loss_weights")


@dataclass
class TextDatasetItem(BaseDatasetItem):
    token_ids: np.ndarray  # (seq_len + 1,)


class TextDatasetBatch(BaseDatasetBatch):
    """Arrays of shape (..., b, s): int32 ids, f32 loss weights; with
    images (the multimodal finetuning data) also ``input_images`` (..., b,
    n, H, W, 3) f32, ``input_image_locations`` (..., b, n) int32 starts and
    ``input_image_mask`` (..., b, n) bool, False on a padded image slot."""

    def __init__(self, token_ids: np.ndarray, target_token_ids: np.ndarray,
                 position_ids: np.ndarray, segment_ids: np.ndarray,
                 loss_weights: np.ndarray, input_images: Optional[np.ndarray] = None,
                 input_image_locations: Optional[np.ndarray] = None,
                 input_image_mask: Optional[np.ndarray] = None):
        self.token_ids = token_ids
        self.target_token_ids = target_token_ids
        self.position_ids = position_ids
        self.segment_ids = segment_ids
        self.loss_weights = loss_weights
        self.input_images = input_images
        self.input_image_locations = input_image_locations
        self.input_image_mask = input_image_mask

    def as_model_input(self, device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
        """The batch dict ``ParallelModule.forward`` and ``loss_function``
        take, on ``device``, in one host-to-device copy: the five arrays
        go over as one int32 buffer (the f32 weights by their bits), and
        the token ids are widened to int64 on the device. Images, when the
        batch has them, take one more copy, and their starts and mask one."""
        host = np.stack([np.asarray(getattr(self, k), np.float32).view(np.int32)
                         if k == "loss_weights" else np.asarray(getattr(self, k), np.int32)
                         for k in _FIELDS])
        buf = torch.from_numpy(host).to(device)
        out = {
            "token_ids": buf[0].long(),
            "target_token_ids": buf[1].long(),
            "position_ids": buf[2],
            "segment_ids": buf[3],
            "loss_weights": buf[4].view(torch.float32),
        }
        if self.input_images is not None:
            out["input_images"] = torch.from_numpy(
                np.ascontiguousarray(self.input_images, np.float32)).to(device)
            where = torch.from_numpy(np.stack([
                np.asarray(self.input_image_locations, np.int32),
                np.asarray(self.input_image_mask, np.int32)])).to(device)
            out["input_image_locations"], out["input_image_mask"] = where[0], where[1].bool()
        return out


class TextDataset(BaseDataset[TextDatasetItem, TextDatasetBatch]):
    def __init__(self, data_prefix: Union[Path, str], sequence_length: int, seed: int = 42,
                 shuffle: bool = True, eod_token_id: int = 0,
                 only_full_sequences: bool = False,
                 allow_incomplete_sequences_every_n: int = 0,
                 load_index_to_memory: bool = True, legacy_dataset: bool = False):
        self.data_prefix = Path(data_prefix)
        self.sequence_length = sequence_length
        self.eod_token_id = eod_token_id
        self.only_full_sequences = only_full_sequences
        self.allow_incomplete_sequences_every_n = allow_incomplete_sequences_every_n
        # Megatron .bin/.idx data has the same store interface as a memory map
        store = LegacyIndexedDataset if legacy_dataset else MemoryMapDataset
        self.memory_map = store(self.data_prefix, load_index_to_memory=load_index_to_memory)
        self._build_pack_index()
        super().__init__(seed=seed, shuffle=shuffle)

    def _build_pack_index(self) -> None:
        """Item i covers tokens [i*L, i*L + L + 1) of the concatenated
        document stream, L = sequence_length. With only_full_sequences the
        items align to document starts instead, the windows of the C++
        builder (``native.build_pack_index``)."""
        sizes = self.memory_map.sizes().astype(np.int64)
        self._total_tokens = int(sizes.sum())
        if not self.only_full_sequences:
            self._num_items = max((self._total_tokens - 1) // self.sequence_length, 0)
            self._item_starts = self._item_ends = None
            return
        self._item_starts, self._item_ends = build_pack_index(
            sizes, self.sequence_length, self.allow_incomplete_sequences_every_n)
        self._num_items = len(self._item_starts)

    def set_seed(self, seed: int, shuffle: bool = True) -> None:
        # the order of items is the sampler's; the items depend only on the
        # documents and the sequence length
        self.seed = seed
        self.shuffle = shuffle

    def ident(self) -> str:
        h = hashlib.md5(
            f"{self.data_prefix}-{self.sequence_length}-{self.only_full_sequences}".encode()
        ).hexdigest()
        return f"text-{h}"

    def __len__(self) -> int:
        return self._num_items

    def __getitem__(self, index: int) -> TextDatasetItem:
        L = self.sequence_length
        if self._item_starts is None:
            start = index * L
            n = min(L + 1, self._total_tokens - start)
        else:
            # only this window's documents; EOD padding after them
            start = int(self._item_starts[index])
            n = min(L + 1, int(self._item_ends[index]) - start)
        tokens = self.memory_map.read_span(start, n)
        if n < L + 1:
            tokens = np.concatenate(
                [tokens, np.full(L + 1 - n, self.eod_token_id, dtype=tokens.dtype)])
        return TextDatasetItem(token_ids=tokens.astype(np.int64))

    def collate(self, batch: List[TextDatasetItem]) -> TextDatasetBatch:
        tokens = np.stack([item.token_ids for item in batch])  # (b, L+1)
        inputs = tokens[:, :-1]
        targets = tokens[:, 1:]
        segment_ids = get_segment_ids(inputs, self.eod_token_id)
        position_ids = get_position_ids_from_segments(segment_ids)
        # every real token counts, the EOD prediction too; only padding
        # runs (input and target both EOD) weigh 0
        loss_weights = np.maximum((targets != self.eod_token_id).astype(np.float32),
                                  (inputs != self.eod_token_id).astype(np.float32))
        return TextDatasetBatch(
            token_ids=inputs.astype(np.int32),
            target_token_ids=targets.astype(np.int32),
            position_ids=position_ids.astype(np.int32),
            segment_ids=segment_ids.astype(np.int32),
            loss_weights=loss_weights,
        )


class TextBlendedDataset(BaseBlendedDataset):
    """Weighted blend over TextDatasets."""
