"""Finetuning datasets: prompt/completion and chat (counterpart of
scaling_tpu/models/transformer/data/finetuning.py), in the same on-disk
formats:

- text jsonl: ``{"prompt": str, "completion": str}`` a line (the prompt may
  be a list of strings; an image entry raises NotImplementedError, as in
  the JAX package);
- text memory map: each record ``[len_prompt, prompt..., completion...]``;
- chat jsonl: each line a list of ``{"type": "text", "content": str,
  "has_loss": bool}`` and ``{"type": "image", "content": path}`` elements
  (the path relative to the data file's directory), the tokens of
  ``has_loss`` elements trained. An image takes 144 placeholder tokens (the
  EOS id, weight 0), which the embedding overwrites with the encoded image
  (``layers/embedding.py``); it is read by ``load_image`` (PIL, CLIP's
  preprocessing) when its item is.

Loss weights are 0 on prompt tokens and padding and 1 on the completion
and its closing EOS; items are padded with EOS to ``sequence_length``, an
over-long text item cut from the front of its prompt, a chat item from
its end, and an image whose 144 tokens no longer fit is dropped with its
start. A chat dataset's batches carry ``max_images`` image slots, the most
any of its samples has, padded with zero images that ``input_image_mask``
leaves out. With a soft prompt, ``softprompt_n_tokens`` placeholder ids 0
lead every item; the embedding writes the prompt over them. Item order
belongs to the loader's sampler, as in the JAX package.

Both datasets build their tokenizer (``tokenizers``) in the constructor;
that import, and PIL's, happen there, not when this module is imported.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from ....data.base_dataset import BaseDataset
from ....data.blended_dataset import BaseBlendedDataset
from ....data.memory_map import MemoryMapDataset
from ....logging import logger
from ..tokenizer import load_tokenizers
from .text_dataset import TextDatasetBatch


IMAGE_ENCODER_TOKEN_COUNT = 144  # (384 / 32)^2 patches (image_encoder.py)
IMAGE_SIZE = 384
# CLIP's preprocessing constants
_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def load_image(path: Path) -> np.ndarray:
    """An image file as a normalised (384, 384, 3) f32 array: RGB, bicubic
    resize, CLIP's mean and std."""
    from PIL import Image

    img = Image.open(str(path)).convert("RGB").resize((IMAGE_SIZE, IMAGE_SIZE), Image.BICUBIC)
    return (np.asarray(img, dtype=np.float32) / 255.0 - _IMAGE_MEAN) / _IMAGE_STD


class FinetuningItem:
    __slots__ = ("token_ids", "target_token_ids", "loss_weights", "images", "image_locations")

    def __init__(self, token_ids: np.ndarray, target_token_ids: np.ndarray,
                 loss_weights: np.ndarray, images: Optional[List[np.ndarray]] = None,
                 image_locations: Optional[List[int]] = None):
        self.token_ids = token_ids
        self.target_token_ids = target_token_ids
        self.loss_weights = loss_weights
        self.images = images  # (H, W, 3) arrays, or None
        self.image_locations = image_locations  # each image's first position


class _FinetuningBase(BaseDataset):
    """Item assembly and collate of both finetuning datasets."""

    # image slots in every batch: a dataset-wide count keeps the batch's
    # shapes the same from step to step
    max_images: int = 0

    def __init__(self, sequence_length: int, eod_token_id: int, seed: int = 42,
                 shuffle: bool = True):
        self.sequence_length = sequence_length
        self.eod_token_id = eod_token_id
        super().__init__(seed=seed, shuffle=shuffle)

    def set_seed(self, seed: int, shuffle: bool = True) -> None:
        # the order is the loader's RandomSampler's, a function of the seed
        self.seed = seed
        self.shuffle = shuffle

    def _ident(self, kind: str) -> str:
        h = hashlib.md5(
            f"{self.data_prefix}-{self.sequence_length}-{self.vocab_file}".encode()).hexdigest()
        return f"finetune-{kind}-{h}"

    def _assemble(self, input_ids: List[int], target_ids: List[int], loss_mask: List[int],
                  truncate: str = "front", images: Optional[List[np.ndarray]] = None,
                  image_locations: Optional[List[int]] = None) -> FinetuningItem:
        """``front`` keeps the tail (where a text item's completion is),
        ``back`` the head (a chat item, as the JAX chat dataset, which keeps
        image starts valid). An image whose span no longer fits is dropped:
        the cut may reach it, and a trailing image loses its last
        placeholder to the target shift."""
        length = self.sequence_length
        if len(input_ids) > length:
            cut = slice(-length, None) if truncate == "front" else slice(None, length)
            input_ids, target_ids, loss_mask = input_ids[cut], target_ids[cut], loss_mask[cut]
        if image_locations is not None:
            keep = [i for i, start in enumerate(image_locations)
                    if start + IMAGE_ENCODER_TOKEN_COUNT <= len(input_ids)]
            images = [images[i] for i in keep]
            image_locations = [image_locations[i] for i in keep]
        pad = length - len(input_ids)
        eod = self.eod_token_id
        return FinetuningItem(np.asarray(input_ids + [eod] * pad, dtype=np.int64),
                              np.asarray(target_ids + [eod] * pad, dtype=np.int64),
                              np.asarray(loss_mask + [0] * pad, dtype=np.float32),
                              images, image_locations)

    def collate(self, batch: List[FinetuningItem]) -> TextDatasetBatch:
        """One document a row: positions count up, segment ids are 0; with
        ``max_images`` slots, each row's images, starts and mask."""
        tokens = np.stack([b.token_ids for b in batch])
        out = TextDatasetBatch(
            token_ids=tokens.astype(np.int32),
            target_token_ids=np.stack([b.target_token_ids for b in batch]).astype(np.int32),
            position_ids=np.broadcast_to(np.arange(tokens.shape[1], dtype=np.int32),
                                         tokens.shape).copy(),
            segment_ids=np.zeros(tokens.shape, dtype=np.int32),
            loss_weights=np.stack([b.loss_weights for b in batch]))
        n = self.max_images
        if n > 0:
            images = np.zeros((len(batch), n, IMAGE_SIZE, IMAGE_SIZE, 3), np.float32)
            starts = np.zeros((len(batch), n), np.int32)
            mask = np.zeros((len(batch), n), bool)
            for i, item in enumerate(batch):
                for j, (img, start) in enumerate(zip(item.images or [],
                                                     item.image_locations or [])):
                    images[i, j], starts[i, j], mask[i, j] = img, start, True
            out.input_images, out.input_image_locations, out.input_image_mask = (
                images, starts, mask)
        return out


def _jsonl_path(prefix: Path) -> Path:
    return prefix if prefix.suffix == ".jsonl" or prefix.exists() else prefix.with_suffix(".jsonl")


class FinetuningTextDataset(_FinetuningBase):
    """Prompt/completion pairs from jsonl or a memory map."""

    def __init__(self, data_prefix: Union[Path, str], sequence_length: int,
                 vocab_file: Union[Path, str], seed: int = 42, shuffle: bool = True,
                 memory_map_dataset: bool = False, softprompt_n_tokens: int = 0):
        self.data_prefix = Path(data_prefix)
        self.vocab_file = Path(vocab_file)
        self.tokenizer, self.tokenizer_no_prefix_space = load_tokenizers(self.vocab_file)
        self.memory_map_dataset = memory_map_dataset
        self.softprompt_n_tokens = softprompt_n_tokens
        self.mmap: Optional[MemoryMapDataset] = None
        if memory_map_dataset:
            self.mmap = MemoryMapDataset(self.data_prefix)
            self._records: List[Any] = list(range(len(self.mmap)))
        else:
            lines = _jsonl_path(self.data_prefix).read_text().splitlines()
            self._records = [json.loads(line) for line in lines if line.strip()]
        super().__init__(sequence_length, self.tokenizer.eos_token_id or 0, seed=seed,
                         shuffle=shuffle)

    def ident(self) -> str:
        return self._ident("text")

    def __len__(self) -> int:
        return len(self._records)

    def _token_ids(self, index: int) -> Tuple[List[int], List[int]]:
        if self.mmap is not None:
            rec = np.asarray(self.mmap[self._records[index]]).tolist()
            n_prompt = int(rec[0])
            return rec[1:n_prompt + 1], rec[n_prompt + 1:]
        item = self._records[index]
        prompt = item["prompt"]
        if isinstance(prompt, list):
            prompt_ids: List[int] = []
            for i, p in enumerate(prompt):
                if not isinstance(p, str):
                    raise NotImplementedError(
                        "image prompt entries need the image encoder "
                        "(transformer_architecture.image_encoder)")
                tok = self.tokenizer if i == 0 else self.tokenizer_no_prefix_space
                prompt_ids.extend(tok.encode(p))
        else:
            prompt_ids = self.tokenizer.encode(prompt)
        return prompt_ids, self.tokenizer_no_prefix_space.encode(item["completion"])

    def __getitem__(self, index: int) -> FinetuningItem:
        prompt_ids, completion_ids = self._token_ids(index)
        prompt_ids = [0] * self.softprompt_n_tokens + prompt_ids  # soft-prompt placeholders
        stream = prompt_ids + completion_ids + [self.eod_token_id]
        # the last prompt token predicts the first completion token
        loss_mask = [0] * (len(prompt_ids) - 1) + [1] * (len(completion_ids) + 1)
        return self._assemble(stream[:-1], stream[1:], loss_mask)


class FinetuningChatDataset(_FinetuningBase):
    """Chat transcripts with per-element loss flags."""

    def __init__(self, data_prefix: Union[Path, str], sequence_length: int,
                 vocab_file: Union[Path, str], seed: int = 42, shuffle: bool = True,
                 softprompt_n_tokens: int = 0):
        self.data_prefix = Path(data_prefix)
        self.vocab_file = Path(vocab_file)
        self.softprompt_n_tokens = softprompt_n_tokens
        self.tokenizer, self.tokenizer_no_prefix_space = load_tokenizers(self.vocab_file)
        path = _jsonl_path(self.data_prefix)
        eos = self.tokenizer.eos_token_id
        self._samples: List[Dict[str, Any]] = []
        missing_eos = 0
        for line in path.read_text().splitlines():
            if not line.strip():
                continue
            tokens: List[int] = []
            mask: List[int] = []
            image_paths: List[Path] = []
            image_locations: List[int] = []
            first_text, has_text_eos = True, False
            for el in json.loads(line):
                if el["type"] == "text":
                    tok = self.tokenizer if first_text else self.tokenizer_no_prefix_space
                    ids = tok.encode(el["content"])
                    tokens.extend(ids)
                    mask.extend([int(bool(el.get("has_loss", False)))] * len(ids))
                    first_text = False
                    has_text_eos = has_text_eos or (eos is not None and eos in ids)
                elif el["type"] == "image":
                    # placeholders the embedding overwrites with the encoded image
                    image_paths.append(self.data_prefix.parent / el["content"])
                    image_locations.append(len(tokens))
                    tokens.extend([eos or 0] * IMAGE_ENCODER_TOKEN_COUNT)
                    mask.extend([0] * IMAGE_ENCODER_TOKEN_COUNT)
                else:
                    raise NotImplementedError(f"chat content type {el['type']!r} is not "
                                              "supported")
            if eos is not None and not has_text_eos:  # placeholders reuse the EOS id
                missing_eos += 1
            self._samples.append({"input": tokens[:-1], "target": tokens[1:], "mask": mask[1:],
                                  "image_paths": image_paths,
                                  "image_locations": image_locations})
        if missing_eos:
            logger.warning(
                f"finetuning_chat_dataset does not add EOS automatically; "
                f"{missing_eos}/{len(self._samples)} samples in {path} carry no EOS token — "
                f"append it in your data.jsonl if completions should terminate")
        self.max_images = max((len(s["image_paths"]) for s in self._samples), default=0)
        super().__init__(sequence_length, eos or 0, seed=seed, shuffle=shuffle)

    def ident(self) -> str:
        return self._ident("chat")

    def __len__(self) -> int:
        return len(self._samples)

    def __getitem__(self, index: int) -> FinetuningItem:
        s = self._samples[index]
        n_sp = self.softprompt_n_tokens
        pad = [0] * n_sp  # placeholders, after the target shift
        images = [load_image(p) for p in s["image_paths"]] or None
        return self._assemble(pad + s["input"], pad + s["target"], pad + s["mask"],
                              truncate="back", images=images,
                              image_locations=([start + n_sp for start in s["image_locations"]]
                                               if images else None))


class FinetuningTextBlendedDataset(BaseBlendedDataset):
    pass


class FinetuningChatBlendedDataset(BaseBlendedDataset):
    pass
