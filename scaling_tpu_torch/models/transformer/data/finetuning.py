"""Finetuning datasets: prompt/completion and chat (counterpart of
scaling_tpu/models/transformer/data/finetuning.py), in the same on-disk
formats:

- text jsonl: ``{"prompt": str, "completion": str}`` a line (the prompt may
  be a list of strings; an image entry raises NotImplementedError, as in
  the JAX package, which has no image encoder on this path);
- text memory map: each record ``[len_prompt, prompt..., completion...]``;
- chat jsonl: each line a list of ``{"type": "text", "content": str,
  "has_loss": bool}`` elements, the tokens of ``has_loss`` elements
  trained (an image element raises NotImplementedError: the image
  encoder is not ported).

Loss weights are 0 on prompt tokens and padding and 1 on the completion
and its closing EOS; items are padded with EOS to ``sequence_length``, an
over-long text item cut from the front of its prompt, a chat item from
its end. With a soft prompt, ``softprompt_n_tokens`` placeholder ids 0
lead every item; the embedding writes the prompt over them. Item order
belongs to the loader's sampler, as in the JAX package.

Both datasets build their tokenizer (``tokenizers``) in the constructor;
the import happens there, not when this module is imported.
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


class FinetuningItem:
    __slots__ = ("token_ids", "target_token_ids", "loss_weights")

    def __init__(self, token_ids: np.ndarray, target_token_ids: np.ndarray,
                 loss_weights: np.ndarray):
        self.token_ids = token_ids
        self.target_token_ids = target_token_ids
        self.loss_weights = loss_weights


class _FinetuningBase(BaseDataset):
    """Item assembly and collate of both finetuning datasets."""

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
                  truncate: str = "front") -> FinetuningItem:
        """``front`` keeps the tail (where a text item's completion is),
        ``back`` the head (a chat item, as the JAX chat dataset)."""
        length = self.sequence_length
        if len(input_ids) > length:
            cut = slice(-length, None) if truncate == "front" else slice(None, length)
            input_ids, target_ids, loss_mask = input_ids[cut], target_ids[cut], loss_mask[cut]
        pad = length - len(input_ids)
        eod = self.eod_token_id
        return FinetuningItem(np.asarray(input_ids + [eod] * pad, dtype=np.int64),
                              np.asarray(target_ids + [eod] * pad, dtype=np.int64),
                              np.asarray(loss_mask + [0] * pad, dtype=np.float32))

    def collate(self, batch: List[FinetuningItem]) -> TextDatasetBatch:
        """One document a row: positions count up, segment ids are 0."""
        tokens = np.stack([b.token_ids for b in batch])
        return TextDatasetBatch(
            token_ids=tokens.astype(np.int32),
            target_token_ids=np.stack([b.target_token_ids for b in batch]).astype(np.int32),
            position_ids=np.broadcast_to(np.arange(tokens.shape[1], dtype=np.int32),
                                         tokens.shape).copy(),
            segment_ids=np.zeros(tokens.shape, dtype=np.int32),
            loss_weights=np.stack([b.loss_weights for b in batch]))


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
        self._samples: List[Dict[str, List[int]]] = []
        missing_eos = 0
        for line in path.read_text().splitlines():
            if not line.strip():
                continue
            tokens: List[int] = []
            mask: List[int] = []
            for i, el in enumerate(json.loads(line)):
                if el["type"] != "text":
                    raise NotImplementedError(
                        f"chat content type {el['type']!r} is not supported (images need the "
                        "image encoder, which is not ported)")
                ids = (self.tokenizer if i == 0 else self.tokenizer_no_prefix_space).encode(
                    el["content"])
                tokens.extend(ids)
                mask.extend([int(bool(el.get("has_loss", False)))] * len(ids))
            if eos is not None and eos not in tokens:
                missing_eos += 1
            self._samples.append({"input": tokens[:-1], "target": tokens[1:],
                                  "mask": mask[1:]})
        if missing_eos:
            logger.warning(
                f"finetuning_chat_dataset does not add EOS automatically; "
                f"{missing_eos}/{len(self._samples)} samples in {path} carry no EOS token — "
                f"append it in your data.jsonl if completions should terminate")
        super().__init__(sequence_length, eos or 0, seed=seed, shuffle=shuffle)

    def ident(self) -> str:
        return self._ident("chat")

    def __len__(self) -> int:
        return len(self._samples)

    def __getitem__(self, index: int) -> FinetuningItem:
        s = self._samples[index]
        pad = [0] * self.softprompt_n_tokens  # placeholders, after the target shift
        return self._assemble(pad + s["input"], pad + s["target"], pad + s["mask"],
                              truncate="back")


class FinetuningTextBlendedDataset(BaseBlendedDataset):
    pass


class FinetuningChatBlendedDataset(BaseBlendedDataset):
    pass
