"""Blended (multi-source) datasets (the port's copy of
scaling_tpu/data/blended_dataset.py).

Mixes N component datasets with weights from one of three schemes:
``weight_by_num_documents`` (p(L) proportional to |L|**alpha),
``weight_examples_proportional`` (T5 mixing with a cap and a temperature)
or explicit ``weights``. The interleave index maps each global index to a
(dataset, sample) pair, spreading each dataset's samples evenly; it is
cached on disk under the same file names as the JAX package's, holds the
same indices for the same seed and datasets, and is published with
atomic renames (meta last).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .base_dataset import BaseDataset

_log = logging.getLogger("scaling_tpu_torch")


@dataclasses.dataclass(frozen=True)
class BlendedDatasetConfig:
    """The ``data.blended_dataset`` section, under the JAX key names and
    defaults."""

    weight_by_num_documents: bool = True  # overrides ``weights`` when set
    weighted_sampler_alpha: float = 0.3
    weights: Optional[List[float]] = None
    weight_examples_proportional: bool = False
    ep_maximum: Optional[int] = None
    ep_temperature: float = 1.0
    minimum_dataset_size: int = 0
    cache_directory: Optional[Path] = None
    shuffle_dataset_indices: bool = True

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BlendedDatasetConfig":
        d = dict(d)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown data.blended_dataset keys: {sorted(unknown)}")
        if d.get("cache_directory") is not None:
            d["cache_directory"] = Path(d["cache_directory"])
        return cls(**d)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if self.cache_directory is not None:
            d["cache_directory"] = str(self.cache_directory)
        return d


def weights_by_num_docs(examples: List[int], alpha: float = 0.3) -> np.ndarray:
    """p_i ∝ n_i; q_i ∝ p_i**alpha; weight_i ∝ q_i / p_i (normalised)."""
    n = np.asarray(examples, dtype=np.float64)
    p = n / n.sum()
    q = p ** alpha
    q = q / q.sum()
    w = q / p
    return w / w.sum()


def weights_examples_proportional(examples: List[int], temperature: float = 1.0,
                                  maximum: Optional[float] = None) -> np.ndarray:
    if not temperature:
        raise ValueError("temperature must be a non-zero float")
    n = np.asarray(examples, dtype=np.float64)
    p = n / n.sum()
    capped = n.copy()
    if maximum:
        if maximum <= 0:
            raise ValueError(f"examples-proportional sampling requires maximum > 0 "
                             f"(got {maximum})")
        capped = np.minimum(capped, maximum)
    r = capped / capped.sum()
    if temperature != 1.0:
        r = r ** (1.0 / temperature)
        r = r / r.sum()
    w = r / p
    return w / w.sum()


def interleave_counts(counts: np.ndarray) -> np.ndarray:
    """(sum(counts), 2) int64 rows of (dataset index, sample index within
    it), each dataset's samples spread evenly: sample j of dataset d sits
    at target position (j + 0.5) / counts[d], and a stable sort of those
    positions orders the rows."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    ds_col = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    within = (np.concatenate([np.arange(c, dtype=np.int64) for c in counts]) if total
              else np.empty(0, np.int64))
    pos = (within + 0.5) / np.repeat(counts, counts)
    order = np.argsort(pos, kind="stable")
    return np.stack([ds_col[order], within[order]], axis=1)


def _atomic_write(path: Path, payload: bytes) -> None:
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=path.name + ".tmp")
    with os.fdopen(fd, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)


class BaseBlendedDataset(BaseDataset):
    """Blend of component datasets; global index -> (dataset, sample)."""

    def __init__(self, seed: int, config: BlendedDatasetConfig,
                 datasets: Sequence[BaseDataset]):
        self.config = config
        self.datasets = list(datasets)
        self.num_datasets = len(self.datasets)
        if self.num_datasets == 0:
            raise ValueError("need at least one component dataset")
        self.seed: Optional[int] = None
        self.weights: Optional[np.ndarray] = None
        self.set_seed(seed=seed, shuffle=True)

    def ident(self) -> str:
        prefix_hash = hashlib.md5("-".join(d.ident() for d in self.datasets).encode()).hexdigest()
        weights = self.weights if self.weights is not None else np.ones(self.num_datasets)
        weight_hash = hashlib.md5(
            "-".join(str(round(float(w) * 100) / 100) for w in weights).encode()).hexdigest()
        return f"{self.datasets[0].__class__.__name__}_prefix_{prefix_hash}_weights_{weight_hash}"

    def _compute_weights(self, sizes: List[int]) -> np.ndarray:
        c = self.config
        if c.weight_by_num_documents:
            if c.weight_examples_proportional:
                return weights_examples_proportional(sizes, c.ep_temperature, c.ep_maximum)
            return weights_by_num_docs(sizes, c.weighted_sampler_alpha)
        if c.weights is None or len(c.weights) != self.num_datasets:
            raise ValueError("weight_by_num_documents=False needs one weight per dataset")
        w = np.asarray(c.weights, dtype=np.float64)
        if not w.sum() > 0.0:
            raise ValueError(f"weights must sum above 0: {c.weights}")
        return w / w.sum()

    def set_seed(self, seed: int, shuffle: bool = True) -> None:
        if seed == self.seed:
            return
        if not shuffle:
            raise ValueError("blended datasets are always shuffled")
        self.seed = seed
        if self.num_datasets == 1:
            self.datasets[0].set_seed(seed=seed, shuffle=shuffle)
            self.size = len(self.datasets[0])
            self.dataset_indices = None
            return
        sizes = []
        for ds in self.datasets:
            ds.set_seed(seed=seed, shuffle=shuffle)
            sizes.append(len(ds))
        self.weights = self._compute_weights(sizes)
        # the largest-weighted dataset is fully represented, the rest
        # scaled down in proportion
        rel = self.weights / self.weights.max()
        if self.config.weight_examples_proportional:
            counts = [max(1, int(round(p * n))) for n, p in zip(sizes, rel)]
        else:
            counts = [max(1, int(p * n)) for n, p in zip(sizes, rel)]
        index = self._load_or_build_index(seed, np.array(counts, dtype=np.int64))
        if self.config.shuffle_dataset_indices:
            np.random.RandomState(seed=seed).shuffle(index)
        self.dataset_indices = index
        self.size = index.shape[0]

    def _load_or_build_index(self, seed: int, counts: np.ndarray) -> np.ndarray:
        if self.config.cache_directory is None:
            return interleave_counts(counts)
        cache_dir = Path(self.config.cache_directory)
        cache_dir.mkdir(parents=True, exist_ok=True)
        stem = cache_dir / f"index_cache_blended_dataset_seed_{seed}_{self.ident()}"
        bin_path = Path(str(stem) + ".bin")
        meta_path = Path(str(stem) + ".meta.json")
        input_path = Path(str(stem) + ".input.json")
        if meta_path.is_file() and bin_path.is_file():
            meta = json.loads(meta_path.read_text())
            data = np.fromfile(bin_path, dtype=np.dtype(meta["dtype"]))
            # the stem hashes the weights to 2 decimals only: the exact
            # counts decide whether the cached index is this mixture's
            cached_counts = None
            if input_path.is_file():
                cached_counts = json.loads(input_path.read_text()).get("counts")
            if data.size == int(np.prod(meta["shape"])) and cached_counts == counts.tolist():
                return data.reshape(tuple(meta["shape"]))
            _log.warning(f"blended index cache at {bin_path} is stale or truncated; rebuilding")
        index = interleave_counts(counts)
        _atomic_write(bin_path, index.tobytes())
        _atomic_write(input_path, json.dumps({"counts": counts.tolist(), "seed": seed}).encode())
        _atomic_write(meta_path, json.dumps({"dtype": index.dtype.name,
                                             "shape": list(index.shape)}).encode())
        return index

    def __len__(self) -> int:
        return max(self.size, self.config.minimum_dataset_size)

    def __getitem__(self, index: int):
        if self.size < self.config.minimum_dataset_size:
            index %= self.size
        if self.num_datasets == 1:
            return self.datasets[0][index]
        ds_idx, sample_idx = self.dataset_indices[index]
        return self.datasets[int(ds_idx)][int(sample_idx)]

    def collate(self, batch: list):
        return self.datasets[0].collate(batch=batch)

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}_{self.datasets[0].__class__.__name__}"
