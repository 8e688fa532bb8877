"""Packed sequences (``segment_ids_to_mask``, ``get_segment_ids`` and
``get_position_ids_from_segments`` of scaling_tpu/nn/seq_packing.py).

Token ``t`` of row ``b`` belongs to packed document ``segment_ids[b, t]``;
attention is allowed only within equal segment ids.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def segment_ids_to_mask(segment_ids: torch.Tensor, causal: bool = True,
                        local_window: Optional[int] = None) -> torch.Tensor:
    """Boolean mask (b, 1, s, s), True where attention is FORBIDDEN."""
    allowed = segment_ids[:, :, None] == segment_ids[:, None, :]
    if causal or local_window is not None:
        positions = torch.arange(segment_ids.shape[1], device=segment_ids.device)
        rel = positions[:, None] - positions[None, :]
        if causal:
            allowed = allowed & (rel >= 0)
        if local_window is not None:
            allowed = allowed & (rel.abs() <= local_window)
    return ~allowed[:, None, :, :]


def get_segment_ids(token_ids: np.ndarray, eod_token: int = 0) -> np.ndarray:
    """Per-token packed-document ids on the host (numpy, int32): the id
    increments after each EOD token."""
    after_eod = np.zeros(token_ids.shape, dtype=np.int32)
    after_eod[:, 1:] = token_ids[:, :-1] == eod_token
    return np.cumsum(after_eod, axis=1).astype(np.int32)


def get_position_ids_from_segments(segment_ids: np.ndarray) -> np.ndarray:
    """Positions restarting at 0 at each segment boundary (numpy)."""
    b, s = segment_ids.shape
    idx = np.arange(s, dtype=np.int64)[None, :]
    is_start = np.zeros((b, s), dtype=bool)
    is_start[:, 0] = True
    is_start[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
    start_idx = np.maximum.accumulate(np.where(is_start, idx, 0), axis=1)
    return idx - start_idx
