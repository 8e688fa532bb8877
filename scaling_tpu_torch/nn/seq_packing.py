"""Packed-sequence masks (``segment_ids_to_mask`` of scaling_tpu/nn/seq_packing.py).

Token ``t`` of row ``b`` belongs to packed document ``segment_ids[b, t]``;
attention is allowed only within equal segment ids.
"""

from __future__ import annotations

from typing import Optional

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
