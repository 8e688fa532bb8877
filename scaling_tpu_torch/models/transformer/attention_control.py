"""AtMan attention controls for inference (counterpart of
scaling_tpu/models/transformer/attention_control.py).

Per-token factors become a manipulation of the pre-softmax attention
scores that every layer applies (``scores_manipulation`` of
``nn.attention``). Both variants of the JAX package:

- log-additive (``log_additive=True``, the default): every query's score
  against a controlled key position moves by ``log(factor)``, -10000 for
  factor 0, so the softmax weight of that key is scaled by ``factor``;
- multiplicative (``log_additive=False``): a matrix of ones with
  ``factor`` in the controlled columns, which the attention multiplies into
  scores shifted so that each row's least unmasked score is 0.

Duplicate controls of one position are last-wins, as in the JAX package.
A manipulation routes the attention to its unfused path: the flash kernels
and the paged serving path take none.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Control:
    """Scale attention toward the key position ``token_index`` by
    ``factor`` (< 1 suppresses; 0 removes the token under the log-additive
    variant and pins its column at the row's least score under the
    multiplicative one)."""

    token_index: int
    factor: float

    def __post_init__(self):
        if self.token_index < 0:
            raise ValueError(f"control token_index must be >= 0, got {self.token_index}")
        if not self.factor >= 0:
            raise ValueError(f"control factor must be >= 0, got {self.factor}")


def build_attention_scores_manipulation(controls: Sequence[Control], seq_len: int,
                                        batch_size: int = 1, dtype=torch.float32,
                                        log_additive: bool = True,
                                        device=None) -> Optional[torch.Tensor]:
    """``(batch_size, 1, seq_len, seq_len)`` score manipulation of
    ``controls``, or None when there are none: every query's row is the
    same, so one row of ``seq_len`` values is built on ``device`` and
    expanded (a view). A control past the sequence raises ValueError."""
    if not controls:
        return None
    row = torch.full((seq_len,), 0.0 if log_additive else 1.0, dtype=torch.float32)
    for c in controls:
        if c.token_index >= seq_len:
            raise ValueError(f"control token_index {c.token_index} >= sequence length {seq_len}")
        if log_additive:
            row[c.token_index] = -10000.0 if c.factor == 0.0 else math.log(c.factor)
        else:
            row[c.token_index] = c.factor
    row = row.to(device=device, dtype=dtype)
    return row.expand(batch_size, 1, seq_len, seq_len)
