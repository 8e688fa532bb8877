"""Masked softmax of the unfused attention path (counterpart of
scaling_tpu/nn/masked_softmax.py).

``MaskedSoftmaxConfig.kernel`` selects the attention path: ``torch`` is
the unfused path below, ``flash_attention`` the fused kernels (K4/K5)
wherever ``nn.attention.flash_path_active`` allows them. The softmax
fills forbidden scores with -10000 (not -inf), optionally upcasts to f32
and multiplies the scores by ``scale`` first, exactly as the JAX module.
"""

from __future__ import annotations

import dataclasses

import torch

KERNELS = ("torch", "flash_attention")


@dataclasses.dataclass(frozen=True)
class MaskedSoftmaxConfig:
    kernel: str = "torch"
    softmax_in_fp32: bool = False
    scale: float = 1.0

    def __post_init__(self):
        if self.kernel not in KERNELS:
            raise ValueError(f"masked_softmax.kernel must be one of {KERNELS}")


class MaskedSoftmax:
    def __init__(self, config: MaskedSoftmaxConfig):
        self.config = config

    def __call__(self, scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """scores (b, n, s_q, s_k); mask True where attention is FORBIDDEN."""
        input_dtype = scores.dtype
        if self.config.softmax_in_fp32 and scores.dtype != torch.float32:
            scores = scores.float()
        if self.config.scale != 1.0:
            scores = scores * self.config.scale
        scores = scores.masked_fill(mask, -10000.0)
        probs = torch.softmax(scores, dim=-1)
        return probs.to(input_dtype)
