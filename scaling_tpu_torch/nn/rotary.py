"""Rotary position embeddings (scaling_tpu/nn/rotary.py), both variants.
Layout is ``(b, s, n, h)``.

- ``RotaryEmbedding``: GPT-NeoX half rotation with cos/sin tables computed
  in f32 on the host and applied in the activation dtype, optionally to a
  leading slice of the head dims;
- ``RotaryEmbeddingComplex``: llama's rotation of adjacent pairs
  ``(x[2i], x[2i+1])`` by ``e^{i t f_i}``, in real f32 arithmetic, the
  result cast to the activation dtype.

Position ids past the table are clamped to its last row, as the JAX
gather clamps them (only padding positions, whose outputs are discarded,
ever reach past it).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def cos_sin_tables(dimensions: int, max_seq_length: int, base: float):
    inv_freq = 1.0 / (base ** (np.arange(0, dimensions, 2, dtype=np.float32) / dimensions))
    t = np.arange(max_seq_length, dtype=np.float32)
    freqs = np.outer(t, inv_freq)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(emb), np.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary_pos_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                         position_ids: torch.Tensor) -> torch.Tensor:
    pos = position_ids.long().clamp(max=cos.shape[0] - 1)
    cos_g = cos[pos][:, :, None, :].to(x.dtype)  # (b, s, 1, d)
    sin_g = sin[pos][:, :, None, :].to(x.dtype)
    return x * cos_g + rotate_half(x) * sin_g


class RotaryEmbedding(torch.nn.Module):
    def __init__(self, dimensions: int, max_seq_length: int, base: float = 10000,
                 device=None):
        super().__init__()
        if dimensions <= 1:
            raise ValueError("RotaryEmbedding cannot use dimensions <= 1")
        self.dimensions = dimensions
        cos, sin = cos_sin_tables(dimensions, max_seq_length, base)
        self.register_buffer("cos", torch.from_numpy(cos).to(device), persistent=False)
        self.register_buffer("sin", torch.from_numpy(sin).to(device), persistent=False)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                position_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        d = self.dimensions
        if query.shape[-1] == d:
            return (apply_rotary_pos_emb(query, self.cos, self.sin, position_ids),
                    apply_rotary_pos_emb(key, self.cos, self.sin, position_ids))
        q_rot = apply_rotary_pos_emb(query[..., :d], self.cos, self.sin, position_ids)
        k_rot = apply_rotary_pos_emb(key[..., :d], self.cos, self.sin, position_ids)
        return (torch.cat([q_rot, query[..., d:]], dim=-1),
                torch.cat([k_rot, key[..., d:]], dim=-1))


def complex_cos_sin_tables(dimensions: int, max_seq_length: int, theta: float):
    """The real and imaginary parts of ``precompute_freqs_cis``: (s, d/2) f32."""
    freqs = 1.0 / (theta ** (np.arange(0, dimensions, 2, dtype=np.float32)[: dimensions // 2]
                             / dimensions))
    angles = np.outer(np.arange(max_seq_length, dtype=np.float32), freqs)
    return np.cos(angles), np.sin(angles)


def apply_complex_rotary_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                             position_ids: torch.Tensor) -> torch.Tensor:
    b, s, n, h = x.shape
    xf = x.float()
    x_even, x_odd = xf[..., 0::2], xf[..., 1::2]  # (b, s, n, h/2)
    pos = position_ids.long().clamp(max=cos.shape[0] - 1)
    cos_g, sin_g = cos[pos][:, :, None, :], sin[pos][:, :, None, :]
    r_even = x_even * cos_g - x_odd * sin_g
    r_odd = x_even * sin_g + x_odd * cos_g
    return torch.stack([r_even, r_odd], dim=-1).reshape(b, s, n, h).to(x.dtype)


class RotaryEmbeddingComplex(torch.nn.Module):
    """Rotates every head dim in adjacent pairs; ``dimensions`` must be the
    head dim, as the JAX layer's shapes require."""

    def __init__(self, dimensions: int, max_seq_length: int, base: float = 10000,
                 device=None):
        super().__init__()
        if dimensions <= 1:
            raise ValueError("RotaryEmbedding cannot use dimensions <= 1")
        self.dimensions = dimensions
        cos, sin = complex_cos_sin_tables(dimensions, max_seq_length, float(base))
        self.register_buffer("cos", torch.from_numpy(cos).to(device), persistent=False)
        self.register_buffer("sin", torch.from_numpy(sin).to(device), persistent=False)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                position_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if query.shape[-1] != self.dimensions:
            raise ValueError(f"rotary_complex rotates whole heads: head dim "
                             f"{query.shape[-1]} != {self.dimensions} rotary dims")
        return (apply_complex_rotary_emb(query, self.cos, self.sin, position_ids),
                apply_complex_rotary_emb(key, self.cos, self.sin, position_ids))


def get_rotary(embedding_type: str, dimensions: int, max_seq_length: int, base: float,
               device=None):
    """The layer's rotary for ``relative_position_embedding_type``: None for
    ``none``."""
    if embedding_type == "rotary":
        return RotaryEmbedding(dimensions, max_seq_length, base, device=device)
    if embedding_type == "rotary_complex":
        return RotaryEmbeddingComplex(dimensions, max_seq_length, base, device=device)
    if embedding_type == "none":
        return None
    raise NotImplementedError(f"relative_position_embedding_type {embedding_type!r}")
