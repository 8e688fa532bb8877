"""The CLIP ViT vision tower and its weight import (counterpart of
scaling_tpu/models/transformer/clip_vision.py).

A class token, learned position embeddings, a pre-norm, ``layers``
pre-norm blocks (q/k/v/out projections, softmax attention in f32, a
quick-GELU MLP) and the patch tokens out: a ``CLIPVisionModel``'s
``last_hidden_state[:, 1:]`` once its weights are imported
(``import_clip_vision_weights``). The attention runs unfused (145 tokens,
non-causal), as in the JAX package. The patch kernel is stored as a
linear's ``(width, p * p * 3)`` over ``patchify``'s (ph, pw, c) order,
the position embedding as ``(1 + tokens, width)``; the JAX tree holds the
former transposed and the latter as is, under the same names.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from ...nn.norm import LayerNorm
from .image_encoder import patchify


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _Linear(torch.nn.Linear):
    """A CLIP projection, drawn uniform in +-1/sqrt(fan_in) as the JAX tower
    draws it."""

    def reset_parameters(self) -> None:  # filled by init_ or a state dict
        pass

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.in_features)
        for p in (self.weight, self.bias):
            p.uniform_(-bound, bound, generator=generator)


class _ClipBlock(torch.nn.Module):
    def __init__(self, width: int, heads: int, intermediate: int, dtype, device=None):
        super().__init__()
        self.heads = heads
        linear = dict(dtype=dtype, device=device)
        self.ln1 = LayerNorm(width, dtype=dtype, device=device)
        self.q = _Linear(width, width, **linear)
        self.k = _Linear(width, width, **linear)
        self.v = _Linear(width, width, **linear)
        self.out = _Linear(width, width, **linear)
        self.ln2 = LayerNorm(width, dtype=dtype, device=device)
        self.fc1 = _Linear(width, intermediate, **linear)
        self.fc2 = _Linear(intermediate, width, **linear)

    def _attention(self, x: torch.Tensor) -> torch.Tensor:
        b, t, w = x.shape
        hd = w // self.heads
        q = self.q(x).reshape(b, t, self.heads, hd) * hd ** -0.5
        k = self.k(x).reshape(b, t, self.heads, hd)
        v = self.v(x).reshape(b, t, self.heads, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, w))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self._attention(self.ln1(x))
        return x + self.fc2(_quick_gelu(self.fc1(self.ln2(x))))


class ClipVisionEncoder(torch.nn.Module):
    """(b, H, W, 3) -> (b, grid * grid, width) patch-token features."""

    def __init__(self, width: int = 768, layers: int = 12, heads: int = 12,
                 patch_size: int = 32, image_size: int = 384,
                 intermediate: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(f"image_size {image_size} is not a multiple of patch {patch_size}")
        if width % heads:
            raise ValueError(f"width {width} does not divide over {heads} heads")
        self.width, self.num_layers, self.heads = width, layers, heads
        self.patch_size, self.image_size = patch_size, image_size
        self.grid = image_size // patch_size
        self.tokens = self.grid * self.grid
        self.intermediate = intermediate or 4 * width
        self.dtype = dtype
        patch_dim = patch_size * patch_size * 3
        factory = dict(dtype=dtype, device=device)
        self.class_embedding = torch.nn.Parameter(torch.empty(width, **factory))
        self.patch_embedding = torch.nn.Parameter(torch.empty(width, patch_dim, **factory))
        self.position_embedding = torch.nn.Parameter(torch.empty(1 + self.tokens, width,
                                                                 **factory))
        self.pre_norm = LayerNorm(width, **factory)
        for i in range(layers):
            self.add_module(f"block_{i}", _ClipBlock(width, heads, self.intermediate, dtype,
                                                     device))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        """The JAX tower's draws: normal class embedding, normal patch
        kernel over sqrt(fan_in), position embeddings of std 0.02."""
        # initialisation streams the parameters from one generator in a fixed
        # order (the model's definition order), never reseeded between draws
        self.class_embedding.normal_(generator=generator)
        self.patch_embedding.normal_(  # sta: disable=STA004
            0.0, 1.0 / math.sqrt(self.patch_embedding.shape[1]), generator=generator)
        self.position_embedding.normal_(0.0, 0.02, generator=generator)  # sta: disable=STA004

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = F.linear(patchify(images.to(self.dtype), self.patch_size), self.patch_embedding)
        cls = self.class_embedding.to(x.dtype)[None, None].expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.position_embedding[None]
        x = self.pre_norm(x)
        for i in range(self.num_layers):
            x = getattr(self, f"block_{i}")(x)
        return x[:, 1:]  # the class token is dropped: the stream takes the patches


def import_clip_vision_weights(encoder: ClipVisionEncoder,
                               state_dict: Mapping[str, torch.Tensor]
                               ) -> Dict[str, torch.Tensor]:
    """A ``CLIPVisionModel`` state dict (keys with or without
    ``vision_model.``) as ``encoder``'s state dict, f32 on the CPU. The
    checkpoint's depth, width and MLP width must be the encoder's
    (ValueError names the one that is not); its patch size too. The conv
    patch kernel ``(width, 3, p, p)`` flattens in (ph, pw, c) order; a
    position grid of another size is bicubic-interpolated as the JAX import
    (and HF's ``interpolate_pos_encoding``) does. ``post_layernorm`` feeds
    only CLIP's pooled head and is not imported."""
    sd = {k.removeprefix("vision_model."): v.detach().to("cpu", torch.float32)
          for k, v in state_dict.items()}
    layers = 1 + max((int(m.group(1)) for k in sd
                      if (m := re.match(r"encoder\.layers\.(\d+)\.", k))), default=-1)
    if layers != encoder.num_layers:
        raise ValueError(f"checkpoint has {layers} encoder layers but the encoder is "
                         f"configured for {encoder.num_layers} (set image_encoder_layers "
                         "to the checkpoint's depth)")
    width = sd["embeddings.class_embedding"].shape[-1]
    if width != encoder.width:
        raise ValueError(f"checkpoint width {width} != encoder width {encoder.width} "
                         "(set image_encoder_width to the checkpoint's hidden_size)")
    inter = sd["encoder.layers.0.mlp.fc1.weight"].shape[0]
    if inter != encoder.intermediate:
        raise ValueError(f"checkpoint mlp width {inter} != encoder intermediate "
                         f"{encoder.intermediate}")
    p = encoder.patch_size
    conv = sd["embeddings.patch_embedding.weight"]
    if tuple(conv.shape) != (width, 3, p, p):
        raise ValueError(f"checkpoint patch kernel {tuple(conv.shape)} != encoder patch {p}")
    pos = sd["embeddings.position_embedding.weight"]
    src = pos.shape[0] - 1
    if src != encoder.tokens:
        grid = int(round(math.sqrt(src)))
        if grid * grid != src:
            raise ValueError(f"checkpoint position grid of {src} tokens is not square")
        patch_pos = pos[1:].reshape(1, grid, grid, width).permute(0, 3, 1, 2)
        patch_pos = F.interpolate(patch_pos, size=(encoder.grid, encoder.grid), mode="bicubic",
                                  align_corners=False)
        pos = torch.cat([pos[:1], patch_pos.permute(0, 2, 3, 1).reshape(encoder.tokens, width)])
    out = {
        "class_embedding": sd["embeddings.class_embedding"],
        # (width, c, ph, pw) -> (width, ph, pw, c) -> (width, p * p * c)
        "patch_embedding": conv.permute(0, 2, 3, 1).reshape(width, p * p * 3),
        "position_embedding": pos,
        "pre_norm.weight": sd["pre_layrnorm.weight"],  # HF's spelling
        "pre_norm.bias": sd["pre_layrnorm.bias"],
    }
    names = {"ln1": "layer_norm1", "ln2": "layer_norm2", "q": "self_attn.q_proj",
             "k": "self_attn.k_proj", "v": "self_attn.v_proj", "out": "self_attn.out_proj",
             "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    for i in range(encoder.num_layers):
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                out[f"block_{i}.{ours}.{leaf}"] = sd[f"encoder.layers.{i}.{theirs}.{leaf}"]
    return {k: v.contiguous() for k, v in out.items()}
