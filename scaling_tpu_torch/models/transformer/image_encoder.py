"""The multimodal image encoder (counterpart of
scaling_tpu/models/transformer/image_encoder.py): a (b, 384, 384, 3) image
becomes 144 prefix tokens of the stream's width, which the embedding
splices into the token embeddings (``layers/embedding.py``).

Three backbones, as in the JAX package:

- ``vit`` (default): 32 x 32 patches (``patchify``, a reshape) through one
  linear, ``layers`` pre-norm blocks of bidirectional attention and a GELU
  MLP (the port's ``ParallelSelfAttention`` with ``causal=False``, which
  runs unfused: the flash kernels are causal), and a final LayerNorm;
- ``clip``: a CLIP ViT tower (``clip_vision.py``) that loads a
  ``CLIPVisionModel`` state dict;
- ``clip_resnet``: CLIP's ModifiedResNet, RN50x16 at the defaults
  (``clip_resnet.py``), whose convolutions stay ``F.conv2d``.

Then a linear into the stream's width, dropout at the site
``layer_0.image_encoder`` in a training pass, and a LayerNorm. Parameter
names are the JAX tree's (``patch_proj``, ``block_{i}``, ``out_norm``,
``clip``, ``proj``, ``final_norm``), so weights and checkpoints cross by
name.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch

from ...nn.attention import ParallelSelfAttention
from ...nn.base_layer import DropoutContext, dropout
from ...nn.linear import Linear
from ...nn.mlp import ParallelMLP
from ...nn.norm import LayerNorm

IMAGE_SIZE = 384
PATCH_SIZE = 32
IMAGE_ENCODER_TOKEN_COUNTS = (IMAGE_SIZE // PATCH_SIZE) ** 2  # 144
BACKBONES = ("vit", "clip", "clip_resnet")


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(b, H, W, c) -> (b, tokens, p * p * c), each patch flattened in
    (ph, pw, c) order: the order the CLIP import flattens the pretrained
    patch kernel in, so both backbones share this one definition."""
    b, h, w, c = images.shape
    p = patch_size
    x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


class _VitBlock(torch.nn.Module):
    """Pre-norm block: bidirectional attention, then a GELU MLP (x4), each
    with a residual."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.norm1 = LayerNorm(width, dtype=dtype, device=device)
        self.attention = ParallelSelfAttention(width, heads, qkv_in_one=True, causal=False,
                                               dtype=dtype, device=device)
        self.norm2 = LayerNorm(width, dtype=dtype, device=device)
        self.mlp = ParallelMLP(width, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x + self.attention(self.norm1(x), None)
        return h + self.mlp(self.norm2(h))


class ImageEncoder(torch.nn.Module):
    """(b, 384, 384, 3) images -> (b, 144, out_features) prefix tokens."""

    def __init__(self, out_features: int, width: int = 768, layers: int = 6, heads: int = 12,
                 dropout_p: float = 0.0, dtype: torch.dtype = torch.float32,
                 backbone: str = "vit", resnet_stages: Sequence[int] = (6, 8, 18, 8),
                 resnet_channels: int = 96, device=None, site: str = "layer_0.image_encoder"):
        super().__init__()
        if backbone not in BACKBONES:
            raise ValueError(f"image encoder backbone must be one of {BACKBONES}, "
                             f"got {backbone!r}")
        self.backbone = backbone
        self.dtype = dtype
        self.dropout_p = dropout_p
        self.site = site
        self.num_layers = layers
        trunk_dim = width
        if backbone == "clip":
            from .clip_vision import ClipVisionEncoder

            self.clip = ClipVisionEncoder(width=width, layers=layers, heads=heads,
                                          patch_size=PATCH_SIZE, image_size=IMAGE_SIZE,
                                          dtype=dtype, device=device)
        elif backbone == "clip_resnet":
            from .clip_resnet import ClipResNetEncoder

            self.clip = ClipResNetEncoder(stage_blocks=tuple(resnet_stages),
                                          channels=resnet_channels, image_size=IMAGE_SIZE,
                                          dtype=dtype, device=device)
            trunk_dim = self.clip.out_dim
        else:
            self.patch_proj = Linear(PATCH_SIZE * PATCH_SIZE * 3, width, dtype=dtype,
                                     device=device)
            for i in range(layers):
                self.add_module(f"block_{i}", _VitBlock(width, heads, dtype, device))
            self.out_norm = LayerNorm(width, dtype=dtype, device=device)
        self.proj = Linear(trunk_dim, out_features, dtype=dtype, device=device)
        self.final_norm = LayerNorm(out_features, dtype=dtype, device=device)

    def load_clip_weights(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Replace the CLIP trunk's weights, in place, with pretrained ones
        (a ``CLIPVisionModel`` state dict for ``clip``, an OpenAI-CLIP
        ModifiedResNet one for ``clip_resnet``); the projection into the
        stream keeps its weights."""
        if self.backbone == "clip":
            from .clip_vision import import_clip_vision_weights

            weights = import_clip_vision_weights(self.clip, state_dict)
        elif self.backbone == "clip_resnet":
            from .clip_resnet import import_clip_resnet_weights

            weights = import_clip_resnet_weights(self.clip, state_dict)
        else:
            raise ValueError("load_clip_weights needs a clip backbone")
        self.clip.load_state_dict(weights)

    def forward(self, images: torch.Tensor,
                ctx: Optional[DropoutContext] = None) -> torch.Tensor:
        if self.backbone == "vit":
            x = self.patch_proj(patchify(images.to(self.dtype), PATCH_SIZE))
            for i in range(self.num_layers):
                x = getattr(self, f"block_{i}")(x)
            x = self.out_norm(x)
        else:
            x = self.clip(images)
        x = dropout(self.proj(x), self.dropout_p, ctx, self.site)
        return self.final_norm(x)
