"""CLIP's ModifiedResNet vision trunk, the RN50x16 family (counterpart of
scaling_tpu/models/transformer/clip_resnet.py).

A three-convolution stem and an average pool, then four stages of
anti-aliased bottlenecks (a strided block pools before its last 1 x 1
convolution and on its shortcut), without CLIP's attention pool: the last
12 x 12 grid of a 384 x 384 image comes out row-major as 144 tokens of
``8 * channels * 4`` features (3072 for RN50x16).

The convolutions are ``F.conv2d`` over NCHW activations with kernels
stored ``(out, in, kh, kw)``; the JAX tree holds them ``(kh, kw, in,
out)`` under the same names (``parallel_module.to_jax_layout``).
BatchNorm runs off its stored statistics: ``mean`` and ``var`` are
parameters under the JAX names, read through ``detach()`` so that they get
no gradient, in the no-decay group (``no_weight_decay``), so AdamW leaves
them as they are; the affine terms and the kernels train.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

_BN_EPS = 1e-5  # torch.nn.BatchNorm2d's default, which the checkpoints assume
_EXPANSION = 4
_DOWNSAMPLE = 32  # the stem's 4x and three strided stages' 2x each
_PREFIXES = ("visual.", "input_encoder.", "module.")


class _Conv(torch.nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1, padding: int = 0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = torch.nn.Parameter(torch.empty(c_out, c_in, k, k, dtype=dtype,
                                                     device=device))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        self.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, stride=self.stride, padding=self.padding)


class _FrozenStatsBatchNorm(torch.nn.Module):
    """Inference-mode BatchNorm over NCHW in the parameters' dtype; the
    running statistics carry no gradient."""

    no_weight_decay = True  # every parameter here: the no-decay group

    def __init__(self, c: int, dtype=torch.float32, device=None):
        super().__init__()
        factory = dict(dtype=dtype, device=device)
        self.weight = torch.nn.Parameter(torch.ones(c, **factory))
        self.bias = torch.nn.Parameter(torch.zeros(c, **factory))
        self.mean = torch.nn.Parameter(torch.zeros(c, **factory))
        self.var = torch.nn.Parameter(torch.ones(c, **factory))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.var.detach() + _BN_EPS)
        shift = self.bias - self.mean.detach() * scale
        return x * scale[:, None, None] + shift[:, None, None]


class _Bottleneck(torch.nn.Module):
    """1x1-bn-relu, 3x3-bn-relu, avgpool(stride), 1x1-bn, the shortcut
    (pooled, 1x1, bn where the shape changes), add, relu."""

    def __init__(self, c_in: int, planes: int, stride: int, dtype, device=None):
        super().__init__()
        c_out = planes * _EXPANSION
        self.stride = stride
        conv = dict(dtype=dtype, device=device)
        self.conv1 = _Conv(c_in, planes, 1, **conv)
        self.bn1 = _FrozenStatsBatchNorm(planes, **conv)
        self.conv2 = _Conv(planes, planes, 3, padding=1, **conv)
        self.bn2 = _FrozenStatsBatchNorm(planes, **conv)
        self.conv3 = _Conv(planes, c_out, 1, **conv)
        self.bn3 = _FrozenStatsBatchNorm(c_out, **conv)
        self.has_downsample = stride > 1 or c_in != c_out
        if self.has_downsample:
            self.downsample_conv = _Conv(c_in, c_out, 1, **conv)
            self.downsample_bn = _FrozenStatsBatchNorm(c_out, **conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.has_downsample:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.downsample_bn(self.downsample_conv(identity))
        return F.relu(out + identity)


class _Stem(torch.nn.Module):
    def __init__(self, channels: int, dtype, device=None):
        super().__init__()
        half = channels // 2
        conv = dict(dtype=dtype, device=device)
        self.conv1 = _Conv(3, half, 3, stride=2, padding=1, **conv)
        self.bn1 = _FrozenStatsBatchNorm(half, **conv)
        self.conv2 = _Conv(half, half, 3, padding=1, **conv)
        self.bn2 = _FrozenStatsBatchNorm(half, **conv)
        self.conv3 = _Conv(half, channels, 3, padding=1, **conv)
        self.bn3 = _FrozenStatsBatchNorm(channels, **conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        return F.avg_pool2d(x, 2)


class ClipResNetEncoder(torch.nn.Module):
    """(b, image_size, image_size, 3) NHWC -> (b, (image_size / 32)^2,
    8 * channels * 4) tokens."""

    def __init__(self, stage_blocks: Sequence[int] = (6, 8, 18, 8), channels: int = 96,
                 image_size: int = 384, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if len(stage_blocks) != 4:
            raise ValueError(f"ClipResNetEncoder needs exactly 4 stages (CLIP layout), "
                             f"got {tuple(stage_blocks)}")
        if image_size % _DOWNSAMPLE:
            raise ValueError(f"image_size {image_size} is not a multiple of {_DOWNSAMPLE}")
        self.stage_blocks = tuple(stage_blocks)
        self.channels = channels
        self.dtype = dtype
        self.out_dim = channels * 8 * _EXPANSION
        self.tokens = (image_size // _DOWNSAMPLE) ** 2
        self.stem = _Stem(channels, dtype, device)
        c_in = channels
        for i, blocks in enumerate(self.stage_blocks):
            planes = channels * 2 ** i
            stage = torch.nn.Module()
            for j in range(blocks):
                stage.add_module(f"block_{j}", _Bottleneck(
                    c_in, planes, 1 if i == 0 or j > 0 else 2, dtype, device))
                c_in = planes * _EXPANSION
            self.add_module(f"layer{i + 1}", stage)

    def stages(self):
        """Each stage's blocks, in order."""
        return [list(getattr(self, f"layer{i + 1}").children()) for i in range(4)]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.stem(images.to(self.dtype).permute(0, 3, 1, 2))
        for stage in self.stages():
            for block in stage:
                x = block(x)
        b, c, h, w = x.shape
        # the grid row-major as tokens, as CLIP's "b d h w -> b (h w) d"
        return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def import_clip_resnet_weights(encoder: ClipResNetEncoder,
                               state_dict: Mapping[str, torch.Tensor]
                               ) -> Dict[str, torch.Tensor]:
    """An OpenAI-CLIP ModifiedResNet state dict as ``encoder``'s state
    dict, f32 on the CPU. Keys may carry stacked ``visual.``,
    ``input_encoder.`` and ``module.`` prefixes (the full CLIP model, a
    magma image encoder dump, a wrapped module). The stem's channels, each
    stage's depth and each block's shortcut must be the encoder's;
    ValueError names the first that is not."""
    sd = {}
    for k, v in state_dict.items():
        stripped = True
        while stripped:  # prefixes stack, e.g. "module.visual.conv1.weight"
            stripped = False
            for prefix in _PREFIXES:
                if k.startswith(prefix):
                    k, stripped = k[len(prefix):], True
        sd[k] = (v.detach().to("cpu", torch.float32) if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.asarray(v, dtype=np.float32)))
    stem = sd.get("conv1.weight")
    if stem is None:
        raise ValueError("state dict has no ModifiedResNet trunk (conv1.weight)")
    want = (encoder.channels // 2, 3, 3, 3)
    if tuple(stem.shape) != want:
        raise ValueError(f"channel mismatch: checkpoint stem {tuple(stem.shape)} vs encoder "
                         f"channels={encoder.channels} (expected {want})")
    out: Dict[str, torch.Tensor] = {}

    def bn(ours: str, theirs: str) -> None:
        for leaf, key in (("weight", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                          ("var", "running_var")):
            out[f"{ours}.{leaf}"] = sd[f"{theirs}.{key}"]

    for i in (1, 2, 3):
        out[f"stem.conv{i}.weight"] = sd[f"conv{i}.weight"]
        bn(f"stem.bn{i}", f"bn{i}")
    for i, stage in enumerate(encoder.stages()):
        name = f"layer{i + 1}"
        depth = len({k.split(".")[1] for k in sd if k.startswith(f"{name}.")})
        if depth != len(stage):
            raise ValueError(f"stage depth mismatch at {name}: checkpoint has {depth} blocks, "
                             f"encoder expects {len(stage)} "
                             f"(stage_blocks={encoder.stage_blocks})")
        for j, block in enumerate(stage):
            ours, theirs = f"{name}.block_{j}", f"{name}.{j}"
            for c in (1, 2, 3):
                out[f"{ours}.conv{c}.weight"] = sd[f"{theirs}.conv{c}.weight"]
                bn(f"{ours}.bn{c}", f"{theirs}.bn{c}")
            has_ds = f"{theirs}.downsample.0.weight" in sd
            if has_ds != block.has_downsample:
                raise ValueError(f"downsample mismatch at {theirs}")
            if has_ds:
                out[f"{ours}.downsample_conv.weight"] = sd[f"{theirs}.downsample.0.weight"]
                bn(f"{ours}.downsample_bn", f"{theirs}.downsample.1")
    return out
