"""LoRA adapters (counterpart of scaling_tpu/nn/lora.py, model-parallel
size 1).

``ParallelLoRa`` computes ``(alpha / rank) * B(A(dropout(x)))`` plus an
optional bias; ``A`` is kaiming-uniform with ``kaiming_a`` and ``B``
zero, so the delta starts at 0. The attention layer adds one delta to
each of its query, key, value and dense projections that the config
names. The factors are stored as ``Linear`` weights, ``lora_a`` ``(rank,
in)`` and ``lora_b`` ``(out, rank)``: the JAX package's ``(in, rank)``
and ``(rank, out)`` transposed, as every linear weight crosses.
"""

from __future__ import annotations

import dataclasses
import math
from enum import Enum
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .base_layer import DropoutContext, dropout


class LoRAModuleType(Enum):
    QUERY = "query"
    KEY = "key"
    VALUE = "value"
    DENSE = "dense"


@dataclasses.dataclass(frozen=True)
class LoRaConfig:
    """The ``lora_config`` section, under the JAX keys and defaults."""

    name: str = "default_lora"
    rank: int = 8
    alpha: int = 8
    dropout: float = 0.0
    bias: bool = False
    kaiming_a: float = math.sqrt(5.0)
    parallel_modules: Tuple[LoRAModuleType, ...] = (
        LoRAModuleType.QUERY, LoRAModuleType.KEY, LoRAModuleType.VALUE, LoRAModuleType.DENSE)

    def __post_init__(self):
        if self.rank <= 0:
            raise ValueError("lora_config.rank must be > 0")
        if not 0.0 <= self.dropout <= 1.0:
            raise ValueError("lora_config.dropout must be in [0, 1]")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LoRaConfig":
        d = dict(d)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown lora_config keys: {sorted(unknown)}")
        if "parallel_modules" in d:
            d["parallel_modules"] = tuple(LoRAModuleType(m) for m in d["parallel_modules"])
        return cls(**d)


class ParallelLoRa(torch.nn.Module):
    """``x -> (alpha / rank) * B(A(dropout(x)))`` [+ bias]; its dropout
    draws at the static ``site``."""

    def __init__(self, in_features: int, out_features: int, rank: int,
                 lora_module_type: LoRAModuleType, alpha: int = 8, dropout: float = 0.0,
                 bias: bool = False, kaiming_a: float = math.sqrt(5.0),
                 dtype: torch.dtype = torch.float32, device=None, site: str = ""):
        super().__init__()
        self.in_features = in_features
        self.rank = rank
        self.scaling = alpha / rank
        self.dropout_rate = dropout
        self.kaiming_a = kaiming_a
        self.module_type = lora_module_type
        self.site = site
        self.lora_a = torch.nn.Parameter(torch.empty(rank, in_features, dtype=dtype,
                                                     device=device))
        self.lora_b = torch.nn.Parameter(torch.zeros(out_features, rank, dtype=dtype,
                                                     device=device))
        self.bias = (torch.nn.Parameter(torch.zeros(out_features, dtype=dtype, device=device))
                     if bias else None)

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        """Kaiming-uniform A over fan_in = ``in_features``, zero B and bias."""
        gain = math.sqrt(2.0 / (1.0 + self.kaiming_a ** 2))
        bound = gain * math.sqrt(3.0 / self.in_features)
        self.lora_a.uniform_(-bound, bound, generator=generator)
        self.lora_b.zero_()
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor, ctx: Optional[DropoutContext] = None) -> torch.Tensor:
        h = dropout(x, self.dropout_rate, ctx, self.site)
        delta = F.linear(F.linear(h, self.lora_a.to(x.dtype)), self.lora_b.to(x.dtype))
        delta = delta * self.scaling
        if self.bias is not None:
            delta = delta + self.bias.to(x.dtype)
        return delta

    def get_delta_weights(self) -> torch.Tensor:
        """The ``(out, in)`` weight delta to fold into the host linear."""
        return (self.lora_b @ self.lora_a) * self.scaling
