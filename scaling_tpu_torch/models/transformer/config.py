"""Architecture config of the served transformer.

Counterpart of ``TransformerArchitectureConfig`` in
``scaling_tpu/models/transformer/config.py``: the same dict keys with the
same defaults, read from the ``transformer_architecture`` section a
``scaling_tpu`` config carries. The port serves a subset of what the JAX
package trains, so every key is one of three kinds:

- supported: it shapes the model here exactly as there;
- inert: it has no effect on inference there either (dropout rates, the
  training attention kernel, parity-only switches), so it is accepted;
- not ported yet: any value but the default raises NotImplementedError.

An unknown key raises ValueError. No key is ever ignored silently.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

_PRECISIONS = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}
_ACTIVATIONS = ("gelu", "silu", "relu", "tanh", "sigmoid")

# keys with no effect on the inference forward, in the JAX package too
_INERT = {
    "attention_use_matmul": False,
    "masked_softmax_fusion": True,
    "layernorm_epsilon": 1.0e-5,  # parity-only; layernorm.layernorm_epsilon rules
    "dropout_embedding": 0.0,
    "dropout_attention_probs": 0.0,
    "dropout_after_attention": 0.0,
    "dropout_after_mlp": 0.0,
    "vocab_file": None,
}

# keys whose non-default values the port does not implement yet
_NOT_PORTED = {
    "causal": True,
    "key_query_norm": False,
    "weight_tying": False,
    "num_local_attention_heads": 0,
    "local_attention_window_size": None,
    "mup": None,
    "bitfit_bias_config": None,
    "adapter_config": None,
    "softprompt_config": None,
    "lora_config": None,
    "embedding_head_config": None,
    "finetunable_token_ids": [],
    "image_encoder": False,
    "moe_num_experts": 8,
    "moe_top_k": 2,
    "moe_capacity_factor": 1.25,
    "moe_aux_loss_coef": 0.01,
}


@dataclasses.dataclass(frozen=True)
class TransformerArchitectureConfig:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_attention_heads: int
    attention_num_kv_heads: Optional[int] = None
    attention_qkv_in_one: bool = True
    attention_bias: bool = True
    rotary_embedding_base: int = 10000
    rotary_percentage: float = 1.0
    sequence_length: int = 2048
    norm_type: str = "layernorm"
    relative_position_embedding_type: str = "rotary"
    mlp_type: str = "default"
    mlp_factor: float = 4.0
    mlp_bias: bool = True
    activation_function: str = "gelu"
    precision: str = "float32"
    layernorm_optimization_type: str = "torch"  # layernorm.optimization_type
    layernorm_eps: float = 1.0e-5  # layernorm.layernorm_epsilon
    attention_kernel: str = "torch"  # masked_softmax.kernel (training only)

    def __post_init__(self):
        for name in ("vocab_size", "hidden_size", "num_layers", "num_attention_heads"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0, got {getattr(self, name)}")
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size must divide over num_attention_heads")
        if self.num_attention_heads % self.num_kv_heads:
            raise ValueError("num_attention_heads must divide over the kv heads")
        if self.precision not in _PRECISIONS:
            raise ValueError(f"precision must be one of {sorted(_PRECISIONS)}")
        if self.activation_function not in _ACTIVATIONS:
            raise ValueError(f"activation_function must be one of {_ACTIVATIONS}")
        if self.layernorm_optimization_type not in ("torch", "fused"):
            raise ValueError("layernorm.optimization_type must be 'torch' or 'fused'")
        if self.attention_kernel not in ("torch", "flash_attention"):
            raise ValueError("masked_softmax.kernel must be 'torch' or 'flash_attention'")
        if not 0.0 < self.rotary_percentage <= 1.0:
            raise ValueError("rotary_percentage must be in (0, 1]")
        intermediate = self.hidden_size * self.mlp_factor
        if float(int(intermediate)) != intermediate:
            raise ValueError("hidden_size * mlp_factor must be a natural number")
        for key, value, supported in (
            ("norm_type", self.norm_type, ("rms",)),
            ("relative_position_embedding_type",
             self.relative_position_embedding_type, ("rotary",)),
            ("mlp_type", self.mlp_type, ("swiglu",)),
        ):
            if value not in supported:
                raise NotImplementedError(
                    f"{key}={value!r} is not ported yet (supported: {supported})"
                )

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TransformerArchitectureConfig":
        """Read a ``transformer_architecture`` dict (JAX key names)."""
        d = dict(d)
        kwargs: Dict[str, Any] = {}
        for key, default in _INERT.items():
            d.pop(key, default)
        for key, default in _NOT_PORTED.items():
            if key in d and d.pop(key) != default:
                raise NotImplementedError(f"{key} is not ported yet")
        for key in [k for k in d if k.startswith("image_encoder_")] + [
            "dropout_image_encoder"
        ]:
            d.pop(key, None)  # inert while image_encoder is off (checked above)
        layernorm = dict(d.pop("layernorm", None) or {})
        if "optimization_type" in layernorm:
            kwargs["layernorm_optimization_type"] = layernorm.pop("optimization_type")
        if "layernorm_epsilon" in layernorm:
            kwargs["layernorm_eps"] = float(layernorm.pop("layernorm_epsilon"))
        masked_softmax = dict(d.pop("masked_softmax", None) or {})
        if "kernel" in masked_softmax:
            kwargs["attention_kernel"] = masked_softmax.pop("kernel")
        leftover = {f"layernorm.{k}" for k in layernorm} | {
            f"masked_softmax.{k}" for k in masked_softmax
        }
        fields = {f.name for f in dataclasses.fields(cls)} - {
            "layernorm_optimization_type", "layernorm_eps", "attention_kernel"
        }
        leftover |= {k for k in d if k not in fields}
        if leftover:
            raise ValueError(f"unknown or unsupported config keys: {sorted(leftover)}")
        kwargs.update(d)
        return cls(**kwargs)

    @property
    def num_kv_heads(self) -> int:
        return self.attention_num_kv_heads or self.num_attention_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def qkv_in_one(self) -> bool:
        """Fused q/k/v weight: only without GQA, as in the JAX layer."""
        return self.attention_qkv_in_one and self.attention_num_kv_heads is None

    @property
    def dtype(self) -> torch.dtype:
        return _PRECISIONS[self.precision]

    @property
    def fused_norm(self) -> bool:
        return self.layernorm_optimization_type == "fused"

    @property
    def rotary_dimensions(self) -> int:
        return max(2, int(self.head_dim * self.rotary_percentage))

    @property
    def intermediate_size(self) -> int:
        return int(self.hidden_size * self.mlp_factor)
