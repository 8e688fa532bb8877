"""Configs of the transformer: the architecture and the training run.

``TransformerArchitectureConfig`` is the counterpart of the JAX class of
that name in ``scaling_tpu/models/transformer/config.py``: the same dict
keys with the same defaults, read from the ``transformer_architecture``
section a ``scaling_tpu`` config carries. Every key is one of three kinds:

- supported: it shapes the model here exactly as there.
  ``masked_softmax.kernel`` selects, for training, the flash kernels or
  the unfused attention through ``nn.attention.flash_path_active``, as the
  JAX layer does; serving always attends through the paged kernel.
  The ``dropout_*`` rates are read: serving has no dropout (there is none
  in the JAX package's inference either), and the training path raises
  NotImplementedError for a rate above 0, since dropout is not ported;
- inert: it has no effect in the JAX package either (parity-only
  switches), so it is accepted;
- not ported yet: any value but the default raises NotImplementedError.

``TransformerConfig`` reads a whole training config under the JAX key
names: ``topology`` (one device), ``optimizer``,
``learning_rate_scheduler``, ``training``, ``trainer``, ``data`` and
``logger`` beside the architecture, with the same three kinds of keys in
each section. The sections of machinery that is not ported (``runner``,
``context``, the Determined ids, an active ``profiler``) are accepted
only empty or off. An unknown key raises ValueError. No key is ever
ignored silently.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

import torch

from ...data.blended_dataset import BlendedDatasetConfig
from ...logging import LoggerConfig
from ...nn.masked_softmax import MaskedSoftmaxConfig
from ...optimizer import LearningRateSchedulerConfig, OptimizerConfig
from ...topology import TopologyConfig
from ...trainer import TrainerConfig

_PRECISIONS = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}
_ACTIVATIONS = ("gelu", "silu", "relu", "tanh", "sigmoid")

# keys with no effect on the model, in the JAX package too
_INERT = {
    "attention_use_matmul": False,
    "masked_softmax_fusion": True,
    "layernorm_epsilon": 1.0e-5,  # parity-only; layernorm.layernorm_epsilon rules
    "vocab_file": None,
}

DROPOUT_KEYS = ("dropout_embedding", "dropout_attention_probs", "dropout_after_attention",
                "dropout_after_mlp")

# keys whose non-default values the port does not implement yet
_NOT_PORTED = {
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
    key_query_norm: bool = False
    weight_tying: bool = False
    mlp_type: str = "default"
    mlp_factor: float = 4.0
    mlp_bias: bool = True
    activation_function: str = "gelu"
    precision: str = "float32"
    layernorm_optimization_type: str = "torch"  # layernorm.optimization_type
    layernorm_eps: float = 1.0e-5  # layernorm.layernorm_epsilon
    attention_kernel: str = "torch"  # masked_softmax.kernel: training attention path
    softmax_in_fp32: bool = False  # masked_softmax.softmax_in_fp32 (unfused path)
    softmax_scale: float = 1.0  # masked_softmax.scale (unfused path)
    causal: bool = True
    num_local_attention_heads: int = 0
    local_attention_window_size: Optional[int] = None
    dropout_embedding: float = 0.0
    dropout_attention_probs: float = 0.0
    dropout_after_attention: float = 0.0
    dropout_after_mlp: float = 0.0

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
        if not 0 <= self.num_local_attention_heads <= self.num_attention_heads:
            raise ValueError("num_local_attention_heads must be in [0, num_attention_heads]")
        if self.num_local_attention_heads and self.local_attention_window_size is None:
            raise ValueError("local_attention_window_size needs to be set if "
                             "num_local_attention_heads")
        for key in DROPOUT_KEYS:
            if not 0.0 <= getattr(self, key) <= 1.0:
                raise ValueError(f"{key} must be in [0, 1]")
        if not 0.0 < self.rotary_percentage <= 1.0:
            raise ValueError("rotary_percentage must be in (0, 1]")
        intermediate = self.hidden_size * self.mlp_factor
        if float(int(intermediate)) != intermediate:
            raise ValueError("hidden_size * mlp_factor must be a natural number")
        for key, value, supported, known in (
            ("norm_type", self.norm_type, ("layernorm", "rms"), ()),
            ("relative_position_embedding_type", self.relative_position_embedding_type,
             ("none", "rotary", "rotary_complex"), ()),
            ("mlp_type", self.mlp_type, ("default", "swiglu"), ("moe",)),
        ):
            if value in known:
                raise NotImplementedError(
                    f"{key}={value!r} is not ported yet (supported: {supported})")
            if value not in supported:
                raise ValueError(f"{key} must be one of {supported + known}, got {value!r}")
        if (self.relative_position_embedding_type == "rotary_complex"
                and self.rotary_dimensions != self.head_dim):
            raise ValueError("rotary_complex rotates whole heads: rotary_percentage must be 1")

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
        for key, field in (("kernel", "attention_kernel"),
                           ("softmax_in_fp32", "softmax_in_fp32"), ("scale", "softmax_scale")):
            if key in masked_softmax:
                kwargs[field] = masked_softmax.pop(key)
        masked_softmax.pop("deterministic_flash_attn_bwd", None)  # the port's is deterministic
        leftover = {f"layernorm.{k}" for k in layernorm} | {
            f"masked_softmax.{k}" for k in masked_softmax
        }
        fields = {f.name for f in dataclasses.fields(cls)} - {
            "layernorm_optimization_type", "layernorm_eps", "attention_kernel",
            "softmax_in_fp32", "softmax_scale",
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

    @property
    def masked_softmax_config(self) -> MaskedSoftmaxConfig:
        return MaskedSoftmaxConfig(kernel=self.attention_kernel,
                                   softmax_in_fp32=self.softmax_in_fp32,
                                   scale=self.softmax_scale)

    def check_trainable(self) -> None:
        """Raise for what the training path does not port: dropout."""
        rates = {k: getattr(self, k) for k in DROPOUT_KEYS if getattr(self, k) > 0.0}
        if rates:
            raise NotImplementedError(f"dropout is not ported for training: {rates}")


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    """The ``training`` section: weight decay and parameter selection."""

    weight_decay: float = 1.0e-4
    parameters_exclude: Tuple[str, ...] = ()  # regexes of parameter names not trained

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainingConfig":
        d = dict(d)
        for key, default in (("finetune", False), ("finetunable_parameters", []),
                             ("use_separate_lr_on_embeddings", False),
                             ("use_seperate_lr_on_embeddings", False)):
            if key in d and d.pop(key) != default:
                raise NotImplementedError(f"training.{key} is not ported")
        d.pop("use_deterministic_torch_algorithms", None)  # config parity in the JAX package too
        unknown = set(d) - {"weight_decay", "parameters_exclude"}
        if unknown:
            raise ValueError(f"unknown training keys: {sorted(unknown)}")
        if "parameters_exclude" in d:
            d["parameters_exclude"] = tuple(d["parameters_exclude"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The ``data`` section, under the JAX key names and defaults."""

    data_prefixes: Optional[Tuple[str, ...]] = None
    blended_dataset: Optional[BlendedDatasetConfig] = None
    eod_token_id: int = 0
    validation_data_prefixes: Optional[Tuple[str, ...]] = None
    load_mmap_index_to_memory: bool = False
    only_full_sequences: bool = False
    allow_incomplete_sequences_every_n: int = 0

    # not ported: the values that leave them off
    _NOT_PORTED = {"legacy_dataset": False, "finetuning_dataset": False,
                   "finetuning_chat_dataset": False, "finetuning_dataset_memory_map": False}
    # no effect in the JAX package either
    _INERT = ("use_mmap", "load_data_item_mmap_index_to_memory")

    def __post_init__(self):
        if self.eod_token_id < 0 or self.allow_incomplete_sequences_every_n < 0:
            raise ValueError("data.eod_token_id and allow_incomplete_sequences_every_n "
                             "must be >= 0")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DataConfig":
        d = dict(d)
        for key, off in cls._NOT_PORTED.items():
            if key in d and d.pop(key) != off:
                raise NotImplementedError(f"data.{key} is not ported")
        for key in cls._INERT:
            d.pop(key, None)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown data keys: {sorted(unknown)}")
        for key in ("data_prefixes", "validation_data_prefixes"):
            if d.get(key) is not None:
                d[key] = tuple(str(p) for p in d[key])
        if d.get("blended_dataset") is not None:
            d["blended_dataset"] = BlendedDatasetConfig.from_dict(d["blended_dataset"])
        return cls(**d)


# keys removed from the JAX config: read from an old checkpoint's config.yml
# only at the values that leave them off
REMOVED_CONFIG_KEYS = {
    ("transformer_architecture", "umup"): (None, False, {"enable": False}),
    ("data", "embedding_dataset"): (None, False),
    ("data", "embedding_dataset_memory_map"): (None, False),
}


def strip_removed_config_keys(d: Dict[str, Any]) -> Dict[str, Any]:
    """``d`` without the removed keys; one at a value that turns its
    feature on raises NotImplementedError."""
    d = {k: (dict(v) if isinstance(v, dict) else v) for k, v in d.items()}
    for (section, key), off in REMOVED_CONFIG_KEYS.items():
        sub = d.get(section)
        if isinstance(sub, dict) and key in sub and sub.pop(key) not in off:
            raise NotImplementedError(f"{section}.{key} was removed from the JAX package")
    return d


_PROFILER_KEYS = ("profile_steps", "profile_start_at_step", "profiler_output",
                  "capture_xla_trace")


def _check_profiler(d: Dict[str, Any]) -> None:
    """The profiler is not ported: it must stay off (``profile_steps`` 0);
    its other keys are inert while it is off, as in the JAX package."""
    unknown = set(d) - set(_PROFILER_KEYS)
    if unknown:
        raise ValueError(f"unknown profiler keys: {sorted(unknown)}")
    if d.get("profile_steps", 0):
        raise NotImplementedError("the profiler section is not ported (profile_steps > 0)")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """A training config (``TransformerConfig`` of the JAX package, the
    parts one device trains with). ``to_dict`` gives back the dict it was
    read from, which the JAX package's ``from_dict`` reads too: the
    trainer writes it into every checkpoint as ``config.yml``."""

    transformer_architecture: TransformerArchitectureConfig
    topology: TopologyConfig
    optimizer: OptimizerConfig = OptimizerConfig()
    learning_rate_scheduler: LearningRateSchedulerConfig = LearningRateSchedulerConfig()
    training: TrainingConfig = TrainingConfig()
    trainer: TrainerConfig = TrainerConfig()
    data: DataConfig = DataConfig()
    logger: LoggerConfig = LoggerConfig()
    source: Dict[str, Any] = dataclasses.field(default_factory=dict, compare=False,
                                               repr=False)

    @property
    def seed(self) -> int:
        return self.trainer.seed

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self.source)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TransformerConfig":
        """Read a JAX training config: the ``config.yml`` the JAX trainer
        dumps into a checkpoint (every key present, at its value) or a
        hand-written one (missing keys take the JAX defaults)."""
        source = json.loads(json.dumps(d, default=str))  # plain types: paths become strings
        d = strip_removed_config_keys(source)
        d.pop("version", None)
        for key in ("runner", "context"):
            if d.pop(key, None):
                raise NotImplementedError(f"the {key} section is not ported")
        for key in ("determined_experiment_id", "determined_trial_id"):
            if d.pop(key, None) is not None:
                raise NotImplementedError(f"{key}: the Determined glue is not ported")
        _check_profiler(d.pop("profiler", None) or {})
        # used only with training.use_separate_lr_on_embeddings, which raises
        LearningRateSchedulerConfig.from_dict(d.pop("embedding_learning_rate_scheduler", None)
                                              or {})
        kwargs: Dict[str, Any] = dict(
            transformer_architecture=TransformerArchitectureConfig.from_dict(
                d.pop("transformer_architecture")),
            topology=TopologyConfig.from_dict(d.pop("topology")),
            source=source,
        )
        for key, section in (("optimizer", OptimizerConfig),
                             ("learning_rate_scheduler", LearningRateSchedulerConfig),
                             ("training", TrainingConfig), ("trainer", TrainerConfig),
                             ("data", DataConfig), ("logger", LoggerConfig)):
            if key in d:
                kwargs[key] = section.from_dict(d.pop(key) or {})
        if d:
            raise ValueError(f"unknown config sections: {sorted(d)}")
        return cls(**kwargs)
