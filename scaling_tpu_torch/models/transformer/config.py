"""Configs of the transformer: the architecture and the training run.

``TransformerArchitectureConfig`` is the counterpart of the JAX class of
that name in ``scaling_tpu/models/transformer/config.py``: the same dict
keys with the same defaults, read from the ``transformer_architecture``
section a ``scaling_tpu`` config carries. Every key is one of two kinds:

- supported: it shapes the model here exactly as there.
  ``masked_softmax.kernel`` selects, for training, the flash kernels or
  the unfused attention through ``nn.attention.flash_path_active``, as the
  JAX layer does; serving always attends through the paged kernel.
  The ``dropout_*`` rates act in a training pass (``nn.base_layer``);
  eval, ``generate`` and serving run without dropout, as in the JAX
  package. The PEFT sections (``bitfit_bias_config``, ``adapter_config``,
  ``softprompt_config``, ``lora_config``, ``embedding_head_config``) build
  their modules here as there;
- inert: it has no effect in the JAX package either (parity-only
  switches, and ``finetunable_token_ids``), so it is accepted.

``image_encoder`` builds the multimodal image encoder
(``image_encoder.py``) from the ``image_encoder_*`` keys and
``dropout_image_encoder``, which a text model carries inert, as the JAX
config does; ``image_encoder_clip_checkpoint`` is read at train start
(``train.py``).

``mlp_type: moe`` builds the routed expert MLP (``nn.moe``) from the
``moe_*`` keys, which a dense model carries inert, as the JAX config
does; ``mup`` (``MupConfig``) sets the width-scaled attention scale, the
head's ``output_mult`` and zero readout, and the ``1/m`` learning-rate
groups of ``model.get_parameter_groups``.

``TransformerConfig`` reads a whole training config under the JAX key
names: ``topology`` (one device), ``optimizer``,
``learning_rate_scheduler``, ``embedding_learning_rate_scheduler``,
``training``, ``trainer``, ``data`` (token streams or the finetuning
datasets),
``logger``, ``profiler`` and ``runner`` (``runner.RunnerConfig``)
beside the architecture, with the same three kinds of keys in each
section. The sections of machinery that is not ported (``context``, the
Determined ids) are accepted only empty or off. An unknown key raises
ValueError. No key is ever ignored silently.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

import torch

from ...data.blended_dataset import BlendedDatasetConfig
from ...logging import LoggerConfig
from ...nn.lora import LoRaConfig
from ...nn.masked_softmax import MaskedSoftmaxConfig
from ...optimizer import LearningRateSchedulerConfig, OptimizerConfig
from ...profiler import ProfilerConfig
from ...runner.config import RunnerConfig
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
    # the JAX embedding keeps the ids and defines a gradient row mask
    # (VocabParallelEmbedding.finetunable_grad_mask) that nothing calls: every
    # row of a trained table takes its gradient there, and here
    "finetunable_token_ids": [],
}

DROPOUT_KEYS = ("dropout_embedding", "dropout_attention_probs", "dropout_after_attention",
                "dropout_after_mlp")


def _section(cls, d: Optional[Dict[str, Any]], what: str):
    """A PEFT section from its dict (None stays None); unknown keys raise."""
    if d is None or isinstance(d, cls):
        return d
    d = dict(d)
    unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"unknown {what} keys: {sorted(unknown)}")
    return cls(**d)


@dataclasses.dataclass(frozen=True)
class BitfitConfig:
    """BitFit: linears' and norms' biases named ``bias_{name}``."""

    name: str = "bitfit"


@dataclasses.dataclass(frozen=True)
class AdapterConfig:
    """Bottleneck adapters after the attention and/or the MLP block; widths
    ``hidden * factor`` (multiplicative, as in the JAX config)."""

    name: str = "adapter"
    attention_downsampling_factor: Optional[float] = None
    mlp_downsampling_factor: Optional[float] = None
    init_std: float = 1.0e-3

    def __post_init__(self):
        for key in ("attention_downsampling_factor", "mlp_downsampling_factor"):
            if getattr(self, key) is not None and not getattr(self, key) > 0:
                raise ValueError(f"adapter_config.{key} must be > 0")


@dataclasses.dataclass(frozen=True)
class SoftpromptConfig:
    """A learned prompt written over the first ``n_tokens`` positions."""

    name: str = "softprompt"
    n_tokens: int = 8

    def __post_init__(self):
        if self.n_tokens <= 0:
            raise ValueError("softprompt_config.n_tokens must be > 0")


@dataclasses.dataclass(frozen=True)
class EmbeddingHeadConfig:
    """The projection stack over the mean-pooled final hidden states."""

    name: str = "embedding_head"
    proj_layers: Tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "proj_layers", tuple(self.proj_layers))


@dataclasses.dataclass(frozen=True)
class MupConfig:
    """Maximal-update parametrisation (``MupConfig`` of the JAX config):
    hyperparameters tuned at ``base_hidden_size`` carry to this width.
    ``base_num_attention_heads`` (default: this model's head count) gives
    the base head dim of the attention scale; ``output_mult`` multiplies
    the untied head's logits; ``readout_zero_init`` zeroes the head."""

    base_hidden_size: int
    base_num_attention_heads: Optional[int] = None
    output_mult: float = 1.0
    readout_zero_init: bool = True

    def __post_init__(self):
        for key in ("base_hidden_size", "base_num_attention_heads", "output_mult"):
            value = getattr(self, key)
            if value is not None and not value > 0:
                raise ValueError(f"mup.{key} must be > 0")


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
    moe_num_experts: int = 8  # mlp_type "moe": experts, routed per token, buffer slack
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_coef: float = 0.01  # the Switch load-balance loss's coefficient
    mup: Optional[MupConfig] = None
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
    vocab_file: Optional[str] = None  # copied into every checkpoint as vocab.json
    bitfit_bias_config: Optional[BitfitConfig] = None
    adapter_config: Optional[AdapterConfig] = None
    softprompt_config: Optional[SoftpromptConfig] = None
    lora_config: Optional[LoRaConfig] = None
    embedding_head_config: Optional[EmbeddingHeadConfig] = None
    image_encoder: bool = False  # 384 x 384 images as 144 prefix tokens each
    image_encoder_width: int = 768
    image_encoder_layers: int = 6
    image_encoder_heads: int = 12
    image_encoder_backbone: str = "vit"  # vit, clip (a CLIP ViT), clip_resnet (RN50x16)
    image_encoder_resnet_stages: Tuple[int, ...] = (6, 8, 18, 8)
    image_encoder_resnet_channels: int = 96
    image_encoder_clip_checkpoint: Optional[str] = None  # applied at train start, fresh runs
    dropout_image_encoder: float = 0.0  # after the image encoder's projection

    def __post_init__(self):
        for key, cls in (("bitfit_bias_config", BitfitConfig), ("adapter_config", AdapterConfig),
                         ("softprompt_config", SoftpromptConfig),
                         ("embedding_head_config", EmbeddingHeadConfig), ("mup", MupConfig)):
            object.__setattr__(self, key, _section(cls, getattr(self, key), key))
        if isinstance(self.lora_config, dict):
            object.__setattr__(self, "lora_config", LoRaConfig.from_dict(self.lora_config))
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
            ("mlp_type", self.mlp_type, ("default", "swiglu", "moe"), ()),
        ):
            if value in known:
                raise NotImplementedError(
                    f"{key}={value!r} is not ported yet (supported: {supported})")
            if value not in supported:
                raise ValueError(f"{key} must be one of {supported + known}, got {value!r}")
        if (self.relative_position_embedding_type == "rotary_complex"
                and self.rotary_dimensions != self.head_dim):
            raise ValueError("rotary_complex rotates whole heads: rotary_percentage must be 1")
        for key in ("moe_num_experts", "moe_top_k", "moe_capacity_factor"):
            if not getattr(self, key) > 0:
                raise ValueError(f"{key} must be > 0")
        if self.moe_aux_loss_coef < 0:
            raise ValueError("moe_aux_loss_coef must be >= 0")
        if self.mlp_type == "moe":
            if self.moe_top_k > self.moe_num_experts:
                raise ValueError(f"moe_top_k ({self.moe_top_k}) cannot exceed "
                                 f"moe_num_experts ({self.moe_num_experts})")
            if self.mlp_bias:
                raise ValueError("mlp_type 'moe' does not support mlp_bias; set it false "
                                 "(experts are GLU FFNs without bias)")
        if self.mup is not None and self.weight_tying:
            raise ValueError("mup does not compose with weight_tying: untie the head to use mup")
        object.__setattr__(self, "image_encoder_resnet_stages",
                           tuple(self.image_encoder_resnet_stages))
        if self.image_encoder_backbone not in ("vit", "clip", "clip_resnet"):
            raise ValueError("image_encoder_backbone must be one of ('vit', 'clip', "
                             f"'clip_resnet'), got {self.image_encoder_backbone!r}")
        if len(self.image_encoder_resnet_stages) != 4:
            raise ValueError("image_encoder_resnet_stages needs exactly 4 stages (CLIP layout)")
        for key in ("image_encoder_width", "image_encoder_layers", "image_encoder_heads",
                    "image_encoder_resnet_channels"):
            if getattr(self, key) <= 0:
                raise ValueError(f"{key} must be > 0")
        if not 0.0 <= self.dropout_image_encoder <= 1.0:
            raise ValueError("dropout_image_encoder must be in [0, 1]")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TransformerArchitectureConfig":
        """Read a ``transformer_architecture`` dict (JAX key names)."""
        d = dict(d)
        kwargs: Dict[str, Any] = {}
        for key, default in _INERT.items():
            d.pop(key, default)
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
    def is_moe(self) -> bool:
        return self.mlp_type == "moe"

    @property
    def mup_width_mult(self) -> float:
        """Width multiplier ``m = hidden / base_hidden`` (1.0 without muP)."""
        return 1.0 if self.mup is None else self.hidden_size / self.mup.base_hidden_size

    @property
    def attention_scale(self) -> Optional[float]:
        """muP's attention scale ``sqrt(base_head_dim) / head_dim``, with
        ``base_head_dim`` the base width over the base model's heads (this
        model's by default); None (``1 / sqrt(head_dim)``) without muP."""
        if self.mup is None:
            return None
        base_heads = self.mup.base_num_attention_heads or self.num_attention_heads
        return (self.mup.base_hidden_size / base_heads) ** 0.5 / self.head_dim

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

    @property
    def peft_names(self) -> List[str]:
        """The names of the active PEFT modules, in the JAX order."""
        return [c.name for c in (self.bitfit_bias_config, self.adapter_config,
                                 self.softprompt_config, self.lora_config,
                                 self.embedding_head_config) if c is not None]

    @property
    def has_dropout(self) -> bool:
        """Whether a training pass draws any dropout mask."""
        return (any(getattr(self, k) > 0.0 for k in DROPOUT_KEYS)
                or (self.lora_config is not None and self.lora_config.dropout > 0.0)
                or (self.image_encoder and self.dropout_image_encoder > 0.0))


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    """The ``training`` section: weight decay and parameter selection. With
    ``finetune`` only parameters matched by ``finetunable_parameters``
    (regexes of JAX keys) and the PEFT modules' train; with
    ``use_separate_lr_on_embeddings`` the embedding table takes the
    ``embedding_learning_rate_scheduler``."""

    weight_decay: float = 1.0e-4
    finetune: bool = False
    finetunable_parameters: Tuple[str, ...] = ()
    parameters_exclude: Tuple[str, ...] = ()  # regexes of parameter names not trained
    use_separate_lr_on_embeddings: bool = False

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainingConfig":
        d = dict(d)
        # the misspelled alias keeps older configs loading, as in the JAX config
        misspelled = d.pop("use_seperate_lr_on_embeddings", None)
        if misspelled is not None and "use_separate_lr_on_embeddings" not in d:
            d["use_separate_lr_on_embeddings"] = misspelled
        d.pop("use_deterministic_torch_algorithms", None)  # config parity in the JAX package too
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown training keys: {sorted(unknown)}")
        for key in ("finetunable_parameters", "parameters_exclude"):
            if key in d:
                d[key] = tuple(d[key])
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
    finetuning_dataset: bool = False  # prompt/completion jsonl (or memory map) data
    finetuning_chat_dataset: bool = False  # chat jsonl data
    finetuning_dataset_memory_map: bool = False
    legacy_dataset: bool = False  # Megatron-format .bin/.idx data

    # no effect in the JAX package either
    _INERT = ("use_mmap", "load_data_item_mmap_index_to_memory")

    def __post_init__(self):
        if self.eod_token_id < 0 or self.allow_incomplete_sequences_every_n < 0:
            raise ValueError("data.eod_token_id and allow_incomplete_sequences_every_n "
                             "must be >= 0")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DataConfig":
        d = dict(d)
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
    embedding_learning_rate_scheduler: LearningRateSchedulerConfig = \
        LearningRateSchedulerConfig()
    training: TrainingConfig = TrainingConfig()
    trainer: TrainerConfig = TrainerConfig()
    data: DataConfig = DataConfig()
    logger: LoggerConfig = LoggerConfig()
    profiler: ProfilerConfig = ProfilerConfig()
    runner: Optional[RunnerConfig] = None
    # the Determined experiment and trial this run belongs to (parity keys:
    # the glue reads its context from the SDK, as in the JAX package)
    determined_experiment_id: Optional[int] = None
    determined_trial_id: Optional[int] = None
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
        if d.pop("context", None):
            raise NotImplementedError("the context section is not ported")
        runner = d.pop("runner", None)
        kwargs: Dict[str, Any] = dict(
            determined_experiment_id=d.pop("determined_experiment_id", None),
            determined_trial_id=d.pop("determined_trial_id", None),
            transformer_architecture=TransformerArchitectureConfig.from_dict(
                d.pop("transformer_architecture")),
            topology=TopologyConfig.from_dict(d.pop("topology")),
            source=source,
            runner=None if runner is None else RunnerConfig.from_dict(runner),
        )
        for key, section in (("optimizer", OptimizerConfig),
                             ("learning_rate_scheduler", LearningRateSchedulerConfig),
                             ("embedding_learning_rate_scheduler", LearningRateSchedulerConfig),
                             ("training", TrainingConfig), ("trainer", TrainerConfig),
                             ("data", DataConfig), ("logger", LoggerConfig),
                             ("profiler", ProfilerConfig)):
            if key in d:
                kwargs[key] = section.from_dict(d.pop(key) or {})
        if d:
            raise ValueError(f"unknown config sections: {sorted(d)}")
        kwargs["topology"].check_sequence_parallel(
            kwargs["transformer_architecture"].sequence_length)
        return cls(**kwargs)
