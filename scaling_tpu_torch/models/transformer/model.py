"""Transformer model assembly, loss and parameter groups (counterpart of
scaling_tpu/models/transformer/model.py).

The stack keeps the JAX package's layer names: ``layer_0`` is the
embedding, ``layer_1 .. layer_L`` the transformer layers,
``layer_{L+1}`` the final norm, ``layer_{L+2}`` the head (untied, or
tied to the embedding table, which then lives under ``layer_0`` only) and,
with an ``embedding_head_config``, ``layer_{L+3}`` the embedding head, so a
parameter ``layer_3/attention/query/weight`` there is
``layers.layer_3.attention.query.weight`` here, and its JAX optimizer key
``layer_3_TransformerLayer.attention.query.weight`` (``jax_param_key``).

Under pipeline parallelism a stage builds only its layers
(``parallel.pipeline.stage_plan``), under their logical names, so the keys
do not move: the first stage ``layer_0``, the last stage the final norm
and the head, every stage its chunks of transformer layers. A tied head
on the last stage projects with a copy of the embedding table held under
``layer_0`` there (the table alone, a soft prompt stays on the first
stage). The initialisation is the one-rank model's: ``init_random_``
walks every logical layer in order with one generator, building each
layer this stage lacks for its draws and dropping it.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from ...nn.base_layer import ContextShard
from ...nn.linear import Embedding, ModelShard
from ...nn.lora import ParallelLoRa
from ...nn.norm import LayerNorm, RMSNorm
from ...ops.cross_entropy import cross_entropy_from_logits
from ...optimizer import Optimizer, OptimizerParamGroup
from ...parallel import ParallelModule
from ...parallel.parallel_module import jax_param_key
from ...parallel.pipeline import StagePlan, stage_plan
from .config import TransformerArchitectureConfig, TransformerConfig
from .layers import (
    EmbeddingInput,
    LayerNormWrapper,
    TransformerEmbeddingHead,
    TransformerLayer,
    TransformerLMHead,
    TransformerLMHeadTied,
)


def num_logical_layers(arch: TransformerArchitectureConfig) -> int:
    return arch.num_layers + (4 if arch.embedding_head_config is not None else 3)


def build_layer(arch: TransformerArchitectureConfig, index: int, device=None,
                shard: ModelShard = ModelShard(),
                embedding: Optional[EmbeddingInput] = None,
                context: ContextShard = ContextShard()) -> torch.nn.Module:
    """Logical layer ``index`` of the stack: the embedding, a transformer
    layer, the final norm, the LM head (tied to ``embedding``'s table with
    ``weight_tying``) or the embedding head; split over ``shard``, its
    attention across the context group ``context``."""
    n = arch.num_layers
    if index == 0:
        return EmbeddingInput(arch, device, shard)
    if index <= n:
        return TransformerLayer(arch, index - 1, device, shard, context)
    if index == n + 1:
        return LayerNormWrapper(arch, device)
    if index == n + 2:
        return (TransformerLMHeadTied(embedding) if arch.weight_tying
                else TransformerLMHead(arch, device, shard))
    return TransformerEmbeddingHead(arch, device)


def get_transformer_layers(arch: TransformerArchitectureConfig, device=None,
                           shard: ModelShard = ModelShard()) -> Dict[str, torch.nn.Module]:
    """EmbeddingInput -> L x TransformerLayer -> final norm -> LM head (tied
    to the embedding's table with ``weight_tying``) [-> embedding head];
    split over the model group of ``shard``."""
    layers: Dict[str, torch.nn.Module] = {}
    for i in range(num_logical_layers(arch)):
        layers[f"layer_{i}"] = build_layer(arch, i, device, shard, layers.get("layer_0"))
    return layers


def stage_layer_indices(arch: TransformerArchitectureConfig, plan: StagePlan) -> List[int]:
    """The logical layers pipe stage ``plan`` holds: the embedding on the
    first, its transformer layers, the final norm and the heads on the last
    (and there a tied head's table, under ``layer_0``)."""
    out = [0] if plan.first or (plan.last and arch.weight_tying) else []
    out += [i + 1 for i in plan.layers]
    if plan.last:
        out += list(range(arch.num_layers + 1, num_logical_layers(arch)))
    return out


def _table_only(embedding: EmbeddingInput) -> EmbeddingInput:
    """The last stage's copy of a tied embedding: its table alone."""
    if embedding.softprompt is not None:
        delattr(embedding, embedding.softprompt)
        embedding.softprompt = None
    return embedding


# model features whose sharded form (expert parallelism, the sharded image
# encoder and adapters) is not ported: refused by name over several ranks
_ONE_RANK_ONLY = ("is_moe", "image_encoder", "lora_config")


class TransformerModel(torch.nn.Module):
    """The layer stack; with a ``topology`` of several ranks, this rank's
    shards of it (``nn.linear.ModelShard``), its attention across the
    context group (``nn.base_layer.ContextShard``) and, over several pipe
    stages, this stage's layers (``plan``; None: the whole stack)."""

    def __init__(self, arch: TransformerArchitectureConfig, device=None, topology=None):
        super().__init__()
        if topology is not None and topology.world_size > 1:
            for name in _ONE_RANK_ONLY:
                if getattr(arch, name):
                    raise NotImplementedError(
                        f"{name.removeprefix('is_')} under pipe_parallel_size "
                        f"{topology.pipe_parallel_size} x data_parallel_size "
                        f"{topology.data_parallel_size} x context_parallel_size "
                        f"{topology.context_parallel_size} x model_parallel_size "
                        f"{topology.model_parallel_size} is not ported")
            split = {"context_parallel_size": topology.context_parallel_size,
                     "pipe_token_slices": topology.pipe_token_slices}
            for knob, size in split.items():
                if size > 1 and arch.embedding_head_config is not None:
                    raise NotImplementedError(
                        f"an embedding head (it pools the whole sequence) under {knob} {size} "
                        "is not ported")
        self.architecture = arch
        self.shard = ModelShard.of(topology)
        self.context = ContextShard.of(topology)
        self.plan: Optional[StagePlan] = None
        if topology is not None and topology.pipe_parallel_size > 1:
            self.plan = stage_plan(topology.config, arch.num_layers, topology.pipe_parallel_rank)
        layers: Dict[str, torch.nn.Module] = {}
        for i in self.layer_indices:
            layers[f"layer_{i}"] = build_layer(arch, i, device, self.shard, layers.get("layer_0"),
                                               self.context)
        if self.tied_copy:
            _table_only(layers["layer_0"])
        self.layers = torch.nn.ModuleDict(layers)

    @property
    def layer_indices(self) -> List[int]:
        """The logical layers this model holds, in order."""
        if self.plan is None:
            return list(range(num_logical_layers(self.architecture)))
        return stage_layer_indices(self.architecture, self.plan)

    @property
    def tied_copy(self) -> bool:
        """Whether ``layer_0`` here is the last stage's copy of a tied table."""
        return self.plan is not None and self.plan.last and not self.plan.first \
            and self.architecture.weight_tying

    @property
    def embedding(self) -> EmbeddingInput:
        return self.layers["layer_0"]

    @property
    def transformer_layers(self):
        """This model's transformer layers, in order."""
        layers = range(self.architecture.num_layers) if self.plan is None else self.plan.layers
        return [self.layers[f"layer_{i + 1}"] for i in layers]

    @property
    def final_norm(self) -> LayerNormWrapper:
        return self.layers[f"layer_{self.architecture.num_layers + 1}"]

    @property
    def lm_head(self) -> torch.nn.Module:
        return self.layers[f"layer_{self.architecture.num_layers + 2}"]

    @property
    def embedding_head(self) -> Optional[TransformerEmbeddingHead]:
        return self.layers[f"layer_{self.architecture.num_layers + 3}"] \
            if self.architecture.embedding_head_config is not None else None

    @torch.no_grad()
    def init_random_(self, seed: int) -> "TransformerModel":
        """Fill every parameter from one seeded generator on the model's
        device, with the JAX package's initialisers (xavier normal linears
        and embedding, zero biases, unit norm gains). The draws differ from
        ``jax.random``'s; tests that compare the packages carry weights
        across with ``convert.params_from_jax`` instead. A pipe stage draws
        every logical layer in order, building each one it lacks (and the
        whole embedding behind a tied copy) for its draws alone, so its
        layers hold the one-rank model's values."""
        device = next(self.parameters()).device
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        for i in range(num_logical_layers(self.architecture)):
            name = f"layer_{i}"
            own = name in self.layers and not (i == 0 and self.tied_copy)
            layer = self.layers[name] if own else build_layer(self.architecture, i, device,
                                                               self.shard)
            for module in layer.modules():
                init = getattr(module, "init_", None)
                if init is not None:
                    init(gen)
            if i == 0 and self.tied_copy:
                self.embedding.embedding.weight.copy_(layer.embedding.weight)
        return self


def per_token_loss(logits: torch.Tensor, targets: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(token cross entropy, correct-prediction flags), both f32."""
    token_loss = cross_entropy_from_logits(logits, targets)
    correct = (logits.argmax(-1) == targets).float()
    return token_loss, correct


def loss_function(output: Dict[str, Any], batch: Dict[str, Any],
                  denominator: Optional[torch.Tensor] = None):
    """Cross entropy weighted by ``loss_weights`` (a weighted mean) and
    accuracy under the same weights; a MoE model's ``aux_loss`` (already
    scaled by its coefficient) is added and reported as ``moe_aux_loss``.
    ``denominator``: the weights' sum over the global batch (a data rank
    passes it; its result is then its share of the global loss)."""
    targets = batch["target_token_ids"]
    loss_weights = batch.get("loss_weights")
    if loss_weights is None:
        loss_weights = torch.ones(targets.shape, dtype=torch.float32, device=targets.device)
    loss_weights = loss_weights.float()
    token_loss, correct = per_token_loss(output["activations"], targets)
    denom = (loss_weights.sum() if denominator is None else denominator).clamp_min(1.0)
    loss = (token_loss * loss_weights).sum() / denom
    accuracy = (correct * loss_weights).sum() / denom
    metrics = {"accuracy": accuracy}
    aux = output.get("aux_loss")
    if aux is not None:
        aux = aux.float()
        loss = loss + aux
        metrics["moe_aux_loss"] = aux
    return loss, metrics


NO_WEIGHT_DECAY_SUBSTRINGS = ("norm", "bias")


def _peft_trainable(key: str, peft_names: List[str]) -> bool:
    """Whether ``key`` names a PEFT module's parameter: ``..._{name}.`` or
    ``...bias_{name}`` exactly, so a short name such as ``ad`` cannot
    claim ``lm_head``."""
    return any(re.search(rf"(_|bias_){re.escape(n)}(\.|$)", key) for n in peft_names)


def _fan_in_scales_with_width(parameter_name: str, param: torch.Tensor,
                              module: torch.nn.Module) -> bool:
    """Whether muP scales the parameter's learning rate by ``1/m``: a
    matrix whose fan-in grows with the width (attention, MLP and expert
    weights, the router, the head, adapters' ``down``, ``lora_a``, the
    embedding head's first projection), not the embedding table, a soft
    prompt, an adapter's ``up``, ``lora_b``, later projections, vectors or
    anything of the image encoder."""
    if param.ndim < 2 or isinstance(module, Embedding) or "softprompt" in parameter_name:
        return False
    if "image_encoder" in parameter_name:  # its widths do not grow with the stream's
        return False
    if parameter_name.endswith(".up") or "lora_b" in parameter_name:
        return False
    m = re.search(r"proj_(\d+)_", parameter_name)
    return m is None or int(m.group(1)) == 0


def get_parameter_groups(config: TransformerConfig, model: TransformerModel
                         ) -> List[OptimizerParamGroup]:
    """Weight-decay, no-decay and embedding groups with the JAX package's
    membership: ``training.parameters_exclude``
    regexes (of JAX keys) drop a parameter; under ``training.finetune`` only
    ``finetunable_parameters`` matches and the PEFT modules' parameters
    train. The embedding table goes to ``embedding_params`` under the
    ``embedding_learning_rate_scheduler`` with
    ``use_separate_lr_on_embeddings``, else with norm gains, every bias,
    the LoRA factors and a CLIP ResNet's BatchNorm parameters (its frozen
    statistics among them) to the no-decay group; the untied head and all other
    matrices decay. Under muP (width multiplier ``m`` != 1) each of the
    first two splits by ``_fan_in_scales_with_width``: the scaled halves
    keep the names and take ``lr_scale = 1/m`` (``weight_decay_params``,
    ``no_weight_decay_params_width_scaled``), the others keep the base
    rate (``weight_decay_params_fixed_width``, ``no_weight_decay_params``),
    as in the JAX package."""
    training = config.training
    include = [re.compile(p) for p in training.finetunable_parameters]
    exclude = [re.compile(p) for p in training.parameters_exclude]
    peft_names = config.transformer_architecture.peft_names

    def trainable(key: str) -> bool:
        if any(p.search(key) for p in exclude):
            return False
        if training.finetune:
            return any(p.search(key) for p in include) or _peft_trainable(key, peft_names)
        return True

    decay, no_decay, embedding, scaled = set(), set(), set(), set()
    for module_name, module in model.named_modules():
        for pname, param in module.named_parameters(recurse=False):
            name = f"{module_name}.{pname}"
            key = jax_param_key(model, name)
            if not trainable(key):
                continue
            parameter_name = key.split(".", 1)[1]
            if _fan_in_scales_with_width(parameter_name, param, module):
                scaled.add(name)
            if isinstance(module, Embedding) and training.use_separate_lr_on_embeddings:
                embedding.add(name)
            elif isinstance(module, (LayerNorm, RMSNorm, Embedding, ParallelLoRa)) or getattr(
                    module, "no_weight_decay", False) or any(
                    s in parameter_name.lower() for s in NO_WEIGHT_DECAY_SUBSTRINGS):
                no_decay.add(name)
            else:
                decay.add(name)
    mult = config.transformer_architecture.mup_width_mult
    lr = config.learning_rate_scheduler
    if mult == 1.0:
        spec = [(decay, training.weight_decay, lr, "weight_decay_params", 1.0),
                (no_decay, 0.0, lr, "no_weight_decay_params", 1.0)]
    else:
        spec = [(decay & scaled, training.weight_decay, lr, "weight_decay_params", 1.0 / mult),
                (decay - scaled, training.weight_decay, lr, "weight_decay_params_fixed_width",
                 1.0),
                (no_decay & scaled, 0.0, lr, "no_weight_decay_params_width_scaled", 1.0 / mult),
                (no_decay - scaled, 0.0, lr, "no_weight_decay_params", 1.0)]
    spec.append((embedding, 0.0, config.embedding_learning_rate_scheduler, "embedding_params",
                 1.0))
    groups = [
        OptimizerParamGroup(keys, weight_decay=wd, learning_rate_scheduler=scheduler, name=name,
                            lr_scale=lr_scale)
        for keys, wd, scheduler, name, lr_scale in spec if keys
    ]
    if not groups:
        raise ValueError("no trainable parameters selected")
    return groups


def init_optimizer(config: TransformerConfig, model: TransformerModel,
                   module: Optional[ParallelModule] = None) -> Optimizer:
    """AdamW over the model's parameter groups; over several ranks
    (``module.layout``), with its leaves' layouts and ZeRO as configured."""
    params = dict(model.named_parameters())
    layout = None if module is None else module.layout
    return Optimizer(config.optimizer, get_parameter_groups(config, model), params,
                     keys={name: jax_param_key(model, name) for name in params},
                     layouts=None if layout is None else module.leaf_layouts(
                         zero=config.optimizer.zero),
                     topology=layout)


def init_model(config: TransformerConfig, device=None, topology=None) -> ParallelModule:
    """The model with random weights from ``trainer.seed`` behind its
    ParallelModule; with a ``topology`` of several ranks, this rank's shards
    (``parallel.Topology``), under ZeRO stage 3 their data slices."""
    model = TransformerModel(config.transformer_architecture, device=device, topology=topology)
    return ParallelModule(model.init_random_(config.seed), config.topology, topology,
                          zero_stage3=config.optimizer.shards_parameters)
