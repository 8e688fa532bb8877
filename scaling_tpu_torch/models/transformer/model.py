"""Transformer model assembly, loss and parameter groups (counterpart of
scaling_tpu/models/transformer/model.py).

The stack keeps the JAX package's layer names: ``layer_0`` is the
embedding, ``layer_1 .. layer_L`` the transformer layers,
``layer_{L+1}`` the final norm and ``layer_{L+2}`` the head (untied, or
tied to the embedding table, which then lives under ``layer_0`` only), so a
parameter ``layer_3/attention/query/weight`` there is
``layers.layer_3.attention.query.weight`` here, and its JAX optimizer key
``layer_3_TransformerLayer.attention.query.weight`` (``jax_param_key``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import torch

from ...nn.linear import Embedding
from ...nn.norm import LayerNorm, RMSNorm
from ...ops.cross_entropy import cross_entropy_from_logits
from ...optimizer import Optimizer, OptimizerParamGroup
from ...parallel import ParallelModule
from ...parallel.parallel_module import jax_param_key
from .config import TransformerArchitectureConfig, TransformerConfig
from .layers import (
    EmbeddingInput,
    LayerNormWrapper,
    TransformerLayer,
    TransformerLMHead,
    TransformerLMHeadTied,
)


def get_transformer_layers(arch: TransformerArchitectureConfig,
                           device=None) -> Dict[str, torch.nn.Module]:
    """EmbeddingInput -> L x TransformerLayer -> final norm -> LM head (tied
    to the embedding's table with ``weight_tying``)."""
    embedding = EmbeddingInput(arch, device)
    layers: Dict[str, torch.nn.Module] = {"layer_0": embedding}
    for i in range(arch.num_layers):
        layers[f"layer_{i + 1}"] = TransformerLayer(arch, i, device)
    layers[f"layer_{arch.num_layers + 1}"] = LayerNormWrapper(arch, device)
    layers[f"layer_{arch.num_layers + 2}"] = (
        TransformerLMHeadTied(embedding) if arch.weight_tying
        else TransformerLMHead(arch, device))
    return layers


class TransformerModel(torch.nn.Module):
    def __init__(self, arch: TransformerArchitectureConfig, device=None):
        super().__init__()
        self.architecture = arch
        self.layers = torch.nn.ModuleDict(get_transformer_layers(arch, device))

    @property
    def embedding(self) -> EmbeddingInput:
        return self.layers["layer_0"]

    @property
    def transformer_layers(self):
        return [self.layers[f"layer_{i + 1}"] for i in range(self.architecture.num_layers)]

    @property
    def final_norm(self) -> LayerNormWrapper:
        return self.layers[f"layer_{self.architecture.num_layers + 1}"]

    @property
    def lm_head(self) -> torch.nn.Module:
        return self.layers[f"layer_{self.architecture.num_layers + 2}"]

    @torch.no_grad()
    def init_random_(self, seed: int) -> "TransformerModel":
        """Fill every parameter from one seeded generator on the model's
        device, with the JAX package's initialisers (xavier normal linears
        and embedding, zero biases, unit norm gains). The draws differ from
        ``jax.random``'s; tests that compare the packages carry weights
        across with ``convert.params_from_jax`` instead."""
        device = next(self.parameters()).device
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        for module in self.modules():
            init = getattr(module, "init_", None)
            if init is not None:
                init(gen)
        return self


def per_token_loss(logits: torch.Tensor, targets: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(token cross entropy, correct-prediction flags), both f32."""
    token_loss = cross_entropy_from_logits(logits, targets)
    correct = (logits.argmax(-1) == targets).float()
    return token_loss, correct


def loss_function(output: Dict[str, Any], batch: Dict[str, Any]):
    """Cross entropy weighted by ``loss_weights`` (a weighted mean) and
    accuracy under the same weights."""
    targets = batch["target_token_ids"]
    loss_weights = batch.get("loss_weights")
    if loss_weights is None:
        loss_weights = torch.ones(targets.shape, dtype=torch.float32, device=targets.device)
    loss_weights = loss_weights.float()
    token_loss, correct = per_token_loss(output["activations"], targets)
    denom = loss_weights.sum().clamp_min(1.0)
    loss = (token_loss * loss_weights).sum() / denom
    accuracy = (correct * loss_weights).sum() / denom
    return loss, {"accuracy": accuracy}


NO_WEIGHT_DECAY_SUBSTRINGS = ("norm", "bias")


def get_parameter_groups(config: TransformerConfig, model: TransformerModel
                         ) -> List[OptimizerParamGroup]:
    """Weight-decay and no-decay groups at muP width multiplier 1, with the
    JAX package's membership: norm gains, every bias and the embedding
    table decay not; the untied head and all other matrices do.
    ``training.parameters_exclude`` regexes match the JAX keys."""
    exclude = [re.compile(p) for p in config.training.parameters_exclude]
    decay, no_decay = set(), set()
    for module_name, module in model.named_modules():
        for pname, _ in module.named_parameters(recurse=False):
            name = f"{module_name}.{pname}"
            key = jax_param_key(model, name)
            if any(p.search(key) for p in exclude):
                continue
            parameter_name = key.split(".", 1)[1].lower()
            if isinstance(module, (LayerNorm, RMSNorm, Embedding)) or any(
                    s in parameter_name for s in NO_WEIGHT_DECAY_SUBSTRINGS):
                no_decay.add(name)
            else:
                decay.add(name)
    groups = [
        OptimizerParamGroup(keys, weight_decay=wd,
                            learning_rate_scheduler=config.learning_rate_scheduler, name=name)
        for keys, wd, name in ((decay, config.training.weight_decay, "weight_decay_params"),
                               (no_decay, 0.0, "no_weight_decay_params"))
        if keys
    ]
    if not groups:
        raise ValueError("no trainable parameters selected")
    return groups


def init_optimizer(config: TransformerConfig, model: TransformerModel) -> Optimizer:
    return Optimizer(config.optimizer, get_parameter_groups(config, model),
                     dict(model.named_parameters()))


def init_model(config: TransformerConfig, device=None) -> ParallelModule:
    """The model with random weights from ``trainer.seed``, behind its
    one-device ParallelModule."""
    model = TransformerModel(config.transformer_architecture, device=device)
    return ParallelModule(model.init_random_(config.seed), config.topology)
