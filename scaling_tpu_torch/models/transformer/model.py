"""Transformer model assembly (counterpart of
scaling_tpu/models/transformer/model.py, ``get_transformer_layer_specs``).

The stack keeps the JAX package's layer names: ``layer_0`` is the
embedding, ``layer_1 .. layer_L`` the transformer layers,
``layer_{L+1}`` the final norm and ``layer_{L+2}`` the untied head, so a
parameter ``layer_3/attention/query/weight`` there is
``layers.layer_3.attention.query.weight`` here.
"""

from __future__ import annotations

from typing import Dict

import torch

from .config import TransformerArchitectureConfig
from .layers import EmbeddingInput, LayerNormWrapper, TransformerLayer, TransformerLMHead


def get_transformer_layers(arch: TransformerArchitectureConfig,
                           device=None) -> Dict[str, torch.nn.Module]:
    """EmbeddingInput -> L x TransformerLayer -> final norm -> LM head."""
    layers: Dict[str, torch.nn.Module] = {"layer_0": EmbeddingInput(arch, device)}
    for i in range(arch.num_layers):
        layers[f"layer_{i + 1}"] = TransformerLayer(arch, i, device)
    layers[f"layer_{arch.num_layers + 1}"] = LayerNormWrapper(arch, device)
    layers[f"layer_{arch.num_layers + 2}"] = TransformerLMHead(arch, device)
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
    def lm_head(self) -> TransformerLMHead:
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
