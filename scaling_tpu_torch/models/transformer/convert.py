"""Carry weights from the JAX package to the port.

``params_from_jax`` maps the JAX model's parameter tree, ``{"layer_i":
{...}}`` with numpy leaves, onto the port's state dict. The module names
are the same on both sides, so a leaf ``layer_3/attention/query/weight``
becomes ``layers.layer_3.attention.query.weight``. Linear weights are
stored ``(in, out)`` by the JAX package and ``(out, in)`` here, so they
are transposed; the embedding table is ``(vocab, hidden)`` on both sides.

Every parameter of every architecture the port builds maps by name alone:
norm gains and biases (``input_layernorm.bias``), the default MLP's
``mlp.dense_in`` / ``mlp.dense_out``, key/query norms
(``attention.norm_query.weight``). A tied model's table sits in the JAX
tree under ``layer_0`` only (its head layer holds an empty subtree), as it
does in the port's state dict.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ...parallel.parallel_module import transposed_in_jax
from .config import TransformerArchitectureConfig


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(value, Mapping):
            out.update(_flatten(value, name))
        else:
            out[name] = np.asarray(value)
    return out


def params_from_jax(np_params: Mapping[str, Any],
                    arch: TransformerArchitectureConfig) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> the port's state dict, in the
    architecture's dtype."""
    state: Dict[str, torch.Tensor] = {}
    for name, value in _flatten(np_params).items():
        if transposed_in_jax(name, value.ndim):
            value = value.T  # (in, out) -> (out, in)
        tensor = torch.from_numpy(np.array(value, dtype=np.float32))
        state[f"layers.{name}"] = tensor.to(arch.dtype)
    return state
