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
(``attention.norm_query.weight``), and the PEFT leaves: LoRA factors
(``attention.query_lora.lora_a``, transposed as linear weights are),
BitFit biases (``bias_{name}``), adapters (``adapter_mlp_{name}.down``,
transposed), the soft prompt (``layer_0.softprompt_{name}``, rows ×
hidden on both sides, not transposed) and the embedding head's
projections (``proj_{i}_{name}``, transposed). A tied model's table sits
in the JAX tree under ``layer_0`` only (its head layer holds an empty
subtree), as it does in the port's state dict. A MoE layer's
``mlp.router.weight`` is transposed as a linear's and stays f32 in any
model dtype, as both packages keep it; its expert weights ``mlp.w_in``,
``mlp.w_gate`` and ``mlp.w_out`` have the same layout on both sides.
The image encoder's leaves (``layer_0.image_encoder...``) map by name too:
its linears transposed, a CLIP ResNet's convolution kernels permuted from
JAX's ``(kh, kw, in, out)`` to PyTorch's ``(out, in, kh, kw)``, a CLIP
tower's position embedding as stored and its flattened patch kernel
transposed as a linear's.

With ``topology`` (a ``TopologyConfig`` of several ranks) and ``rank``,
``params_from_jax`` returns that rank's shards: each leaf's contiguous
slice over the model group along the dim JAX's partition spec names
(``jax_partition_spec``), as ``TransformerModel`` builds them; with
``zero_stage3`` also the slice of that over the data group, on the dim
``data_slice_dim`` picks, as ``ParallelModule`` stores parameters under
ZeRO stage 3.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ...parallel.parallel_module import (
    data_slice_dim,
    from_jax_layout,
    jax_partition_spec,
    port_dim,
    slice_of,
)
from ...topology.topology import rank_coords
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


def param_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype of the parameter ``name`` in a model of ``dtype``: f32 for
    a MoE router, ``dtype`` for every other parameter."""
    return torch.float32 if name.endswith("router.weight") else dtype


def params_from_jax(np_params: Mapping[str, Any], arch: TransformerArchitectureConfig,
                    topology: Any = None, rank: int = 0,
                    zero_stage3: bool = False) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> the port's state dict, in the
    architecture's dtype (a MoE router in f32); with ``topology`` and
    ``rank``, that rank's shards (``zero_stage3``: their data slices)."""
    mp = 1 if topology is None else topology.model_parallel_size
    dp = 1 if topology is None or not zero_stage3 else topology.data_parallel_size
    dp_rank = mp_rank = 0
    if mp > 1 or dp > 1:
        _, dp_rank, _, mp_rank = rank_coords((1, topology.data_parallel_size,
                                              topology.context_parallel_size, mp), rank)
    state: Dict[str, torch.Tensor] = {}
    for name, value in _flatten(np_params).items():
        array = np.array(value, dtype=np.float32)
        tensor = from_jax_layout(name, torch.from_numpy(array))
        layer, rest = name.split(".", 1)
        spec = jax_partition_spec(f"{layer}_Layer.{rest}", tensor.ndim)
        if dp > 1:
            tensor = slice_of(tensor, data_slice_dim(name, spec, array.shape, dp), dp_rank, dp)
        if mp > 1 and "model" in spec:
            tensor = slice_of(tensor, port_dim(name, tensor.ndim, spec.index("model")),
                              mp_rank, mp)
        state[f"layers.{name}"] = tensor.contiguous().to(param_dtype(name, arch.dtype))
    return state
