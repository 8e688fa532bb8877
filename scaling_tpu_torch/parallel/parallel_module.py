"""The model's forward and training step on one device (counterpart of
``ParallelModule.forward`` and ``build_train_step`` of
scaling_tpu/parallel/parallel_module.py at world size 1).

``forward`` runs the layer stack over a batch dict (``token_ids``,
``position_ids``, ``segment_ids``); with ``activation_checkpointing_type:
every_layer`` each layer of the stack runs under
``torch.utils.checkpoint`` (non-reentrant) and is recomputed in the
backward, as the JAX forward wraps each layer in ``jax.checkpoint``.

``build_train_step`` returns ``step(micro_batches)``: for each of the
``gradient_accumulation_steps`` micro-batches a forward and a backward of
``loss / gas``, the gradients added into f32 buffers (torch's bf16
``.grad`` would round a sum that the JAX step takes in f32), then one
optimizer step. It returns the mean loss, the mean metrics and the
optimizer's output.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..optimizer import Optimizer, OptimizerStepOutput
from ..topology import ActivationCheckpointingType, TopologyConfig


def jax_param_key(model: torch.nn.Module, name: str) -> str:
    """The JAX package's key (``ParamMeta.key``, its optimizer and
    checkpoint key) of the port's parameter ``name`` of a ``layers`` stack:
    ``layers.layer_3.x.y`` -> ``layer_3_<Class>.x.y``."""
    m = re.fullmatch(r"layers\.(layer_\d+)\.(.+)", name)
    if m is None:
        raise ValueError(f"not a parameter of the layer stack: {name}")
    return f"{m.group(1)}_{type(model.layers[m.group(1)]).__name__}.{m.group(2)}"


def transposed_in_jax(name: str, ndim: int) -> bool:
    """Whether the parameter ``name`` (of either package) is stored
    transposed by the JAX package: every matrix but the embedding table
    (linears are ``(in, out)`` there, ``(out, in)`` here)."""
    return ndim == 2 and not name.endswith("embedding.weight")


# the linears the JAX package splits over the model axis by input
# (RowParallelLinear); its other linears split by output (ColumnParallelLinear)
_ROW_PARALLEL = ("dense", "dense_out", "down_proj")


def jax_partition_spec(key: str, ndim: int) -> tuple:
    """The partition spec the JAX metas give the parameter ``key`` (its
    ``MESH.json`` record), over the JAX layout: the vocabulary axis of the
    embedding, the output axis of a column-parallel linear and its bias,
    the input axis of a row-parallel one; norms and row-parallel biases are
    replicated."""
    if key.endswith("embedding.weight"):
        return ("model", None)
    module = key.rsplit(".", 2)[-2]
    if ndim == 2:
        return ("model", None) if module in _ROW_PARALLEL else (None, "model")
    linear_bias = key.endswith(".bias") and "norm" not in module
    return ("model",) if linear_bias and module not in _ROW_PARALLEL else (None,) * ndim


class ParallelModule:
    def __init__(self, model: torch.nn.Module, topology: TopologyConfig):
        self.model = model
        self.topology = topology

    def ckpt_keys(self) -> Dict[str, str]:
        """The JAX key of each parameter, by the port's name, in the
        model's order: the names checkpoints are written under."""
        return {name: jax_param_key(self.model, name)
                for name, _ in self.model.named_parameters()}

    @property
    def remat(self) -> bool:
        return self.topology.activation_checkpointing_type == ActivationCheckpointingType.EVERY_LAYER

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The stack over ``batch``; returns ``{"activations": logits}``."""
        m = self.model
        if m.training:
            m.architecture.check_trainable()
        tokens = batch["token_ids"]
        b, s = tokens.shape
        pos = batch.get("position_ids")
        if pos is None:
            pos = torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)
        seg = batch.get("segment_ids")
        if seg is None:
            seg = torch.zeros(b, s, dtype=torch.int32, device=tokens.device)

        def run(layer: Callable, *args):
            if self.remat and torch.is_grad_enabled():
                return checkpoint(layer, *args, use_reentrant=False)
            return layer(*args)

        h = run(m.embedding, tokens)
        for layer in m.transformer_layers:
            h = run(layer, h, pos, None, seg)
        h = run(m.final_norm, h)
        return {"activations": run(m.lm_head, h)}

    def build_train_step(self, optimizer: Optimizer, loss_function: Callable
                         ) -> Callable[[Dict[str, torch.Tensor]],
                                       Tuple[torch.Tensor, Dict[str, Any], OptimizerStepOutput]]:
        """``step(micro_batches)``: leaves stacked ``(gas, micro_batch_size,
        ...)``. Returns (mean loss, mean metrics, optimizer output)."""
        gas = self.topology.gradient_accumulation_steps
        self.model.architecture.check_trainable()
        optimizer.freeze_frozen_params()
        params = [optimizer.params[n] for n in optimizer.optimized]
        buffers = [torch.empty_like(p, dtype=torch.float32) for p in params]

        def step(micro_batches: Dict[str, torch.Tensor]):
            self.model.train()
            loss_sum = torch.zeros((), dtype=torch.float32, device=buffers[0].device)
            metrics_sum: Dict[str, torch.Tensor] = {}
            for i in range(gas):
                mb = {k: v[i] for k, v in micro_batches.items()}
                for p in params:
                    p.grad = None
                loss, metrics = loss_function(self.forward(mb), mb)
                scaled = optimizer.scale_loss(loss.float() / gas)
                scaled.backward()
                grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
                if i == 0:
                    torch._foreach_copy_(buffers, grads)
                else:
                    torch._foreach_add_(buffers, grads)
                loss_sum += loss.detach().float()
                for k, v in metrics.items():
                    metrics_sum[k] = metrics_sum.get(k, 0.0) + v.detach().float()
            for p in params:
                p.grad = None
            out = optimizer.step(dict(zip(optimizer.optimized, buffers)))
            return loss_sum / gas, {k: v / gas for k, v in metrics_sum.items()}, out

        return step
