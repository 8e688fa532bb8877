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

from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..optimizer import Optimizer, OptimizerStepOutput
from ..topology import ActivationCheckpointingType, TopologyConfig


class ParallelModule:
    def __init__(self, model: torch.nn.Module, topology: TopologyConfig):
        self.model = model
        self.topology = topology

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
