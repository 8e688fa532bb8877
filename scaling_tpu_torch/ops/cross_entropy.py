"""Cross entropy from logits with a memory-lean backward (counterpart of
``scaling_tpu/ops/cross_entropy.py``; plain PyTorch, as the JAX version
is XLA and not a kernel).

Autograd of ``log_softmax -> gather`` would keep an f32 ``(b, s, vocab)``
residual alive from the forward to the backward. The closed-form
gradient needs none of it, ``d loss / d logits = softmax(logits) -
onehot(targets)``, so the Function saves only the logits in their own
dtype, the int targets and an f32 ``(b, s)`` log-sum-exp, recomputes the
softmax in the backward and returns ``dlogits`` in the logits' dtype.
"""

from __future__ import annotations

import torch


class CrossEntropyFromLogits(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        x = logits.float()
        lse = torch.logsumexp(x, dim=-1)
        target_logit = x.gather(-1, targets[..., None]).squeeze(-1)
        ctx.save_for_backward(logits, targets, lse)
        return lse - target_logit

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        logits, targets, lse = ctx.saved_tensors
        dlogits = torch.exp(logits.float() - lse[..., None])
        dlogits.scatter_add_(-1, targets[..., None],
                             torch.full_like(lse[..., None], -1.0))
        dlogits.mul_(g.float()[..., None])
        return dlogits.to(logits.dtype), None


def cross_entropy_from_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token cross entropy, f32 ``targets.shape``."""
    return CrossEntropyFromLogits.apply(logits, targets.long())
