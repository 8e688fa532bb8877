"""The routed expert MLP (``ParallelMoEMLP`` of scaling_tpu/nn/moe.py) on
one device: GShard/Switch top-k routing with a static capacity and the
Switch load-balance loss.

The function is the JAX layer's, step for step:

- router logits and softmax in f32 from ``x.float()`` (the router weight
  stays f32 in a bf16 model);
- the aux loss ``E * sum_e mean_prob_e * assigned_frac_e * coef`` with the
  assignment from the top-1 ``argmax``;
- the top ``k`` experts of each token, ties to the lower index as
  ``jax.lax.top_k`` breaks them, gates renormalised by ``max(sum, 1e-9)``;
- capacity ``C = max(1, int(capacity_factor * k * s / E))`` per batch row;
  a (token, choice) pair's position in its expert's buffer is the count of
  earlier pairs of that row routed there, token-major and choice-minor,
  and pairs at or past ``C`` are dropped (their token keeps its residual);
- the combine weights cast to ``x.dtype`` before they multiply.

The JAX layer dispatches and combines through two ``(b, s, E, C)``
one-hot einsums. Here the kept pairs are gathered into an ``(E, b*C, h)``
buffer whose empty slots are zero, the three expert products run as
``torch.bmm`` over the expert axis, and each token gathers its ``k`` rows
back and weighs them with one batched product: the same arithmetic
without the one-hot products. Both gathers take a gather as their
backward (``_GatherRows``). ``dense_dispatch_reference`` keeps the
one-hot formulation as the layer's plain version for the tests.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .activation_function import ActivationFunction, get_activation_function


class _GatherRows(torch.autograd.Function):
    """``out[i] = src[index[i]]``, a zero row where ``index[i] == len(src)``,
    with a backward that gathers too: ``grad_src[j] = sum_m
    grad_out[inverse[j, m]]`` (``inverse[j, m] == len(out)``: no term).
    Indexing's own backward accumulates through a sort of the indices,
    which on the card cost more than the expert products; here each
    direction is one gather, deterministic, and the sum over ``m`` (the
    ``top_k`` choices of a token) is one reduction in f32."""

    @staticmethod
    def forward(ctx, src, index, inverse):
        ctx.save_for_backward(inverse)
        return torch.cat([src, src.new_zeros(1, src.shape[1])])[index]

    @staticmethod
    def backward(ctx, grad):
        (inverse,) = ctx.saved_tensors
        rows = torch.cat([grad, grad.new_zeros(1, grad.shape[1])])[inverse]
        return rows.sum(dim=1, dtype=torch.float32).to(grad.dtype), None, None


def capacity(capacity_factor: float, top_k: int, seq_len: int, num_experts: int) -> int:
    """Slots of each expert's buffer per batch row (the JAX expression)."""
    return max(1, int(capacity_factor * top_k * seq_len / num_experts))


class ParallelMoEMLP(torch.nn.Module):
    """Top-k routed expert MLPs (GLU or plain) behind one dispatch.

    ``router.weight`` is ``(E, h)`` (the JAX ``(h, E)`` transposed) and f32
    whatever ``dtype`` is; ``w_in``, ``w_gate`` (with ``glu``) are
    ``(E, h, f)`` and ``w_out`` ``(E, f, h)``, in the JAX layout."""

    def __init__(self, io_features: int, intermediate_feature_factor: float,
                 num_experts: int, top_k: int = 2, capacity_factor: float = 1.25,
                 aux_loss_coef: float = 0.01, glu: bool = True,
                 activation: ActivationFunction = ActivationFunction.SILU,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        intermediate = io_features * intermediate_feature_factor
        if float(int(intermediate)) != intermediate:
            raise ValueError("io_features * intermediate_feature_factor must be a natural number")
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k must be in [1, num_experts], got {top_k}")
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor, self.aux_loss_coef = capacity_factor, aux_loss_coef
        self.glu = glu
        self.activation_fn = get_activation_function(activation)
        E, h, f = num_experts, io_features, int(intermediate)
        self.router = torch.nn.Module()
        self.router.weight = torch.nn.Parameter(
            torch.empty(E, h, dtype=torch.float32, device=device))

        def expert(*shape):
            return torch.nn.Parameter(torch.empty(*shape, dtype=dtype, device=device))

        self.w_in = expert(E, h, f)
        if glu:
            self.w_gate = expert(E, h, f)
        self.w_out = expert(E, f, h)

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        """The router from ``normal(0, 0.02)``; each expert's matrices xavier
        normal over that expert's own fans (the expert axis is no fan)."""
        # initialisation streams the parameters from one generator in a fixed
        # order (the model's definition order), never reseeded between draws
        self.router.weight.normal_(0.0, 0.02, generator=generator)
        for w in (self.w_in, getattr(self, "w_gate", None), self.w_out):
            if w is not None:
                w.normal_(0.0, math.sqrt(2.0 / (w.shape[1] + w.shape[2])),  # sta: disable=STA004
                          generator=generator)

    def route(self, x: torch.Tensor, with_aux: bool = True):
        """Routing of ``x`` (b, s, h): (gates (b, s, k) f32, experts (b, s,
        k) int64, positions (b, s, k) int64, aux f32 scalar or None)."""
        b, s, _ = x.shape
        E, k = self.num_experts, self.top_k
        probs = F.linear(x.float(), self.router.weight.float()).softmax(dim=-1)
        aux = None
        if with_aux:
            assigned = F.one_hot(probs.argmax(dim=-1), E).float()
            aux = E * (probs.mean(dim=(0, 1)) * assigned.mean(dim=(0, 1))).sum()
            aux = aux * self.aux_loss_coef
        # a stable descending sort keeps the lower index first on a tie
        gates, experts = probs.sort(dim=-1, descending=True, stable=True)
        gates, experts = gates[..., :k], experts[..., :k]
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        chosen = F.one_hot(experts.reshape(b, s * k), E)  # token-major, choice-minor
        earlier = chosen.cumsum(dim=1) - chosen
        positions = earlier.gather(-1, experts.reshape(b, s * k, 1)).reshape(b, s, k)
        return gates, experts, positions, aux

    def forward(self, x: torch.Tensor, with_aux: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``x`` (b, s, h) -> (y (b, s, h), aux loss, coefficient-scaled, or
        None without ``with_aux``)."""
        b, s, h = x.shape
        E, k = self.num_experts, self.top_k
        C = capacity(self.capacity_factor, k, s, E)
        gates, experts, positions, aux = self.route(x, with_aux)
        keep = positions < C
        T, slots = b * s, E * b * C
        row = torch.arange(b, device=x.device)[:, None, None]
        # each (token, choice) pair's buffer slot, ``slots`` (a zero row) if dropped
        slot = torch.where(keep, experts * (b * C) + row * C + positions, slots).reshape(T, k)
        # each slot's pair, T * k where empty; dropped pairs all land on one
        # extra slot, cut off after
        pair = torch.full((slots + 1,), T * k, dtype=torch.int64, device=x.device)
        pair.scatter_(0, slot.reshape(T * k), torch.arange(T * k, device=x.device))
        pair = pair[:slots]
        # the token of each slot, T (a zero row) where empty
        xin = _GatherRows.apply(x.reshape(T, h), torch.where(pair < T * k, pair // k, T),
                                slot).view(E, b * C, h)
        up = torch.bmm(xin, self.w_in.to(x.dtype))
        if self.glu:
            act = self.activation_fn(torch.bmm(xin, self.w_gate.to(x.dtype))) * up
        else:
            act = self.activation_fn(up)
        out = torch.bmm(act, self.w_out.to(x.dtype)).view(slots, h)
        picked = _GatherRows.apply(out, slot.reshape(T * k), pair[:, None]).view(T, k, h)
        weights = (gates * keep).to(x.dtype).view(T, 1, k)
        y = torch.bmm(weights, picked).view(b, s, h)
        return y, aux


def dense_dispatch_reference(layer: ParallelMoEMLP, x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX layer's one-hot dispatch and combine einsums over the
    layer's routing: the plain version the tests hold the layer against."""
    b, s, _ = x.shape
    E, k = layer.num_experts, layer.top_k
    C = capacity(layer.capacity_factor, k, s, E)
    gates, experts, positions, aux = layer.route(x)
    keep = (positions < C).float()
    choice = F.one_hot(experts, E).float()  # (b, s, k, E)
    slot = F.one_hot(positions.clamp_max(C), C + 1)[..., :C].float()  # (b, s, k, C)
    combine = torch.einsum("bsk,bsk,bske,bskc->bsec", gates, keep, choice, slot)
    dispatch = torch.einsum("bsk,bske,bskc->bsec", keep, choice, slot)
    xin = torch.einsum("bsec,bsh->ebch", dispatch.to(x.dtype), x)
    up = torch.einsum("ebch,ehf->ebcf", xin, layer.w_in.to(x.dtype))
    if layer.glu:
        gate = torch.einsum("ebch,ehf->ebcf", xin, layer.w_gate.to(x.dtype))
        act = layer.activation_fn(gate) * up
    else:
        act = layer.activation_fn(up)
    out = torch.einsum("ebcf,efh->ebch", act, layer.w_out.to(x.dtype))
    return torch.einsum("bsec,ebch->bsh", combine.to(x.dtype), out), aux
