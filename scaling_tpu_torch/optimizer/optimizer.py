"""Mixed-precision AdamW with f32 master weights (counterpart of
scaling_tpu/optimizer/optimizer.py), with ZeRO stage 1.

The compute parameters stay in the model's dtype (bf16 for the bench
model); the optimizer keeps an f32 master copy of every optimised
parameter and f32 moments. ``step`` takes f32 gradients and follows the
JAX step's order of operations: unscale, the global L2 norm over the
optimised leaves, the clip coefficient ``min(1, clip / (norm + 1e-6))``,
the learning rate at ``step + 1``, decoupled decay
``master * (1 - lr * wd / lr_scale)``, the update
``(lr / bc1) * m / (sqrt(v) / sqrt(bc2) + eps)``, skip on overflow (only
with the loss scaler on), then the cast back to the compute dtype. The
arithmetic runs as ``torch._foreach_*`` ops over each group's leaves.

The step counter and the loss scaler live on the host. With the scaler
off nothing is read back from the card (the overflow flag of the output
stays a device tensor); with it on, the overflow flag is read once per
step to decide the skip. ``torch.optim.AdamW`` is not used: it keeps no
separate f32 masters. With ``debug_log`` the output's ``debug_dict``
holds each parameter's clipped gradient norm, by its JAX key, as device
tensors (one ``_foreach_norm``, no host sync); nothing logs it, as in the
JAX trainer.

Over several ranks (``layouts`` and ``topology`` given) the gradients
arrive summed over the data group, and the clipping norm is the global
one: each rank adds the squared norms of the pieces it owns (a leaf split
over the model group on every model rank, a whole one on model rank 0
only; a ZeRO slice on every data rank, a whole leaf on data rank 0 only;
each pipe stage its own layers, and a tied table on the first stage only,
not the last stage's copy; context rank 0 only, the others hold the same
replicas) and the world sums them, so no leaf is counted
twice and every rank clips, and skips on overflow, alike. With ``zero: true``
(stage 1, ``zero_stage`` 1) the f32 masters and both moments are kept for
this rank's data slice of each leaf (over its pipe stage's data group) (``LeafLayout.data_dim``; leaves no
dim of which ``dp`` divides stay whole), the update runs on the slices,
and the updated parameters are all-gathered over the data group. At stage
3 the parameters themselves are those slices (``ParallelModule``'s ZeRO-3,
``zero3_dims`` equal to this optimizer's ``zero_dims``): the gradients
arrive as the slices, the masters are copied from them, the update writes
them, and nothing is all-gathered. Stage 2 raises as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, NamedTuple, Optional

import torch
import torch.distributed as dist

from ..parallel.collectives import all_gather_cat, all_reduce_
from .learning_rate_scheduler import LearningRateScheduler, LearningRateSchedulerConfig
from .loss_scaler import LossScaler, LossScalerConfig, LossScalerState, has_inf_or_nan


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    gradient_clipping: float = 0.0  # clip the global L2 norm to this; 0 = off
    allreduce_bucket_size: int = 500000000  # config parity: one flat all-reduce a step
    loss_scaler: LossScalerConfig = LossScalerConfig()
    zero: bool = False
    zero_stage: int = 1
    zero_save_static: bool = False
    debug_log: bool = False

    def __post_init__(self):
        if self.zero_stage == 2:
            raise ValueError("zero_stage 2 is implicit (gradients are reduced before the "
                             "update); use 1 or 3")
        if self.zero_stage != 1 and not self.zero:
            raise ValueError(f"zero_stage {self.zero_stage} requires zero: true")
        if self.zero_stage not in (1, 3):
            raise ValueError(f"zero_stage {self.zero_stage}: expected 1 or 3")

    @property
    def shards_parameters(self) -> bool:
        """ZeRO stage 3: the parameters are sharded over the data group."""
        return self.zero and self.zero_stage == 3

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OptimizerConfig":
        d = dict(d)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown optimizer keys: {sorted(unknown)}")
        if "loss_scaler" in d:
            d["loss_scaler"] = LossScalerConfig.from_dict(d["loss_scaler"] or {})
        return cls(**d)


class OptimizerParamGroup:
    """Named parameter subset with its own weight decay and LR schedule;
    membership by parameter name (the model's state-dict name)."""

    def __init__(self, keys, weight_decay: float = 0.0,
                 learning_rate_scheduler: Optional[LearningRateSchedulerConfig] = None,
                 name: str = "param_group", lr_scale: float = 1.0):
        self.keys = set(keys)
        self.weight_decay = weight_decay
        self.lr_config = learning_rate_scheduler or LearningRateSchedulerConfig()
        self.scheduler = LearningRateScheduler(self.lr_config)
        self.name = name
        self.lr_scale = lr_scale  # constant multiplier on the scheduled LR


@dataclasses.dataclass
class OptimizerState:
    step: int  # completed optimizer steps
    master: Dict[str, torch.Tensor]  # f32 masters of the optimised parameters
    exp_avg: Dict[str, torch.Tensor]
    exp_avg_sq: Dict[str, torch.Tensor]
    loss_scaler: LossScalerState


class OptimizerStepOutput(NamedTuple):
    global_grad_norm: Optional[torch.Tensor] = None
    global_grad_norm_clipped: Optional[torch.Tensor] = None
    learning_rates: Optional[dict] = None
    overflow: Any = None  # bool with the scaler on, else a device bool tensor
    no_overflow_steps: Optional[int] = None
    current_loss_scale: Optional[float] = None
    # with ``debug_log``: each parameter's gradient L2 norm (f32, on the
    # device, after unscaling and clipping; 0 for a frozen one), by its key
    debug_dict: Optional[Dict[str, torch.Tensor]] = None


class Optimizer:
    """AdamW over named parameters, grouped by name. Parameters in no
    group are frozen: no master, no moments, no update. ``keys`` names each
    parameter in ``debug_dict`` (the JAX meta keys, ``init_optimizer``
    passes them); by default its own name."""

    def __init__(self, config: OptimizerConfig, parameter_groups: List[OptimizerParamGroup],
                 params: Mapping[str, torch.nn.Parameter],
                 keys: Optional[Mapping[str, str]] = None,
                 layouts: Optional[Mapping[str, Any]] = None, topology: Any = None):
        self.config = config
        # over several ranks: each leaf's LeafLayout and the run's Topology
        self.topology = topology if topology is not None and topology.world_size > 1 else None
        self.layouts = dict(layouts or {})
        self.parameter_groups = parameter_groups
        self.params = dict(params)
        self.keys = {n: n for n in self.params} if keys is None else dict(keys)
        self.loss_scaler = LossScaler(config.loss_scaler)
        self.group_names: List[List[str]] = [[] for _ in parameter_groups]
        claimed = set()
        for name in self.params:
            for gi, group in enumerate(parameter_groups):
                if name in group.keys:
                    self.group_names[gi].append(name)
                    claimed.add(name)
                    break
        missing = {k for g in parameter_groups for k in g.keys} - claimed
        if missing:
            raise ValueError(f"parameter group keys not found in model: {sorted(missing)[:5]}")
        self.optimized = [n for names in self.group_names for n in names]
        topo = self.topology
        zero = config.zero and topo is not None and topo.data_parallel_size > 1
        # the port dim of each ZeRO-sliced leaf's data slice
        self.zero_dims: Dict[str, int] = {
            n: self.layouts[n].data_dim for n in self.optimized
            if zero and self.layouts[n].data_dim is not None}
        # stage 3: the parameters (and so the gradients) are the slices already
        self.sliced_params = zero and config.shards_parameters
        self._owned = [self._owns(n) for n in self.optimized]
        self.state = self.init_state()

    def _owns(self, name: str, stored_only: bool = True) -> bool:
        """Whether this rank counts ``name``'s piece in a norm over the world
        (``stored_only``: not a tied table's last-stage copy, the global
        norm's rule; ``debug_log`` counts each stage's own leaves)."""
        topo = self.topology
        if topo is None:
            return True
        layout = self.layouts[name]
        if (stored_only and not layout.stored) or topo.context_parallel_rank != 0:
            return False
        if layout.model_dim is None and topo.model_parallel_rank != 0:
            return False
        return name in self.zero_dims or topo.data_parallel_rank == 0

    def _own(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``name``'s parameter or gradient ``t``: at
        stage 3 ``t`` is the slice already."""
        return t if self.sliced_params else self.piece(name, t)

    def piece(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's ZeRO slice of ``name``'s local tensor ``t`` (a view;
        ``t`` itself for a leaf that is not sliced)."""
        d = self.zero_dims.get(name)
        if d is None:
            return t
        dp, rank = self.topology.data_parallel_size, self.topology.data_parallel_rank
        n = t.shape[d] // dp
        return t.narrow(d, rank * n, n)

    @torch.no_grad()
    def init_state(self) -> OptimizerState:
        """Fresh state: f32 masters copied from the parameters, zero moments."""
        master = {n: self._own(n, self.params[n].detach()).to(torch.float32, copy=True)
                  for n in self.optimized}
        return OptimizerState(
            step=0, master=master,
            exp_avg={n: torch.zeros_like(m) for n, m in master.items()},
            exp_avg_sq={n: torch.zeros_like(m) for n, m in master.items()},
            loss_scaler=self.loss_scaler.init_state(),
        )

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return self.loss_scaler.scale_loss(loss, self.state.loss_scaler)

    def freeze_frozen_params(self) -> None:
        """No gradient for parameters of no group (JAX: ``stop_gradient``)."""
        for name, p in self.params.items():
            if name not in self.optimized:
                p.requires_grad_(False)

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> OptimizerStepOutput:
        """One AdamW step from f32 gradients (``grads`` by parameter name;
        they are scaled in place). Updates the parameters and the state."""
        c = self.config
        state = self.state
        g32 = [self._own(n, grads[n]) for n in self.optimized]
        if c.loss_scaler.enable:
            torch._foreach_mul_(g32, 1.0 / state.loss_scaler.current_scale)
        norms = list(torch._foreach_norm(g32))
        if self.topology is None:
            raw_overflow = has_inf_or_nan(norms)
            global_norm = torch.stack(norms).square().sum().sqrt()
        else:
            owned = [n for n, own in zip(norms, self._owned) if own]
            sq = (torch.stack(owned).square().sum() if owned
                  else torch.zeros((), device=norms[0].device))
            global_norm = all_reduce_(sq, dist.group.WORLD).sqrt()
            raw_overflow = has_inf_or_nan([global_norm])
        if c.gradient_clipping > 0.0:
            coeff = torch.clamp(c.gradient_clipping / (global_norm + 1e-6), max=1.0)
            torch._foreach_mul_(g32, coeff)
            clipped_norm = torch.clamp(global_norm, max=c.gradient_clipping)
        else:
            clipped_norm = global_norm

        step_index = state.step + 1
        group_lrs = [g.scheduler.get_lr(step_index) * g.lr_scale for g in self.parameter_groups]
        overflow: Any = raw_overflow
        scaler_out = None
        if c.loss_scaler.enable:  # only the scaler skips; without it a nan propagates loudly
            overflow = bool(raw_overflow.item())
            scaler_out = self.loss_scaler.step(state.loss_scaler, overflow)
        debug = self._grad_norms(g32) if c.debug_log else None
        if not (c.loss_scaler.enable and overflow):
            self._update(dict(zip(self.optimized, g32)), group_lrs, step_index)
            state.step = step_index
        return OptimizerStepOutput(
            global_grad_norm=global_norm,
            global_grad_norm_clipped=clipped_norm,
            learning_rates={g.name: lr for g, lr in zip(self.parameter_groups, group_lrs)},
            overflow=overflow,
            no_overflow_steps=scaler_out.no_overflow_steps if scaler_out else None,
            current_loss_scale=scaler_out.current_loss_scale if scaler_out else None,
            debug_dict=debug,
        )

    def _grad_norms(self, g32: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``sqrt(sum(g^2))`` of each clipped f32 gradient in one
        ``_foreach_norm``, by key in the parameters' order, with no host
        sync; a frozen parameter's is 0, its gradient in the JAX step. Over
        several ranks each leaf's pieces are summed, each counted once."""
        norms = dict(zip(self.optimized, torch._foreach_norm(g32))) if g32 else {}
        topo = self.topology
        if topo is not None and norms:
            sq = torch.stack([norms[n].square() if self._owns(n, stored_only=False)
                              else torch.zeros_like(norms[n]) for n in self.optimized])
            all_reduce_(sq, topo.model_group)
            all_reduce_(sq, topo.grad_group)
            norms = dict(zip(self.optimized, sq.sqrt().unbind(0)))
        zero = None
        out = {}
        for name, p in self.params.items():
            norm = norms.get(name)
            if norm is None:
                if zero is None:
                    zero = torch.zeros((), dtype=torch.float32, device=p.device)
                norm = zero
            out[self.keys[name]] = norm
        return out

    def _update(self, g32: Dict[str, torch.Tensor], group_lrs: List[float],
                step_index: int) -> None:
        c, state = self.config, self.state
        bc1 = 1.0 - c.beta1 ** step_index
        bc2 = 1.0 - c.beta2 ** step_index
        for group, names, lr in zip(self.parameter_groups, self.group_names, group_lrs):
            if not names:
                continue
            masters = [state.master[n] for n in names]
            avgs = [state.exp_avg[n] for n in names]
            sqs = [state.exp_avg_sq[n] for n in names]
            grads = [g32[n] for n in names]
            wd = group.weight_decay / group.lr_scale
            if wd:
                torch._foreach_mul_(masters, 1.0 - lr * wd)
            torch._foreach_mul_(avgs, c.beta1)
            torch._foreach_add_(avgs, grads, alpha=1.0 - c.beta1)
            torch._foreach_mul_(sqs, c.beta2)
            torch._foreach_addcmul_(sqs, grads, grads, value=1.0 - c.beta2)
            denom = torch._foreach_sqrt(sqs)
            torch._foreach_div_(denom, math.sqrt(bc2))
            torch._foreach_add_(denom, c.eps)
            torch._foreach_addcdiv_(masters, avgs, denom, value=-(lr / bc1))
            torch._foreach_copy_([self._own(n, self.params[n]) for n in names], masters)
        if self.sliced_params:
            return
        for n in self.zero_dims:  # the updated slices to every data rank
            p = self.params[n]
            p.copy_(all_gather_cat(self.piece(n, p), self.topology.data_group,
                                   self.zero_dims[n]))
