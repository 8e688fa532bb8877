"""The pipeline's executor: one pipe stage's training step and forward
(counterpart of ``PipelinedBody`` and ``ParallelModule
._build_spatial_train_step`` of scaling_tpu/parallel/, which run every
stage in one SPMD program; here each stage is a process, as in the
reference framework).

``build_train_step`` returns the step of ``ParallelModule
.build_train_step`` at a pipe stage: it runs this rank's instruction
stream of ``pipeline_schedule.executor_schedule`` (1F1B without virtual
stages, the interleaved stream with them) as it stands:

- ``load_micro_batch``: nothing to do, every stage holds the step's
  micro-batches of its data rank (the first stage embeds the tokens, every
  stage reads the positions and segments, the last the targets and loss
  weights); only activations and their gradients cross between stages;
- ``recv_activation`` / ``send_activation`` and ``recv_grad`` /
  ``send_grad``: ``collectives.p2p_recv`` / ``p2p_send`` over the channel
  of the instruction's peer (the next or previous stage, or the wrap's
  peer of an interleaved stream), ``(micro_batch_size, sequence, hidden)``
  in the compute dtype;
- ``forward_pass``: the work item's chunk of layers (under virtual stages
  round ``r`` runs chunk ``r * pp + stage``), after the embedding on the
  first stage's first round; with ``every_pipe_stage`` the chunk is one
  remat region (``parallel_module.remat``), so a stage keeps only the input of each
  item in flight;
- ``loss`` (the last stage's last round): the final norm, the head and
  ``loss_function``, scaled by ``1 / gas`` and the loss scale;
- ``backward_pass``: the loss's backward, or the output's with the
  received gradient; each item's gradients are added into the f32 buffers
  in micro-batch order 0 .. gas - 1 for every parameter (an interleaved
  stream's reversed backwards are held until their turn), as the one-stage
  step adds them;
- ``reduce_tied_grads``: a tied table's buffer summed over the first and
  last stage (``Topology.tied_group``), so the two copies take one update;
- ``optimizer_step``: the sends waited for, the data group's reduction,
  the loss and metrics summed over the data group and handed from the last
  stage to every stage of the pipe (``share_from_last_stage``), then the
  optimizer's step, whose clipping norm counts each stage's pieces once.

Dropout masks are a function of the step's key, the micro-batch and each
site's static id, so they are the one-stage step's at every layout.

With ``pipe_token_slices`` S (TeraPipe; ``PipelinedBody._token_sliced`` of
the JAX package) the work items are the (micro-batch, slice) pairs: each
micro-batch's sequence splits into S contiguous slices (``sequence_slice``,
positions and segments made explicit first, so each slice keeps its
absolute positions), which cross the stages as the stream's items, each
transfer ``1/S`` of a micro-batch's. A slice attends over the earlier
slices of its micro-batch through each layer's ``TokenSliceCache``: the
K/V that those slices' forwards handed back, kept as leaves that require a
gradient. The backwards run in the stream's reverse order, so slice k's
backward comes before those of the slices it read: it adds their K/V's
gradients into the leaves' ``.grad``, and slice j's backward then
back-propagates its output and its own K/V together, with the received
gradient and the leaves' accumulated ones. Under ``every_pipe_stage`` the
remat region gives back the slice's K/V as outputs beside its activation,
and takes the earlier slices' as inputs; ``every_layer`` does so layer by
layer. The loss is the one-stage step's: each slice's token losses over
the micro-batch's summed weights. Dropout masks are the one-stage step's,
cut to the slice (``DropoutContext.for_seq_shard``). Parameter gradients
add up over a micro-batch's slices, then go into the f32 buffers in
micro-batch order. A deterministic ``forward`` runs the whole sequence,
which gives the sliced step's function without the cache.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..nn.attention import TokenSliceCache
from ..nn.base_layer import DropoutContext, MaskSource
from ..topology import ActivationCheckpointingType
from .collectives import (
    all_reduce_,
    broadcast_,
    broadcast_object,
    p2p_recv,
    p2p_send,
)
from .parallel_module import _SAVE_DOTS_CONTEXT, checkpoint, remat, sequence_slice
from .pipeline_schedule import executor_schedule, work_items


class PipelineEngine:
    """One pipe stage of ``module`` (a ``ParallelModule`` whose model holds a
    ``plan``)."""

    def __init__(self, module):
        self.module = module
        self.lay = module.layout
        self.plan = module.plan
        model = module.model
        self.pp, self.vpp, self.stage = self.plan.pp, self.plan.vpp, self.plan.stage
        self.chunks = [[model.layers[f"layer_{i + 1}"] for i in chunk]
                       for chunk in self.plan.chunks]
        arch = model.architecture
        self.hidden, self.dtype = arch.hidden_size, arch.dtype
        self.device = next(model.parameters()).device
        self.remat_mode = module.topology.activation_checkpointing_type
        self.stage_remat = self.remat_mode == ActivationCheckpointingType.EVERY_PIPE_STAGE
        self.slices = module.topology.pipe_token_slices
        self._metric_names: Optional[List[str]] = None

    # ------------------------------------------------------------ pieces
    def round_of(self, name: str) -> int:
        """The round whose backward reaches parameter ``name``: its chunk's,
        the embedding's first round, the edges' (and a tied copy's) last."""
        index = int(name.split(".")[1].removeprefix("layer_"))
        if index == 0:
            return 0 if self.plan.first else self.vpp - 1
        for r, chunk in enumerate(self.plan.chunks):
            if index - 1 in chunk:
                return r
        return self.vpp - 1

    def run_chunk(self, rnd: int, h: torch.Tensor, batch: Dict[str, torch.Tensor],
                  ctx: Optional[DropoutContext]) -> torch.Tensor:
        def run(x):
            return self.module.run_layers(self.chunks[rnd], x, batch, ctx)[0]
        if self.stage_remat and torch.is_grad_enabled():
            return remat(run, (h,), [p for layer in self.chunks[rnd] for p in layer.parameters()])
        return run(h)

    def stream_shape(self, batch: Dict[str, torch.Tensor]) -> Tuple[int, ...]:
        """The shape of an activation between stages for ``batch`` (a
        micro-batch or a token slice): under sequence parallelism this model
        rank's shard of its sequence."""
        b, s = batch["token_ids"].shape
        if self.lay.sequence_parallel:
            s //= self.lay.model_parallel_size
        return (b, s, self.hidden)

    def run_slice(self, h: torch.Tensor, batch: Dict[str, torch.Tensor],
                  ctx: Optional[DropoutContext], prior: List[Tuple]) -> Tuple[torch.Tensor, list]:
        """A token slice through this stage's layers: ``prior[j]`` is layer
        ``j``'s (keys, values, segments) of the micro-batch's earlier slices.
        Returns the output and each layer's (k, v) of this slice, under the
        config's remat mode (the stage, or each layer, one region whose
        outputs are the activation and the K/V)."""
        pos, seg = batch["position_ids"], batch["segment_ids"]
        layers = self.chunks[0]
        per_layer = self.remat_mode in (ActivationCheckpointingType.EVERY_LAYER,
                                        ActivationCheckpointingType.EVERY_LAYER_SAVE_DOTS)

        def one(layer, segments, x, *kv):
            n = len(kv) // 2
            x, (k, v) = self.module.call(
                layer, x, pos, TokenSliceCache(kv[:n], kv[n:], segments), seg, None, None, True,
                ctx, release=not per_layer)
            return x, k, v

        def stage(x, *flat):
            out, at = [], 0
            for layer, (keys, _, segments) in zip(layers, prior):
                n = 2 * len(keys)
                x, k, v = one(layer, segments, x, *flat[at:at + n])
                out += [k, v]
                at += n
            return (x, *out)

        flat = [t for keys, values, _ in prior for t in (*keys, *values)]
        training = torch.is_grad_enabled()
        if self.stage_remat and training:
            out = remat(stage, (h, *flat), [p for layer in layers for p in layer.parameters()])
            return out[0], [(out[1 + 2 * j], out[2 + 2 * j]) for j in range(len(layers))]
        kvs = []
        for layer, (keys, values, segments) in zip(layers, prior):
            fn = functools.partial(one, layer, segments)
            args = (h, *keys, *values)
            if training and self.remat_mode == ActivationCheckpointingType.EVERY_LAYER:
                h, k, v = remat(fn, args, layer.parameters())
            elif (training and self.remat_mode
                  == ActivationCheckpointingType.EVERY_LAYER_SAVE_DOTS):
                h, k, v = checkpoint(fn, *args, use_reentrant=False,
                                     context_fn=_SAVE_DOTS_CONTEXT)
            else:
                h, k, v = fn(*args)
            kvs.append((k, v))
        return h, kvs

    def _peer(self, ins, default: int) -> int:
        return default if ins.peer is None else ins.peer

    def _recv(self, peer: int, shape) -> torch.Tensor:
        buf = torch.empty(shape, dtype=self.dtype, device=self.device)
        return p2p_recv(buf, self.lay.stage_rank(peer), self.lay.channels[(peer, self.stage)])

    def _send(self, t: torch.Tensor, peer: int, sends: list) -> None:
        # a copy of its own: gloo writes a CUDA source back in place when the
        # transfer ends, which must not touch a tensor autograd holds
        t = t.detach().clone(memory_format=torch.contiguous_format)
        sends.append((p2p_send(t, self.lay.channels[(self.stage, peer)]), t))

    def share_from_last_stage(self, loss: Optional[torch.Tensor],
                              metrics: Optional[Dict[str, torch.Tensor]]
                              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The last stage's loss and metrics on every stage of the pipe:
        one broadcast of a small tensor (the metrics' names cross once)."""
        lay = self.lay
        last = lay.stage_rank(self.pp - 1)
        if self._metric_names is None:
            self._metric_names = broadcast_object(sorted(metrics) if self.plan.last else None,
                                                  last, lay.pipe_group)
        names = self._metric_names
        if self.plan.last:
            t = torch.stack([loss.float()] + [metrics[k].float() for k in names])
        else:
            t = torch.empty(1 + len(names), dtype=torch.float32, device=self.device)
        broadcast_(t, last, lay.pipe_group)
        return t[0], dict(zip(names, t[1:]))

    def optimizer_step(self, optimizer, names: List[str], buffers: List[torch.Tensor],
                       sends: list, loss_sum: torch.Tensor, metrics_sum: Dict[str, torch.Tensor]):
        """The stream's last instruction: the sends waited for, the data
        group's reduction, the loss and metrics summed over the data group and
        handed from the last stage to every stage, the optimizer's step.
        Returns (loss sum, metric sums, the optimizer's output)."""
        module = self.module
        for work, _ in sends:
            work.wait()
        sends.clear()
        module.reduce_gradients(names, buffers)
        loss_out = metrics_out = None
        if self.plan.last:
            keys = sorted(metrics_sum)
            summed = all_reduce_(torch.stack([loss_sum] + [metrics_sum[k] for k in keys]),
                                 module.data_group)
            loss_out, metrics_out = summed[0], dict(zip(keys, summed[1:]))
        loss_out, metrics_out = self.share_from_last_stage(loss_out, metrics_out)
        return loss_out, metrics_out, optimizer.step(dict(zip(names, buffers)))

    # ----------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, batch: Dict[str, torch.Tensor],
                ctx: Optional[DropoutContext] = None) -> Optional[Dict[str, torch.Tensor]]:
        """One deterministic pass of ``batch`` through the stages, round by
        round: the last stage returns the output, the others None."""
        shape = self.stream_shape(batch)
        sends: list = []
        out = None
        for rnd in range(self.vpp):
            if self.plan.first and rnd == 0:
                h = self.module.embed(batch, ctx)
            else:
                h = self._recv(self.stage - 1 if self.stage else self.pp - 1, shape)
            h = self.run_chunk(rnd, h, batch, ctx)
            if self.plan.last and rnd == self.vpp - 1:
                out = self.module.head(h, batch)
            else:
                self._send(h, self.stage + 1 if not self.plan.last else 0, sends)
        for work, _ in sends:
            work.wait()
        return out

    # -------------------------------------------------------- train step
    def build_train_step(self, optimizer, loss_function: Callable,
                         mask_source: Optional[MaskSource] = None) -> Callable:
        if self.slices > 1:
            return self.build_sliced_step(optimizer, loss_function, mask_source)
        module, lay, plan = self.module, self.lay, self.plan
        gas = module.topology.gradient_accumulation_steps
        has_dropout = module.model.architecture.has_dropout
        optimizer.freeze_frozen_params()
        names = list(optimizer.optimized)
        params = [optimizer.params[n] for n in names]
        buffers = [torch.empty_like(p, dtype=torch.float32) for p in params]
        by_round: Dict[int, List[int]] = {r: [] for r in range(self.vpp)}
        for i, n in enumerate(names):
            by_round[self.round_of(n)].append(i)
        tied = ([i for i, n in enumerate(names) if n == "layers.layer_0.embedding.weight"]
                if module.model.architecture.weight_tying and (plan.first or plan.last) else [])
        instructions = executor_schedule(self.pp, self.stage, gas, self.vpp).instructions()
        forwards = work_items(gas, self.pp, self.vpp)
        backwards = forwards if self.vpp == 1 else list(reversed(forwards))

        def step(micro_batches: Dict[str, torch.Tensor], dropout_key: Optional[Tuple] = None):
            if dropout_key is None and has_dropout:
                raise ValueError("the model has dropout: the step needs its dropout key")
            module.model.train()
            mbs = [{k: v[i] for k, v in micro_batches.items()} for i in range(gas)]
            shape = self.stream_shape(mbs[0])
            dens = (module.weight_sums(mbs) if plan.last and module.data_group is not None
                    else None)
            for b in buffers:
                b.zero_()
            items: Dict[Tuple[int, int], Dict[str, Any]] = {}
            pending: Dict[int, Dict[int, List[torch.Tensor]]] = {r: {} for r in by_round}
            next_m = {r: 0 for r in by_round}
            sends: list = []
            loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
            metrics_sum: Dict[str, torch.Tensor] = {}
            fi = bi = 0
            out = None
            for ins in instructions:
                kind = ins.name
                if kind == "recv_activation":
                    x = self._recv(self._peer(ins, self.stage - 1), shape)
                    items[forwards[fi]] = {"input": x.requires_grad_()}
                elif kind == "forward_pass":
                    m, rnd = forwards[fi]
                    fi += 1
                    item = items.setdefault((m, rnd), {})
                    ctx = (None if dropout_key is None else module.dropout_context(
                        dropout_key, mask_source).for_micro_batch(m))
                    h = item["input"] if "input" in item else module.embed(mbs[m], ctx)
                    item["output"] = self.run_chunk(rnd, h, mbs[m], ctx)
                elif kind == "send_activation":
                    self._send(items[forwards[fi - 1]]["output"],
                               self._peer(ins, self.stage + 1), sends)
                elif kind == "loss":
                    m, rnd = forwards[fi - 1]
                    item = items[(m, rnd)]
                    loss, metrics = module.loss(module.head(item.pop("output"), mbs[m]),
                                                mbs[m], loss_function,
                                                None if dens is None else dens[m])
                    item["loss"] = optimizer.scale_loss(loss.float() / gas)
                    loss_sum += loss.detach().float()
                    for k, v in metrics.items():
                        metrics_sum[k] = metrics_sum.get(k, 0.0) + v.detach().float()
                elif kind == "recv_grad":
                    items[backwards[bi]]["grad"] = self._recv(
                        self._peer(ins, self.stage + 1), shape)
                elif kind == "backward_pass":
                    m, rnd = backwards[bi]
                    bi += 1
                    item = items[(m, rnd)]
                    module.clear_grads(params)
                    if "loss" in item:
                        if item["loss"].requires_grad:  # else nothing trained reaches it
                            item["loss"].backward()
                    else:
                        torch.autograd.backward(item.pop("output"), item.pop("grad"))
                    pending[rnd][m] = module.grads_of([names[i] for i in by_round[rnd]],
                                                      [params[i] for i in by_round[rnd]])
                    while next_m[rnd] in pending[rnd]:  # micro-batch order, as one stage adds
                        grads = pending[rnd].pop(next_m[rnd])
                        torch._foreach_add_([buffers[i] for i in by_round[rnd]], grads)
                        next_m[rnd] += 1
                    if "input" not in item:  # the first round of the first stage
                        del items[(m, rnd)]
                elif kind == "send_grad":
                    x = items.pop(backwards[bi - 1])["input"]
                    self._send(torch.zeros_like(x) if x.grad is None else x.grad,
                               self._peer(ins, self.stage - 1), sends)
                elif kind == "reduce_tied_grads":
                    module.clear_grads(params)
                    if tied:
                        all_reduce_(buffers[tied[0]], lay.tied_group)
                elif kind == "optimizer_step":
                    loss_sum, metrics_sum, out = self.optimizer_step(
                        optimizer, names, buffers, sends, loss_sum, metrics_sum)
            return loss_sum / gas, {k: v / gas for k, v in metrics_sum.items()}, out

        return step

    def build_sliced_step(self, optimizer, loss_function: Callable,
                          mask_source: Optional[MaskSource] = None) -> Callable:
        """The step under ``pipe_token_slices``: the token-slice stream's
        instructions over (micro-batch, slice) work items (see the module
        docstring)."""
        module, lay, plan, S = self.module, self.lay, self.plan, self.slices
        gas = module.topology.gradient_accumulation_steps
        has_dropout = module.model.architecture.has_dropout
        optimizer.freeze_frozen_params()
        names = list(optimizer.optimized)
        params = [optimizer.params[n] for n in names]
        buffers = [torch.empty_like(p, dtype=torch.float32) for p in params]
        tied = ([i for i, n in enumerate(names) if n == "layers.layer_0.embedding.weight"]
                if module.model.architecture.weight_tying and (plan.first or plan.last) else [])
        instructions = executor_schedule(self.pp, self.stage, gas, 1, S).instructions()
        forwards = work_items(gas, self.pp, 1, S)
        backwards = list(reversed(forwards))
        n_layers = len(self.chunks[0])

        def step(micro_batches: Dict[str, torch.Tensor], dropout_key: Optional[Tuple] = None):
            if dropout_key is None and has_dropout:
                raise ValueError("the model has dropout: the step needs its dropout key")
            module.model.train()
            mbs = [{k: v[i] for k, v in micro_batches.items()} for i in range(gas)]
            parts = [[sequence_slice(mb, k, S, "pipe_token_slices") for k in range(S)]
                     for mb in mbs]
            shape = self.stream_shape(parts[0][0])
            slice_len = parts[0][0]["token_ids"].shape[1]
            dens = module.weight_sums(mbs) if plan.last else None
            for b in buffers:
                b.zero_()
            items: Dict[Tuple[int, int], Dict[str, Any]] = {}
            # micro-batch -> each layer's (keys, values, segments) of its slices so far
            caches: Dict[int, List[Tuple[list, list, list]]] = {}
            pending: Dict[int, List[torch.Tensor]] = {}
            next_m = 0
            sends: list = []
            loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
            metrics_sum: Dict[str, torch.Tensor] = {}
            fi = bi = 0
            out = None
            for ins in instructions:
                kind = ins.name
                if kind == "recv_activation":
                    x = self._recv(self.stage - 1, shape)
                    items[forwards[fi]] = {"input": x.requires_grad_()}
                elif kind == "forward_pass":
                    m, k = forwards[fi]
                    fi += 1
                    item = items.setdefault((m, k), {})
                    batch = parts[m][k]
                    ctx = (None if dropout_key is None else module.dropout_context(
                        dropout_key, mask_source).for_micro_batch(m).for_seq_shard(k, S))
                    h = (item["input"] if "input" in item
                         else module.embed(batch, ctx, k * slice_len, S * slice_len))
                    prior = caches.setdefault(m, [([], [], []) for _ in range(n_layers)])
                    item["output"], kvs = self.run_slice(
                        h, batch, ctx, [(tuple(a), tuple(b), tuple(c)) for a, b, c in prior])
                    item["kv"] = kvs if k < S - 1 else []
                    if k < S - 1:  # later slices read them as leaves
                        leaves = []
                        for (keys, values, segments), (kk, vv) in zip(prior, kvs):
                            lk, lv = kk.detach().requires_grad_(), vv.detach().requires_grad_()
                            keys.append(lk)
                            values.append(lv)
                            segments.append(batch["segment_ids"])
                            leaves += [lk, lv]
                        item["leaves"] = leaves
                elif kind == "send_activation":
                    self._send(items[forwards[fi - 1]]["output"], self.stage + 1, sends)
                elif kind == "loss":
                    m, k = forwards[fi - 1]
                    item = items[(m, k)]
                    batch = parts[m][k]
                    loss, metrics = module.loss(module.head(item.pop("output"), batch), batch,
                                                loss_function, dens[m])
                    item["loss"] = optimizer.scale_loss(loss.float() / gas)
                    loss_sum += loss.detach().float()
                    for key, v in metrics.items():
                        metrics_sum[key] = metrics_sum.get(key, 0.0) + v.detach().float()
                elif kind == "recv_grad":
                    items[backwards[bi]]["grad"] = self._recv(self.stage + 1, shape)
                elif kind == "backward_pass":
                    m, k = backwards[bi]
                    bi += 1
                    item = items[(m, k)]
                    if k == S - 1:  # the micro-batch's first backward
                        module.clear_grads(params)
                    if "loss" in item:
                        roots, grads = [item.pop("loss")], [None]
                    else:
                        roots, grads = [item.pop("output")], [item.pop("grad")]
                    for (kk, vv), i in zip(item.pop("kv"), range(0, 2 * n_layers, 2)):
                        lk, lv = item["leaves"][i], item["leaves"][i + 1]
                        roots += [kk, vv]
                        grads += [torch.zeros_like(lk) if lk.grad is None else lk.grad,
                                  torch.zeros_like(lv) if lv.grad is None else lv.grad]
                    pairs = [(r, g) for r, g in zip(roots, grads) if r.requires_grad]
                    if pairs:  # else nothing trained reaches this item
                        torch.autograd.backward(*zip(*pairs))
                    item.pop("leaves", None)
                    if k == 0:  # the micro-batch's last backward
                        del caches[m]
                        pending[m] = module.grads_of(names, params)
                        module.clear_grads(params)
                        while next_m in pending:  # micro-batch order, as one stage adds
                            torch._foreach_add_(buffers, pending.pop(next_m))
                            next_m += 1
                    if "input" not in item:  # the first stage keeps no input
                        del items[(m, k)]
                elif kind == "send_grad":
                    x = items.pop(backwards[bi - 1])["input"]
                    self._send(torch.zeros_like(x) if x.grad is None else x.grad,
                               self.stage - 1, sends)
                elif kind == "reduce_tied_grads":
                    if tied:
                        all_reduce_(buffers[tied[0]], lay.tied_group)
                elif kind == "optimizer_step":
                    loss_sum, metrics_sum, out = self.optimizer_step(
                        optimizer, names, buffers, sends, loss_sum, metrics_sum)
            return loss_sum / gas, {k: v / gas for k, v in metrics_sum.items()}, out

        return step
