"""The model's forward and training step (counterpart of
``ParallelModule.forward`` and ``build_train_step`` of
scaling_tpu/parallel/parallel_module.py), on one rank or on this rank's
shards of a pipe x data x model layout (``topology.Topology``).

``forward`` runs the layer stack over a batch dict (``token_ids``,
``position_ids``, ``segment_ids``; for a model with an image encoder
``input_images``, ``input_image_locations`` and ``input_image_mask``,
which the embedding splices) and, for a MoE model, sums the
layers' load-balance losses into ``aux_loss`` in layer order, as the JAX
IO dict carries it; with ``activation_checkpointing_type:
every_layer`` each layer of the stack is one remat region (``remat``) and
is recomputed in the backward, as the JAX forward wraps each layer in
``jax.checkpoint``. ``every_layer_save_dots`` is JAX's ``remat_policy``,
``dots_with_no_batch_dims_saveable``: under ``torch.utils.checkpoint``
(non-reentrant) a selective-checkpoint policy (``save_dots_policy``) keeps the outputs of ``aten.mm`` and
``aten.addmm`` (the linears, LoRA's products and the head: dots with no
batch dimension) and recomputes everything else, ``aten.bmm`` (the
unfused attention's products, the MoE experts') and the kernels K2-K5
among it, as JAX recomputes their ``pallas_call`` s.

``build_train_step`` returns ``step(micro_batches, dropout_key)``: for
each of the ``gradient_accumulation_steps`` micro-batches a forward and a
backward of ``loss / gas``, the gradients added into f32 buffers (torch's
bf16 ``.grad`` would round a sum that the JAX step takes in f32), then
one optimizer step. It returns the mean loss, the mean metrics and the
optimizer's output. Micro-batch ``i`` draws its dropout masks from the
step's key folded with ``i`` (``nn.base_layer``), as the JAX step folds
its key; the masks are a function of the key and each site's static id,
so the recompute of ``every_layer`` draws the forward's masks again.
Parameters of no optimizer group are frozen (``requires_grad`` off): no
gradient is computed for them, as JAX's ``stop_gradient`` removes theirs.

Over several ranks each rank holds the slices of its model rank
(``leaf_layouts``: the dim of each leaf split over the model group, from
JAX's partition spec, and under ZeRO the dim of its optimizer slice over
the data group, ``spec_with_data_axis``'s rule) and steps on its data
rank's rows of each global micro-batch. The loss is the global batch's:
each rank divides its weighted sum by the data group's summed weights
(one all-reduce a step), so the gradients summed over the data group
(one flat all-reduce a step) are the one-rank step's, also where the
weights differ between ranks. The key/query norm gains' gradients, which
each model rank takes from its own heads, are summed over the model
group. Dropout masks are the one-rank masks' rows (``DropoutContext``'s
``batch_shard``).

Under context parallelism (``context_parallel_size`` cp) the context ranks
of a data rank read the same micro-batches and each keeps its contiguous
``1/cp`` of the sequence (``sequence_slice``, JAX's ``P(data, context)``),
the positions and segments made explicit first, so that every slice keeps
its absolute positions (a slice that took the default ``0 .. s-1`` would
turn its rotary angles wrong). The loss divides by the weights summed over
the data x context group (``grad_group``), and the gradients and the
reported loss are summed over it; ZeRO's slices stay cut over the data
group. Dropout masks are the one-rank masks' sequence slices
(``DropoutContext``'s ``seq_shard``). ``forward`` gathers the logits of the
slices, so that it returns the one-rank output at every layout.

Over several pipe stages (``model.plan``) the step is
``pipeline_engine.PipelineEngine``'s, which runs this rank's instruction
stream of the schedule; ``forward`` runs one micro-batch through the
stages (the last stage returns the output, the others None) and
``eval_loss`` hands every rank the loss. ``every_pipe_stage`` remats each
stage's chunk of layers as one region there (``remat`` too); at one stage
it is per-layer remat of the transformer layers, the edges not rematted. A checkpoint's
leaf is gathered to global rank 0 from the stage that holds it
(``gather_leaf``), so the files are the one-rank model's at every pipe
layout.
"""

from __future__ import annotations

import functools
import re
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..nn.base_layer import DropoutContext, MaskSource
from ..optimizer import Optimizer, OptimizerStepOutput
from ..topology import ActivationCheckpointingType, TopologyConfig
from .collectives import all_gather_cat, all_reduce_, broadcast_, flat_all_reduce_

# the batch's leaves with a sequence dim (dim 1), which sequence splitting cuts
SEQUENCE_KEYS = ("token_ids", "target_token_ids", "loss_weights", "position_ids",
                 "segment_ids")


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
    transposed by the JAX package: every matrix but the embedding table, a
    soft prompt and a CLIP tower's position embedding (linears, the MoE
    router, LoRA factors, adapters, the embedding head's projections and a
    CLIP tower's flattened patch kernel are ``(in, out)`` there, ``(out,
    in)`` here; the tables are ``(rows, hidden)`` on both sides, and the 3-D
    expert weights keep the JAX layout). 4-D convolution kernels are
    permuted instead (``to_jax_layout``)."""
    leaf = name.rsplit(".", 1)[-1]
    return (ndim == 2 and not name.endswith("embedding.weight")
            and not leaf.startswith("softprompt_") and leaf != "position_embedding")


def to_jax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """The parameter ``t`` in the JAX layout (a view): matrices transposed
    as ``transposed_in_jax`` says, a convolution kernel from PyTorch's
    ``(out, in, kh, kw)`` to JAX's ``(kh, kw, in, out)``."""
    if t.ndim == 4:
        return t.permute(2, 3, 1, 0)
    return t.t() if transposed_in_jax(name, t.ndim) else t


def port_dim(name: str, ndim: int, jax_dim: int) -> int:
    """The port's dim of the JAX layout's dim ``jax_dim`` (``to_jax_layout``
    read backwards)."""
    if ndim == 4:
        return (2, 3, 1, 0)[jax_dim]
    return 1 - jax_dim if transposed_in_jax(name, ndim) else jax_dim


def from_jax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """The inverse of ``to_jax_layout`` (a view)."""
    if t.ndim == 4:
        return t.permute(3, 2, 0, 1)
    return t.t() if transposed_in_jax(name, t.ndim) else t


# the linears the JAX package splits over the model axis by input
# (RowParallelLinear); its other linears split by output (ColumnParallelLinear)
_ROW_PARALLEL = ("dense", "dense_out", "down_proj")
# the attention's own linears; any other child named ``{query,key,value,dense}_x``
# of an attention is the LoRA ``x`` of that projection
_ATTENTION_LINEARS = ("query_key_value", "query", "key", "value", "dense")
_LORA_PARENT = re.compile(r"(query|key|value|dense)_.+")
# a MoE's expert weights: experts over the data axis, the FFN width over model
_EXPERT_SPECS = {"w_in": ("data", None, "model"), "w_gate": ("data", None, "model"),
                 "w_out": ("data", "model", None)}


def jax_partition_spec(key: str, ndim: int) -> tuple:
    """The partition spec the JAX metas give the parameter ``key`` (its
    ``MESH.json`` record), over the JAX layout: the vocabulary axis of the
    embedding, the output axis of a column-parallel linear and its bias
    (``bias`` or BitFit's ``bias_{name}``), the input axis of a row-parallel
    one; norms and row-parallel biases are replicated. The image encoder's
    projection into the stream is row-parallel, its CLIP tower replicated
    whole. A LoRA follows its
    host: on ``dense`` ``lora_a`` splits by input and ``lora_b`` and the
    bias are replicated; on query, key and value ``lora_a`` is replicated
    and ``lora_b`` and the bias split by output. Adapters, soft prompts and
    the embedding head's projections are replicated. A MoE's experts split
    over ``data`` and their FFN width over ``model``; its router is
    replicated."""
    if key.endswith("embedding.weight"):
        return ("model", None)
    parts = key.split(".")
    leaf, module = parts[-1], parts[-2]
    if ".image_encoder.clip." in key:  # a CLIP tower runs replicated
        return (None,) * ndim
    if module == "proj" and parts[-3].endswith("image_encoder"):  # row-parallel
        return ("model", None) if ndim == 2 else (None,)
    if module == "mlp" and leaf in _EXPERT_SPECS:
        return _EXPERT_SPECS[leaf]
    if module == "router" and parts[-3:-2] == ["mlp"]:
        return (None, None)
    if (len(parts) >= 3 and parts[-3] == "attention" and module not in _ATTENTION_LINEARS
            and _LORA_PARENT.fullmatch(module)):
        dense = module.startswith("dense_")
        if leaf == "lora_a":
            return ("model", None) if dense else (None, None)
        if leaf == "lora_b":
            return (None, None) if dense else (None, "model")
        return (None,) if dense else ("model",)
    if (module.startswith("adapter_") or leaf.startswith("softprompt_")
            or re.fullmatch(r"proj_\d+_.+", leaf)):
        return (None,) * ndim
    if ndim == 2:
        return ("model", None) if module in _ROW_PARALLEL else (None, "model")
    linear_bias = (leaf == "bias" or leaf.startswith("bias_")) and "norm" not in module
    return ("model",) if linear_bias and module not in _ROW_PARALLEL else (None,) * ndim


def spec_with_data_axis(spec: tuple, shape: tuple, dp: int) -> tuple:
    """ZeRO's placement rule (``spec_with_data_axis`` of
    scaling_tpu/parallel/sharding.py): ``data`` on the last free dim of the
    JAX-layout ``shape`` that ``dp`` divides; the spec unchanged when the
    data axis is used already or no dim divides."""
    spec = list(spec) + [None] * (len(shape) - len(spec))
    if dp <= 1 or "data" in spec:
        return tuple(spec)
    for d in reversed(range(len(shape))):
        if spec[d] is None and shape[d] % dp == 0 and shape[d] > 0:
            spec[d] = "data"
            break
    return tuple(spec)


class LeafLayout(NamedTuple):
    """Where a parameter's slices live: its JAX key, its global shape in the
    port's layout, the port dim split over the model group, the port dim
    of its ZeRO slice over the data group (None: whole), and whether this
    stage's copy is the stored one (False for the last stage's copy of a
    tied table: the first stage's is stored and counted)."""

    key: str
    shape: Tuple[int, ...]
    model_dim: Optional[int]
    data_dim: Optional[int]
    stored: bool = True


def positions_and_segments(batch: Dict[str, torch.Tensor]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batch's ``position_ids`` and ``segment_ids``, by default
    ``0 .. s-1`` and one segment."""
    tokens = batch["token_ids"]
    b, s = tokens.shape
    pos = batch.get("position_ids")
    if pos is None:
        pos = torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)
    seg = batch.get("segment_ids")
    if seg is None:
        seg = torch.zeros(b, s, dtype=torch.int32, device=tokens.device)
    return pos, seg


def sequence_slice(batch: Dict[str, torch.Tensor], rank: int, size: int,
                   what: str = "context_parallel_size") -> Dict[str, torch.Tensor]:
    """Slice ``rank`` of ``size`` contiguous slices of the batch's sequence
    (views), its positions and segments made explicit first: each slice
    keeps the absolute positions of its tokens. ``what`` names the knob in
    the error when ``size`` does not divide the sequence."""
    if size == 1:
        return batch
    for key in batch:
        if key not in SEQUENCE_KEYS:
            raise NotImplementedError(f"{key} under {what} {size} is not ported")
    s = batch["token_ids"].shape[1]
    if s % size:
        raise ValueError(f"{what} ({size}) must divide the sequence length ({s})")
    pos, seg = positions_and_segments(batch)
    full = dict(batch, position_ids=pos, segment_ids=seg)
    return {k: slice_of(v, 1, rank, size) for k, v in full.items()}


def slice_of(t: torch.Tensor, dim: Optional[int], rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous ``1/size`` of ``t`` along ``dim`` (a view)."""
    if dim is None or size == 1:
        return t
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n)


# the products JAX's dots_with_no_batch_dims_saveable keeps: a 2-D input
# times a matrix (F.linear flattens (b, s, h) into one), with or without bias
SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def save_dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``every_layer_save_dots``: save the outputs of ``SAVED_DOTS``,
    recompute the rest. The policy sees the ops that reach the dispatcher:
    a hand-written kernel's launch (K2 by Triton, K3-K5 through their C
    entry points) does not, so it runs again in the recompute, after the
    same ``aten`` allocations as in the forward; the saved products are
    matched to the recompute's in the order the forward ran them, which
    the recompute repeats because it runs the same code on the same
    inputs."""
    return CheckpointPolicy.MUST_SAVE if op in SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


_SAVE_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts, save_dots_policy)


class Remat(torch.autograd.Function):
    """``fn(*args)`` as one remat region (``remat``): the forward runs
    ``fn`` without a graph and keeps only the tensor arguments; the
    backward runs it again with one and back-propagates through it, which
    adds the region's parameter gradients to their ``.grad`` and returns
    the arguments'. The parameters are inputs only so that the output needs
    a gradient where no argument does (a frozen embedding's token ids).
    ``torch.utils.checkpoint`` does the same, but its first call imports
    ``torch._dynamo``: 13.4 s in a fresh process on the card's machine,
    16.1-16.5 s with four started at once (PERF.md "PR 19"), which every
    worker process would pay on its first step. ``every_layer_save_dots``
    keeps it: its policy needs the dispatch mode."""

    @staticmethod
    def forward(ctx, fn, n_args, *inputs):
        args = inputs[:n_args]
        ctx.fn, ctx.n_inputs = fn, len(inputs)
        ctx.tensor_at = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        ctx.args = [None if i in ctx.tensor_at else a for i, a in enumerate(args)]
        ctx.save_for_backward(*(args[i] for i in ctx.tensor_at))
        with torch.no_grad():
            return fn(*args)

    @staticmethod
    def backward(ctx, *grads):
        args = list(ctx.args)
        for i, t in zip(ctx.tensor_at, ctx.saved_tensors):
            args[i] = t.detach().requires_grad_(ctx.needs_input_grad[2 + i])
        with torch.enable_grad():
            out = ctx.fn(*args)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
        if pairs:
            torch.autograd.backward(*zip(*pairs))
        arg_grads = [args[i].grad if i in ctx.tensor_at else None for i in range(len(args))]
        return (None, None, *arg_grads) + (None,) * (ctx.n_inputs - len(args))


def remat(fn: Callable, args: tuple, params) -> Any:
    """``fn(*args)`` recomputed in the backward; ``params``: the parameters
    ``fn`` reads (those that need no gradient are left out)."""
    return Remat.apply(fn, len(args), *args, *(p for p in params if p.requires_grad))


class ParallelModule:
    """The model behind its forward, loss and training step. ``topology``
    is the config's section; ``layout`` the ``topology.Topology`` of a run
    of several ranks (None: one rank)."""

    def __init__(self, model: torch.nn.Module, topology: TopologyConfig, layout=None):
        self.model = model
        self.topology = topology
        self.layout = layout if layout is not None and layout.world_size > 1 else None
        # this stage's layers over several pipe stages (None: the whole stack)
        self.plan = getattr(model, "plan", None)

    @property
    def pipe_group(self):
        return None if self.layout is None else self.layout.pipe_group

    @property
    def data_group(self):
        return None if self.layout is None else self.layout.data_group

    @property
    def model_group(self):
        return None if self.layout is None else self.layout.model_group

    @property
    def grad_group(self):
        """The ranks of one model slice (data x context): the loss's and the
        gradients' sum."""
        return None if self.layout is None else self.layout.grad_group

    @property
    def context_size(self) -> int:
        return 1 if self.layout is None else self.layout.context_parallel_size

    def context_slice(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This context rank's slice of ``batch`` (the batch itself at cp 1)."""
        if self.context_size == 1:
            return batch
        return sequence_slice(batch, self.layout.context_parallel_rank, self.context_size)

    def dropout_context(self, key: Tuple, mask_source: Optional[MaskSource] = None
                        ) -> DropoutContext:
        """The step's dropout context at this rank's data and context shard."""
        lay = self.layout
        if lay is None:
            return DropoutContext(key, mask_source)
        return DropoutContext(key, mask_source,
                              (lay.data_parallel_rank, lay.data_parallel_size),
                              (lay.context_parallel_rank, lay.context_parallel_size))

    def leaf_layouts(self, zero: bool = False) -> Dict[str, LeafLayout]:
        """Each parameter's ``LeafLayout`` by the port's name, from JAX's
        partition spec of its key; ``zero``: with the ZeRO slice dims."""
        lay = self.layout
        mp = 1 if lay is None else lay.model_parallel_size
        dp = 1 if lay is None else lay.data_parallel_size
        out = {}
        for name, p in self.model.named_parameters():
            key = jax_param_key(self.model, name)
            spec = jax_partition_spec(key, p.ndim)
            shape = list(p.shape)
            model_dim = None
            if mp > 1 and "model" in spec:
                model_dim = port_dim(key, p.ndim, spec.index("model"))
                shape[model_dim] *= mp
            data_dim = None
            if zero and dp > 1:
                jax_shape = tuple(to_jax_layout(key, torch.empty(shape, device="meta")).shape)
                zspec = spec_with_data_axis(spec, jax_shape, dp)
                if "data" in zspec and "data" not in spec:
                    data_dim = port_dim(key, p.ndim, zspec.index("data"))
            stored = lay is None or self.owner_stage(name) == lay.pipe_parallel_rank
            out[name] = LeafLayout(key, tuple(shape), model_dim, data_dim, stored)
        return out

    def gather_leaf(self, name: str, t: Optional[torch.Tensor],
                    data_dim: Optional[int] = None,
                    dtype: Optional[torch.dtype] = None) -> Optional[torch.Tensor]:
        """The whole leaf ``name`` from this rank's ``t`` (its model slice,
        or with ``data_dim`` its ZeRO slice of that), on global rank 0; None
        on the others. Every rank calls it, leaf by leaf in one order. Over
        several pipe stages ``t`` is None on the stages that do not hold the
        leaf, and the holder's first data and model rank broadcasts it over
        its pipe group to the first stage (``dtype``: the leaf's there)."""
        lay = self.layout
        if lay is None:
            return t
        owner = self.owner_stage(name)
        if lay.pipe_parallel_rank == owner:
            if data_dim is not None:
                t = all_gather_cat(t, lay.data_group, data_dim)
            model_dim = self.layouts[name].model_dim
            if model_dim is not None:
                t = all_gather_cat(t, lay.model_group, model_dim)
        if owner != 0 and lay.data_parallel_rank == 0 and lay.model_parallel_rank == 0:
            if lay.pipe_parallel_rank == owner:
                # a copy: gloo writes the result back into a CUDA source too
                t = t.detach().clone(memory_format=torch.contiguous_format)
            else:
                shape, own_dtype = self.whole_leaves[name]
                t = torch.empty(shape, dtype=dtype or own_dtype,
                                device=next(self.model.parameters()).device)
            broadcast_(t, lay.stage_rank(owner), lay.pipe_group)
        return t if lay.global_rank == 0 else None

    def owner_stage(self, name: str) -> int:
        """The pipe stage whose copy of parameter ``name`` is stored (0 at
        one stage; a tied table's is the first stage's)."""
        if self.plan is None:
            return 0
        from .pipeline import stage_of_layer

        index = int(name.split(".")[1].removeprefix("layer_"))
        return stage_of_layer(self.topology, self.model.architecture.num_layers, index)

    @functools.cached_property
    def whole_model(self) -> torch.nn.Module:
        """The whole one-rank stack on the meta device (names, keys, global
        shapes and dtypes of every stage's leaves)."""
        return type(self.model)(self.model.architecture, device="meta")

    @functools.cached_property
    def whole_leaves(self) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """Every parameter of the whole stack: name -> (global shape in the
        port's layout, dtype), in the stack's order."""
        return {n: (tuple(p.shape), p.dtype) for n, p in self.whole_model.named_parameters()}

    def whole_ckpt_keys(self) -> Dict[str, str]:
        """``ckpt_keys`` of the whole stack: every stage's parameters, in
        the one-rank model's order (the order every rank gathers them in)."""
        if self.plan is None:
            return self.ckpt_keys()
        whole = self.whole_model
        return {name: jax_param_key(whole, name) for name, _ in whole.named_parameters()}

    def shard_leaf(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's model slice of the whole leaf ``name`` (a view)."""
        lay = self.layout
        if lay is None:
            return whole
        return slice_of(whole, self.layouts[name].model_dim, lay.model_parallel_rank,
                        lay.model_parallel_size)

    @functools.cached_property
    def layouts(self) -> Dict[str, LeafLayout]:
        return self.leaf_layouts()

    def loss(self, output: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
             loss_function: Callable, denominator: Optional[torch.Tensor] = None):
        """``loss_function`` on this rank's rows (and sequence slice); over
        a data x context group, with the global batch's summed loss weights as
        the denominator (summed here unless given), so that the group's sum of
        the results is the global batch's loss and metrics; a ``denominator``
        given is used on one rank too (a pipeline's token slice)."""
        if self.grad_group is None and denominator is None:
            return loss_function(output, batch)
        if denominator is None:
            denominator = self.weight_sums([batch])[0]
        return loss_function(output, batch, denominator=denominator)

    def weight_sums(self, micro_batches) -> torch.Tensor:
        """Each micro-batch's loss weights summed over the data x context
        group, one all-reduce for all of them."""
        sums = []
        for mb in micro_batches:
            w = mb.get("loss_weights")
            sums.append(torch.tensor(float(mb["target_token_ids"].numel()),
                                     device=mb["target_token_ids"].device)
                        if w is None else w.float().sum())
        return all_reduce_(torch.stack(sums), self.grad_group)

    def ckpt_keys(self) -> Dict[str, str]:
        """The JAX key of each parameter, by the port's name, in the
        model's order: the names checkpoints are written under."""
        return {name: jax_param_key(self.model, name)
                for name, _ in self.model.named_parameters()}

    @property
    def remat(self) -> bool:
        return (self.topology.activation_checkpointing_type
                != ActivationCheckpointingType.DISABLED)

    def merge_lora_weights(self) -> None:
        """Fold every layer's LoRA deltas into its base weights, in place."""
        for layer in self.model.transformer_layers:
            layer.merge_lora_weights()

    def run(self, layer: Callable, *args, edge: bool = False):
        """``layer(*args)``, under the config's per-layer remat mode in a
        training pass; ``every_pipe_stage`` remats no single layer, and at
        one stage the transformer layers but not the edges (``edge``)."""
        if not (self.remat and torch.is_grad_enabled()):
            return layer(*args)
        mode = self.topology.activation_checkpointing_type
        if mode == ActivationCheckpointingType.EVERY_LAYER_SAVE_DOTS:
            return checkpoint(layer, *args, use_reentrant=False, context_fn=_SAVE_DOTS_CONTEXT)
        if mode == ActivationCheckpointingType.EVERY_PIPE_STAGE and (edge or self.plan is not None):
            return layer(*args)
        return remat(layer, args, layer.parameters())

    def embed(self, batch: Dict[str, torch.Tensor],
              ctx: Optional[DropoutContext] = None) -> torch.Tensor:
        return self.run(self.model.embedding, batch["token_ids"], ctx,
                        batch.get("input_images"), batch.get("input_image_locations"),
                        batch.get("input_image_mask"), edge=True)

    def run_layers(self, layers, h: torch.Tensor, batch: Dict[str, torch.Tensor],
                   ctx: Optional[DropoutContext] = None):
        """``h`` through ``layers`` (transformer layers) with the batch's
        positions and segments; with a MoE model also the layers' summed
        load-balance losses, in layer order."""
        pos, seg = positions_and_segments(batch)
        moe = self.model.architecture.is_moe
        aux = torch.zeros((), dtype=torch.float32, device=h.device) if moe else None
        for layer in layers:
            if moe:
                h, layer_aux = self.run(layer, h, pos, None, seg, None, None, False, ctx, True)
                aux = aux + layer_aux
            else:
                h = self.run(layer, h, pos, None, seg, None, None, False, ctx)
        return h, aux

    def head(self, h: torch.Tensor, batch: Dict[str, torch.Tensor],
             aux: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The final norm and the heads over ``h``: ``{"activations":
        logits}`` [``"embeddings"``] [``"aux_loss"``]."""
        m = self.model
        h = self.run(m.final_norm, h, edge=True)
        out = {"activations": self.run(m.lm_head, h, edge=True)}
        if aux is not None:
            out["aux_loss"] = aux
        if m.embedding_head is not None:
            out["embeddings"] = self.run(m.embedding_head, h, batch.get("loss_weights"),
                                         edge=True)
        return out

    def forward(self, batch: Dict[str, torch.Tensor],
                ctx: Optional[DropoutContext] = None) -> Optional[Dict[str, torch.Tensor]]:
        """The stack over ``batch``; returns ``{"activations": logits}``,
        with ``"embeddings"`` beside them when the model has an embedding
        head and ``"aux_loss"`` when it is a MoE model. ``ctx``: the dropout
        context of a training pass, None for a deterministic one. Over
        several pipe stages every rank of the pipe calls it: the last stage
        returns the output, the others None. Under context parallelism
        every rank of the context group calls it with the whole batch and
        gets the whole output (each rank's slice, gathered)."""
        if self.plan is not None:
            return self.engine.forward(batch, ctx)
        if self.context_size == 1:
            return self.local_forward(batch, ctx)
        out = self.local_forward(self.context_slice(batch), ctx)
        return {k: all_gather_cat(v, self.layout.context_group, 1) if v.ndim >= 2 else v
                for k, v in out.items()}

    def local_forward(self, batch: Dict[str, torch.Tensor],
                      ctx: Optional[DropoutContext] = None) -> Dict[str, torch.Tensor]:
        """``forward`` of one stage over this rank's slice of the batch."""
        h = self.embed(batch, ctx)
        h, aux = self.run_layers(self.model.transformer_layers, h, batch, ctx)
        return self.head(h, batch, aux)

    @functools.cached_property
    def engine(self):
        from .pipeline_engine import PipelineEngine

        return PipelineEngine(self)

    def eval_loss(self, batch: Dict[str, torch.Tensor], loss_function: Callable
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss and metrics of a deterministic forward of ``batch``, the
        global batch's on every rank (summed over the data group, from the
        last stage over the pipe group)."""
        if self.plan is None:
            batch = self.context_slice(batch)
            out = self.local_forward(batch)
        else:
            out = self.forward(batch)
        loss = metrics = None
        if out is not None:
            loss, metrics = self.loss(out, batch, loss_function)
            if self.grad_group is not None:
                names = sorted(metrics)
                summed = all_reduce_(torch.stack([loss.float()] + [
                    metrics[k].float() for k in names]), self.grad_group)
                loss, metrics = summed[0], dict(zip(names, summed[1:]))
        if self.plan is not None:
            loss, metrics = self.engine.share_from_last_stage(loss, metrics)
        return loss, metrics

    def build_train_step(self, optimizer: Optimizer, loss_function: Callable,
                         mask_source: Optional[MaskSource] = None
                         ) -> Callable[..., Tuple[torch.Tensor, Dict[str, Any],
                                                  OptimizerStepOutput]]:
        """``step(micro_batches, dropout_key=None)``: leaves stacked ``(gas,
        micro_batch_size, ...)``, ``dropout_key`` the step's
        (``nn.base_layer.dropout_key``), which a model with dropout needs.
        ``mask_source`` replaces the masks' draw (tests replay the JAX
        package's masks through it). Returns (mean loss, mean metrics,
        optimizer output)."""
        if self.plan is not None:
            return self.engine.build_train_step(optimizer, loss_function, mask_source)
        gas = self.topology.gradient_accumulation_steps
        has_dropout = self.model.architecture.has_dropout
        optimizer.freeze_frozen_params()
        params = [optimizer.params[n] for n in optimizer.optimized]
        buffers = [torch.empty_like(p, dtype=torch.float32) for p in params]

        def step(micro_batches: Dict[str, torch.Tensor], dropout_key: Optional[Tuple] = None):
            if dropout_key is None and has_dropout:
                raise ValueError("the model has dropout: the step needs its dropout key")
            self.model.train()
            loss_sum = torch.zeros((), dtype=torch.float32, device=buffers[0].device)
            metrics_sum: Dict[str, torch.Tensor] = {}
            mbs = [self.context_slice({k: v[i] for k, v in micro_batches.items()})
                   for i in range(gas)]
            dens = None if self.grad_group is None else self.weight_sums(mbs)
            for i, mb in enumerate(mbs):
                ctx = (None if dropout_key is None
                       else self.dropout_context(dropout_key, mask_source).for_micro_batch(i))
                for p in params:
                    p.grad = None
                loss, metrics = self.loss(self.local_forward(mb, ctx), mb, loss_function,
                                          None if dens is None else dens[i])
                scaled = optimizer.scale_loss(loss.float() / gas)
                if scaled.requires_grad:  # else no trained parameter reaches the loss
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
            if self.grad_group is not None:
                flat_all_reduce_(buffers, self.grad_group)
                # the reported loss and metrics: the global batch's
                names = sorted(metrics_sum)
                summed = all_reduce_(torch.stack([loss_sum] + [metrics_sum[k] for k in names]),
                                     self.grad_group)
                loss_sum, metrics_sum = summed[0], dict(zip(names, summed[1:]))
            out = optimizer.step(dict(zip(optimizer.optimized, buffers)))
            return loss_sum / gas, {k: v / gas for k, v in metrics_sum.items()}, out

        return step
