"""Self attention (counterpart of scaling_tpu/nn/attention.py).

Projections (fused or separate, GQA through ``num_kv_heads``), optional
key/query norm (over the head dim, before rotary), rotary or none, then
one of three attention paths, and the output projection:

- the paged serving path: the block-paged KV pool view and its writer,
  kernel K1 over the pool;
- the dense KV cache of ``generate``: a ``(k, v)`` or ``(k, v, segment
  ids)`` tuple of ``(b, max_len, ...)`` buffers, written at
  ``cache_offset`` (``dense_kv_write``); queries attend unfused over the
  written slots with grouped products over the unrepeated K/V, causal by
  slot, within equal segment ids when the cache
  carries them, with an optional additive score term (the left-pad mask
  of ragged prompts). Under left padding a row's rotary positions lag its
  slots: ``position_ids`` stay the rotary clock, the slots the causal one.
  The JAX layer's 3-tuple cache also carries pipeline token slices; here
  they have a cache of their own (below);
- the token-slice cache of a pipeline stage (``TokenSliceCache``,
  TeraPipe): the K/V and segment ids of a micro-batch's earlier token
  slices, tensors that autograd may differentiate. The dense cache is
  written in place, which autograd cannot take: the next slice's write
  would change what an earlier slice's graph saved. So the slice's queries
  attend over the concatenation of the earlier slices' K/V and its own,
  unfused, each query at or before its own slot and in its own segment;
  the layer hands the slice's K/V back (``return_kv``) for the slices after
  it. Under model parallelism the cache holds the rank's own kv heads;
  The trailing local-window heads also keep to ``slot_q - slot_k <=
  window``, the rule of the uncached forward (the JAX package's dense
  cache drops the window, so its cached decode parts from its own
  uncached one; the port does not copy that);
- no cache (training, prefill, full-sequence logits): causal attention
  within equal ``segment_ids`` (packed documents), optional trailing
  local-window heads. ``flash_path_active`` decides, as in the JAX layer,
  between the flash kernels (K4 forward, K5 backward,
  ``ops.flash_attention``) with unrepeated KV, and the unfused path
  (``multi_head_attention`` over a ``segment_ids_to_mask`` mask and
  ``MaskedSoftmax``). There is no TPU gate here: on the CPU the flash
  path runs the kernels' plain versions. Under context parallelism
  (``context``, a ``base_layer.ContextShard``) each rank holds a slice of
  the sequence and the attention crosses the context group: ring attention
  (``ops.ring_attention``, unfused, as JAX's) or Ulysses attention
  (``ops.ulysses_attention``, K4/K5 on the whole sequence of a head shard
  where the flash gate takes it). K/V are repeated only as far as the model
  group (and for Ulysses the context group) must divide the kv heads, by
  JAX's rule: ``div / gcd(n_kv, div)`` copies a head, the full GQA repeat
  where that does not divide it. Score manipulations, local-window heads
  and probability dropout raise by name there, where the JAX layer
  asserts.

With a ``lora_config`` each named projection gets a ``ParallelLoRa``
delta (``{query,key,value,dense}_{name}``): q, k and v add theirs after
the split, the output projection after the dense product, each drawing
its own dropout mask; ``merge_lora_weights`` folds the deltas into the
host weights. Attention-probability dropout runs on the unfused path
only: a rate above 0 in a training pass (a ``DropoutContext`` given)
routes away from K4/K5 through ``flash_path_active``, as in the JAX
layer. A score manipulation (AtMan controls, ``models/transformer/
attention_control.py``) is log-additive or multiplicative on the unfused
paths; the paged path refuses it, and local-window heads, by name, as the
JAX layer does.

Over a model group (``shard``, ``nn.linear.ModelShard``) the input enters
the model region once; q, k and v (or the fused, head-major
``query_key_value``) are column-parallel, so each rank attends its
contiguous ``n / mp`` query heads and ``n_kv / mp`` kv heads with the
same paths (K4/K5 on the local heads), and the output projection is
row-parallel. Where ``n_kv % mp != 0`` each rank holds ``1 / mp`` of the
kv projections' columns; the group gathers the whole k and v and each
rank repeats them as JAX's context-parallel path does (``mp /
gcd(n_kv, mp)`` copies a head, or the full GQA repeat where that does not
divide it) and keeps its slice; their gradient is summed back over the
group. The key/query norms then see the local heads only, so their
parameters enter the model region in the forward: the region's backward
sums their gradients over the group. Local-window heads, LoRA, score
manipulations and the cached decode paths (but the token-slice cache)
raise by name under model parallelism.

The pool and the dense cache are updated IN PLACE: the writers put the
new tokens' K/V into the tensors the caller holds, so no updated caches
are handed back (the JAX package returns new arrays and absorbs them).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from ..ops.flash_attention import HEAD_DIMS, flash_attention
from ..ops.paged_attention import paged_attention
from .base_layer import ContextShard, DropoutContext, dropout
from ..parallel.collectives import copy_to_model_region, gather_shared_from_model_region
from .linear import ColumnParallelLinear, ModelShard, RowParallelLinear
from .lora import LoRAModuleType, LoRaConfig, ParallelLoRa
from .masked_softmax import MaskedSoftmax, MaskedSoftmaxConfig
from .norm import get_norm
from .seq_packing import segment_ids_to_mask

FLASH_MIN_BLOCK = 128  # the flash path needs seq % 128 == 0 (the JAX gate's rule)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(b, s, n_kv, h) -> (b, s, n_kv * n_rep, h) for GQA."""
    if n_rep == 1:
        return x
    b, s, n_kv, h = x.shape
    return x[:, :, :, None, :].expand(b, s, n_kv, n_rep, h).reshape(b, s, n_kv * n_rep, h)


@dataclasses.dataclass
class PagedKVCacheView:
    """One layer's slice of the block-paged KV pool plus the batch's
    addressing state. Block 0 is the trash block: it absorbs writes from
    inactive rows and padding.

    ``pool_k``/``pool_v`` are ``(num_blocks, block_size, n_kv, h)``, in the
    model dtype or int8 with per-slot-per-head ``scale_k``/``scale_v`` of
    shape ``(num_blocks, block_size, n_kv)``. ``new_len`` (per row) is how
    many of the ``s`` presented tokens are real; None means all of them."""

    pool_k: torch.Tensor
    pool_v: torch.Tensor
    block_table: torch.Tensor  # (b, max_blocks) int32; 0 = trash
    context_len: torch.Tensor  # (b,) int32 tokens already cached per row
    scale_k: Optional[torch.Tensor] = None
    scale_v: Optional[torch.Tensor] = None
    new_len: Optional[torch.Tensor] = None  # (b,) int32

    @property
    def quantized(self) -> bool:
        return self.scale_k is not None


def kv_quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token-per-head int8: ``x`` (..., n_kv, h) -> (q, scale)
    with ``scale`` (..., n_kv) f32. ``torch.round`` rounds half to even,
    like ``jnp.round``."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def paged_flat_slots(block_table: torch.Tensor, positions: torch.Tensor,
                     block_size: int) -> torch.Tensor:
    """Per-row logical ``positions`` (b, s) -> flat pool slots
    ``block_id * block_size + offset`` through each row's block table.
    Positions past the table's reach go to the trash block, never into
    the row's last real block."""
    max_blocks = block_table.shape[1]
    positions = positions.long()
    blk_idx = positions // block_size
    blocks = torch.gather(block_table.long(), 1, blk_idx.clamp(0, max_blocks - 1))
    blocks = torch.where(blk_idx < max_blocks, blocks, 0)
    return blocks * block_size + positions % block_size


def paged_scatter_kv(view: PagedKVCacheView, flat: torch.Tensor,
                     k_rows: torch.Tensor, v_rows: torch.Tensor) -> None:
    """Write new K/V rows ``(n, n_kv, h)`` into the pool at flat slots
    ``flat`` ``(n,)``, quantising when the pool is int8 — in place. The
    order of duplicate writes (padding into the trash block) is undefined."""
    num_blocks, block_size, n_kv, h = view.pool_k.shape
    flat = flat.long()
    pk = view.pool_k.view(num_blocks * block_size, n_kv, h)
    pv = view.pool_v.view(num_blocks * block_size, n_kv, h)
    if view.quantized:
        qk, sk = kv_quantize_int8(k_rows)
        qv, sv = kv_quantize_int8(v_rows)
        pk.index_copy_(0, flat, qk)
        pv.index_copy_(0, flat, qv)
        view.scale_k.view(num_blocks * block_size, n_kv).index_copy_(0, flat, sk)
        view.scale_v.view(num_blocks * block_size, n_kv).index_copy_(0, flat, sv)
    else:
        pk.index_copy_(0, flat, k_rows.to(pk.dtype))
        pv.index_copy_(0, flat, v_rows.to(pv.dtype))


def dense_kv_write(cache: Tuple[torch.Tensor, ...], k: torch.Tensor, v: torch.Tensor,
                   offset: int, segment_ids: Optional[torch.Tensor] = None) -> None:
    """Write ``s`` new tokens' K/V (and, into a 3-tuple cache, their
    segment ids) at slots ``offset .. offset + s - 1`` of every row of a
    dense ``(b, max_len, ...)`` cache, in place, in the cache's dtype."""
    s = k.shape[1]
    cache[0][:, offset:offset + s] = k
    cache[1][:, offset:offset + s] = v
    if len(cache) == 3:
        cache[2][:, offset:offset + s] = 0 if segment_ids is None else segment_ids


@dataclasses.dataclass
class TokenSliceCache:
    """One layer's K/V of a micro-batch's earlier token slices at a pipe
    stage: ``keys`` and ``values`` ``(b, s_j, n_kv_local, d)`` each, after
    rotary, and the slices' ``segments`` ``(b, s_j)``, in slice order. The
    slice reads them as they are (no copy is written): autograd carries its
    gradient into them."""

    keys: Tuple[torch.Tensor, ...] = ()
    values: Tuple[torch.Tensor, ...] = ()
    segments: Tuple[torch.Tensor, ...] = ()


def flash_path_active(*, kernel_is_flash: bool, causal: bool,
                      dropout_attention_probs: float, deterministic: bool,
                      context_parallel_size: int, seq_len: int, head_dim: int,
                      dtype: torch.dtype, has_kv_cache: bool = False,
                      has_scores_manipulation: bool = False) -> bool:
    """The flash-vs-unfused gate of the JAX layer (``flash_path_active``),
    without its TPU platform check: causal, no cache, no probability
    dropout, no context parallelism and ``seq_len % 128 == 0``. Where the
    JAX gate routes every ``head_dim >= 64`` and every dtype to splash,
    this one routes only what K4/K5 are built for: the head dims
    ``HEAD_DIMS`` in bf16. Any other head dim or dtype goes to the unfused
    path, as ``head_dim < 64`` does in both packages. The route depends on
    shapes and dtypes alone, so it is the same on the CPU and on the card."""
    if not kernel_is_flash or has_kv_cache or has_scores_manipulation:
        return False
    if not causal or context_parallel_size > 1:
        return False
    if dropout_attention_probs > 0.0 and not deterministic:
        return False
    return (seq_len % FLASH_MIN_BLOCK == 0 and head_dim in HEAD_DIMS
            and dtype == torch.bfloat16)


def multi_head_attention(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                         mask: torch.Tensor, scaling_factor: float,
                         softmax: MaskedSoftmax,
                         scores_manipulation: Optional[torch.Tensor] = None,
                         dropout_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                         log_additive: bool = True) -> torch.Tensor:
    """Unfused attention: QK^T -> masked softmax -> PV. q (b, s_q, n, h),
    k/v (b, s_k, n_kv, h) with ``n_kv`` dividing ``n``: query head ``i``
    reads kv head ``i // (n / n_kv)``, as ``repeat_kv`` lays them out, and
    the grouped products read each kv head once, with no repeated copy.
    mask (b, 1 or n, s_q, s_k) True = forbidden. ``scores_manipulation`` is
    added to the scaled scores (``log_additive``) or multiplies them after
    each row is shifted so that its least unmasked score is 0, as in the
    JAX ``multi_head_attention``. ``dropout_fn`` is applied to the
    ``(b, n, s_q, s_k)`` probabilities. Returns (b, s_q, n, h)."""
    b, s_q, n, h = query.shape
    n_kv = key.shape[2]
    q = query.reshape(b, s_q, n_kv, n // n_kv, h)
    scores = torch.einsum("bqgrh,bkgh->bgrqk", q, key).reshape(b, n, s_q, -1) * scaling_factor
    if scores_manipulation is not None:
        m = scores_manipulation.to(scores.dtype)
        if log_additive:
            scores = scores + m
        else:
            filled = scores.masked_fill(mask, 10000.0)
            scores = (scores - filled.amin(dim=-1, keepdim=True)) * m
    probs = softmax(scores, mask)
    if dropout_fn is not None:
        probs = dropout_fn(probs)
    probs = probs.reshape(b, n_kv, n // n_kv, s_q, -1)
    out = torch.einsum("bgrqk,bkgh->bqgrh", probs.to(value.dtype), value)
    return out.reshape(b, s_q, n, h)


class ParallelSelfAttention(torch.nn.Module):
    """Projections -> key/query norm -> rotary -> attention -> output
    projection. With a paged KV view: kernel K1 over the pool; with a dense
    cache tuple: unfused attention over its slots; without a cache: flash
    (K4/K5) or unfused attention over the sequence."""

    def __init__(self, hidden_size: int, num_attention_heads: int,
                 num_kv_heads: Optional[int] = None, qkv_in_one: bool = False,
                 bias: bool = True, rotary: Optional[torch.nn.Module] = None,
                 scaling_factor: Optional[float] = None,
                 masked_softmax_config: Optional[MaskedSoftmaxConfig] = None,
                 causal: bool = True, num_local_attention_heads: int = 0,
                 local_attention_window_size: Optional[int] = None,
                 dropout_attention_probs: float = 0.0, key_query_norm: bool = False,
                 norm_type: str = "layernorm", norm_eps: float = 1e-5,
                 fused_norm: bool = False,
                 dtype: torch.dtype = torch.float32, device=None,
                 bitfit_bias_name: Optional[str] = None,
                 lora_config: Optional[LoRaConfig] = None, site: str = "attention",
                 shard: ModelShard = ModelShard(), context: ContextShard = ContextShard()):
        super().__init__()
        if hidden_size % num_attention_heads:
            raise ValueError("hidden_size must divide over num_attention_heads")
        self.hidden_size = hidden_size
        self.num_attention_heads = num_attention_heads
        self.head_dim = hidden_size // num_attention_heads
        self.num_kv_heads = num_kv_heads or num_attention_heads
        if num_attention_heads % self.num_kv_heads:
            raise ValueError("num_attention_heads must divide over the kv heads")
        self.num_repeat_kv = num_attention_heads // self.num_kv_heads
        if qkv_in_one and self.num_repeat_kv != 1:
            raise ValueError("a fused qkv weight cannot hold differing kv heads")
        self.qkv_in_one = qkv_in_one
        self.scaling_factor = (
            scaling_factor if scaling_factor is not None
            else 1.0 / math.sqrt(self.head_dim)
        )
        self.shard = shard
        if shard.size > 1:
            for name, value in (("num_local_attention_heads", num_local_attention_heads),
                                ("lora_config", lora_config)):
                if value:
                    raise NotImplementedError(f"{name} under model_parallel_size "
                                              f"{shard.size} is not ported")
        self.context = context
        if context.size > 1:
            for name, value in (("num_local_attention_heads (local-window heads)",
                                 num_local_attention_heads),
                                ("dropout_attention_probs (attention-probability dropout)",
                                 dropout_attention_probs)):
                if value:
                    raise NotImplementedError(f"{name} under context_parallel_size "
                                              f"{context.size} is unsupported, as in JAX")
        # this rank's heads; kv_shared: the repeat of the gathered kv heads
        # when they do not split over the group; context_kv_rep: the repeat
        # of the local kv heads that Ulysses's split over the context group
        # needs (JAX's rule over div = mp x cp; mp alone for the ring)
        self.local_heads = shard.split(num_attention_heads, "num_attention_heads")
        div = shard.size * (context.size if context.variant == "ulysses" else 1)
        rep = 1
        if self.num_kv_heads % div:
            rep = div // math.gcd(self.num_kv_heads, div)
            if self.num_repeat_kv % rep:
                rep = self.num_repeat_kv  # the full repeat
        self.kv_shared: Optional[int] = rep if self.num_kv_heads % shard.size else None
        self.context_kv_rep = 1 if self.kv_shared is not None else rep
        self.local_kv_heads = self.num_kv_heads * (self.kv_shared or 1) // shard.size
        common = dict(bias=bias, dtype=dtype, device=device, bitfit_bias_name=bitfit_bias_name,
                      shard=shard)
        if qkv_in_one:
            self.query_key_value = ColumnParallelLinear(hidden_size, 3 * hidden_size,
                                                        copy_input=False, **common)
        else:
            kv_size = self.num_kv_heads * self.head_dim
            self.query = ColumnParallelLinear(hidden_size, hidden_size, copy_input=False,
                                              **common)
            self.key = ColumnParallelLinear(hidden_size, kv_size, copy_input=False, **common)
            self.value = ColumnParallelLinear(hidden_size, kv_size, copy_input=False, **common)
        self.dense = RowParallelLinear(hidden_size, hidden_size, **common)
        self.rotary_embedding = rotary
        self.key_query_norm = key_query_norm
        if key_query_norm:
            norm = dict(eps=norm_eps, fused=fused_norm, dtype=dtype, device=device,
                        bitfit_bias_name=bitfit_bias_name)
            self.norm_query = get_norm(norm_type, self.head_dim, **norm)
            self.norm_key = get_norm(norm_type, self.head_dim, **norm)
        self.masked_softmax = MaskedSoftmax(masked_softmax_config or MaskedSoftmaxConfig())
        self.use_flash = self.masked_softmax.config.kernel == "flash_attention"
        self.causal = causal
        if num_local_attention_heads > 0 and local_attention_window_size is None:
            raise ValueError("local_attention_window_size needs to be set with "
                             "num_local_attention_heads")
        self.num_local_attention_heads = num_local_attention_heads
        self.local_attention_window_size = local_attention_window_size
        self.dropout_attention_probs = dropout_attention_probs
        self.site = site
        self.lora_config = lora_config
        self.lora_modules: Dict[LoRAModuleType, str] = {}  # module type -> child name
        for module_type in (lora_config.parallel_modules if lora_config else ()):
            name = f"{module_type.value}_{lora_config.name}"
            out_features = (hidden_size if module_type in (LoRAModuleType.DENSE,
                                                           LoRAModuleType.QUERY)
                            else self.num_kv_heads * self.head_dim)
            self.add_module(name, ParallelLoRa(
                hidden_size, out_features, lora_config.rank, module_type,
                alpha=lora_config.alpha, dropout=lora_config.dropout, bias=lora_config.bias,
                kaiming_a=lora_config.kaiming_a, dtype=dtype, device=device,
                site=f"{site}.{name}"))
            self.lora_modules[module_type] = name

    def _lora(self, module_type: LoRAModuleType) -> Optional[ParallelLoRa]:
        name = self.lora_modules.get(module_type)
        return None if name is None else getattr(self, name)

    def _shared_kv(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the gathered, repeated kv heads."""
        b, s = t.shape[:2]
        t = gather_shared_from_model_region(t, self.shard.group).reshape(
            b, s, self.num_kv_heads, self.head_dim)
        t = repeat_kv(t, self.kv_shared)
        return t[:, :, self.shard.rows(t.shape[2])]

    def _norm(self, norm: torch.nn.Module, t: torch.Tensor) -> torch.Tensor:
        """The key or query ``norm`` of ``t``. Over a model group each rank
        normalises its own heads, so the norm's parameters enter the model
        region: their gradients are summed over the group."""
        if self.shard.size == 1:
            return norm(t)
        return torch.func.functional_call(norm, {
            name: copy_to_model_region(p, self.shard.group)
            for name, p in norm.named_parameters()}, (t,))

    def _qkv(self, x: torch.Tensor, ctx: Optional[DropoutContext] = None):
        b, s, _ = x.shape
        x = copy_to_model_region(x, self.shard.group)
        if self.qkv_in_one:
            qkv = self.query_key_value(x).reshape(
                b, s, self.local_heads, 3 * self.head_dim
            )
            q, k, v = qkv.split(self.head_dim, dim=-1)
        else:
            q = self.query(x).reshape(b, s, self.local_heads, self.head_dim)
            if self.kv_shared is not None:
                k, v = self._shared_kv(self.key(x)), self._shared_kv(self.value(x))
            else:
                k = self.key(x).reshape(b, s, self.local_kv_heads, self.head_dim)
                v = self.value(x).reshape(b, s, self.local_kv_heads, self.head_dim)
        if self.lora_modules:  # in the JAX order: query, key, value
            out = []
            for t, module_type in ((q, LoRAModuleType.QUERY), (k, LoRAModuleType.KEY),
                                   (v, LoRAModuleType.VALUE)):
                lora = self._lora(module_type)
                out.append(t if lora is None else t + lora(x, ctx).reshape(t.shape))
            q, k, v = out
        return q, k, v

    def forward(self, x: torch.Tensor, position_ids: torch.Tensor,
                kv_cache=None, segment_ids: Optional[torch.Tensor] = None,
                cache_offset: Optional[int] = None,
                scores_manipulation: Optional[torch.Tensor] = None,
                return_kv: bool = False, ctx: Optional[DropoutContext] = None,
                scores_log_additive: bool = True):
        """``kv_cache``: a ``PagedKVCacheView``, a dense cache tuple written
        at ``cache_offset``, or None. ``ctx``: the training pass's dropout
        context, None for a deterministic pass. ``scores_manipulation`` is
        log-additive or, with ``scores_log_additive=False``, multiplicative.
        Returns the output, or ``(output, (k, v))`` with ``return_kv`` (the
        new tokens' K/V after rotary)."""
        sliced = isinstance(kv_cache, TokenSliceCache)
        if self.shard.size > 1 and ((kv_cache is not None and not sliced)
                                    or scores_manipulation is not None):
            raise NotImplementedError(
                f"{'a KV cache' if kv_cache is not None else 'a score manipulation (AtMan)'} "
                f"under model_parallel_size {self.shard.size} is not ported")
        if self.context.size > 1 and (kv_cache is not None or scores_manipulation is not None):
            raise NotImplementedError(
                f"{'a KV cache' if kv_cache is not None else 'a score manipulation (AtMan)'} "
                f"under context_parallel_size {self.context.size} is unsupported, as in JAX")
        q, k, v = self._qkv(x, ctx)
        if self.key_query_norm:
            q, k = self._norm(self.norm_query, q), self._norm(self.norm_key, k)
        if self.rotary_embedding is not None:
            q, k = self.rotary_embedding(q, k, position_ids)
        if kv_cache is not None and not self.causal:
            raise NotImplementedError("the cached decode paths are causal")
        if isinstance(kv_cache, PagedKVCacheView):
            if scores_manipulation is not None:
                raise NotImplementedError(
                    "attention_scores_manipulation is unsupported on the paged decode path")
            if self.num_local_attention_heads:
                raise NotImplementedError(
                    "local-window heads are unsupported on the paged decode path")
            out = self._paged_attention(q, k, v, kv_cache)
        elif sliced:
            out = self._slice_cache_attention(q, k, v, kv_cache, segment_ids,
                                              scores_manipulation, ctx)
        elif kv_cache is not None:
            out = self._dense_cache_attention(q, k, v, kv_cache, cache_offset, segment_ids,
                                              scores_manipulation, scores_log_additive)
        else:
            out = self._attention(q, k, v, segment_ids, scores_manipulation, ctx,
                                  scores_log_additive)
        out = self._project_out(out, ctx)
        return (out, (k, v)) if return_kv else out

    def _attention(self, q, k, v, segment_ids: Optional[torch.Tensor],
                   scores_manipulation: Optional[torch.Tensor] = None,
                   ctx: Optional[DropoutContext] = None,
                   log_additive: bool = True) -> torch.Tensor:
        """No cache: the training forward (``ParallelSelfAttention.__call__``
        of the JAX layer without context parallelism)."""
        b, s = q.shape[:2]
        if segment_ids is None:
            segment_ids = torch.zeros(b, s, dtype=torch.int32, device=q.device)
        n_local = self.num_local_attention_heads
        if self.context.size > 1:
            return self._context_attention(q, k, v, segment_ids)
        if flash_path_active(
            kernel_is_flash=self.use_flash, causal=self.causal,
            dropout_attention_probs=self.dropout_attention_probs,
            deterministic=ctx is None, context_parallel_size=1,
            seq_len=s, head_dim=self.head_dim, dtype=q.dtype,
            has_scores_manipulation=scores_manipulation is not None,
        ):
            return flash_attention(q, k, v, segment_ids, sm_scale=self.scaling_factor,
                                   num_local_heads=n_local,
                                   local_window=self.local_attention_window_size)
        mask = segment_ids_to_mask(segment_ids, causal=self.causal)

        def probs_dropout(site: str):
            if ctx is None or self.dropout_attention_probs == 0.0:
                return None
            return lambda p: dropout(p, self.dropout_attention_probs, ctx, site,
                                     head_shard=(1, self.shard.rank, self.shard.size))

        probs_site = f"{self.site}.attention_probs"
        if n_local == 0:
            return multi_head_attention(q, k, v, mask, self.scaling_factor,
                                        self.masked_softmax, scores_manipulation,
                                        probs_dropout(probs_site), log_additive)
        # mixed heads: the first n - n_local global, the last n_local in the window
        k = repeat_kv(k, self.num_repeat_kv)
        v = repeat_kv(v, self.num_repeat_kv)
        local_mask = segment_ids_to_mask(segment_ids, causal=self.causal,
                                         local_window=self.local_attention_window_size)
        n_global = self.num_attention_heads - n_local
        out_l = multi_head_attention(q[:, :, n_global:], k[:, :, n_global:],
                                     v[:, :, n_global:], local_mask,
                                     self.scaling_factor, self.masked_softmax,
                                     scores_manipulation, probs_dropout(probs_site + "_local"),
                                     log_additive)
        if n_global == 0:
            return out_l
        out_g = multi_head_attention(q[:, :, :n_global], k[:, :, :n_global],
                                     v[:, :, :n_global], mask, self.scaling_factor,
                                     self.masked_softmax, scores_manipulation,
                                     probs_dropout(probs_site), log_additive)
        return torch.cat([out_g, out_l], dim=2)

    def _context_attention(self, q, k, v, segment_ids: torch.Tensor) -> torch.Tensor:
        """This rank's sequence slice across the context group: ring or
        Ulysses attention (the CP dispatch of the JAX layer), K/V repeated
        as far as the split over the groups needs."""
        from ..ops.ring_attention import ring_attention
        from ..ops.ulysses_attention import ulysses_attention

        k, v = repeat_kv(k, self.context_kv_rep), repeat_kv(v, self.context_kv_rep)
        attend = ulysses_attention if self.context.variant == "ulysses" else ring_attention
        return attend(q, k, v, segment_ids, self.context, causal=self.causal,
                      sm_scale=self.scaling_factor)

    def _slice_cache_attention(self, q, k, v, cache: TokenSliceCache,
                               segment_ids: Optional[torch.Tensor],
                               scores_manipulation: Optional[torch.Tensor],
                               ctx: Optional[DropoutContext]) -> torch.Tensor:
        """A token slice over the earlier slices' K/V and its own: query
        ``i`` of the slice (slot ``offset + i``) attends to slots at or
        before its own within its segment, as the whole sequence's causal
        mask has it. Probability dropout draws the whole sequence's mask and
        keeps the slice's rows and its prefix of keys."""
        if scores_manipulation is not None or self.num_local_attention_heads:
            raise NotImplementedError(
                "a score manipulation or local-window heads under pipe_token_slices is "
                "unsupported (training with token slices attends globally)")
        b, s = q.shape[:2]
        seg_q = (torch.zeros(b, s, dtype=torch.int32, device=q.device)
                 if segment_ids is None else segment_ids)
        keys = torch.cat([*cache.keys, k], dim=1)
        values = torch.cat([*cache.values, v], dim=1)
        segs = torch.cat([*cache.segments, seg_q], dim=1)
        end = keys.shape[1]
        slots_q = (end - s) + torch.arange(s, device=q.device)
        allowed = (torch.arange(end, device=q.device)[None, :] <= slots_q[:, None])[None] & (
            segs[:, None, :] == seg_q[:, :, None])
        dropout_fn = None
        if ctx is not None and self.dropout_attention_probs > 0.0:
            def dropout_fn(p):
                return dropout(p, self.dropout_attention_probs, ctx,
                               f"{self.site}.attention_probs",
                               head_shard=(1, self.shard.rank, self.shard.size), seq_dim=2,
                               key_dim=3)
        return multi_head_attention(q, keys, values, ~allowed[:, None], self.scaling_factor,
                                    self.masked_softmax, dropout_fn=dropout_fn)

    def _dense_cache_attention(self, q, k, v, cache, offset: int,
                               segment_ids: Optional[torch.Tensor],
                               scores_manipulation: Optional[torch.Tensor],
                               log_additive: bool = True) -> torch.Tensor:
        """Write the ``s`` new tokens at slots ``offset..``, then attend
        over the written slots ``0 .. offset + s - 1`` alone, each query at
        or before its own slot (and, with a 3-tuple cache, in its segment).
        The last ``num_local_attention_heads`` heads also keep to ``slot_q -
        slot_k <= local_attention_window_size``: the window of the uncached
        forward and of K4/K5, counted in slots. ``scores_manipulation`` spans
        the whole cache and is cut to them."""
        b, s = q.shape[:2]
        dense_kv_write(cache, k, v, offset, segment_ids)
        end = offset + s
        slots_k = torch.arange(end, device=q.device)
        slots_q = offset + torch.arange(s, device=q.device)
        rel = slots_q[:, None] - slots_k[None, :]  # (s, end)
        allowed = (rel >= 0)[None]  # (1, s, end)
        if len(cache) == 3:
            seg_q = (torch.zeros(b, s, dtype=cache[2].dtype, device=q.device)
                     if segment_ids is None else segment_ids)
            allowed = allowed & (cache[2][:, None, :end] == seg_q[:, :, None])
        mask = ~allowed[:, None]  # (b or 1, 1, s, end)
        n_local = self.num_local_attention_heads
        if n_local:
            is_local = torch.arange(self.num_attention_heads, device=q.device) >= (
                self.num_attention_heads - n_local)
            outside = rel > self.local_attention_window_size
            mask = mask | (is_local[:, None, None] & outside[None])[None]  # (., n, s, end)
        if scores_manipulation is not None:
            scores_manipulation = scores_manipulation[..., :end]
        return multi_head_attention(q, cache[0][:, :end], cache[1][:, :end], mask,
                                    self.scaling_factor, self.masked_softmax,
                                    scores_manipulation, log_additive=log_additive)

    def _paged_attention(self, q, k, v, view: PagedKVCacheView) -> torch.Tensor:
        """Scatter the ``s`` new tokens per row into the pool (padding past
        ``new_len`` into the trash block), then attend each row over its
        blocks with kernel K1."""
        b, s = q.shape[:2]
        block_size = view.pool_k.shape[1]
        ctx_len = view.context_len.int()
        if view.new_len is None:
            new_len = torch.full((b,), s, dtype=torch.int32, device=q.device)
        else:
            new_len = view.new_len.int()
        steps = torch.arange(s, dtype=torch.int32, device=q.device)[None, :]
        positions = ctx_len[:, None] + steps
        flat = paged_flat_slots(view.block_table, positions, block_size)
        flat = torch.where(steps < new_len[:, None], flat, 0)
        paged_scatter_kv(view, flat.reshape(-1),
                         k.reshape(b * s, *k.shape[2:]), v.reshape(b * s, *v.shape[2:]))
        return paged_attention(
            q.contiguous(), view.pool_k, view.pool_v,
            view.block_table.int().contiguous(), (ctx_len + new_len).contiguous(),
            ctx_len.contiguous(),
            sm_scale=self.scaling_factor, num_repeat_kv=self.num_repeat_kv,
            scale_k=view.scale_k, scale_v=view.scale_v,
        )

    def _project_out(self, out: torch.Tensor,
                     ctx: Optional[DropoutContext] = None) -> torch.Tensor:
        b, s = out.shape[:2]
        out = out.reshape(b, s, self.local_heads * self.head_dim)
        y = self.dense(out)
        lora = self._lora(LoRAModuleType.DENSE)
        return y if lora is None else y + lora(out, ctx)

    @torch.no_grad()
    def merge_lora_weights(self) -> None:
        """Fold each LoRA delta into its host weight and zero the LoRA's
        ``B`` (and bias), in place, as the JAX layer's ``merge_lora_weights``
        does functionally: the LoRA path then adds exactly nothing. A LoRA
        bias folds into the host's bias; a host without a ``bias``
        parameter raises ValueError, and the fused ``query_key_value``
        layout NotImplementedError, before anything is changed."""
        for module_type in self.lora_modules:
            lora = self._lora(module_type)
            if lora.bias is None:
                continue
            if self.qkv_in_one and module_type != LoRAModuleType.DENSE:
                raise NotImplementedError(
                    "LoRA bias merge is unsupported for the fused query_key_value layout; "
                    "set attention_qkv_in_one false or lora bias=False")
            host = self.dense if module_type == LoRAModuleType.DENSE else getattr(
                self, module_type.value)
            if host.bias is None:
                raise ValueError(
                    f"cannot merge LoRA bias on {module_type.value}: the host projection has "
                    "no bias parameter to absorb it (set lora bias=False or keep the LoRA "
                    "unmerged)")
        for module_type in self.lora_modules:
            lora = self._lora(module_type)
            delta = lora.get_delta_weights()
            if module_type != LoRAModuleType.DENSE and self.qkv_in_one:
                w = self.query_key_value.weight.view(self.num_attention_heads, 3,
                                                     self.head_dim, self.hidden_size)
                idx = ("query", "key", "value").index(module_type.value)
                w[:, idx] += delta.view(self.num_attention_heads, self.head_dim,
                                        self.hidden_size).to(w.dtype)
            else:
                host = self.dense if module_type == LoRAModuleType.DENSE else getattr(
                    self, module_type.value)
                host.weight += delta.to(host.weight.dtype)
                if lora.bias is not None:
                    host.bias += lora.bias.to(host.bias.dtype)
            lora.lora_b.zero_()
            if lora.bias is not None:
                lora.bias.zero_()
