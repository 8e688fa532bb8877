"""Inference (counterpart of scaling_tpu/models/transformer/inference.py):
full-sequence ``logits`` and ``hidden_states``, ``generate`` over a dense
KV cache, and the paged pass of the serving engine (``_run_layers`` over
``PagedKVCacheView``s, ``_make_batch`` and the per-row sampler
``sample_rows``).

``generate`` takes a ``(b, s)`` batch, one 1-D prompt, or ragged lists of
token ids (or text, with a tokenizer). Ragged prompts are left-padded:
the pads sit in their own segment during the prefill, the decode masks
their cache slots with an additive -1e9, and each row's rotary positions
start at its first content token while the cache slots keep the causal
clock, so a row generates what it would alone. The prefill
(``prefill_forward``) consumes no cache, so the flash kernel K4 runs there
wherever its gate allows (bf16, ``prompt_len % 128 == 0``), and only the
sampled position reaches the final norm and the vocabulary projection.
The decode attends unfused over the written slots of the dense cache,
as the JAX package leaves it to XLA. It runs one loop whatever
``fused_decode`` says: tokens and per-step logits go into preallocated
buffers on the device, and the host checks whether every row has stopped
every ``DONE_CHECK_EVERY`` steps (``fused_decode=True``, the counterpart
of the JAX package's on-device loop) or every step (``False``, its
per-step dispatch). Both give the same tokens. ``use_cache=False``
refeeds the whole padded buffer every step.

Sampling: greedy rows take the argmax, exactly as the JAX package does.
Rows with temperature > 0 draw with Gumbel-max noise from a counter-based
hash (``request_uniforms``): in the serving engine of ``(sample_seed,
req_id, position)``, so a preempted and resumed sequence draws the same
tokens; in ``generate`` (``make_sampler``) of ``(seed, row, step)``. The
draws are the same on the CPU and on the card, and they are not JAX's
threefry draws.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import yaml

from ... import resolve_device
from ...checkpoint import load_model_checkpoint
from ...parallel.parallel_module import jax_param_key
from .config import TransformerArchitectureConfig, strip_removed_config_keys
from .layers import TransformerLayer
from .model import TransformerModel
from .tokenizer import Tokenizer

_MASK32 = 0xFFFFFFFF
DONE_CHECK_EVERY = 8  # fused decode: steps between checks whether every row stopped
PAD_SCORE = -1e9  # additive score of a left-pad cache slot


class CompletionOutput(NamedTuple):
    completion_ids: List[int]
    completion: Optional[str]
    logits: Optional[torch.Tensor] = None  # (tokens, vocab): each emitted token's logits


def sample_argmax(logits: torch.Tensor, key: Any = None) -> torch.Tensor:
    """Greedy sampling."""
    return logits.argmax(dim=-1)


class _LeftPadLayout(NamedTuple):
    """Position/segment/mask views for a left-padded (ragged) batch; all
    None when the batch is rectangular."""

    pos_all: Optional[torch.Tensor] = None  # (b, prompt+gen) rotary positions
    seg_all: Optional[torch.Tensor] = None  # (b, prompt+gen) pad segment = 1
    prompt_pos: Optional[torch.Tensor] = None  # prompt-prefix slices of the above
    prompt_seg: Optional[torch.Tensor] = None
    content_len: Optional[torch.Tensor] = None  # (b,) per-row rotary clock base
    pad_mask: Optional[torch.Tensor] = None  # (b, 1, 1, prompt+gen) additive PAD_SCORE

    @property
    def ragged(self) -> bool:
        return self.pos_all is not None


def _left_pad_layout(pad_start: Optional[torch.Tensor], prompt_len: int, max_tokens: int,
                     use_cache: bool) -> _LeftPadLayout:
    """One left-padded layout over the full generation buffer: positions
    restart at each row's first content token and run straight into the
    generated slots; pads keep their own segment. Prefill slices the
    prompt prefix; the uncached path uses the full-buffer views directly;
    the decode paths blank the pad cache slots with the additive mask."""
    if pad_start is None:
        return _LeftPadLayout()
    slots_all = torch.arange(prompt_len + max_tokens, device=pad_start.device)[None]
    ps = pad_start[:, None]
    pos_all = (slots_all - ps).clamp_min(0).int()
    seg_all = (slots_all < ps).int()
    pad_mask = None
    if use_cache:
        pad_mask = torch.where(slots_all < ps, PAD_SCORE, 0.0)[:, None, None, :]
    return _LeftPadLayout(pos_all=pos_all, seg_all=seg_all, prompt_pos=pos_all[:, :prompt_len],
                          prompt_seg=seg_all[:, :prompt_len],
                          content_len=prompt_len - pad_start, pad_mask=pad_mask)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (two multiply-xorshift rounds) on int64
    tensors holding values in [0, 2**32); exact on every device."""
    x = x & _MASK32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _MASK32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _MASK32
    return x ^ (x >> 16)


def request_uniforms(sample_seed: int, req_ids: torch.Tensor,
                     positions: torch.Tensor, vocab: int) -> torch.Tensor:
    """(rows, vocab) uniforms in (0, 1), a pure function of
    (sample_seed, req_id, position, token index)."""
    dev = req_ids.device
    row_key = _mix32(_mix32(_mix32(torch.full_like(req_ids.long(), sample_seed))
                            ^ req_ids.long()) ^ positions.long())
    idx = torch.arange(vocab, dtype=torch.int64, device=dev)
    bits = _mix32(row_key[:, None] ^ _mix32(idx + 0x9E3779B9)[None, :])
    # 24 bits: exactly representable in f32, never 0 or 1
    return ((bits >> 8).float() + 0.5) / float(1 << 24)


def sample_rows(logits: torch.Tensor, temperatures: torch.Tensor,
                top_ks: torch.Tensor, uniforms: torch.Tensor,
                top_ps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row temperature / top-k / top-p sampling; ``temperature <= 0``
    is greedy. The masks follow the JAX ``sample_rows`` op for op
    (temperature clamp, sort-based top-k cutoff, nucleus cutoff over the
    descending sort after top-k); the draw is Gumbel-max over
    ``uniforms`` (rows, vocab)."""
    vocab = logits.shape[-1]
    greedy = logits.argmax(dim=-1)
    scaled = logits.float() / temperatures.float().clamp_min(1e-6)[:, None]
    sorted_scaled = scaled.sort(dim=-1).values
    k_active = (top_ks > 0) & (top_ks < vocab)
    k_idx = (vocab - top_ks.long()).clamp(0, vocab - 1)
    kth = sorted_scaled.gather(-1, k_idx[:, None])
    scaled = torch.where(k_active[:, None] & (scaled < kth), float("-inf"), scaled)
    if top_ps is not None:
        p_active = (top_ps > 0.0) & (top_ps < 1.0)
        sorted_desc = scaled.sort(dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        keep = (probs.cumsum(dim=-1) - probs) < top_ps.float()[:, None]
        kept = keep.sum(dim=-1, keepdim=True)
        cutoff = sorted_desc.gather(-1, (kept - 1).clamp_min(0))
        scaled = torch.where(p_active[:, None] & (scaled < cutoff),
                             float("-inf"), scaled)
    gumbel = -torch.log(-torch.log(uniforms))
    sampled = (scaled + gumbel).argmax(dim=-1)
    return torch.where(temperatures <= 0.0, greedy, sampled).int()


def make_sampler(temperature: float = 1.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None) -> Callable[[torch.Tensor, Any], torch.Tensor]:
    """Temperature / top-k / top-p (nucleus) sampling for ``generate``,
    with the masks of JAX ``make_sampler`` (``sample_rows`` applies them
    per row). ``sample(logits, key)`` draws with ``key = (seed, step)``:
    row ``i`` of step ``t`` from ``request_uniforms(seed, i, t)``."""

    def sample(logits: torch.Tensor, key: Tuple[int, int]) -> torch.Tensor:
        rows, vocab = logits.shape
        dev = logits.device
        seed, step = key
        full = lambda v, dtype: torch.full((rows,), v, dtype=dtype, device=dev)  # noqa: E731
        uniforms = request_uniforms(seed, torch.arange(rows, device=dev),
                                    full(step, torch.int64), vocab)
        return sample_rows(logits, full(max(temperature, 1e-6), torch.float32),
                           full(top_k or 0, torch.int64), uniforms,
                           None if top_p is None else full(top_p, torch.float32))

    return sample


class TransformerInferenceModule:
    """The model on one device: full-sequence logits, ``generate`` over a
    dense KV cache, and the serving engine's pass over block-paged pools."""

    def __init__(self, architecture: TransformerArchitectureConfig,
                 model: TransformerModel, tokenizer: Optional[Tokenizer] = None):
        self.architecture = architecture
        self.model = model.eval().requires_grad_(False)
        self.device = next(model.parameters()).device
        self.tokenizer = tokenizer

    @classmethod
    def random_init(cls, architecture: TransformerArchitectureConfig,
                    seed: int = 0, device=None) -> "TransformerInferenceModule":
        """Random weights from a seeded generator (nothing is downloaded)."""
        model = TransformerModel(architecture, device=resolve_device(device))
        return cls(architecture, model.init_random_(seed))

    @classmethod
    def from_state_dict(cls, architecture: TransformerArchitectureConfig,
                        state_dict: Dict[str, torch.Tensor],
                        device=None) -> "TransformerInferenceModule":
        model = TransformerModel(architecture, device=resolve_device(device))
        model.load_state_dict(state_dict)
        return cls(architecture, model)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: Union[Path, str], device=None,
                        vocab_file: Optional[Union[Path, str]] = None
                        ) -> "TransformerInferenceModule":
        """The model of a checkpoint of either package: ``latest`` is
        followed when ``checkpoint_dir`` holds one, the architecture comes
        from its ``config.yml`` and the weights from its layer npz files,
        cast to the architecture's dtype. A tokenizer is loaded from
        ``vocab_file`` or the checkpoint's ``vocab.json`` when there is one."""
        ckpt = Path(checkpoint_dir)
        if (ckpt / "latest").is_file():
            ckpt = ckpt / (ckpt / "latest").read_text().strip()
        config_file = ckpt / "config.yml"
        if not config_file.is_file():
            raise FileNotFoundError(f"no config.yml in {ckpt}")
        config = strip_removed_config_keys(yaml.safe_load(config_file.read_text()))
        architecture = TransformerArchitectureConfig.from_dict(config["transformer_architecture"])
        model = TransformerModel(architecture, device=resolve_device(device))
        load_model_checkpoint(ckpt, {jax_param_key(model, name): p
                                     for name, p in model.named_parameters()})
        vocab = Path(vocab_file) if vocab_file else ckpt / "vocab.json"
        tokenizer = Tokenizer.from_file(vocab) if vocab.is_file() else None
        return cls(architecture, model, tokenizer)

    def _make_batch(self, token_ids: torch.Tensor, position_ids: torch.Tensor,
                    segment_ids: Optional[torch.Tensor] = None,
                    scores_manipulation: Optional[torch.Tensor] = None
                    ) -> Dict[str, Optional[torch.Tensor]]:
        def on_device(t, dtype):
            return None if t is None else t.to(self.device, dtype)

        return {
            "token_ids": on_device(token_ids, torch.int64),
            "position_ids": on_device(position_ids, torch.int32),
            "segment_ids": on_device(segment_ids, torch.int32),
            "attention_scores_manipulation": scores_manipulation,
        }

    @torch.no_grad()
    def _run_layers(self, batch: Dict[str, Optional[torch.Tensor]], caches: Optional[list] = None,
                    offset: Optional[int] = None, gather_start: Optional[torch.Tensor] = None,
                    gather_width: Optional[int] = None) -> torch.Tensor:
        """One pass through the stack; returns logits. ``caches`` (one per
        transformer layer) are paged KV views or dense cache tuples written
        at ``offset``, both in place; None runs over the sequence alone.

        ``gather_start`` (rows,) with ``gather_width`` slices each row's
        window of trunk activations after the last transformer layer and
        before the final norm and head, which are position-wise: only the
        positions that will be sampled pay the vocab projection. The
        logits then cover positions ``gather_start .. + gather_width - 1``."""
        m = self.model
        layers = m.transformer_layers
        if caches is not None and len(caches) != len(layers):
            raise ValueError(
                f"{len(caches)} KV caches for {len(layers)} transformer layers"
            )
        pos, seg = batch["position_ids"], batch.get("segment_ids")
        manipulation = batch.get("attention_scores_manipulation")
        h = m.embedding(batch["token_ids"])
        for i, layer in enumerate(layers):
            h = layer(h, pos, None if caches is None else caches[i], seg, offset, manipulation)
        if gather_start is not None:
            idx = gather_start.long()[:, None] + torch.arange(
                gather_width, device=h.device
            )[None, :]
            h = h.gather(1, idx[:, :, None].expand(-1, -1, h.shape[-1]))
        return m.lm_head(m.final_norm(h))

    def _token_batch(self, token_ids) -> torch.Tensor:
        """``token_ids`` (a tensor, an array or lists) as int64 ``(b, s)`` on
        the model's device."""
        if isinstance(token_ids, torch.Tensor):
            t = token_ids.to(self.device, torch.int64)
        else:
            t = torch.from_numpy(np.asarray(token_ids, dtype=np.int64)).to(self.device)
        return t[None] if t.ndim == 1 else t

    def logits(self, token_ids) -> torch.Tensor:
        """Full-sequence logits ``(b, s, vocab)`` of one prompt or a batch
        (attention controls are not ported)."""
        tokens = self._token_batch(token_ids)
        b, s = tokens.shape
        pos = torch.arange(s, device=self.device)[None].expand(b, s)
        return self._run_layers(self._make_batch(tokens, pos))

    @torch.no_grad()
    def hidden_states(self, token_ids, include: Optional[List[int]] = None,
                      exclude: Optional[List[int]] = None) -> Dict[str, torch.Tensor]:
        """Each layer's output keyed ``layer_{i}_{Class}`` as in the JAX
        package, filtered by ``include`` / ``exclude`` layer indices."""
        tokens = self._token_batch(token_ids)
        b, s = tokens.shape
        pos = torch.arange(s, device=self.device, dtype=torch.int32)[None].expand(b, s)
        recorded = {}
        x = tokens
        for i, (name, layer) in enumerate(self.model.layers.items()):
            x = layer(x, pos) if isinstance(layer, TransformerLayer) else layer(x)
            if (include is None or i in include) and (exclude is None or i not in exclude):
                recorded[f"{name}_{type(layer).__name__}"] = x
        return recorded

    # ------------------------------------------------------------ generate
    @staticmethod
    def _alloc_caches(kvs, max_len: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Dense ``(b, max_len, n_kv, h)`` caches in k's dtype, seeded with
        the prompt's K/V."""
        caches = []
        for k, v in kvs:
            s = k.shape[1]
            ck = k.new_zeros((k.shape[0], max_len) + k.shape[2:])
            cv = v.new_zeros((v.shape[0], max_len) + v.shape[2:])
            ck[:, :s], cv[:, :s] = k, v
            caches.append((ck, cv))
        return caches

    @torch.no_grad()
    def prefill_forward(self, token_ids: torch.Tensor, position_ids: torch.Tensor,
                        segment_ids: Optional[torch.Tensor] = None):
        """The prompt pass: the stack with each layer's (k, v) returned (no
        cache consumed, so flash stays active), and logits ``(b, 1, vocab)``
        of the last position: only that position feeds the final norm and
        the head."""
        m = self.model
        batch = self._make_batch(token_ids, position_ids, segment_ids)
        pos, seg = batch["position_ids"], batch["segment_ids"]
        h = m.embedding(batch["token_ids"])
        kvs = []
        for layer in m.transformer_layers:
            h, kv = layer(h, pos, None, seg, return_kv=True)
            kvs.append(kv)
        return m.lm_head(m.final_norm(h[:, -1:])), kvs

    def _prefill(self, token_ids: torch.Tensor, max_len: int,
                 position_ids: Optional[torch.Tensor] = None,
                 segment_ids: Optional[torch.Tensor] = None):
        """Prompt pass, then fixed-size caches seeded with its K/V."""
        b, s = token_ids.shape
        pos = (torch.arange(s, device=self.device)[None].expand(b, s)
               if position_ids is None else position_ids)
        logits, kvs = self.prefill_forward(token_ids, pos, segment_ids)
        return logits, self._alloc_caches(kvs, max_len)

    def _decode_step(self, caches, tok: torch.Tensor, offset: int,
                     position_ids: torch.Tensor,
                     pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """One token a row at cache slot ``offset``: its logits ``(b, vocab)``."""
        batch = self._make_batch(tok[:, None], position_ids, scores_manipulation=pad_mask)
        return self._run_layers(batch, caches, offset)[:, -1]

    def generate(self, input_ids, max_tokens: int = 32, sample_fn: Optional[Callable] = None,
                 use_cache: bool = True, eos_token_id: Optional[int] = None,
                 stop_tokens: Optional[List[int]] = None, seed: int = 0,
                 fused_decode: bool = True):
        """Autoregressive decode. Stops a row at ``eos_token_id`` or any of
        ``stop_tokens`` (the stop token is emitted); each emitted token's
        logits come back in ``CompletionOutput.logits``. A batch (a ``(b,
        s)`` tensor or array, or b token lists, ragged ones included)
        returns a list of ``CompletionOutput``; 1-D input one output.
        ``sample_fn(logits, (seed, step))`` picks the tokens (greedy by
        default; see ``make_sampler``)."""
        if isinstance(input_ids, str) or (isinstance(input_ids, (list, tuple)) and input_ids
                                          and isinstance(input_ids[0], str)):
            if self.tokenizer is None:
                raise ValueError("text prompts need a tokenizer")
            input_ids = (self.tokenizer.encode(input_ids) if isinstance(input_ids, str)
                         else [self.tokenizer.encode(t) for t in input_ids])
        pad_start = None
        if (isinstance(input_ids, (list, tuple)) and input_ids
                and isinstance(input_ids[0], (list, tuple))
                and len({len(r) for r in input_ids}) > 1):
            lens = [len(r) for r in input_ids]
            longest = max(lens)
            pad_start = torch.tensor([longest - n for n in lens], device=self.device)
            input_ids = [[0] * (longest - n) + list(r) for r, n in zip(input_ids, lens)]
        single = (input_ids.ndim if isinstance(input_ids, torch.Tensor)
                  else np.ndim(input_ids)) == 1
        prompt = self._token_batch(input_ids)
        b, prompt_len = prompt.shape
        lay = _left_pad_layout(pad_start, prompt_len, max_tokens, use_cache)
        if eos_token_id is None and self.tokenizer is not None:
            eos_token_id = self.tokenizer.eos_token_id
        stop = set(stop_tokens or [])
        if eos_token_id is not None:
            stop.add(int(eos_token_id))
        sample = sample_fn or sample_argmax
        if use_cache:
            toks, lgts = self._decode(prompt, lay, max_tokens, sample, stop, seed,
                                      DONE_CHECK_EVERY if fused_decode else 1)
        else:
            toks, lgts = self._decode_uncached(prompt, lay, max_tokens, sample, stop, seed)
        outs = []
        for i in range(b):
            end = len(toks[i])
            for j, t in enumerate(toks[i]):
                if t in stop:
                    end = j + 1  # the stop token itself is emitted
                    break
            ids = toks[i][:end]
            outs.append(CompletionOutput(
                completion_ids=ids,
                completion=self.tokenizer.decode(ids) if self.tokenizer else None,
                logits=lgts[i, :end] if end else None))
        return outs[0] if single else outs

    def _positions(self, lay: _LeftPadLayout, b: int, offset: int, t: int) -> torch.Tensor:
        """Rotary positions of decode step ``t`` (cache slot ``offset``)."""
        if lay.ragged:
            return (lay.content_len + (t - 1))[:, None]
        return torch.full((b, 1), offset, dtype=torch.int32, device=self.device)

    @torch.no_grad()
    def _decode(self, prompt, lay: _LeftPadLayout, max_tokens: int, sample, stop: set,
                seed: int, check_every: int):
        """Prefill, then every decode step on the device into preallocated
        token and logit buffers; one transfer of the tokens at the end. The
        host learns every ``check_every`` steps whether every row stopped."""
        b, prompt_len = prompt.shape
        logits, caches = self._prefill(prompt, prompt_len + max_tokens, lay.prompt_pos,
                                       lay.prompt_seg)
        steps = max(0, max_tokens - 1)
        stop_ids = torch.tensor(sorted(stop), dtype=torch.int64, device=self.device)
        tok = sample(logits[:, -1], (seed, 0)).long()
        toks = torch.zeros((b, steps + 1), dtype=torch.int64, device=self.device)
        lgts = logits.new_zeros((b, steps + 1, logits.shape[-1]))
        toks[:, 0], lgts[:, 0] = tok, logits[:, -1]
        done = torch.isin(tok, stop_ids)
        for t in range(1, steps + 1):
            if t % check_every == 0 and bool(done.all()):
                break  # rows past their stop token are trimmed on the host
            offset = prompt_len + t - 1
            step_logits = self._decode_step(caches, tok, offset,
                                            self._positions(lay, b, offset, t), lay.pad_mask)
            tok = sample(step_logits, (seed, t)).long()
            toks[:, t], lgts[:, t] = tok, step_logits
            done |= torch.isin(tok, stop_ids)
        return toks.cpu().tolist(), lgts

    @torch.no_grad()
    def _decode_uncached(self, prompt, lay: _LeftPadLayout, max_tokens: int, sample,
                         stop: set, seed: int):
        """No cache: the whole padded buffer is refed every step, and each
        step's tokens are fetched to the host."""
        b, prompt_len = prompt.shape
        max_len = prompt_len + max_tokens
        row_tokens: List[List[int]] = [[] for _ in range(b)]
        step_logits: List[torch.Tensor] = []
        finished = [False] * b
        buf = torch.zeros((b, max_len), dtype=torch.int64, device=self.device)
        buf[:, :prompt_len] = prompt
        if lay.ragged:
            pos, seg = lay.pos_all, lay.seg_all
        else:
            pos, seg = torch.arange(max_len, device=self.device)[None].expand(b, -1), None
        for t in range(max_tokens):
            if all(finished):
                break
            cur = prompt_len + t
            start = torch.full((b,), cur - 1, device=self.device)
            logits = self._run_layers(self._make_batch(buf, pos, seg),
                                      gather_start=start, gather_width=1)[:, 0]
            tok = sample(logits, (seed, t)).long()
            step_logits.append(logits)
            for i, tk in enumerate(tok.cpu().tolist()):  # one transfer a step
                if not finished[i]:
                    row_tokens[i].append(tk)
                    finished[i] = tk in stop
            buf[:, cur] = tok
        lgts = torch.stack(step_logits, dim=1) if step_logits else None
        return row_tokens, lgts
