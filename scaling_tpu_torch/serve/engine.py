"""The serving engine: one fused mixed step per tick (counterpart of
scaling_tpu/serve/engine.py, chunked fused mode).

Per tick the scheduler mixes prompt prefill CHUNKS with decode rows for
every running sequence, and the engine runs them all as ONE
Sarathi-style mixed forward: every slot row is either a prefill chunk
(``new_len`` real tokens of the prompt) or a decode row (its last
token), tagged only by per-row lengths. Attention goes through the
paged pool with kernel K1; the norms through kernel K2 when the model
asks for the fused norm. Shared-prefix blocks come from the scheduler's
prefix trie; copy-on-write forks it orders are applied before the
forward.

Only the final norm and the head run on the positions that are sampled
(one per row: a decode row's token, a finishing chunk's last real
token). Sampling is per request (``inference.sample_rows``); greedy is
the default.

What the JAX engine also offers and this one does not yet —
whole-prompt prefill, separate decode and chunk programs
(``fused_tick=False``), speculative decoding, deadlines, overload
shedding, the request journal, graceful drain, fleet labels and obs
spans — raises NotImplementedError when asked for.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models.transformer.inference import (
    TransformerInferenceModule,
    request_uniforms,
    sample_rows,
)
from .kvcache import PagedKVPools, init_pools
from .scheduler import (
    ContinuousBatchingScheduler,
    Request,
    SchedulerConfig,
    Sequence,
    Tick,
)


@dataclasses.dataclass
class EngineConfig:
    num_slots: int = 8
    block_size: int = 16
    num_blocks: int = 128
    max_blocks_per_seq: int = 16
    token_budget: int = 512
    kv_dtype: str = "native"  # 'native' | 'int8'
    # Sarathi-style chunked prefill: tokens per chunk
    prefill_chunk: Optional[int] = 32
    # ONE fused mixed forward per tick (the only mode ported)
    fused_tick: bool = True
    enable_prefix_cache: bool = True
    spec_k: int = 0
    sample_seed: int = 0
    # not ported yet: any value but the default raises
    default_deadline_ms: Optional[float] = None
    default_ttft_deadline_ms: Optional[float] = None
    shed_high_watermark: Optional[float] = None
    shed_low_watermark: Optional[float] = None
    max_waiting: Optional[int] = None
    replica_id: Optional[int] = None

    def __post_init__(self):
        if self.prefill_chunk is None:
            raise NotImplementedError("whole-prompt prefill is not ported yet")
        if not self.fused_tick:
            raise NotImplementedError(
                "separate decode and chunk programs are not ported yet"
            )
        if self.spec_k:
            raise NotImplementedError("speculative decoding is not ported yet")
        for name in ("default_deadline_ms", "default_ttft_deadline_ms",
                     "shed_high_watermark", "shed_low_watermark", "max_waiting",
                     "replica_id"):
            if getattr(self, name) is not None:
                raise NotImplementedError(f"{name} is not ported yet")

    @property
    def mixed_width(self) -> int:
        """Token width of every row of the mixed forward."""
        return self.prefill_chunk

    @property
    def sample_width(self) -> int:
        """Positions per row that are sampled (no speculation: one)."""
        return 1

    def scheduler_config(self) -> SchedulerConfig:
        return SchedulerConfig(
            num_slots=self.num_slots, block_size=self.block_size,
            num_blocks=self.num_blocks,
            max_blocks_per_seq=self.max_blocks_per_seq,
            token_budget=self.token_budget,
            prefill_chunk=self.prefill_chunk,
            prefix_cache=self.enable_prefix_cache,
        )


@dataclasses.dataclass
class MixedInputs:
    """Host-side operands of one mixed forward, one row per slot."""

    tokens: np.ndarray    # (slots, width) int32
    ctx: np.ndarray       # (slots,) int32 tokens already cached
    new_lens: np.ndarray  # (slots,) int32 real tokens this tick (0 = idle row)
    gen0: np.ndarray      # (slots,) int32 generated-token index of position 0
    tables: np.ndarray    # (slots, max_blocks) int32; 0 = trash
    chunk_rows: List[Tuple[Sequence, int, int]]  # (seq, start, n_real)


class ServeEngine:
    """Continuous-batching engine over a ``TransformerInferenceModule``.

    ``device`` defaults to the card and must be where the model lives;
    without a card, ``device=None`` raises rather than run on the CPU."""

    def __init__(self, inference_module: TransformerInferenceModule,
                 config: Optional[EngineConfig] = None, device=None):
        dev, model_dev = resolve_device(device), inference_module.device
        if dev.type != model_dev.type or dev.index not in (None, model_dev.index):
            raise ValueError(f"engine on {dev} but the model is on {model_dev}")
        self.device = model_dev
        self.inf = inference_module
        self.config = config or EngineConfig()
        self.scheduler = ContinuousBatchingScheduler(self.config.scheduler_config())
        self.pools: PagedKVPools = init_pools(
            inference_module.architecture, self.config.num_blocks,
            self.config.block_size, kv_dtype=self.config.kv_dtype,
            device=self.device,
        )
        n = self.config.num_slots
        # per-slot sampler state, set at admission
        self._temp = np.zeros((n,), np.float32)
        self._topk = np.zeros((n,), np.int32)
        self._topp = np.zeros((n,), np.float32)
        self._reqid = np.zeros((n,), np.int32)
        self.tick_index = 0
        self.finished: List[Sequence] = []
        self.prefilled_tokens = 0  # prompt tokens actually prefilled
        self._next_req_id = 0

    # ------------------------------------------------------------- intake
    def submit(self, prompt: List[int], max_new_tokens: int,
               arrival_s: Optional[float] = None,
               eos_token_id: Optional[int] = None,
               temperature: float = 0.0,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               req_id: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               ttft_deadline_ms: Optional[float] = None) -> Sequence:
        """Admit one request into the waiting queue."""
        if deadline_ms is not None or ttft_deadline_ms is not None:
            raise NotImplementedError("request deadlines are not ported yet")
        if req_id is None:
            req_id = self._next_req_id
        self._next_req_id = max(self._next_req_id, req_id + 1)
        req = Request(
            req_id=req_id, prompt=list(prompt), max_new_tokens=max_new_tokens,
            arrival_s=time.monotonic() if arrival_s is None else arrival_s,
            eos_token_id=eos_token_id,
            temperature=temperature, top_k=top_k, top_p=top_p,
        )
        return self.scheduler.add_request(req)

    def attach_journal(self, journal) -> None:
        raise NotImplementedError("the request journal is not ported yet")

    def begin_drain(self) -> None:
        raise NotImplementedError("graceful drain is not ported yet")

    # ------------------------------------------------------------- ticking
    def _reset_rows(self, slots: List[int]) -> None:
        for s in slots:
            self._temp[s] = 0.0
            self._topk[s] = 0
            self._topp[s] = 0.0
            self._reqid[s] = 0

    def _admit_slot(self, seq: Sequence) -> None:
        slot = seq.slot
        self._temp[slot] = seq.request.temperature
        self._topk[slot] = seq.request.top_k or 0
        self._topp[slot] = seq.request.top_p or 0.0
        self._reqid[slot] = seq.request.req_id

    def _apply_cow(self, pairs) -> None:
        """Copy-on-write block forks the scheduler ordered this tick, applied
        before the forward."""
        for src, dst in pairs:
            self.pools.copy_block(src, dst)

    def _mixed_inputs(self, t: Tick) -> MixedInputs:
        """The tick's rows: prefill chunks and decode rows. Idle rows keep
        an all-trash table and new_len 0: their writes land in the trash
        block and they see no slot."""
        cfg = self.config
        n, width = cfg.num_slots, cfg.mixed_width
        inp = MixedInputs(
            tokens=np.zeros((n, width), np.int32),
            ctx=np.zeros((n,), np.int32),
            new_lens=np.zeros((n,), np.int32),
            gen0=np.zeros((n,), np.int32),
            tables=np.zeros((n, cfg.max_blocks_per_seq), np.int32),
            chunk_rows=[],
        )
        for seq in t.prefills:
            slot = seq.slot
            prompt = seq.resume_prompt
            start = seq.num_cached
            n_real = min(cfg.prefill_chunk, seq.prefill_len - start)
            if n_real <= 0:
                raise RuntimeError("chunk row scheduled with nothing to prefill")
            inp.tokens[slot, :n_real] = prompt[start:start + n_real]
            inp.new_lens[slot] = n_real
            inp.ctx[slot] = start
            inp.tables[slot, :len(seq.blocks)] = seq.blocks
            if start == seq.prefix_cached:
                self._admit_slot(seq)  # first chunk of this admission
            # the chunk's last real position draws with the key of the
            # request's first generated token
            inp.gen0[slot] = len(seq.generated) - (n_real - 1)
            inp.chunk_rows.append((seq, start, n_real))
        for seq in t.decodes:
            slot = seq.slot
            inp.tokens[slot, 0] = seq.generated[-1]
            inp.new_lens[slot] = 1
            inp.ctx[slot] = seq.num_cached
            inp.tables[slot, :len(seq.blocks)] = seq.blocks
            inp.gen0[slot] = len(seq.generated)
        return inp

    def _forward_mixed(self, inp: MixedInputs) -> Tuple[torch.Tensor, torch.Tensor]:
        """One mixed forward: (logits of the sampled positions
        (slots, sample_width, vocab), sampled tokens (slots, sample_width))."""
        cfg = self.config
        n, width, sw = cfg.num_slots, cfg.mixed_width, cfg.sample_width
        m = cfg.max_blocks_per_seq
        # one host->device copy for every int operand of the tick
        packed = torch.from_numpy(np.concatenate([
            inp.tables.reshape(-1), inp.ctx, inp.new_lens, inp.gen0,
            inp.tokens.reshape(-1),
        ])).to(self.device, non_blocking=True)
        tables = packed[:n * m].view(n, m)
        ctx = packed[n * m:n * m + n]
        new_lens = packed[n * m + n:n * m + 2 * n]
        gen0 = packed[n * m + 2 * n:n * m + 3 * n]
        tokens = packed[n * m + 3 * n:].view(n, width)
        pos = ctx[:, None] + torch.arange(width, dtype=torch.int32, device=self.device)
        g0 = (new_lens - sw).clamp(0, width - sw)
        logits = self.inf._run_layers(
            self.inf._make_batch(tokens, pos),
            self.pools.views(tables, ctx, new_lens),
            gather_start=g0, gather_width=sw,
        )
        return logits, self._sample(logits, gen0 + g0)

    def _sample(self, logits: torch.Tensor, pos0: torch.Tensor) -> torch.Tensor:
        """Sample every gathered position; position ``j`` of a row draws
        with the key of generated-token index ``pos0 + j``."""
        rows, sw, vocab = logits.shape
        flat = logits.reshape(rows * sw, vocab)
        if not (self._temp > 0).any():  # all greedy: no sort, no noise
            return flat.argmax(dim=-1).int().view(rows, sw)

        def rep(x: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.repeat(x, sw)).to(self.device)

        positions = (pos0.long()[:, None] + torch.arange(sw, device=self.device)).reshape(-1)
        reqids = rep(self._reqid)
        uniforms = request_uniforms(self.config.sample_seed, reqids, positions, vocab)
        out = sample_rows(flat, rep(self._temp), rep(self._topk), uniforms,
                          top_ps=rep(self._topp))
        return out.view(rows, sw)

    def _run_mixed(self, t: Tick) -> None:
        """The fused tick: ONE forward covers every prefill chunk and the
        whole decode batch."""
        inp = self._mixed_inputs(t)
        _, sampled = self._forward_mixed(inp)
        host_samples = sampled.cpu().numpy()  # the tick's one device->host pull
        now = time.monotonic()
        for seq, start, n_real in inp.chunk_rows:
            seq.num_cached = start + n_real
            self.prefilled_tokens += n_real
            if seq.num_cached == seq.prefill_len:
                self._emit_token(seq, int(host_samples[seq.slot, 0]), now)
        for seq in t.decodes:
            seq.num_cached += 1
            self._emit_token(seq, int(host_samples[seq.slot, 0]), now)

    def _emit_token(self, seq: Sequence, tok: int, now: float) -> None:
        seq.generated.append(tok)
        if seq.first_token_s is None:
            seq.first_token_s = now
        seq.token_stamps.append(now)

    def _finish(self, seq: Sequence, now: float) -> None:
        self.scheduler.finish(seq)
        seq.finish_status = "completed"
        seq.finished_s = now
        self.finished.append(seq)

    def tick(self) -> Tick:
        """One engine step: schedule, fork shared blocks, run the mixed
        forward, retire completions."""
        t = self.scheduler.schedule()
        self._reset_rows(self.scheduler.drain_freed_slots())
        self._apply_cow(t.cow_pairs)
        if t.prefills or t.decodes:
            self._run_mixed(t)
        now = time.monotonic()
        for seq in list(t.prefills) + list(t.decodes):
            if seq.done and seq.slot is not None:
                self._finish(seq, now)
        self._reset_rows(self.scheduler.drain_freed_slots())
        self.tick_index += 1
        return t

    def run_until_done(self, max_ticks: int = 100_000) -> List[Sequence]:
        """Drain every submitted request; returns finished sequences in
        completion order."""
        ticks = 0
        while self.scheduler.has_work:
            self.tick()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(
                    f"engine made no progress draining the queue within "
                    f"{max_ticks} ticks"
                )
        return self.finished
