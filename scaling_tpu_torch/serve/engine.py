"""The serving engine (counterpart of scaling_tpu/serve/engine.py).

Per tick the scheduler mixes prompt prefill work with decode work for
every running sequence. By default the engine runs it all as ONE fused
Sarathi-style mixed forward: every slot row is either a prefill CHUNK
(``new_len`` real tokens of the prompt) or a decode row carrying its last
token plus up to ``spec_k`` self-drafted speculative candidates, tagged
only by per-row lengths. Two other dispatch modes stand behind the
config, as in the JAX engine:

- ``fused_tick=False``: separate programs, one decode forward over the
  whole slot set at one token a row plus one chunk forward per
  prefilling sequence;
- ``prefill_chunk=None``: whole-prompt prefill through the same
  ``prefill_forward`` that ``generate`` uses, the prompt right-padded to a
  power-of-two bucket whose pads sit in segment 1 (flash attention, K4,
  takes buckets of 128 and more in bf16), its K/V scattered into the
  pool by ``write_prompt_kv``; decodes then run the separate decode
  forward.

Attention over the paged pool goes through kernel K1 in every mode; the
norms through kernel K2 when the model asks for the fused norm.
Shared-prefix blocks come from the scheduler's prefix trie; copy-on-write
forks it orders are applied before the forward. Only the final norm and
the head run on the positions that are sampled.

Sampling is per request (``inference.sample_rows``); greedy is the
default. Every sampled position draws with the uniforms of (seed,
request, generated-token index), so a preempted and resumed sequence,
a replayed journal and speculative acceptance (``_accept_speculative``)
all reproduce the tokens of plain decode, at any temperature.

Resilience, as in the JAX engine (docs/SERVING.md "Resilience"):
per-request deadlines expire at tick boundaries with status
``timeout``; the shed watermarks and ``max_waiting`` make ``submit``
return a :class:`Backpressure`; ``attach_journal`` records every
submission, each tick's tokens and every terminal status for crash
replay; ``begin_drain`` (SIGTERM through ``install_drain_handler``)
admits nothing new while in-flight requests finish. The fault points
``serve.tick`` and ``serve.admit`` fire at the top of ``tick`` and
``submit``.

Observability: counters, gauges and histograms in the obs registry
(flushed every ``flush_interval`` ticks and when ``run_until_done``
drains; with ``replica_id`` they carry a ``replica`` label), the spans
``serve.admit`` (traced requests), ``serve.draft``, ``serve.mixed``,
``serve.prefill``, ``serve.prefill_chunk``, ``serve.decode``,
``serve.preempt`` and ``serve.cow``, and one ``serve-request`` event a
retired request. ``warmup_mode`` keeps warm-up traffic off the books.

``paged_kernel='xla'`` (the JAX engine's gather fallback) is not ported:
on the card it would mean running K1's plain version.
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs, resolve_device
from ..logging.logger import logger
from ..models.transformer.inference import (
    TransformerInferenceModule,
    request_uniforms,
    sample_rows,
)
from ..resilience.faults import get_fault_plan
from .kvcache import PagedKVPools, init_pools, write_prompt_kv
from .scheduler import (
    Backpressure,
    ContinuousBatchingScheduler,
    Request,
    SchedulerConfig,
    Sequence,
    Tick,
)

MIN_PREFILL_BUCKET = 8


def prefill_bucket(prompt_len: int) -> int:
    """Power-of-two length ladder of whole-prompt prefill: every prompt
    length in a bucket runs at the bucket's shape."""
    b = MIN_PREFILL_BUCKET
    while b < prompt_len:
        b *= 2
    return b


@dataclasses.dataclass
class EngineConfig:
    num_slots: int = 8
    block_size: int = 16
    num_blocks: int = 128
    max_blocks_per_seq: int = 16
    token_budget: int = 512
    kv_dtype: str = "native"  # 'native' | 'int8'
    # Sarathi-style chunked prefill (tokens per chunk); None = whole-prompt
    # prefill through the pow2 bucket ladder
    prefill_chunk: Optional[int] = 32
    # 'pallas' is the paged kernel, K1 here; 'xla' is not ported
    paged_kernel: str = "pallas"
    # ONE fused mixed forward per tick (chunked mode only); False runs the
    # separate decode and per-sequence chunk forwards
    fused_tick: bool = True
    enable_prefix_cache: bool = True
    # self-drafting speculative decoding: n-gram drafts scored k at once
    # through the mixed forward's rows; 0 = off
    spec_k: int = 0
    sample_seed: int = 0
    flush_interval: int = 50  # registry flush cadence (ticks)
    # per-request deadline defaults (ms from arrival; None = unbounded)
    default_deadline_ms: Optional[float] = None
    default_ttft_deadline_ms: Optional[float] = None
    # overload shedding: pool-pressure watermarks (with hysteresis) and a
    # waiting-queue cap; None disables each
    shed_high_watermark: Optional[float] = None
    shed_low_watermark: Optional[float] = None
    max_waiting: Optional[int] = None
    # fleet identity: a ``replica`` label on the metrics and a field on
    # the serve-request events; None = the single-engine deployment
    replica_id: Optional[int] = None

    def __post_init__(self):
        if self.paged_kernel not in ("pallas", "xla"):
            raise ValueError(
                f"paged_kernel must be 'pallas' or 'xla', got {self.paged_kernel!r}"
            )
        if self.paged_kernel == "xla":
            raise NotImplementedError(
                "paged_kernel='xla' is not ported: on the card it would run the "
                "paged kernel's plain version"
            )
        if self.spec_k > 0 and (self.prefill_chunk is None or not self.fused_tick):
            raise ValueError(
                "spec_k > 0 needs chunked prefill AND the fused mixed "
                "program (drafts are scored through its s>1 rows)"
            )

    @property
    def fused(self) -> bool:
        """The mixed forward replaces decode + chunk dispatch (chunked mode
        only: whole-prompt mode keeps its bucket ladder)."""
        return self.fused_tick and self.prefill_chunk is not None

    @property
    def mixed_width(self) -> int:
        """Token width of every row of the mixed forward: chunk rows need
        ``prefill_chunk`` slots, speculative decode rows ``spec_k + 1``."""
        return max(self.prefill_chunk or 1, self.spec_k + 1)

    @property
    def sample_width(self) -> int:
        """Positions per row of the mixed forward that are sampled: a
        decode row its last token's plus one per draft, a finishing chunk
        row one."""
        return min(self.mixed_width, self.spec_k + 1)

    def scheduler_config(self) -> SchedulerConfig:
        return SchedulerConfig(
            num_slots=self.num_slots, block_size=self.block_size,
            num_blocks=self.num_blocks,
            max_blocks_per_seq=self.max_blocks_per_seq,
            token_budget=self.token_budget,
            prefill_chunk=self.prefill_chunk,
            prefix_cache=self.enable_prefix_cache,
            spec_k=self.spec_k if self.fused else 0,
            shed_high_watermark=self.shed_high_watermark,
            shed_low_watermark=self.shed_low_watermark,
            max_waiting=self.max_waiting,
        )


@dataclasses.dataclass
class MixedInputs:
    """Host-side operands of one paged forward, one row per slot (or, with
    ``slots``, one row per listed slot)."""

    tokens: np.ndarray    # (rows, width) int32
    ctx: np.ndarray       # (rows,) int32 tokens already cached
    new_lens: np.ndarray  # (rows,) int32 real tokens this tick (0 = idle row)
    gen0: np.ndarray      # (rows,) int32 generated-token index of position 0
    tables: np.ndarray    # (rows, max_blocks) int32; 0 = trash
    chunk_rows: List[Tuple[Sequence, int, int]]  # (seq, start, n_real)
    slots: Optional[List[int]] = None  # whose sampler state each row uses


class ServeEngine:
    """Continuous-batching engine over a ``TransformerInferenceModule``.

    ``device`` defaults to the card and must be where the model lives;
    without a card, ``device=None`` raises rather than run on the CPU."""

    def __init__(self, inference_module: TransformerInferenceModule,
                 config: Optional[EngineConfig] = None, device=None):
        dev, model_dev = resolve_device(device), inference_module.device
        if dev.type != model_dev.type or dev.index not in (None, model_dev.index):
            raise ValueError(f"engine on {dev} but the model is on {model_dev}")
        if inference_module.architecture.num_local_attention_heads:
            # the paged attention (K1) has no window, as in the JAX engine
            raise NotImplementedError(
                "local-window heads (num_local_attention_heads) are unsupported on the paged "
                "serving path; generate with use_cache=True or False serves them")
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
        self.max_concurrent_prefills = 0
        self.prefilled_tokens = 0  # prompt tokens actually prefilled
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
        # prefill-side forward shapes run so far (buckets, chunk, mixed width)
        self._prefill_shapes: set = set()
        self._next_req_id = 0
        # bench warm-up: while True, nothing is counted and no span or
        # serve-request event is emitted (the kernels' first builds must
        # not enter the measured workload's percentiles)
        self.warmup_mode = False
        self._reg = obs.get_registry()
        self.replica_id = self.config.replica_id
        self._labels = (None if self.replica_id is None
                        else {"replica": str(self.replica_id)})
        self._replica_fields = ({} if self.replica_id is None
                                else {"replica": self.replica_id})
        self._prefix_hits_flushed = 0
        # resilience: drain, the shed and timeout tallies, the journal
        self.draining = False
        self.shed_count = 0
        self.timeout_count = 0
        self.journal = None
        self._journal_pending: Dict[int, List[int]] = {}
        # live requests carrying a deadline: no sweep while it is 0
        self._deadline_live = 0

    # ------------------------------------------------------------- intake
    def submit(self, prompt: List[int], max_new_tokens: int,
               arrival_s: Optional[float] = None,
               eos_token_id: Optional[int] = None,
               temperature: float = 0.0,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               deadline_ms: Optional[float] = None,
               ttft_deadline_ms: Optional[float] = None,
               req_id: Optional[int] = None,
               force: bool = False,
               count_shed: bool = True,
               trace: Optional[str] = None):
        """Admit one request and return its :class:`Sequence`, or reject it
        with a :class:`Backpressure` (draining, or over the shed
        watermarks). ``req_id`` pins the request's identity (a journal
        replay reuses it: the sampler keys fold it); ``deadline_ms`` /
        ``ttft_deadline_ms`` override the config's defaults; ``force``
        admits past drain and backpressure (replayed recovery work);
        ``count_shed=False`` returns a rejection without counting or
        journaling it. ``trace`` pins the request's trace id; by default
        it inherits the ambient ``obs.trace_context``. Warm-up traffic
        takes none."""
        get_fault_plan().fire("serve.admit")
        if force:
            bp = None
        elif self.draining:
            bp = Backpressure(
                reason="draining",
                pool_pressure=round(self.scheduler.pool_pressure(), 4),
                waiting=len(self.scheduler.waiting), draining=True,
            )
        else:
            bp = self.scheduler.admission_backpressure()
        if bp is not None:
            if not self.warmup_mode and count_shed:
                # a draining rejection is shutdown, not overload: it stays
                # out of the shed count and out of the journal
                if not bp.draining:
                    self.shed_count += 1
                    self._counter("serve_requests_shed_total").inc()
                    if self.journal is not None:
                        self.journal.record_shed(bp.reason)
                logger.log_event(
                    "serve-shed", _level="debug", reason=bp.reason,
                    pool_pressure=bp.pool_pressure, waiting=bp.waiting,
                    **self._replica_fields,
                )
            return bp
        if req_id is None:
            req_id = self._next_req_id
        self._next_req_id = max(self._next_req_id, req_id + 1)
        if self.warmup_mode:
            trace = None
        elif trace is None:
            trace = obs.current_trace_id()
        cfg = self.config
        req = Request(
            req_id=req_id, prompt=list(prompt), max_new_tokens=max_new_tokens,
            arrival_s=time.monotonic() if arrival_s is None else arrival_s,
            eos_token_id=eos_token_id,
            temperature=temperature, top_k=top_k, top_p=top_p,
            deadline_ms=deadline_ms if deadline_ms is not None else cfg.default_deadline_ms,
            ttft_deadline_ms=(ttft_deadline_ms if ttft_deadline_ms is not None
                              else cfg.default_ttft_deadline_ms),
            trace_id=trace,
        )
        if trace is not None:  # the trace's first engine-side record
            with obs.trace_context(trace):
                with self._span("serve.admit", req=req_id, **self._replica_fields):
                    seq = self.scheduler.add_request(req)
        else:
            seq = self.scheduler.add_request(req)
        if req.deadline_ms is not None or req.ttft_deadline_ms is not None:
            self._deadline_live += 1
        if not self.warmup_mode:
            self._counter("serve_requests_admitted_total").inc()
            if self.journal is not None:
                self.journal.record_submit(req)
        return seq

    def attach_journal(self, journal) -> None:
        """Wire the crash-replay request journal (serve/journal.py): every
        measured submission, each tick's emitted tokens and every terminal
        status are appended, so a supervised relaunch can replay."""
        self.journal = journal

    def begin_drain(self) -> None:
        """Graceful drain: admit nothing new (``submit`` returns
        ``Backpressure(reason='draining')``) while in-flight requests run
        to completion or their deadlines."""
        if self.draining:
            return
        self.draining = True
        logger.log_event(
            "serve-drain", tick=self.tick_index,
            running=len(self.scheduler.running),
            waiting=len(self.scheduler.waiting),
            **self._replica_fields,
        )

    # ---------------------------------------------------------- telemetry
    def _counter(self, name: str):
        return self._reg.counter(name, self._labels)

    def _gauge(self, name: str):
        return self._reg.gauge(name, self._labels)

    def _histogram(self, name: str):
        return self._reg.histogram(name, self._labels)

    def _span(self, name: str, **fields):
        """``obs.span``, silenced in warm-up: its ticks carry the kernels'
        first builds."""
        if self.warmup_mode:
            return contextlib.nullcontext()
        return obs.span(name, **fields)

    @staticmethod
    def _trace_fields(seqs, key: str = "traces") -> dict:
        """``{key: [trace ids]}`` of the traced requests a batch span
        advanced; empty without any, so trace-less records stay as they
        were."""
        out: List[str] = []
        for s in seqs:
            tid = s.request.trace_id
            if tid and tid not in out:
                out.append(tid)
        return {key: out} if out else {}

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
        if not pairs:
            return
        for src, dst in pairs:
            self.pools.copy_block(src, dst)
        self._counter("serve_cow_forks_total").inc(len(pairs))

    def _empty_inputs(self, rows: int, width: int) -> MixedInputs:
        """Idle rows: an all-trash table and new_len 0, so their writes land
        in the trash block and they see no slot."""
        return MixedInputs(
            tokens=np.zeros((rows, width), np.int32),
            ctx=np.zeros((rows,), np.int32),
            new_lens=np.zeros((rows,), np.int32),
            gen0=np.zeros((rows,), np.int32),
            tables=np.zeros((rows, self.config.max_blocks_per_seq), np.int32),
            chunk_rows=[],
        )

    def _chunk_row(self, inp: MixedInputs, row: int, seq: Sequence) -> None:
        """Row ``row`` carries ``seq``'s next prompt chunk."""
        prompt = seq.resume_prompt
        start = seq.num_cached
        n_real = min(self.config.prefill_chunk, seq.prefill_len - start)
        if n_real <= 0:
            raise RuntimeError("chunk row scheduled with nothing to prefill")
        inp.tokens[row, :n_real] = prompt[start:start + n_real]
        inp.new_lens[row] = n_real
        inp.ctx[row] = start
        inp.tables[row, :len(seq.blocks)] = seq.blocks
        if start == seq.prefix_cached:
            self._admit_slot(seq)  # first chunk of this admission
        # the chunk's last real position draws with the key of the
        # request's first generated token
        inp.gen0[row] = len(seq.generated) - (n_real - 1)
        inp.chunk_rows.append((seq, start, n_real))

    def _decode_row(self, inp: MixedInputs, seq: Sequence) -> None:
        """Slot row of a decoding ``seq``: its last token, then its drafts."""
        slot, draft = seq.slot, seq.draft
        inp.tokens[slot, 0] = seq.generated[-1]
        if draft:
            inp.tokens[slot, 1:1 + len(draft)] = draft
        inp.new_lens[slot] = 1 + len(draft)
        inp.ctx[slot] = seq.num_cached
        inp.tables[slot, :len(seq.blocks)] = seq.blocks
        inp.gen0[slot] = len(seq.generated)

    def _mixed_inputs(self, t: Tick) -> MixedInputs:
        """The fused tick's rows: prefill chunks and decode rows."""
        inp = self._empty_inputs(self.config.num_slots, self.config.mixed_width)
        for seq in t.prefills:
            self._chunk_row(inp, seq.slot, seq)
        for seq in t.decodes:
            self._decode_row(inp, seq)
        return inp

    def _forward_mixed(self, inp: MixedInputs, sample_width: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One paged forward over ``inp``'s rows: (logits of the sampled
        positions (rows, sample_width, vocab), sampled tokens (rows,
        sample_width)). Row ``r`` samples positions ``g0 .. g0 +
        sample_width - 1`` with ``g0 = clip(new_len - sample_width, 0)``."""
        rows, width = inp.tokens.shape
        sw = self.config.sample_width if sample_width is None else sample_width
        m = self.config.max_blocks_per_seq
        # one host->device copy for every int operand of the forward
        packed = torch.from_numpy(np.concatenate([
            inp.tables.reshape(-1), inp.ctx, inp.new_lens, inp.gen0,
            inp.tokens.reshape(-1),
        ])).to(self.device, non_blocking=True)
        tables = packed[:rows * m].view(rows, m)
        ctx = packed[rows * m:rows * m + rows]
        new_lens = packed[rows * m + rows:rows * m + 2 * rows]
        gen0 = packed[rows * m + 2 * rows:rows * m + 3 * rows]
        tokens = packed[rows * m + 3 * rows:].view(rows, width)
        pos = ctx[:, None] + torch.arange(width, dtype=torch.int32, device=self.device)
        g0 = (new_lens - sw).clamp(0, width - sw)
        logits = self.inf._run_layers(
            self.inf._make_batch(tokens, pos),
            self.pools.views(tables, ctx, new_lens),
            gather_start=g0, gather_width=sw,
        )
        return logits, self._sample(logits, gen0 + g0, inp.slots)

    def _sample(self, logits: torch.Tensor, pos0: torch.Tensor,
                slots: Optional[List[int]] = None) -> torch.Tensor:
        """Sample every gathered position; position ``j`` of a row draws
        with the key of generated-token index ``pos0 + j``. Row ``r`` takes
        the sampler state of slot ``slots[r]`` (default: slot ``r``)."""
        rows, sw, vocab = logits.shape
        flat = logits.reshape(rows * sw, vocab)
        idx = slice(None) if slots is None else np.asarray(slots)
        temp = self._temp[idx]
        if not (temp > 0).any():  # all greedy: no sort, no noise
            return flat.argmax(dim=-1).int().view(rows, sw)

        def rep(x: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.repeat(x[idx], sw)).to(self.device)

        positions = (pos0.long()[:, None] + torch.arange(sw, device=self.device)).reshape(-1)
        uniforms = request_uniforms(self.config.sample_seed, rep(self._reqid), positions,
                                    vocab)
        out = sample_rows(flat, rep(self._temp), rep(self._topk), uniforms,
                          top_ps=rep(self._topp))
        return out.view(rows, sw)

    def _land_chunk(self, seq: Sequence, start: int, n_real: int) -> bool:
        """A chunk's KV is in the pool; True when it completed the prompt."""
        seq.num_cached = start + n_real
        if not self.warmup_mode:
            self.prefilled_tokens += n_real
            self._counter("serve_prefill_tokens_total").inc(n_real)
        return seq.num_cached == seq.prefill_len

    def _run_mixed(self, t: Tick) -> None:
        """The fused tick: ONE forward covers every prefill chunk and the
        whole decode batch with its drafts; acceptance happens on the host
        over the returned per-position samples."""
        inp = self._mixed_inputs(t)
        if inp.chunk_rows:
            self._prefill_shapes.add(("mixed", self.config.mixed_width))
        with self._span("serve.mixed", step=self.tick_index,
                        decodes=len(t.decodes), chunks=len(t.prefills),
                        **self._trace_fields(t.decodes),
                        **self._trace_fields(t.prefills, "chunk_traces")):
            _, sampled = self._forward_mixed(inp)
            # the tick's ONE deliberate device->host pull: the sampled
            # token grid must land on host to be emitted to callers
            host_samples = sampled.cpu().numpy()  # sta: disable=STA010
        now = time.monotonic()
        sw = self.config.sample_width
        emits = []
        for seq, start, n_real in inp.chunk_rows:
            if self._land_chunk(seq, start, n_real):
                # position n_real - 1, gathered at n_real - 1 - g0
                emits.append((seq, [int(host_samples[seq.slot, min(n_real, sw) - 1])]))
        for seq in t.decodes:
            emits.append((seq, self._accept_speculative(seq, host_samples[seq.slot])))
        self._emit_tokens(emits, now)

    def _run_prefill_chunk(self, seq: Sequence) -> None:
        """The separate chunk forward: one row of ``prefill_chunk`` tokens
        (pads to the trash block); a chunk that completes the prompt emits
        the first token."""
        inp = self._empty_inputs(1, self.config.prefill_chunk)
        inp.slots = [seq.slot]
        self._chunk_row(inp, 0, seq)
        _, start, n_real = inp.chunk_rows[0]
        self._prefill_shapes.add(("chunk", self.config.prefill_chunk))
        with self._span("serve.prefill_chunk", step=self.tick_index,
                        tokens=n_real, start=start, **self._trace_fields([seq])):
            _, sampled = self._forward_mixed(inp, sample_width=1)
            # deliberate sync: the chunk's token lands on host to be emitted
            tok = int(sampled.cpu()[0, 0])  # sta: disable=STA010
        if self._land_chunk(seq, start, n_real):
            self._emit_tokens([(seq, [tok])], time.monotonic())

    def _run_prefill(self, seq: Sequence) -> None:
        """Whole-prompt prefill: the resume prompt right-padded to its pow2
        bucket, the pads in segment 1 (content never attends to them, they
        never attend to content), one ``prefill_forward`` sampled at the
        last real position, its K/V scattered into the sequence's blocks
        with every pad sent to the trash block."""
        prompt = seq.resume_prompt
        L = len(prompt)
        bucket = prefill_bucket(L)
        self._prefill_shapes.add(("bucket", bucket))
        m = self.config.max_blocks_per_seq
        host = np.zeros((bucket + m,), np.int32)
        host[:L] = prompt
        host[bucket:bucket + len(seq.blocks)] = seq.blocks
        self._admit_slot(seq)
        with self._span("serve.prefill", step=self.tick_index, tokens=L,
                        **self._trace_fields([seq])):
            packed = torch.from_numpy(host).to(self.device, non_blocking=True)
            tokens, block_row = packed[:bucket][None], packed[bucket:]
            pos = torch.arange(bucket, dtype=torch.int32, device=self.device)[None]
            seg = (pos >= L).int()
            logits, kvs = self.inf.prefill_forward(tokens, pos, seg, last_index=L - 1)
            views = self.pools.views(block_row[None], torch.zeros(1, dtype=torch.int32,
                                                                  device=self.device))
            for view, (k, v) in zip(views, kvs):
                write_prompt_kv(view, k, v, block_row, L, self.config.block_size)
            gen = torch.full((1,), len(seq.generated), dtype=torch.int32, device=self.device)
            # deliberate sync: the prefilled token must land on host to be
            # emitted (one pull per prefill, inside the measured span)
            tok = int(self._sample(logits, gen, [seq.slot]).cpu()[0, 0])  # sta: disable=STA010
        seq.num_cached = L
        if not self.warmup_mode:
            self.prefilled_tokens += L
            self._counter("serve_prefill_tokens_total").inc(L)
        self._emit_tokens([(seq, [tok])], time.monotonic())

    def _run_decode(self, decodes: List[Sequence]) -> None:
        """The separate decode forward: every slot at one token (K1 at
        s = 1); rows not decoding this tick see no slot and write into the
        trash block."""
        inp = self._empty_inputs(self.config.num_slots, 1)
        for seq in decodes:
            self._decode_row(inp, seq)
        with self._span("serve.decode", step=self.tick_index, batch=len(decodes),
                        **self._trace_fields(decodes)):
            _, sampled = self._forward_mixed(inp, sample_width=1)
            # the tick's one deliberate device->host pull
            host_samples = sampled.cpu().numpy()  # sta: disable=STA010
        now = time.monotonic()
        emits = []
        for seq in decodes:
            seq.num_cached += 1
            emits.append((seq, [int(host_samples[seq.slot, 0])]))
        self._emit_tokens(emits, now)

    def _accept_speculative(self, seq: Sequence, row_samples: np.ndarray) -> List[int]:
        """Exact speculative acceptance (Leviathan et al., arxiv 2211.17192,
        with pathwise keys): position ``j``'s sample is plain decode's next
        token provided every earlier draft matched its sample. Returns the
        sample run up to and including the first mismatch, cut at the
        request's budget and at EOS; ``num_cached`` advances by the tokens
        accepted, so a rejected draft's slot is overwritten next tick."""
        draft = seq.draft
        xs = [int(x) for x in row_samples[:len(draft) + 1]]
        emitted = [xs[0]]
        matched = 0
        for j, d in enumerate(draft):
            if d != xs[j]:
                break
            matched += 1
            emitted.append(xs[j + 1])
        emitted = emitted[:seq.remaining_tokens]
        eos = seq.request.eos_token_id
        if eos is not None and eos in emitted:
            emitted = emitted[:emitted.index(eos) + 1]
        accepted = min(matched, len(emitted) - 1)
        if self.warmup_mode:
            draft = []
        self.spec_drafted_tokens += len(draft)
        self.spec_accepted_tokens += accepted if draft else 0
        if draft:
            self._counter("serve_spec_drafted_tokens_total").inc(len(draft))
            if accepted:
                self._counter("serve_spec_accepted_tokens_total").inc(accepted)
        seq.draft = []
        seq.num_cached += len(emitted)
        return emitted

    def _emit_tokens(self, emits: List[Tuple[Sequence, List[int]]], now: float) -> None:
        """Each sequence takes its tokens (pending for the journal's one
        append a tick). Outside warm-up the TTFT and ITL observations and
        the token count go to the registry with one lookup a metric."""
        ttft, itl = [], []
        count = 0
        journaling = self.journal is not None and not self.warmup_mode
        for seq, toks in emits:
            for tok in toks:
                seq.generated.append(tok)
                if journaling:
                    self._journal_pending.setdefault(seq.request.req_id, []).append(tok)
                if seq.first_token_s is None:
                    seq.first_token_s = now
                    ttft.append(now - seq.request.arrival_s)
                elif seq.token_stamps:
                    itl.append(now - seq.token_stamps[-1])
                seq.token_stamps.append(now)
                count += 1
        if self.warmup_mode or not count:
            return
        for name, values in (("serve_ttft_seconds", ttft), ("serve_itl_seconds", itl)):
            if values:
                histogram = self._histogram(name)
                for v in values:
                    histogram.observe(v)
        self._counter("serve_tokens_generated_total").inc(count)

    def _finish(self, seq: Sequence, now: float) -> None:
        self.scheduler.finish(seq)  # the row reset rides the freed-slot drain
        self._retire(seq, now, "completed")

    def _retire(self, seq: Sequence, now: float, status: str) -> None:
        """Every way a request ends ('completed' | 'timeout'): the journal's
        final tokens and status in one append, the counters and the
        ``serve-request`` event (outside warm-up)."""
        seq.finish_status = status
        seq.finished_s = now
        self.finished.append(seq)
        req = seq.request
        if req.deadline_ms is not None or req.ttft_deadline_ms is not None:
            self._deadline_live -= 1
        if self.warmup_mode:
            return
        if self.journal is not None:
            self.journal.record_finish(
                req.req_id, status, tokens=self._journal_pending.pop(req.req_id, None))
        if status == "completed":
            self._counter("serve_requests_completed_total").inc()
        else:
            self.timeout_count += 1
            self._counter("serve_requests_timeout_total").inc()
        itl = [b - a for a, b in zip(seq.token_stamps, seq.token_stamps[1:])]
        fields = dict(
            req=req.req_id,
            status=status,
            prompt_tokens=len(req.prompt),
            output_tokens=len(seq.generated),
            e2e_s=round(now - req.arrival_s, 6),
            itl_mean_s=round(sum(itl) / len(itl), 6) if itl else 0.0,
            preemptions=seq.preemptions,
            **self._replica_fields,
        )
        if req.trace_id is not None:
            fields["trace"] = req.trace_id
        if seq.first_token_s is not None:  # a TTFT timeout has no first token
            fields["ttft_s"] = round(seq.first_token_s - req.arrival_s, 6)
        logger.log_event("serve-request", _level="debug", **fields)

    def _expire_deadlines(self, now: float) -> None:
        """Tick-boundary deadline sweep: cancel every live request past its
        total deadline, or past its TTFT deadline with no first token yet;
        its slot and blocks are admissible this tick."""
        if not self._deadline_live:
            return
        live = list(self.scheduler.running.values()) + list(self.scheduler.waiting)
        for seq in live:
            req = seq.request
            waited_ms = (now - req.arrival_s) * 1000.0
            expired = (
                req.deadline_ms is not None and waited_ms > req.deadline_ms
            ) or (
                req.ttft_deadline_ms is not None and seq.first_token_s is None
                and waited_ms > req.ttft_deadline_ms
            )
            if expired:
                self.scheduler.cancel(seq)
                self._retire(seq, now, "timeout")

    def tick(self) -> Tick:
        """One engine step: expire deadlines, draft speculative candidates,
        schedule, fork shared blocks, run the forward(s), retire
        completions, append the tick's tokens to the journal."""
        get_fault_plan().fire("serve.tick")
        self._expire_deadlines(time.monotonic())
        if self.config.spec_k > 0:
            with self._span("serve.draft", step=self.tick_index):
                self.scheduler.propose_drafts()
        t = self.scheduler.schedule()
        if t.preempted:
            self._counter("serve_preemptions_total").inc(len(t.preempted))
            # a zero-width marker: which traced requests went back to waiting
            with self._span("serve.preempt", step=self.tick_index,
                            count=len(t.preempted), **self._trace_fields(t.preempted)):
                pass
        sched = self.scheduler
        if sched.prefix_hit_tokens > self._prefix_hits_flushed:
            self._counter("serve_prefix_hit_tokens_total").inc(
                sched.prefix_hit_tokens - self._prefix_hits_flushed)
            self._prefix_hits_flushed = sched.prefix_hit_tokens
        self._reset_rows(sched.drain_freed_slots())
        if t.cow_pairs:
            with self._span("serve.cow", step=self.tick_index, pairs=len(t.cow_pairs),
                            **self._trace_fields(t.prefills)):
                self._apply_cow(t.cow_pairs)
        if self.config.fused:
            if t.prefills or t.decodes:
                self._run_mixed(t)
        else:
            for seq in t.prefills:
                if self.config.prefill_chunk is not None:
                    self._run_prefill_chunk(seq)
                else:
                    self._run_prefill(seq)
            if t.decodes:
                self._run_decode(t.decodes)
        self.max_concurrent_prefills = max(self.max_concurrent_prefills, len(t.prefills))
        now = time.monotonic()
        for seq in list(t.prefills) + list(t.decodes):
            if seq.done and seq.slot is not None:
                self._finish(seq, now)
        self._reset_rows(sched.drain_freed_slots())
        if self.journal is not None and self._journal_pending:
            # one append for every row's tick tokens (completions flushed
            # theirs with their status in _retire)
            self.journal.record_tokens_batch(self._journal_pending)
            self._journal_pending.clear()
        for name, value in sched.gauges().items():
            self._gauge(name).set(value)
        if self.spec_drafted_tokens:
            self._gauge("serve_spec_accept_rate").set(
                self.spec_accepted_tokens / self.spec_drafted_tokens)
        self.tick_index += 1
        if self.tick_index % self.config.flush_interval == 0:
            self._reg.flush_step(self.tick_index)
        return t

    @property
    def spec_accept_rate(self) -> Optional[float]:
        """Accepted / drafted speculative tokens (None before any drafting)."""
        if not self.spec_drafted_tokens:
            return None
        return self.spec_accepted_tokens / self.spec_drafted_tokens

    @property
    def prefill_program_count(self) -> int:
        """Prefill-side forward shapes run: pow2 buckets (whole-prompt
        mode), the chunk forward and the mixed width, as the JAX engine
        counts its compiled programs."""
        return len(self._prefill_shapes)

    def stats_snapshot(self) -> dict:
        """One JSON-safe dict of the engine's load and lifetime tallies,
        with the JAX engine's fields and names: the ``stats`` reply of a
        subprocess replica (``serve.replica_proc``), which is also its
        heartbeat, and what the router's least-loaded sort, the
        supervisor's liveness pass and the process fleet's serve-summary
        read. Beside them, this process's kernel and plain-version
        launches (``ops.launches``), so the host can check a worker's
        kernels. Plain attribute and length reads, safe from an RPC
        thread while a tick runs."""
        from ..ops import launches

        sched = self.scheduler
        finished = list(self.finished)
        return {
            "replica": self.replica_id,
            "queue_depth": len(sched.waiting) + len(sched.running),
            "waiting": len(sched.waiting),
            "running": len(sched.running),
            "pool_pressure": sched.pool_pressure(),
            "has_work": sched.has_work,
            "draining": self.draining,
            "next_req_id": self._next_req_id,
            "tick": self.tick_index,
            "shed_count": self.shed_count,
            "timeout_count": self.timeout_count,
            "finished": len(finished),
            "completed": sum(1 for s in finished if s.finish_status == "completed"),
            "output_tokens": sum(len(s.generated) for s in finished),
            "preemptions": sched.preemption_count,
            "prefix_hit_tokens": sched.prefix_hit_tokens,
            "prefilled_tokens": self.prefilled_tokens,
            "spec_drafted_tokens": self.spec_drafted_tokens,
            "spec_accepted_tokens": self.spec_accepted_tokens,
            "prefill_compiles": self.prefill_program_count,
            "max_concurrent_prefills": self.max_concurrent_prefills,
            "kernel_launches": launches.snapshot(launches.KERNEL),
            "plain_launches": launches.snapshot(launches.PLAIN),
        }

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
        self._reg.flush_step(self.tick_index)
        return self.finished


def install_drain_handler(engine: ServeEngine) -> None:
    """SIGTERM -> ``engine.begin_drain()``, chaining any handler installed
    before (launchers and cluster agents keep theirs): no new admissions,
    in-flight requests finish or hit their deadlines, and the bench loop
    exits 0 with a complete run directory."""
    prev = signal.getsignal(signal.SIGTERM)

    def handler(signum, frame):
        engine.begin_drain()
        if callable(prev):  # SIG_DFL / SIG_IGN are not callable
            prev(signum, frame)

    signal.signal(signal.SIGTERM, handler)
