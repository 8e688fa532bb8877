"""Continuous-batching scheduler (Orca, OSDI '22) — host-side policy.

A copy of scaling_tpu/serve/scheduler.py for the port (which imports
nothing of the JAX package), without what the port's engine does not run
yet: the fault-injection hook, overload shedding, deadline cancellation
and speculative drafts. Pure Python: every decision the serving engine
makes about WHICH sequences run each tick lives here — admission, the
per-tick prefill/decode mix under a token budget, block accounting,
preemption on pool exhaustion, and slot recycling.

Preemption is recompute-style (PagedAttention, SOSP '23 §4.5): the
youngest running sequence drops its blocks and re-enters the waiting
queue with ``prompt + generated-so-far`` as its new prompt. Under greedy
sampling the resumed sequence regenerates token-for-token.

Shared-prefix block reuse (RadixAttention, arxiv 2312.07104):
:class:`PrefixCache` is a trie over FULL blocks of prompt tokens.
Admission walks the trie and maps every matched block straight into the
new sequence's table (refcounted — the allocator counts sequence users
per block), so N requests sharing a system prompt pay its prefill ONCE;
only the unmatched tail streams chunks. Freed cached blocks are not
returned to the free list — they become LRU-evictable trie leaves,
reclaimed only under pool pressure. A write into a shared block forks it
first (copy-on-write pairs on the :class:`Tick`).
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

# block 0 is the TRASH block: never allocated, it absorbs the jitted
# decode step's writes from inactive slots and padding (nn/attention.py
# PagedKVCacheView). Allocators start handing out ids at 1.
TRASH_BLOCK = 0


class SequenceState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    """One inference request as the load generator / API submits it.

    ``temperature`` / ``top_k`` / ``top_p`` are per-request sampler
    settings carried into the engine's tick as per-row tensors
    (inference.sample_rows); ``temperature=0`` (the default) is greedy."""

    req_id: int
    prompt: List[int]
    max_new_tokens: int
    arrival_s: float = 0.0
    eos_token_id: Optional[int] = None
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None


@dataclasses.dataclass
class Sequence:
    """Scheduler-side state of one request's lifetime."""

    request: Request
    state: SequenceState = SequenceState.WAITING
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None  # decode-batch row while RUNNING
    blocks: List[int] = dataclasses.field(default_factory=list)
    num_cached: int = 0  # tokens whose KV sits in the pool
    prefill_len: int = 0  # resume-prompt length at (re-)admission
    preemptions: int = 0
    # shared-prefix reuse: tokens whose blocks came straight from the
    # prefix trie at (re-)admission (their prefill is SKIPPED), and how
    # far this sequence's own full prompt blocks are registered in it
    prefix_cached: int = 0
    cached_upto: int = 0
    # telemetry stamps (engine fills these; monotonic seconds)
    first_token_s: Optional[float] = None
    finished_s: Optional[float] = None
    token_stamps: List[float] = dataclasses.field(default_factory=list)
    finish_status: str = "completed"  # set at retirement

    @property
    def resume_prompt(self) -> List[int]:
        """What a (re-)admission must prefill: the original prompt plus
        everything already generated (recompute-style preemption)."""
        return list(self.request.prompt) + list(self.generated)

    @property
    def remaining_tokens(self) -> int:
        return self.request.max_new_tokens - len(self.generated)

    @property
    def prefilling(self) -> bool:
        """RUNNING but the prompt's KV is not fully in the pool yet —
        under chunked prefill such a sequence streams chunks instead of
        decoding (it has no first token to decode from)."""
        return self.slot is not None and self.num_cached < self.prefill_len

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.request.max_new_tokens:
            return True
        eos = self.request.eos_token_id
        return eos is not None and bool(self.generated) and self.generated[-1] == eos


class BlockAllocator:
    """Refcounted free-list over the pool's block ids; block 0 (trash) is
    reserved.

    A block's refcount counts its USERS: one per sequence whose table
    maps it, plus one held by the prefix trie while the block backs a
    cached prefix node (:class:`PrefixCache` — copy-on-write semantics:
    a writer facing ``refcount > 1`` must fork the block first, see
    ``ContinuousBatchingScheduler._fork_shared_write_blocks``). ``free``
    DECREMENTS; the block only returns to the free list at refcount 0."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"pool needs >=2 blocks (1 trash + 1 usable), got {num_blocks}"
            )
        self.num_blocks = num_blocks
        self._free: Deque[int] = deque(range(1, num_blocks))
        self._ref: Dict[int, int] = {}
        # refcount-transition hook (block, new_rc) — the prefix cache
        # registers here to track its evictable set incrementally
        # instead of rescanning the trie on every capacity question
        self.on_ref_change = None

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def _changed(self, block: int, rc: int) -> None:
        if self.on_ref_change is not None:
            self.on_ref_change(block, rc)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"pool exhausted: need {n} block(s), {len(self._free)} free"
            )
        out = [self._free.popleft() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
            self._changed(b, 1)
        return out

    def incref(self, block: int) -> None:
        """A new user (sequence table row or trie node) maps the block."""
        if block == TRASH_BLOCK or block not in self._ref:
            raise ValueError(f"incref on block {block} not allocated")
        self._ref[block] += 1
        self._changed(block, self._ref[block])

    def free(self, blocks: List[int]) -> None:
        """Drop one reference per listed block; refcount-0 blocks return
        to the free list (a block the trie still references stays out —
        LRU eviction, not this, reclaims it)."""
        for b in blocks:
            if b == TRASH_BLOCK or b not in self._ref:
                raise ValueError(f"freeing block {b} not held (double free?)")
            self._ref[b] -= 1
            rc = self._ref[b]
            if rc == 0:
                del self._ref[b]
                self._free.append(b)
            self._changed(b, rc)


class PrefixNode:
    """One FULL block of prompt tokens in the prefix trie. The node's
    path from the root uniquely determines the block's KV content (KV of
    token ``t`` depends on every token before it), so two prompts
    walking the same path can share the same pool block bit-for-bit."""

    __slots__ = ("key", "block", "children", "parent", "last_used")

    def __init__(self, key: Tuple[int, ...], block: int,
                 parent: Optional["PrefixNode"]):
        self.key = key
        self.block = block
        self.children: Dict[Tuple[int, ...], "PrefixNode"] = {}
        self.parent = parent
        self.last_used = 0


class PrefixCache:
    """Shared-prefix block reuse (RadixAttention, arxiv 2312.07104),
    full-block granularity.

    ``match`` maps a new prompt's longest cached full-block prefix into
    its block table (incref per block — the requester becomes a user);
    ``insert`` registers a sequence's freshly-prefilled full prompt
    blocks so LATER requests can reuse them (the trie itself holds one
    reference per cached block). A cached block whose only reference is
    the trie's is *evictable*: eviction is LRU over such leaves (a node
    in use — refcount > 1 — is refused, and since sharing walks root-
    down, an in-use descendant implies in-use ancestors, so leaf-first
    LRU can never strand a live path)."""

    def __init__(self, allocator: BlockAllocator, block_size: int):
        self.allocator = allocator
        self.block_size = block_size
        self._root = PrefixNode((), TRASH_BLOCK, None)
        self._clock = 0
        self._nodes = 0
        # incremental evictable tracking: cached blocks whose only
        # reference is the trie's. Kept current by the allocator's
        # refcount-transition hook so the scheduler's per-tick capacity
        # questions are O(1), not a trie DFS per sequence.
        self._cached_blocks: set = set()
        self._evictable: set = set()
        allocator.on_ref_change = self._ref_changed

    def _ref_changed(self, block: int, rc: int) -> None:
        if block not in self._cached_blocks:
            return
        if rc == 1:
            self._evictable.add(block)
        else:
            self._evictable.discard(block)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    @property
    def cached_blocks(self) -> int:
        return self._nodes

    def match(self, prompt: List[int]) -> Tuple[List[int], int]:
        """Longest cached full-block prefix of ``prompt``: returns the
        pool blocks to map (one incref each — caller must ``free`` them
        if the admission is abandoned) and the token count they cover.
        At least one prompt token is always left to prefill — the final
        chunk must run to produce the first output token."""
        bs = self.block_size
        cap = ((len(prompt) - 1) // bs) * bs
        node = self._root
        blocks: List[int] = []
        t = 0
        stamp = self._tick()
        while t < cap:
            child = node.children.get(tuple(prompt[t:t + bs]))
            if child is None:
                break
            self.allocator.incref(child.block)
            child.last_used = stamp
            blocks.append(child.block)
            node = child
            t += bs
        # hits are counted by the scheduler (prefix_hit_tokens) on
        # successful admission only — a deferred admission must not
        # inflate the hit rate
        return blocks, t

    def insert(self, path_tokens: List[int], block: int,
               parent_blocks: Optional[List[int]] = None) -> bool:
        """Register ``block`` as the cached KV for the last full block of
        ``path_tokens`` (whose length must be a block multiple). Returns
        True when the trie took a reference; False when the path is
        already cached (by this block or a duplicate prefilled
        concurrently — the caller's block simply stays private).

        ``parent_blocks`` (the inserting sequence's own block table):
        when given, every ancestor node must be backed by the SAME pool
        block the sequence maps at that position. This preserves the
        eviction invariant — an in-use descendant implies in-use
        ancestors — which breaks if a sequence that privately
        re-prefilled a duplicate first block hangs its next block under
        the canonical node: that node could drop to refcount 1 (counted
        evictable) while leaf-only eviction can never reach it, and
        ``available_blocks()`` would promise blocks ``evict()`` cannot
        deliver (allocator raise mid-schedule)."""
        bs = self.block_size
        if len(path_tokens) % bs != 0 or not path_tokens:
            raise ValueError(
                f"prefix paths are full blocks only; got {len(path_tokens)} "
                f"tokens at block_size {bs}"
            )
        node = self._root
        for i, t in enumerate(range(0, len(path_tokens) - bs, bs)):
            node = node.children.get(tuple(path_tokens[t:t + bs]))
            if node is None:
                # parent block was never cached (e.g. evicted between the
                # sequence's chunks): an orphan node would claim a prefix
                # whose ancestors can't be mapped — skip the insert
                return False
            if parent_blocks is not None and node.block != parent_blocks[i]:
                # the chain diverged (this sequence holds a private
                # duplicate of an ancestor): registering under the
                # canonical node would let it pin an ancestor this
                # sequence does not map
                return False
        key = tuple(path_tokens[-bs:])
        if key in node.children:
            return False
        child = PrefixNode(key, block, node)
        child.last_used = self._tick()
        node.children[key] = child
        self._cached_blocks.add(block)
        self.allocator.incref(block)  # the cache's own reference
        self._nodes += 1
        return True

    def evictable_count(self) -> int:
        """Blocks reclaimable right now: cached blocks whose only
        reference is the trie's (in-use descendants imply in-use
        ancestors, so every refcount-1 block is cascade-evictable).
        O(1): the set is maintained through the allocator's
        refcount-transition hook."""
        return len(self._evictable)

    def evict(self, n: int) -> int:
        """Reclaim up to ``n`` blocks, LRU over refcount-1 LEAVES
        (cascading: an evicted leaf may expose its parent). Refuses any
        node a sequence still maps (refcount > 1) — eviction must never
        pull a live block out from under a running request. The leaf
        walk only runs under pool pressure (the steady state never
        enters here); the hot capacity question is ``evictable_count``,
        which is O(1)."""
        freed = 0
        while freed < n and self._evictable:
            victim: Optional[PrefixNode] = None
            stack = list(self._root.children.values())
            while stack:
                node = stack.pop()
                if node.children:
                    stack.extend(node.children.values())
                elif node.block in self._evictable and (
                        victim is None or node.last_used < victim.last_used):
                    victim = node
            if victim is None:
                break
            del victim.parent.children[victim.key]
            self._nodes -= 1
            self.allocator.free([victim.block])  # trie ref -> free list
            self._cached_blocks.discard(victim.block)
            freed += 1
        return freed


@dataclasses.dataclass
class SchedulerConfig:
    num_slots: int = 8  # decode-batch rows (the jitted batch size)
    block_size: int = 16  # tokens per KV block
    num_blocks: int = 128  # pool size incl. the trash block
    max_blocks_per_seq: int = 16  # block-table width (jitted shape)
    token_budget: int = 512  # prompt+decode tokens admitted per tick
    # Sarathi-style chunked prefill: prompts stream into the pool in
    # fixed-size chunks that share the tick budget with decode rows (no
    # prompt ever monopolizes a tick); None = legacy whole-prompt
    # prefill through the pow2 bucket ladder
    prefill_chunk: Optional[int] = None
    # shared-prefix block reuse (chunked mode only: whole-prompt mode
    # can't resume a prefill mid-prompt)
    prefix_cache: bool = True

    def __post_init__(self):
        cap = self.max_blocks_per_seq * self.block_size
        if cap < 2:
            raise ValueError("max_blocks_per_seq * block_size must be >= 2")
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1 (or None for whole-prompt "
                f"prefill), got {self.prefill_chunk}"
            )


@dataclasses.dataclass
class Tick:
    """One scheduling decision: which sequences do prefill work this
    tick (the whole prompt, or ONE chunk each under chunked prefill),
    which decode, who got preempted to make room, and which shared
    blocks must be copy-on-write forked (``(src, dst)`` pool block
    pairs the engine copies BEFORE running the tick's programs)."""

    prefills: List[Sequence]
    decodes: List[Sequence]
    preempted: List[Sequence]
    cow_pairs: List[Tuple[int, int]] = dataclasses.field(default_factory=list)


class ContinuousBatchingScheduler:
    """Admission + per-tick prefill/decode mix + preemption policy."""

    def __init__(self, config: SchedulerConfig):
        self.config = config
        self.allocator = BlockAllocator(config.num_blocks)
        # shared-prefix reuse needs chunked prefill (a prefix hit resumes
        # the prefill mid-prompt, which only the chunk path can do)
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.allocator, config.block_size)
            if config.prefix_cache and config.prefill_chunk is not None
            else None
        )
        self.waiting: Deque[Sequence] = deque()
        self.running: Dict[int, Sequence] = {}  # slot -> sequence
        self._free_slots: Deque[int] = deque(range(config.num_slots))
        self.preemption_count = 0
        self.prefix_hit_tokens = 0  # prefill tokens skipped via the trie
        # slots whose sequence left (finish/preempt) since the engine
        # last synced: their decode-batch rows must be zeroed before the
        # next device step, or stale block tables would write into blocks
        # now owned by someone else
        self._freed_slots: List[int] = []

    # ------------------------------------------------------------ intake
    def add_request(self, request: Request) -> Sequence:
        if request.max_new_tokens < 1:
            # prefill emits one token unconditionally; a 0-budget request
            # would receive a token it never asked for
            raise ValueError(
                f"request {request.req_id}: max_new_tokens must be >= 1, "
                f"got {request.max_new_tokens}"
            )
        if not request.prompt:
            raise ValueError(f"request {request.req_id}: empty prompt")
        cap = self.config.max_blocks_per_seq * self.config.block_size
        need = len(request.prompt) + request.max_new_tokens
        if need > cap:
            raise ValueError(
                f"request {request.req_id} needs {need} KV slots but the "
                f"block table holds {cap} "
                f"(max_blocks_per_seq={self.config.max_blocks_per_seq} x "
                f"block_size={self.config.block_size})"
            )
        usable = self.config.num_blocks - 1  # minus the trash block
        if self.blocks_needed(need) > usable:
            raise ValueError(
                f"request {request.req_id} needs "
                f"{self.blocks_needed(need)} blocks at full length but the "
                f"pool holds {usable} — it could never finish"
            )
        seq = Sequence(request=request)
        self.waiting.append(seq)
        return seq

    # ---------------------------------------------------------- accounting
    def blocks_needed(self, num_tokens: int) -> int:
        bs = self.config.block_size
        return (num_tokens + bs - 1) // bs

    def available_blocks(self) -> int:
        """Blocks grantable right now: the free list plus cached prefix
        blocks no sequence maps (LRU-evictable on demand)."""
        extra = (
            self.prefix_cache.evictable_count() if self.prefix_cache else 0
        )
        return self.allocator.free_blocks + extra

    def _take(self, n: int) -> List[int]:
        """Allocate ``n`` blocks, evicting LRU refcount-free prefix
        blocks first when the free list is short (the cache yields to
        live sequences, never the reverse)."""
        short = n - self.allocator.free_blocks
        if short > 0 and self.prefix_cache is not None:
            self.prefix_cache.evict(short)
        return self.allocator.alloc(n)

    # ------------------------------------------------- shared-prefix trie
    def _register_prefix_blocks(self) -> None:
        """Register every running sequence's freshly-prefilled FULL
        prompt blocks in the trie so later prompts can reuse them. Keyed
        by the token path from the root — the only thing the block's KV
        content depends on — so a preempted-and-resumed sequence's
        resume-prompt blocks (prompt + generated) cache correctly too."""
        cache = self.prefix_cache
        if cache is None:
            return
        bs = self.config.block_size
        for seq in self.running.values():
            limit = min(seq.num_cached, seq.prefill_len)
            while seq.cached_upto + bs <= limit:
                end = seq.cached_upto + bs
                cache.insert(
                    seq.resume_prompt[:end], seq.blocks[end // bs - 1],
                    parent_blocks=seq.blocks,
                )
                seq.cached_upto = end

    def _fork_shared_write_blocks(self, seq: Sequence, step: int,
                                  cow_pairs: List[Tuple[int, int]]) -> bool:
        """Copy-on-write: if any block the next ``step`` tokens will be
        written into is shared (refcount > 1 — another sequence's table
        or the prefix trie also maps it), fork it first: allocate a
        private copy, record the (src, dst) pair for the engine's
        device-side block copy, and drop this sequence's reference to
        the shared original. Full-block prefix sharing never writes into
        a shared block (writes land past the shared prefix), so this is
        a safety net that keeps the invariant LOCAL instead of relying
        on every future caller's arithmetic. Returns False when the pool
        can't supply a fork block (caller preempts as usual)."""
        bs = self.config.block_size
        first = seq.num_cached // bs
        last = (seq.num_cached + step - 1) // bs
        for idx in range(first, min(last + 1, len(seq.blocks))):
            src = seq.blocks[idx]
            if self.allocator.refcount(src) <= 1:
                continue
            if self.available_blocks() < 1:
                return False
            dst = self._take(1)[0]
            cow_pairs.append((src, dst))
            self.allocator.free([src])  # this seq's ref on the original
            seq.blocks[idx] = dst
        return True

    # ------------------------------------------------------------- policy
    def schedule(self) -> Tick:
        """One tick's worth of work.

        1. GROW: every running sequence gets the blocks its next tokens
           need — one decode token, or its next prefill CHUNK under
           chunked prefill (blocks are allocated incrementally, not
           reserved for the whole horizon — that is what lets wildly
           different lengths share one pool). On exhaustion the youngest
           running sequence is preempted recompute-style; a sequence that
           cannot grow even after every younger peer is gone preempts
           itself and waits. Oldest-first, so the oldest request always
           progresses — the policy cannot livelock.
        2. CHUNKS (chunked prefill only): every mid-prefill sequence
           streams its next chunk, oldest first, while budget remains;
           the oldest mid-prefill sequence always gets its chunk even on
           a spent budget (it must finish EVENTUALLY), and decode rows
           are charged before any chunk — a long prompt can no longer
           monopolize a tick the way the legacy sole-prefill rule let it.
        3. ADMIT: prefills from the waiting queue while a slot, enough
           pool blocks (first chunk / whole prompt), and token budget
           remain.
        """
        preempted: List[Sequence] = []
        cow_pairs: List[Tuple[int, int]] = []
        chunk = self.config.prefill_chunk
        # freshly-completed full prompt blocks enter the prefix trie
        # BEFORE admission walks it, so a same-tick follower can hit
        self._register_prefix_blocks()

        # --- grow running sequences (oldest first)
        for seq in sorted(self.running.values(),
                          key=lambda s: s.request.req_id):
            if seq.state is not SequenceState.RUNNING:
                continue  # evicted earlier in this very loop
            if chunk is not None and seq.prefilling:
                step = min(chunk, seq.prefill_len - seq.num_cached)
            else:
                step = 1  # a decode row writes its last token's slot
            need = self.blocks_needed(seq.num_cached + step) - len(seq.blocks)
            if need > 0:
                while (need > self.available_blocks()
                       and self._preempt_youngest(seq, preempted)):
                    pass
                if need > self.available_blocks():
                    # every younger peer is gone and the pool is still
                    # full: this sequence yields to its elders until
                    # blocks free up
                    self._preempt(seq, preempted)
                    continue
                seq.blocks.extend(self._take(need))
            # copy-on-write: fork any shared block the scored slots
            # would write into (full-block prefix sharing never places
            # writes there, but the invariant is enforced, not assumed).
            # Pairs collect per-sequence: if the fork fails and the
            # sequence is preempted, its dst blocks just returned to the
            # free list — publishing the pairs would have the engine
            # copy into blocks another admission may own by now.
            seq_pairs: List[Tuple[int, int]] = []
            while not self._fork_shared_write_blocks(seq, step, seq_pairs):
                if not self._preempt_youngest(seq, preempted):
                    self._preempt(seq, preempted)
                    seq_pairs = []
                    break
            cow_pairs.extend(seq_pairs)

        # each surviving decoding sequence decodes one token this tick;
        # mid-prefill rows don't decode (they have no token yet) and are
        # charged per chunk below instead
        decoding = [
            s for s in self.running.values()
            if not (chunk is not None and s.prefilling)
        ]
        budget = self.config.token_budget - len(decoding)

        prefills: List[Sequence] = []
        if chunk is not None:
            # already-running mid-prefill sequences stream their next
            # chunk, oldest first; the first one is never budget-starved
            # (decode rows recur every tick — waiting for a slack tick
            # could starve the prompt forever)
            for seq in sorted(self.running.values(),
                              key=lambda s: s.request.req_id):
                if not seq.prefilling:
                    continue
                if budget <= 0 and prefills:
                    break
                prefills.append(seq)
                budget -= min(chunk, seq.prefill_len - seq.num_cached)

        while self.waiting and self._free_slots and budget > 0:
            # pop the head BEFORE any preemption: evicted victims re-enter
            # at the queue front, and the head must not be displaced by
            # the very sequence evicted on its behalf
            head = self.waiting.popleft()
            prompt_tokens = len(head.resume_prompt)
            matched_blocks: List[int] = []
            matched = 0
            if chunk is not None:
                # shared-prefix reuse: map every cached full block of
                # the prompt into the table — their prefill is already
                # paid; only the tail streams chunks
                if self.prefix_cache is not None:
                    matched_blocks, matched = self.prefix_cache.match(
                        head.resume_prompt
                    )
                # chunked mode admits at the chunk budget: the first
                # chunk runs this tick, the rest stream on later ticks.
                # A chunk that would cross the remaining budget defers to
                # the next tick — unless the tick has no prefill work at
                # all (the progress guarantee; overshoot is then bounded
                # by one chunk, never by a whole prompt)
                admit_tokens = min(chunk, prompt_tokens - matched)
                if admit_tokens > budget and prefills:
                    if matched_blocks:
                        self.allocator.free(matched_blocks)
                    self.waiting.appendleft(head)
                    break
                first_blocks = (
                    self.blocks_needed(matched + admit_tokens)
                    - len(matched_blocks)
                )
            else:
                # an over-budget prompt admits only as the tick's sole
                # prefill (a prompt longer than the whole budget must
                # still run EVENTUALLY; making it wait for an idle tick
                # would starve it)
                if prompt_tokens > budget and prefills:
                    self.waiting.appendleft(head)
                    break
                admit_tokens = prompt_tokens
                first_blocks = self.blocks_needed(prompt_tokens)
            need = first_blocks
            while (need > self.available_blocks()
                   and self._preempt_youngest(head, preempted)):
                pass
            if need > self.available_blocks():
                # pool genuinely full; running decodes will free blocks
                if matched_blocks:
                    self.allocator.free(matched_blocks)
                self.waiting.appendleft(head)
                break
            head.blocks = matched_blocks + self._take(need)
            head.slot = self._free_slots.popleft()
            head.state = SequenceState.RUNNING
            head.num_cached = matched
            head.prefix_cached = matched
            head.cached_upto = matched
            head.prefill_len = prompt_tokens
            self.running[head.slot] = head
            self.prefix_hit_tokens += matched
            prefills.append(head)
            budget -= admit_tokens
        # a preempted victim re-admitted this tick can be evicted AGAIN by
        # a still-older head later in the same loop — drop it from the
        # prefill list (its slot is gone; it waits at the queue front)
        prefills = [s for s in prefills if s.state == SequenceState.RUNNING]
        # decodes: running sequences that were NOT just admitted (their
        # prefill emits this tick's token), are not mid-prefill, and
        # survived preemption
        new = {id(s) for s in prefills}
        decodes = [
            self.running[slot] for slot in sorted(self.running)
            if id(self.running[slot]) not in new
            and not (chunk is not None and self.running[slot].prefilling)
        ]
        return Tick(prefills=prefills, decodes=decodes, preempted=preempted,
                    cow_pairs=cow_pairs)

    def _preempt_youngest(self, for_seq: Sequence,
                          preempted: List[Sequence]) -> bool:
        """Evict the most-recently-admitted running sequence to free
        blocks for ``for_seq``. Never preempts on behalf of a YOUNGER
        request (arrival order is the fairness clock), and never empties
        the running set below one sequence — someone must make progress.
        Returns True when a sequence was evicted."""
        if len(self.running) <= 1:
            return False
        youngest_slot = max(
            self.running, key=lambda s: self.running[s].request.req_id
        )
        victim = self.running[youngest_slot]
        if victim.request.req_id <= for_seq.request.req_id:
            return False
        self._preempt(victim, preempted)
        return True

    def _preempt(self, victim: Sequence, preempted: List[Sequence]) -> None:
        self._evict(victim)
        victim.preemptions += 1
        self.preemption_count += 1
        victim.state = SequenceState.WAITING
        self.waiting.appendleft(victim)  # resumes ahead of colder requests
        preempted.append(victim)

    def _evict(self, seq: Sequence) -> None:
        # drops ONE reference per block: private blocks return to the
        # free list, trie-cached blocks stay resident (LRU-evictable) —
        # a preempted prefix-sharing sequence releases only what it owns
        self.allocator.free(seq.blocks)
        seq.blocks = []
        seq.num_cached = 0
        # prefix_cached survives as a post-mortem stat; a re-admission
        # overwrites it with the fresh match
        seq.cached_upto = 0
        self.running.pop(seq.slot)
        self._free_slots.append(seq.slot)
        self._freed_slots.append(seq.slot)
        seq.slot = None

    def drain_freed_slots(self) -> List[int]:
        """Slots vacated since the last drain (engine zeroes their rows)."""
        out, self._freed_slots = self._freed_slots, []
        return out

    # ------------------------------------------------------------ lifecycle
    def finish(self, seq: Sequence) -> None:
        """Completed sequence: recycle its slot and blocks immediately —
        the freed capacity is admissible in the very next tick."""
        assert seq.state == SequenceState.RUNNING and seq.slot is not None
        self._evict(seq)
        seq.state = SequenceState.FINISHED

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

