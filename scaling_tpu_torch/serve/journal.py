"""Crash-replay request journal (the port's copy of
scaling_tpu/serve/journal.py: the same record kinds and fields, so each
package replays the other's journal; docs/SERVING.md "Resilience").

The serving engine has no checkpoint: its durable state is the REQUEST
STREAM, and everything else (KV pools, block tables, slots) is
recomputable from it. The journal records exactly that stream — one
JSON line per submission (prompt + sampling parameters + deadlines),
per tick's emitted tokens, and per terminal status — through the same
single-``write(2)`` O_APPEND appender the metrics sink uses
(``logging.append_jsonl_line``), so a SIGKILL at any instant leaves at
worst one torn tail line, never an unparseable journal.

Recovery is recompute-style, like scheduler preemption: a supervised
relaunch (``serve bench --resume`` under ``--restarts``) replays the
journal, re-enqueues every request with no terminal status — SAME
``req_id``, SAME prompt, SAME sampling params — and the engine
regenerates their outputs from scratch. Token-for-token identity with
the crashed run (and with a fault-free run) holds by construction, not
by luck: every sample draws with the (request id, token position) key
(``inference.request_uniforms``: a counter hash of the seed, the
request and the position), so position ``i`` of request ``r``
is the same draw in every process that ever computes it — greedy or
sampled, crashed or not. Requests that already finished are NOT
re-enqueued; their journaled tokens are the delivered output. A
``timeout`` status is terminal too — replaying a request that already
missed its deadline would burn capacity on an answer nobody is waiting
for.

Every append fires the ``serve.journal`` fault point
(``SCALING_TPU_FAULTS``) so tests can kill/fail at an exact record.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

from ..logging.logger import append_jsonl_line
from ..resilience.faults import get_fault_plan

# journal record kinds (the "kind" field of each JSON line)
SUBMIT = "serve-submit"
TOKENS = "serve-tokens"
FINISH = "serve-finish"
SHED = "serve-shed"


class RequestJournal:
    """Append-only request journal; one writer per engine process."""

    def __init__(self, path):
        self.path = str(path)
        Path(self.path).parent.mkdir(parents=True, exist_ok=True)

    def _append(self, rec: dict) -> None:
        get_fault_plan().fire("serve.journal", path=self.path)
        append_jsonl_line(self.path, json.dumps(rec, sort_keys=True))

    def record_submit(self, request) -> None:
        """The full replay recipe for one request: everything ``submit``
        needs to re-enqueue it bit-identically (the req_id is the
        sampler-key fold, so it MUST survive the crash)."""
        self._append({
            "kind": SUBMIT,
            "req": request.req_id,
            "prompt": [int(t) for t in request.prompt],
            "max_new_tokens": request.max_new_tokens,
            "eos_token_id": request.eos_token_id,
            "temperature": request.temperature,
            "top_k": request.top_k,
            "top_p": request.top_p,
            "deadline_ms": request.deadline_ms,
            "ttft_deadline_ms": request.ttft_deadline_ms,
            # trace identity survives the crash with the replay recipe:
            # the failover re-dispatch adopts it so the survivor's work
            # lands on the ORIGINAL request's trace
            "trace": getattr(request, "trace_id", None),
        })

    def record_tokens(self, req_id: int, tokens: List[int]) -> None:
        """One tick's newly emitted tokens for a request (batched per
        tick, not per token — a decode tick with 8 rows is 8 appends,
        not 8 x tokens)."""
        if not tokens:
            return
        self._append({
            "kind": TOKENS, "req": req_id,
            "toks": [int(t) for t in tokens],
        })

    def record_tokens_batch(self, batches: Dict[int, List[int]]) -> None:
        """EVERY row's tick tokens in ONE append: same per-request
        record lines, one ``write(2)``. A tick that appended 12 separate
        lines paid 12 GIL release/re-acquire round-trips — in the
        threaded fleet each re-acquire can wait a whole switch interval
        behind a peer replica's tick, and the convoy quadrupled tick
        counts. One syscall keeps the journal off the critical path."""
        lines = [
            json.dumps(
                {"kind": TOKENS, "req": int(rid),
                 "toks": [int(t) for t in toks]},
                sort_keys=True,
            )
            for rid, toks in sorted(batches.items()) if toks
        ]
        if not lines:
            return
        get_fault_plan().fire("serve.journal", path=self.path)
        append_jsonl_line(self.path, "\n".join(lines))

    def record_finish(self, req_id: int, status: str,
                      tokens: Optional[List[int]] = None) -> None:
        """Terminal status — with ``tokens``, the request's final token
        batch rides the SAME append (one write per retirement, not
        two)."""
        recs = []
        if tokens:
            recs.append({
                "kind": TOKENS, "req": req_id,
                "toks": [int(t) for t in tokens],
            })
        recs.append({"kind": FINISH, "req": req_id, "status": status})
        get_fault_plan().fire("serve.journal", path=self.path)
        append_jsonl_line(
            self.path,
            "\n".join(json.dumps(r, sort_keys=True) for r in recs),
        )

    def record_shed(self, reason: str) -> None:
        """An overload-shed submission consumed a client offer without
        producing a request: the bench's resume path must skip the
        corresponding workload item (the client was told Backpressure;
        re-offering it after a crash would double-serve its successors
        and silently resurrect a rejection)."""
        self._append({"kind": SHED, "reason": reason})


@dataclasses.dataclass
class JournalReplay:
    """The journal, folded into per-request state. A request
    re-submitted after a crash (its id appears in a LATER submit record)
    resets its token tally — replay regenerates the output from scratch,
    and only the freshest generation is the output."""

    submits: Dict[int, dict]  # req_id -> latest submit record
    tokens: Dict[int, List[int]]  # req_id -> tokens since latest submit
    status: Dict[int, Optional[str]]  # None = still in flight at crash
    shed_count: int = 0  # overload-shed submissions (offered, rejected)
    bad_lines: int = 0  # torn tail from a SIGKILL mid-append

    @property
    def submitted_count(self) -> int:
        """Distinct requests ever submitted (admitted into the engine)."""
        return len(self.submits)

    @property
    def offered_count(self) -> int:
        """Workload items CONSUMED by the crashed run(s): admitted
        submissions plus overload sheds (each shed record is one offer
        the engine rejected — replayed force-admissions never shed, so
        the sum maps 1:1 onto the bench's arrival-ordered workload
        prefix)."""
        return len(self.submits) + self.shed_count

    @property
    def next_req_id(self) -> int:
        return max(self.submits, default=-1) + 1

    @property
    def incomplete(self) -> List[dict]:
        """Submit records to re-enqueue, in request order. Timeouts are
        terminal: a request that missed its deadline is not replayed."""
        return [
            self.submits[r] for r in sorted(self.submits)
            if self.status.get(r) is None
        ]

    @property
    def timeout_count(self) -> int:
        """Requests that hit their deadline in the crashed run(s) —
        terminal, not replayed, but still part of the run dir's story
        (the resumed run folds them into its summary's gate fields)."""
        return sum(1 for s in self.status.values() if s == "timeout")

    @property
    def completed(self) -> Dict[int, List[int]]:
        """req_id -> delivered output tokens, for requests with a
        ``completed`` terminal status."""
        return {
            r: self.tokens[r] for r in sorted(self.submits)
            if self.status.get(r) == "completed"
        }


def journal_path(base_path, replica_id: Optional[int] = None) -> Path:
    """The journal file for one engine: the base path itself for a
    single-engine run, ``<stem>_r<id><suffix>`` for fleet replica
    ``id``. Namespacing per replica is what lets a fleet ``--resume``
    replay each replica's incomplete requests from its OWN stream —
    one shared file would interleave N writers (torn lines beyond the
    single-writer O_APPEND guarantee) and collide their tallies."""
    p = Path(base_path)
    if replica_id is None:
        return p
    return p.with_name(f"{p.stem}_r{int(replica_id)}{p.suffix}")


def open_journal(path, resume: bool, replica_id: Optional[int] = None):
    """The bench's journal lifecycle: returns ``(journal, replay)``.

    ``resume=True`` folds the existing journal FIRST (the crashed
    run's records) and keeps appending to it. ``resume=False`` is a
    FRESH run: any stale journal from a previous drill in the same run
    dir is truncated — the appender is O_APPEND by design (SIGKILL
    safety), so without this a later ``--resume`` would replay the
    previous run's request stream into the new workload.

    ``replica_id`` namespaces the file per fleet replica
    (:func:`journal_path`) so N engine writers never share a stream."""
    p = journal_path(path, replica_id)
    replay = None
    if resume:
        replay = replay_journal(p)
    elif p.exists():
        p.unlink()
    return RequestJournal(p), replay


def failover_split(path):
    """Harvest a DEAD replica's journal for fleet failover: returns
    ``(completed, incomplete, timeout_count)`` — delivered outputs
    (req_id -> tokens) the supervisor folds straight into the run's
    results, submit records to re-dispatch to SURVIVORS (original
    req_ids + ``force=True`` keep the (request, position) sampler keys,
    so any replica regenerates the same tokens), and the dead replica's
    terminal timeouts (counted, never replayed). One named seam so the
    failover policy is unit-testable against a literal journal file."""
    rep = replay_journal(path)
    return rep.completed, rep.incomplete, rep.timeout_count


def submitted_ids(path) -> set:
    """Req ids with a submit record in ``path`` — the admission arbiter
    for in-doubt RPCs: a submit whose reply was lost in a partition was
    admitted iff the (dead) replica's journal carries its record. The
    supervisor consults this at failover so an in-doubt request is
    re-dispatched EXACTLY once — via journal replay when it was admitted,
    via the router's parked copy when it never was."""
    return set(replay_journal(path).submits)


def replay_journal(path) -> JournalReplay:
    """Parse a journal (tolerant of one torn tail line — the SIGKILL
    signature) into :class:`JournalReplay`."""
    replay = JournalReplay(submits={}, tokens={}, status={})
    p = Path(path)
    if not p.is_file():
        return replay
    from ..resilience.guards import retry_io

    # the crash-recovery read itself rides the bounded-retry layer: a
    # flaky shared mount at relaunch time must not turn a recoverable
    # crash into a lost request stream
    journal_text = retry_io(p.read_text, what="request journal replay read")
    for line in journal_text.splitlines():
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            replay.bad_lines += 1
            continue
        kind = rec.get("kind")
        if kind == SUBMIT:
            rid = int(rec["req"])
            replay.submits[rid] = rec
            replay.tokens[rid] = []  # a re-submission restarts the tally
            replay.status[rid] = None
        elif kind == TOKENS and int(rec.get("req", -1)) in replay.submits:
            replay.tokens[int(rec["req"])].extend(
                int(t) for t in rec.get("toks", ())
            )
        elif kind == FINISH and int(rec.get("req", -1)) in replay.submits:
            replay.status[int(rec["req"])] = rec.get("status")
        elif kind == SHED:
            replay.shed_count += 1
        else:
            replay.bad_lines += 1
    return replay
