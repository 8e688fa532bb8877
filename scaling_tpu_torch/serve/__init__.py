"""Serving (counterpart of scaling_tpu/serve/): the continuous-batching
scheduler, the block-paged KV pools, the engine with its speculative,
whole-prompt and separate-program modes, the crash-replay request journal
and the load generator (``python -m scaling_tpu_torch.serve bench``)."""

from .engine import (
    MIN_PREFILL_BUCKET,
    EngineConfig,
    ServeEngine,
    install_drain_handler,
    prefill_bucket,
)
from .journal import (
    JournalReplay,
    RequestJournal,
    failover_split,
    journal_path,
    open_journal,
    replay_journal,
    submitted_ids,
)
from .kvcache import PagedKVPools, init_pools, write_prompt_kv
from .scheduler import (
    NGRAM_SCAN_WINDOW,
    Backpressure,
    ContinuousBatchingScheduler,
    Request,
    SchedulerConfig,
    ngram_propose,
)

__all__ = [
    "MIN_PREFILL_BUCKET",
    "NGRAM_SCAN_WINDOW",
    "Backpressure",
    "ContinuousBatchingScheduler",
    "EngineConfig",
    "JournalReplay",
    "PagedKVPools",
    "Request",
    "RequestJournal",
    "SchedulerConfig",
    "ServeEngine",
    "failover_split",
    "init_pools",
    "install_drain_handler",
    "journal_path",
    "ngram_propose",
    "open_journal",
    "prefill_bucket",
    "replay_journal",
    "submitted_ids",
    "write_prompt_kv",
]
