"""Serving (counterpart of scaling_tpu/serve/): the continuous-batching
scheduler, the block-paged KV pools, the engine with its speculative,
whole-prompt and separate-program modes, the crash-replay request journal,
the fleet (:mod:`.router`: N replicas behind a prefix-affinity router;
:mod:`.replica_proc`: replicas as supervised subprocesses with
journal-exact failover and autoscaling) and the load generator (``python
-m scaling_tpu_torch.serve bench``, ``--replicas N`` / ``--replicas-proc
N`` for the fleets)."""

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
from .router import (
    AutoscalePolicy,
    FleetRouter,
    InDoubtAdmit,
    ReplicaHandle,
    ReplicaStats,
    ReplicaUnreachable,
    install_fleet_drain_handler,
)
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
    "AutoscalePolicy",
    "Backpressure",
    "ContinuousBatchingScheduler",
    "EngineConfig",
    "FleetRouter",
    "InDoubtAdmit",
    "JournalReplay",
    "PagedKVPools",
    "ReplicaHandle",
    "ReplicaStats",
    "ReplicaUnreachable",
    "Request",
    "RequestJournal",
    "SchedulerConfig",
    "ServeEngine",
    "failover_split",
    "init_pools",
    "install_drain_handler",
    "install_fleet_drain_handler",
    "journal_path",
    "ngram_propose",
    "open_journal",
    "prefill_bucket",
    "replay_journal",
    "submitted_ids",
    "write_prompt_kv",
]
