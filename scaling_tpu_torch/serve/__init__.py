"""Serving (counterpart of scaling_tpu/serve/): the continuous-batching
scheduler, the block-paged KV pools, the engine and the load generator
(``python -m scaling_tpu_torch.serve bench``)."""

from .engine import EngineConfig, ServeEngine
from .kvcache import PagedKVPools, init_pools
from .scheduler import ContinuousBatchingScheduler, Request, SchedulerConfig

__all__ = [
    "ContinuousBatchingScheduler",
    "EngineConfig",
    "PagedKVPools",
    "Request",
    "SchedulerConfig",
    "ServeEngine",
    "init_pools",
]
