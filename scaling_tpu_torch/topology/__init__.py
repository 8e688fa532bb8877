"""Topology of a run (counterpart of scaling_tpu/topology/): the config
section and the ranks' layout over ``torch.distributed``."""

from .config import ActivationCheckpointingType, TopologyConfig
from .topology import Topology, choose_backend, init_distributed

__all__ = ["ActivationCheckpointingType", "Topology", "TopologyConfig", "choose_backend",
           "init_distributed"]
