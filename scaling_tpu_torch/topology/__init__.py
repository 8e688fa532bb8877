"""Topology of a run (counterpart of scaling_tpu/topology/): one device."""

from .config import ActivationCheckpointingType, TopologyConfig

__all__ = ["ActivationCheckpointingType", "TopologyConfig"]
