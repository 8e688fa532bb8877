"""Per-run state (counterpart of scaling_tpu/context/)."""

from .context import BaseContext

__all__ = ["BaseContext"]
