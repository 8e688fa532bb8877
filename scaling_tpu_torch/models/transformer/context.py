"""The transformer's run context (counterpart of
scaling_tpu/models/transformer/context.py)."""

from __future__ import annotations

from ...context import BaseContext


class TransformerContext(BaseContext):
    pass
