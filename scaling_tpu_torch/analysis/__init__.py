"""Static analysis of the port (counterpart of ``scaling_tpu/analysis/``).

Two complementary gates over the port's training and serving paths:

- ``lint``: AST rules over ``scaling_tpu_torch/`` source — host syncs in
  kernel wrappers and autograd Functions, generator reuse, the precision
  policy, swallowed exceptions, and the whole-program rules over one call
  graph (cross-thread races, device syncs on the step and tick hot paths,
  unguarded I/O, the control-plane and RPC protocol). Rule IDs are the
  JAX package's (``STA001``..``STA016``); suppress per line with
  ``# sta: disable=STA003``.
- ``audit`` (``dispatch_audit``): one step of a section run under a
  ``TorchDispatchMode`` — the aten op inventory, bf16->f32 upcasts
  feeding matmuls, host syncs, RNG ops, the kernel launches and plain
  runs, and the shapes the scheduler produces — pinned against goldens.

CLI: ``python -m scaling_tpu_torch.analysis [lint|audit|protocol|all]``.

Importing this package imports no torch: the lint is stdlib ``ast``.
"""

from __future__ import annotations

__all__ = ["main", "lint_paths", "Finding", "RULES"]


def main(argv=None) -> int:
    from .cli import main as _main

    return _main(argv)


def __getattr__(name):
    # lazy re-exports so the package import stays light
    if name in ("lint_paths", "Finding", "RULES"):
        from . import lint as _lint

        return getattr(_lint, name)
    raise AttributeError(name)
