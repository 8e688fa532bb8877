"""scaling_tpu_torch: the PyTorch/CUDA port of ``scaling_tpu`` for one H100.

The package mirrors ``scaling_tpu``'s layout (``nn/``, ``ops/``,
``models/transformer/``, ``serve/``) so each module's counterpart is easy
to find, and it imports neither JAX nor ``scaling_tpu``. The kernels the
JAX package wrote in Pallas are hand-written for Hopper here
(``csrc/`` for CUDA C++, Triton modules under ``ops/``), each with a
plain PyTorch version beside it that CPU tensors use.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; without a card they raise rather than move to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as a torch.device, defaulting to the card. Asking for
    CUDA where there is none raises: nothing drifts onto the CPU unless
    the caller passed ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "scaling_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions on the CPU"
        )
    return dev
