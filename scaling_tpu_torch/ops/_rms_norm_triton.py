"""The Triton program behind ``ops.rms_norm`` (imported at first launch).

One program normalises a block of ``BLOCK_R`` whole rows: it loads them
once, takes the mean of squares in f32, and writes ``x * r * w`` in the
output's dtype. ``BLOCK_D`` is the row width rounded up to a power of
two, masked at the ragged edge.
"""

from __future__ import annotations

import torch
import triton
import triton.language as tl


@triton.jit
def _rms_norm_fwd(x_ptr, w_ptr, y_ptr, n_rows, d, stride_x, stride_y, eps,
                  BLOCK_R: tl.constexpr, BLOCK_D: tl.constexpr):
    pid = tl.program_id(0)
    rows = pid * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.arange(0, BLOCK_D)
    row_ok = rows < n_rows
    col_ok = cols < d
    mask = row_ok[:, None] & col_ok[None, :]
    x = tl.load(x_ptr + rows[:, None] * stride_x + cols[None, :], mask=mask,
                other=0.0).to(tl.float32)
    r = tl.rsqrt(tl.sum(x * x, axis=1) / d + eps)
    w = tl.load(w_ptr + cols, mask=col_ok, other=0.0).to(tl.float32)
    y = x * r[:, None] * w[None, :]
    tl.store(y_ptr + rows[:, None] * stride_y + cols[None, :],
             y.to(y_ptr.dtype.element_ty), mask=mask)


def block_rows(d: int) -> int:
    """Rows per program: about 8K elements of a tile, at least one row."""
    return max(1, min(16, 8192 // triton.next_power_of_2(d)))


def launch(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor, eps: float) -> None:
    """``y[i] = rmsnorm(x[i]) * w`` for the rows of the 2-D ``x``."""
    n, d = x.shape
    br = block_rows(d)
    _rms_norm_fwd[(triton.cdiv(n, br),)](
        x, w, y, n, d, x.stride(0), y.stride(0), eps,
        BLOCK_R=br, BLOCK_D=triton.next_power_of_2(d), num_warps=4,
    )
