"""The Triton programs behind ``ops.rms_norm_bwd`` (imported at first launch).

They replace the TPU kernel of ``rms_norm_fused``'s backward, ``_rms_bwd``
with its Pallas body ``_bwd_kernel`` in ``scaling_tpu/ops/rms_norm.py``.
Why Triton serves here: the backward is two row reductions (the mean of
squares and ``mean(g*w*x)``), an elementwise pass for ``dx`` and a column
reduction for ``dw``. It needs no tensor cores and no traffic between
programs beyond the ``dw`` partials, which is the case the Triton route
is for. It is bound by bytes: read x and g, write dx (the partials are
small).

``_rms_norm_bwd`` gives each program a contiguous range of whole rows,
walked ``BLOCK_R`` rows at a time: it recomputes ``r = rsqrt(mean(x^2) +
eps)``, writes ``dx = r*g*w - x*r^3*mean(g*w*x)`` in x's dtype, and sums
``g*x*r`` over its rows into one f32 row of a ``(programs, d)`` partial.
The TPU kernel accumulates ``dw`` across its sequential grid; Hopper's
programs run in no order, so ``_sum_partials`` adds the partials in a
second pass, each column in a fixed order: no atomics, and ``dw`` is
bitwise identical from run to run. It is written in w's dtype.
"""

from __future__ import annotations

import torch
import triton
import triton.language as tl


@triton.jit
def _rms_norm_bwd(x_ptr, w_ptr, g_ptr, dx_ptr, part_ptr, n_rows, d, stride_x, stride_g,
                  stride_dx, rows_per_program, eps,
                  BLOCK_R: tl.constexpr, BLOCK_D: tl.constexpr):
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK_D)
    col_ok = cols < d
    w = tl.load(w_ptr + cols, mask=col_ok, other=0.0).to(tl.float32)
    acc = tl.zeros([BLOCK_D], dtype=tl.float32)
    first = pid * rows_per_program
    for r0 in range(first, first + rows_per_program, BLOCK_R):
        rows = r0 + tl.arange(0, BLOCK_R)
        mask = (rows < n_rows)[:, None] & col_ok[None, :]
        x = tl.load(x_ptr + rows[:, None] * stride_x + cols[None, :], mask=mask,
                    other=0.0).to(tl.float32)
        g = tl.load(g_ptr + rows[:, None] * stride_g + cols[None, :], mask=mask,
                    other=0.0).to(tl.float32)
        r = tl.rsqrt(tl.sum(x * x, axis=1) / d + eps)
        gw = g * w[None, :]
        mean_gwx = tl.sum(gw * x, axis=1) / d
        dx = r[:, None] * gw - x * (r * r * r)[:, None] * mean_gwx[:, None]
        tl.store(dx_ptr + rows[:, None] * stride_dx + cols[None, :],
                 dx.to(dx_ptr.dtype.element_ty), mask=mask)
        acc += tl.sum(g * x * r[:, None], axis=0)
    tl.store(part_ptr + pid * d + cols, acc, mask=col_ok)


@triton.jit
def _sum_partials(part_ptr, dw_ptr, n_parts, d,
                  BLOCK_P: tl.constexpr, BLOCK_D: tl.constexpr):
    pid = tl.program_id(0)
    cols = pid * BLOCK_D + tl.arange(0, BLOCK_D)
    col_ok = cols < d
    acc = tl.zeros([BLOCK_D], dtype=tl.float32)
    for p0 in range(0, n_parts, BLOCK_P):
        parts = p0 + tl.arange(0, BLOCK_P)
        mask = (parts < n_parts)[:, None] & col_ok[None, :]
        acc += tl.sum(tl.load(part_ptr + parts[:, None] * d + cols[None, :], mask=mask,
                              other=0.0), axis=0)
    tl.store(dw_ptr + cols, acc.to(dw_ptr.dtype.element_ty), mask=col_ok)


def block_rows(d: int) -> int:
    """Rows per step of a program: about 4K elements of a tile."""
    return max(1, min(16, 4096 // triton.next_power_of_2(d)))


def programs_for(n: int, d: int, device: torch.device) -> tuple:
    """(programs, rows per program): about four programs per SM, each a
    multiple of ``block_rows`` rows, so the partials stay small."""
    br = block_rows(d)
    target = 4 * torch.cuda.get_device_properties(device).multi_processor_count
    per = triton.cdiv(triton.cdiv(n, target), br) * br
    return triton.cdiv(n, per), per


def launch(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, dx: torch.Tensor,
           dw: torch.Tensor, eps: float) -> None:
    """dx and dw of ``rmsnorm(x) * w`` for the rows of the 2-D ``x`` and ``g``."""
    n, d = x.shape
    programs, per = programs_for(n, d, x.device)
    partials = torch.empty(programs, d, dtype=torch.float32, device=x.device)
    bd = triton.next_power_of_2(d)
    _rms_norm_bwd[(programs,)](
        x, w, g, dx, partials, n, d, x.stride(0), g.stride(0), dx.stride(0), per, eps,
        BLOCK_R=block_rows(d), BLOCK_D=bd, num_warps=8,
    )
    _sum_partials[(triton.cdiv(d, 128),)](
        partials, dw, programs, d, BLOCK_P=64, BLOCK_D=128, num_warps=4,
    )
