"""Kernels K2 and K3 (RMSNorm forward and backward): the port's plain
versions against the JAX Pallas kernel ``rms_norm_fused`` and its VJP in
interpret mode (the kernels against the plain versions on the card are in
test_torch_kernels_gpu.py); the backward's dx-only variant for a frozen
gain; and K3's launch plan, a pure function of the shapes.

f32: atol 1e-6 (the same f32 statistics; summation order only). bf16
inputs are compared after casting both outputs to f32, at one bf16
rounding (atol 1e-2 for values of order one). Row counts that do not
divide the TPU kernel's 256-row block are included. The backward in f32:
dx atol 1e-5 and dw atol 1e-4 (dw sums up to 520 rows of products of
order one, in another order than the TPU kernel's sequential grid).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from scaling_tpu.ops.rms_norm import force_rms_interpret, rms_norm_fused  # noqa: E402
from scaling_tpu_torch.nn.norm import RMSNorm  # noqa: E402
from scaling_tpu_torch.ops import RMSNormFunction, launches, rms_norm, rms_norm_bwd  # noqa: E402
from scaling_tpu_torch.ops.rms_norm import (  # noqa: E402
    CONSUMER_WARPS,
    MAX_FINISHERS,
    MAX_STAGES,
    RING_HEADER,
    SMEM_PER_BLOCK,
    STAGE_BYTES,
    STATIC_SMEM,
    plan_bwd,
)

EPS = 1e-5


def jax_rms(x, w):
    with force_rms_interpret():
        return np.asarray(rms_norm_fused(jnp.asarray(x), jnp.asarray(w), EPS))


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("rows", [1, 7, 300])
def test_plain_matches_pallas_kernel_f32(d, rows):
    rng = np.random.default_rng(d + rows)
    x = (3.0 * rng.normal(size=(rows, d))).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    launches.reset()
    out = rms_norm(torch.from_numpy(x), torch.from_numpy(w), EPS)
    np.testing.assert_allclose(out.numpy(), jax_rms(x, w), atol=1e-6, rtol=0)
    assert launches.PLAIN["rms_norm"] == 1 and launches.KERNEL["rms_norm"] == 0


@pytest.mark.parametrize("d", [128, 256])
def test_plain_matches_pallas_kernel_bf16(d):
    rng = np.random.default_rng(d)
    x = rng.normal(size=(2, 9, d)).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = jax_rms(xb, jnp.asarray(w, jnp.bfloat16)).astype(np.float32)
    out = rms_norm(torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16(),
                   torch.from_numpy(w).bfloat16(), EPS)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    np.testing.assert_allclose(out.float().numpy(), ref, atol=1e-2, rtol=0)


def test_norm_module_fused_and_torch_paths_agree():
    """``optimization_type: fused`` (K2) and ``torch`` (plain ops) are the
    same function."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(5, 256)).astype(np.float32))
    fused, plain = RMSNorm(256, EPS, fused=True), RMSNorm(256, EPS, fused=False)
    with torch.no_grad():
        fused.weight.uniform_(0.5, 1.5)
        plain.weight.copy_(fused.weight)
    torch.testing.assert_close(fused(x), plain(x), atol=1e-6, rtol=0)


def jax_rms_vjp(x, w, g):
    with force_rms_interpret():
        _, vjp = jax.vjp(lambda xx, ww: rms_norm_fused(xx, ww, EPS), jnp.asarray(x),
                         jnp.asarray(w))
        dx, dw = vjp(jnp.asarray(g))
    return np.asarray(dx), np.asarray(dw)


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("rows", [7, 300, 520])  # 300: blocks of 1 row; 520: 8 of 65
def test_plain_bwd_matches_pallas_vjp_f32(d, rows):
    rng = np.random.default_rng(3 * d + rows)
    x = (3.0 * rng.normal(size=(rows, d))).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    g = rng.normal(size=(rows, d)).astype(np.float32)
    launches.reset()
    dx, dw = rms_norm_bwd(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g), EPS)
    assert launches.PLAIN["rms_norm_bwd"] == 1 and launches.KERNEL["rms_norm_bwd"] == 0
    ref_dx, ref_dw = jax_rms_vjp(x, w, g)
    np.testing.assert_allclose(dx.numpy(), ref_dx, atol=1e-5, rtol=0)
    np.testing.assert_allclose(dw.numpy(), ref_dw, atol=1e-4, rtol=0)


def test_bwd_returns_dw_in_the_weights_dtype_bf16():
    """dx in x's dtype and dw accumulated in f32 but returned in w's dtype,
    as the TPU kernel does (bf16 values compared after one rounding)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 11, 256)).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=(256,))).astype(np.float32)
    g = rng.normal(size=(3, 11, 256)).astype(np.float32)
    xb, wb, gb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, g))
    ref_dx, ref_dw = jax_rms_vjp(xb, wb, gb)
    tx, tw, tg = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
                  for a in (xb, wb, gb))
    dx, dw = rms_norm_bwd(tx, tw, tg, EPS)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.bfloat16 and dw.shape == (256,)
    np.testing.assert_allclose(dx.float().numpy(), ref_dx.astype(np.float32), atol=2e-2)
    np.testing.assert_allclose(dw.float().numpy(), ref_dw.astype(np.float32),
                               atol=1e-2 * np.abs(ref_dw.astype(np.float32)).max())


def test_norm_function_gradients_match_the_torch_path():
    """The fused module's autograd Function (K2 forward, K3 backward) and
    the plain-ops ``torch`` path under autograd give the same gradients
    (f32, atol 1e-4: dw sums 24 rows in another order)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 6, 256)).astype(np.float32)
    w = torch.from_numpy((1.0 + 0.1 * rng.normal(size=(256,))).astype(np.float32))
    grads = []
    for fused in (True, False):
        norm = RMSNorm(256, EPS, fused=fused)
        with torch.no_grad():
            norm.weight.copy_(w)
        xt = torch.from_numpy(x).requires_grad_()
        (norm(xt) ** 2).sum().backward()
        grads.append((xt.grad, norm.weight.grad))
    for fused_g, torch_g in zip(*grads):
        torch.testing.assert_close(fused_g, torch_g, atol=1e-4, rtol=1e-5)


def test_frozen_gain_takes_the_dx_only_backward(monkeypatch):
    """A gain that needs no gradient: the Function's backward asks for the
    dx-only variant and returns None for the gain, and its dx is bitwise the
    full backward's and within 1e-5 of ``jax.vjp`` of the Pallas kernel
    (interpret mode) with respect to x (f32, seeded inputs)."""
    rng = np.random.default_rng(11)
    x = (3.0 * rng.normal(size=(3, 40, 256))).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=(256,))).astype(np.float32)
    g = rng.normal(size=(3, 40, 256)).astype(np.float32)
    xt, frozen, gt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w), torch.from_numpy(g)
    handed_back = []
    backward = RMSNormFunction.backward

    def spy(ctx, grad):
        out = backward(ctx, grad)
        handed_back.append(out[1])
        return out

    monkeypatch.setattr(RMSNormFunction, "backward", staticmethod(spy))
    (dx,) = torch.autograd.grad(RMSNormFunction.apply(xt, frozen, EPS), (xt,), gt)
    assert handed_back == [None]
    full_dx, full_dw = rms_norm_bwd(xt.detach(), frozen, gt, EPS)
    only_dx, none = rms_norm_bwd(xt.detach(), frozen, gt, EPS, need_dw=False)
    assert full_dw is not None and none is None
    assert torch.equal(dx, full_dx) and torch.equal(only_dx, full_dx)
    with force_rms_interpret():
        _, vjp = jax.vjp(lambda xx: rms_norm_fused(xx, jnp.asarray(w), EPS), jnp.asarray(x))
        (ref_dx,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", [128, 2048, 8192, 32768])
@pytest.mark.parametrize("n", [1, 7, 333, 8191, 8192, 65536])
def test_bwd_plan_covers_every_row_once(n, d):
    """K3's launch plan (a pure function of the shapes): the bands cover
    rows 0..n-1 each exactly once, the ring and its header fit the 227 KB a
    block can use, the rows split evenly among the warps with at most 256
    bytes of x and g a lane, and rows too wide for a 64 KB stage take the
    chunked walk, in bf16, f32 and mixed x / g dtypes; on an H100's 132 SMs
    and on a smaller card."""
    for x_bytes, g_bytes in ((2, 2), (4, 4), (2, 4)):
        for sms in (132, 8):
            plan = plan_bwd(n, d, x_bytes, g_bytes, sms)
            bands = plan.bands(n)
            assert bands[0][0] == 0 and bands[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
            assert all(stop >= start for start, stop in bands)
            assert 1 <= plan.grid <= sms and 1 <= plan.finishers <= MAX_FINISHERS
            assert 2 * plan.finishers - 1 <= plan.grid or plan.finishers == 1
            row_bytes = d * (x_bytes + g_bytes)
            if row_bytes > STAGE_BYTES:
                assert plan.wide and plan.smem_bytes == 0
                continue
            assert not plan.wide and 2 <= plan.stages <= MAX_STAGES
            assert plan.rows_per_stage * plan.warps_per_row == CONSUMER_WARPS
            assert d % plan.warps_per_row == 0
            assert d // plan.warps_per_row * (x_bytes + g_bytes) <= 32 * 256
            stage = plan.rows_per_stage * row_bytes
            assert stage <= STAGE_BYTES
            assert plan.smem_bytes == RING_HEADER + 4 * d + plan.stages * stage
            assert plan.smem_bytes + STATIC_SMEM <= SMEM_PER_BLOCK
            # every band is cut into whole stages of rows_per_stage rows
            assert plan.grid == max(1, min(sms, -(-n // plan.rows_per_stage)))


def test_bwd_plan_at_the_training_rows():
    """(8192, 2048) bf16 on an H100: 132 blocks of 62-63 rows, 8 rows of
    4 KB a stage (one warp a row), two 64 KB stages, 64 finishers, and
    f32 partials of 1.1 MB."""
    plan = plan_bwd(8192, 2048, 2, 2, 132)
    assert (plan.grid, plan.rows_per_stage, plan.warps_per_row, plan.stages,
            plan.finishers) == (132, 8, 1, 2, 64)
    assert {stop - start for start, stop in plan.bands(8192)} == {62, 63}
    assert plan.partial_bytes(2048) == 132 * 2048 * 4
