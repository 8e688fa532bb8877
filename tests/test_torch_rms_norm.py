"""Kernel K2 (RMSNorm forward): the port's plain version against the JAX
Pallas kernel ``rms_norm_fused`` in interpret mode (the Triton kernel
against the plain version on the card is in test_torch_kernels_gpu.py).

f32: atol 1e-6 (the same f32 statistics; summation order only). bf16
inputs are compared after casting both outputs to f32, at one bf16
rounding (atol 1e-2 for values of order one). Row counts that do not
divide the TPU kernel's 256-row block are included.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from scaling_tpu.ops.rms_norm import force_rms_interpret, rms_norm_fused  # noqa: E402
from scaling_tpu_torch.nn.norm import RMSNorm  # noqa: E402
from scaling_tpu_torch.ops import launches, rms_norm  # noqa: E402

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
