"""Kernels K4 and K5 (flash attention forward and backward): the port's
plain versions, through the same ``torch.autograd.Function`` the card
runs, against the JAX ``flash_attention_fused`` (the splash kernel in
interpret mode, inside ``force_flash_interpret`` for the forward and the
gradient tracing alike). The CUDA kernels against the plain versions on
the card are in test_torch_kernels_gpu.py.

f32 throughout. Forward: atol 2e-5 (the JAX package's own flash-vs-XLA
tolerance; the same f32 softmax, another summation order). Gradients of
``sum(out * w)``: atol 5e-4 (the JAX package's flash-grad tolerance).
Cases: MHA; GQA with 2 query heads per KV head; packed segment ids; 2
trailing local heads with window 16 (also at S 256). Beside them, without
a launch, the wrapper's admission rule against the training layer's
routing gate: every shape the gate sends to the flash path is one the
kernels take, and head dims the kernels are not built for (96, 256) go
to the unfused path.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from scaling_tpu.ops.flash_attention import (  # noqa: E402
    flash_attention_fused,
    force_flash_interpret,
)
from scaling_tpu_torch.nn.attention import ParallelSelfAttention  # noqa: E402
from scaling_tpu_torch.nn.masked_softmax import MaskedSoftmaxConfig  # noqa: E402
from scaling_tpu_torch.ops import flash_attention, launches  # noqa: E402

from .test_torch_parity_helpers import route_flash_as_bf16  # noqa: E402
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401

FWD_ATOL = 2e-5
GRAD_ATOL = 5e-4
WINDOW = 16

CASES = {  # b, s, n, n_kv, d, packed, local heads
    "mha": (1, 128, 2, 2, 64, False, 0),
    "gqa": (2, 128, 4, 2, 64, False, 0),
    "gqa-packed": (2, 128, 4, 2, 64, True, 0),
    "gqa-packed-local": (2, 128, 4, 2, 64, True, 2),
    "s256-local": (1, 256, 4, 2, 64, True, 2),
}


def make_inputs(b, s, n, n_kv, d, packed, seed):
    rng = np.random.default_rng(seed)
    q = (0.5 * rng.normal(size=(b, s, n, d))).astype(np.float32)
    k = (0.5 * rng.normal(size=(b, s, n_kv, d))).astype(np.float32)
    v = rng.normal(size=(b, s, n_kv, d)).astype(np.float32)
    w = rng.normal(size=(b, s, n, d)).astype(np.float32)  # the loss weights
    seg = np.zeros((b, s), np.int32)
    if packed:  # three documents in row 0, two in row 1
        seg[0, 37:] = 1
        seg[0, 90:] = 2
        seg[-1, s // 2 + 5:] += 1
    return q, k, v, w, seg


def jax_attention(q, k, v, w, seg, n_local):
    d = q.shape[-1]

    def f(q, k, v):
        return flash_attention_fused(q, k, v, jnp.asarray(seg), causal=True,
                                     sm_scale=d ** -0.5, num_local_heads=n_local,
                                     local_window=WINDOW if n_local else None)

    with force_flash_interpret():
        out = f(q, k, v)
        grads = jax.grad(lambda q, k, v: (f(q, k, v) * w).sum(), argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def port_attention(q, k, v, w, seg, n_local):
    d = q.shape[-1]
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(qt, kt, vt, torch.from_numpy(seg), sm_scale=d ** -0.5,
                          num_local_heads=n_local, local_window=WINDOW if n_local else None)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_kernels_match_splash(case):
    b, s, n, n_kv, d, packed, n_local = CASES[case]
    inputs = make_inputs(b, s, n, n_kv, d, packed, seed=len(case))
    launches.reset()
    out, grads = port_attention(*inputs, n_local)
    assert launches.PLAIN["flash_attention_fwd"] == 1
    assert launches.PLAIN["flash_attention_bwd"] == 1
    assert sum(launches.KERNEL.values()) == 0
    ref_out, ref_grads = jax_attention(*inputs, n_local)
    np.testing.assert_allclose(out, ref_out, atol=FWD_ATOL, rtol=0)
    for name, g, ref in zip(("dq", "dk", "dv"), grads, ref_grads):
        assert g.shape == ref.shape, name
        np.testing.assert_allclose(g, ref, atol=GRAD_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("n_local", [0, 2], ids=["global", "local"])
def test_flash_and_unfused_attention_layer_agree(n_local, monkeypatch):
    """The layer's two training paths, selected by ``masked_softmax.kernel``
    through ``flash_path_active``, compute the same attention (f32, atol
    2e-5: an f32 softmax against the -10000-filled one). The gate sends
    f32 unfused, since K4/K5 take bf16 only; here it routes by shape
    alone, so the flash path runs in f32."""
    route_flash_as_bf16(monkeypatch)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 128, 256)).astype(np.float32))
    pos = torch.arange(128)[None].expand(2, 128)
    seg = torch.from_numpy(make_inputs(2, 128, 4, 2, 64, True, 0)[-1])
    layers = {}
    for kernel in ("torch", "flash_attention"):
        torch.manual_seed(0)
        layer = ParallelSelfAttention(
            256, 4, num_kv_heads=2, masked_softmax_config=MaskedSoftmaxConfig(kernel=kernel),
            num_local_attention_heads=n_local, local_attention_window_size=WINDOW)
        for p in layer.parameters():
            torch.nn.init.normal_(p, std=0.05)
        layers[kernel] = layer
    launches.reset()
    flash = layers["flash_attention"](x, pos, segment_ids=seg)
    assert launches.PLAIN["flash_attention_fwd"] == 1
    unfused = layers["torch"](x, pos, segment_ids=seg)
    assert launches.PLAIN["flash_attention_fwd"] == 1
    torch.testing.assert_close(flash, unfused, atol=FWD_ATOL, rtol=0)


def _kernel_operands(s, d, dtype=torch.bfloat16):
    """Zero operands of the kernels' shapes on the CPU: ``_check_shapes``
    reads only shapes, dtypes, strides and alignment, and launches nothing."""
    q = torch.zeros(1, s, 2, d, dtype=dtype)
    k = torch.zeros(1, s, 1, d, dtype=dtype)
    return q, k, k.clone(), torch.zeros(1, s, dtype=torch.int32)


@pytest.mark.parametrize("model", ["0.5b", "toy", "d64", "d96", "d128", "d256"])
def test_kernels_admit_every_shape_the_flash_path_routes(model):
    """The training layer routes to K4/K5 through ``flash_path_active``;
    the kernels' wrapper admits through ``_check_shapes``. For the head dim
    of each model the train bench ships, and for head dims 64, 96, 128 and
    256, every sequence length up to 8192 that the gate routes to the flash
    path must be one the kernels take, so a change of tile size cannot
    leave a routed shape without a kernel; a head dim the kernels are not
    built for is never routed."""
    from scaling_tpu_torch.nn.attention import flash_path_active
    from scaling_tpu_torch.ops.flash_attention import HEAD_DIMS, _check_shapes
    from scaling_tpu_torch.train.bench import MODELS

    if model.startswith("d"):
        d = int(model[1:])
    else:
        d = MODELS[model]["hidden_size"] // MODELS[model]["num_attention_heads"]
    routed = [s for s in range(64, 8192 + 1, 64)
              if flash_path_active(kernel_is_flash=True, causal=True,
                                   dropout_attention_probs=0.0, deterministic=False,
                                   context_parallel_size=1, seq_len=s, head_dim=d,
                                   dtype=torch.bfloat16)]
    assert bool(routed) == (d in HEAD_DIMS)
    assert all(s % 128 == 0 for s in routed)
    for s in routed:
        assert _check_shapes(*_kernel_operands(s, d), 0, None) == (0, 0), s


@pytest.mark.parametrize("d", [96, 256])
def test_head_dims_without_a_kernel_take_the_unfused_path(d):
    """At head dims K4/K5 are not built for, the gate says False and the
    layer computes attention unfused, launching no flash version at all
    (the JAX package, off the TPU, takes its XLA path at every head dim)."""
    from scaling_tpu_torch.nn.attention import flash_path_active

    assert not flash_path_active(kernel_is_flash=True, causal=True,
                                 dropout_attention_probs=0.0, deterministic=False,
                                 context_parallel_size=1, seq_len=256, head_dim=d,
                                 dtype=torch.bfloat16)
    torch.manual_seed(0)
    layer = ParallelSelfAttention(
        4 * d, 4, num_kv_heads=2,
        masked_softmax_config=MaskedSoftmaxConfig(kernel="flash_attention"))
    for p in layer.parameters():
        torch.nn.init.normal_(p, std=0.05)
    x = torch.randn(1, 128, 4 * d)
    launches.reset()
    out = layer(x, torch.arange(128)[None])
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert sum(launches.PLAIN.values()) == 0 and sum(launches.KERNEL.values()) == 0


@pytest.mark.parametrize("s,d", [(192, 64), (192, 128), (64, 64), (320, 128)])
def test_kernels_admit_multiples_of_64(s, d):
    """The kernels also take sequences that are multiples of 64 but not of
    128 (the card tests run s 192 and s 320)."""
    from scaling_tpu_torch.ops.flash_attention import _check_shapes

    assert _check_shapes(*_kernel_operands(s, d), 2, 16) == (2, 16)


@pytest.mark.parametrize("s,d,dtype,match", [
    (128, 96, torch.bfloat16, "head dim"),
    (100, 64, torch.bfloat16, "multiple"),
    (128, 64, torch.float32, "bfloat16"),
], ids=["head-dim-96", "s-100", "f32"])
def test_kernels_refuse_what_they_cannot_run(s, d, dtype, match):
    from scaling_tpu_torch.ops.flash_attention import _check_shapes

    with pytest.raises(ValueError, match=match):
        _check_shapes(*_kernel_operands(s, d, dtype), 0, None)


def test_explicit_backward_formulas_pass_gradcheck():
    """The plain backward is written by hand (not autograd); in f64 it must
    match finite differences of the plain forward exactly enough for
    ``torch.autograd.gradcheck`` (GQA, three documents, one local head)."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.normal(size=shape)).requires_grad_()
               for shape in ((2, 12, 4, 4), (2, 12, 2, 4), (2, 12, 2, 4)))
    seg = torch.zeros(2, 12, dtype=torch.int32)
    seg[1, 5:] = 1
    seg[1, 9:] = 2
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_attention(q, k, v, seg, sm_scale=0.3, num_local_heads=1,
                                        local_window=3),
        (q, k, v), eps=1e-6, atol=1e-6)
