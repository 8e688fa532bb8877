"""The port's kernels on the card (marked ``gpu``; they skip without an
sm_90 CUDA device). Run there with
``python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py``
(``--noconftest``: the card's machine has no JAX, which the repository's
conftest imports).

Each kernel against its plain version on the same CUDA tensors. f32: atol
1e-5 (summation order only). bf16: atol and rtol 1e-2, one rounding of
the output. The flash kernels (bf16 only) take P and dS into their
products as bf16, so their gradients are held at 2e-2 of the largest
reference value; their lse (f32 from the same bf16 products) at 1e-3.
The flash backward and the RMSNorm backward's dw must repeat bitwise.
And the toy model served on the card in f32 gives the CPU run's greedy
tokens, through the kernels only.
"""

import pytest
import torch

from scaling_tpu_torch.nn.attention import kv_quantize_int8
from scaling_tpu_torch.ops import (
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_plain,
    launches,
    paged_attention,
    paged_attention_plain,
    rms_norm,
    rms_norm_bwd,
    rms_norm_bwd_plain,
    rms_norm_plain,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU tests cover the plain versions")
    cap = torch.cuda.get_device_capability()
    if cap != (9, 0):
        pytest.skip(f"needs compute capability 9.0 (sm_90a build), found {cap}")
    return torch.device("cuda")


def tol(dtype):
    return 1e-5 if dtype == torch.float32 else 1e-2


@pytest.mark.parametrize("quantized", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("h,n,n_kv,s,bs", [
    (64, 4, 2, 8, 4), (128, 16, 4, 32, 16), (128, 8, 8, 1, 16), (64, 4, 1, 40, 8),
])
def test_paged_attention_kernel_matches_plain(card, quantized, dtype, h, n, n_kv, s, bs):
    gen = torch.Generator(device=card)
    gen.manual_seed(h + n + s + bs)
    rows, num_blocks, max_blocks = 5, 64, 16
    q = torch.randn(rows, s, n, h, generator=gen, device=card).to(dtype)
    pk = torch.randn(num_blocks, bs, n_kv, h, generator=gen, device=card)
    pv = torch.randn(num_blocks, bs, n_kv, h, generator=gen, device=card)
    ctx = torch.tensor([0, 0, 3, 17, max_blocks * bs - s], device=card)
    new = torch.tensor([0, 1, s, min(s, 5), s], device=card)
    valid = ctx + new
    nblk = (valid + bs - 1) // bs
    table = torch.randint(1, num_blocks, (rows, max_blocks), generator=gen, device=card)
    table = torch.where(torch.arange(max_blocks, device=card)[None] < nblk[:, None], table, 0)
    kw = dict(sm_scale=h ** -0.5, num_repeat_kv=n // n_kv)
    if quantized:
        (pk, kw["scale_k"]), (pv, kw["scale_v"]) = kv_quantize_int8(pk), kv_quantize_int8(pv)
    else:
        pk, pv = pk.to(dtype), pv.to(dtype)
    args = (q, pk, pv, table.int(), valid.int(), ctx.int())
    launches.reset()
    out = paged_attention(*args, **kw)
    ref = paged_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert sum(launches.KERNEL.values()) == 1
    assert bool((out[0] == 0).all())  # valid_len 0: zeros, not nan
    torch.testing.assert_close(out.float(), ref.float(), atol=tol(dtype), rtol=tol(dtype))


def test_paged_attention_rejects_what_it_cannot_run(card):
    q = torch.randn(1, 1, 2, 32, device=card)  # head dim 32: not built
    pool = torch.randn(4, 4, 2, 32, device=card)
    idx = torch.zeros(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head dim"):
        paged_attention(q, pool, pool, torch.zeros(1, 2, dtype=torch.int32, device=card),
                        idx, idx, sm_scale=1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,d", [(1, 2048), (333, 2048), (512, 2048), (7, 256)])
def test_rms_norm_kernel_matches_plain(card, dtype, rows, d):
    x = (3 * torch.randn(rows, d, device=card)).to(dtype)
    w = (1.0 + 0.1 * torch.randn(d, device=card)).to(dtype)
    launches.reset()
    out, ref = rms_norm(x, w, 1e-5), rms_norm_plain(x, w, 1e-5)
    torch.cuda.synchronize()
    assert launches.KERNEL["rms_norm"] == 1
    torch.testing.assert_close(out.float(), ref.float(), atol=tol(dtype), rtol=tol(dtype))


def test_toy_engine_on_the_card_matches_the_cpu(card):
    from scaling_tpu_torch.models.transformer import (
        TransformerArchitectureConfig,
        TransformerInferenceModule,
    )
    from scaling_tpu_torch.serve import EngineConfig, ServeEngine
    from scaling_tpu_torch.serve.bench import MODELS, sample_workload

    arch = TransformerArchitectureConfig.from_dict(MODELS["toy"])
    cfg = dict(num_slots=4, block_size=16, num_blocks=40, max_blocks_per_seq=8)
    work = sample_workload(8, 1.0, (10, 90), (4, 20), arch.vocab_size, seed=3)

    def serve(device):
        inf = TransformerInferenceModule.random_init(arch, seed=0, device="cpu")
        if device.type != "cpu":
            inf = TransformerInferenceModule(arch, inf.model.to(device))
        engine = ServeEngine(inf, EngineConfig(**cfg), device=device)
        for _, prompt, n in work:
            engine.submit(prompt, n)
        return {s.request.req_id: s.generated for s in engine.run_until_done()}

    cpu_tokens = serve(torch.device("cpu"))
    launches.reset()
    card_tokens = serve(card)
    assert launches.KERNEL["paged_attention"] > 0 and launches.KERNEL["rms_norm"] > 0
    assert sum(launches.PLAIN.values()) == 0
    assert card_tokens == cpu_tokens


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,d", [(1, 2048), (333, 2048), (8192, 2048), (7, 256)])
def test_rms_norm_bwd_kernel_matches_plain(card, dtype, rows, d):
    x = (3 * torch.randn(rows, d, device=card)).to(dtype)
    w = (1.0 + 0.1 * torch.randn(d, device=card)).to(dtype)
    g = torch.randn(rows, d, device=card).to(dtype)
    launches.reset()
    dx, dw = rms_norm_bwd(x, w, g, 1e-5)
    dx2, dw2 = rms_norm_bwd(x, w, g, 1e-5)
    ref_dx, ref_dw = rms_norm_bwd_plain(x, w, g, 1e-5)
    torch.cuda.synchronize()
    assert launches.KERNEL["rms_norm_bwd"] == 2
    assert dx.dtype == dtype and dw.dtype == dtype and dw.shape == (d,)
    assert torch.equal(dw, dw2) and torch.equal(dx, dx2)  # no atomics: bitwise repeats
    torch.testing.assert_close(dx.float(), ref_dx.float(), atol=tol(dtype), rtol=tol(dtype))
    # dw sums over the rows: the tolerance scales with its magnitude
    scale = ref_dw.float().abs().max().item()
    assert (dw.float() - ref_dw.float()).abs().max().item() <= tol(dtype) * max(scale, 1.0)


def flash_inputs(card, b, s, n, n_kv, d, segments, seed):
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    q = (torch.randn(b, s, n, d, generator=gen, device=card) * d ** -0.5).bfloat16()
    k = torch.randn(b, s, n_kv, d, generator=gen, device=card).bfloat16()
    v = torch.randn(b, s, n_kv, d, generator=gen, device=card).bfloat16()
    seg = torch.zeros(b, s, dtype=torch.int32, device=card)
    for cut in range(1, segments):
        seg[:, cut * s // segments + 7:] += 1
    return q, k, v, seg


def rel_err(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


FLASH_CASES = [  # b, s, n, n_kv, d, segments, local heads, window
    (1, 128, 2, 2, 64, 1, 0, None),
    (2, 256, 4, 2, 64, 3, 0, None),
    (2, 192, 4, 1, 128, 2, 2, 40),
    (1, 512, 16, 4, 128, 1, 4, 100),
]


@pytest.mark.parametrize("b,s,n,n_kv,d,segments,n_local,window", FLASH_CASES)
def test_flash_attention_kernels_match_plain(card, b, s, n, n_kv, d, segments, n_local,
                                             window):
    q, k, v, seg = flash_inputs(card, b, s, n, n_kv, d, segments, seed=s + n + d)
    launches.reset()
    out, lse = flash_attention_fwd(q, k, v, seg, n_local, window)
    ref_out, ref_lse = flash_attention_plain(q, k, v, seg, n_local, window)
    torch.cuda.synchronize()
    assert launches.KERNEL["flash_attention_fwd"] == 1
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref_out.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)

    dout = torch.randn_like(q)
    grads = flash_attention_bwd(q, k, v, out, lse, dout, seg, n_local, window)
    again = flash_attention_bwd(q, k, v, out, lse, dout, seg, n_local, window)
    refs = flash_attention_bwd_plain(q, k, v, out, lse, dout, seg, n_local, window)
    torch.cuda.synchronize()
    assert launches.KERNEL["flash_attention_bwd"] == 2
    for name, g, g2, ref in zip(("dq", "dk", "dv"), grads, again, refs):
        assert g.shape == ref.shape and g.dtype == torch.bfloat16, name
        assert torch.equal(g, g2), f"{name} is not deterministic"
        assert rel_err(g, ref) <= 2e-2, (name, rel_err(g, ref))


def test_flash_attention_kernels_read_strided_views(card):
    """q, k and v as views into one fused (b, s, n, 3d) projection, as a
    fused-QKV layer hands them over: the kernels read them through their
    strides and agree with the plain versions on contiguous copies."""
    gen = torch.Generator(device=card)
    gen.manual_seed(5)
    b, s, n, d = 2, 256, 4, 64
    qkv = torch.randn(b, s, n, 3 * d, generator=gen, device=card).bfloat16()
    q, k, v = (0.125 * qkv[..., :d]).bfloat16(), qkv[..., d:2 * d], qkv[..., 2 * d:]
    assert not k.is_contiguous() and not v.is_contiguous()
    seg = torch.zeros(b, s, dtype=torch.int32, device=card)
    out, lse = flash_attention_fwd(q, k, v, seg)
    ref_out, ref_lse = flash_attention_plain(q, k.contiguous(), v.contiguous(), seg)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    dout = torch.randn(b, s, n, d, generator=gen, device=card).bfloat16()
    grads = flash_attention_bwd(q, k, v, out, lse, dout, seg)
    refs = flash_attention_bwd_plain(q, k.contiguous(), v.contiguous(), out, lse, dout, seg)
    for g, ref in zip(grads, refs):
        assert rel_err(g, ref) <= 2e-2


def test_flash_attention_rejects_what_it_cannot_run(card):
    q, k, v, seg = flash_inputs(card, 1, 128, 2, 2, 64, 1, seed=0)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention_fwd(q.float(), k.float(), v.float(), seg)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_fwd(q[:, :100], k[:, :100], v[:, :100], seg[:, :100].contiguous())


def test_toy_training_step_on_the_card_matches_the_cpu(card):
    """The bf16 toy model: two train steps through K2-K5 on the card
    against the same steps on the CPU through the plain versions, from the
    same weights (the losses within 2e-2: bf16 products in another order)."""
    import numpy as np

    from scaling_tpu_torch.models.transformer import init_optimizer, loss_function
    from scaling_tpu_torch.parallel import ParallelModule
    from scaling_tpu_torch.train.bench import build, synth_batch

    losses = {}
    for dev in ("cpu", card):
        config, module, _ = build("toy", 128, 2, device="cpu")
        module = ParallelModule(module.model.to(dev), config.topology)
        step = module.build_train_step(init_optimizer(config, module.model), loss_function)
        batch = synth_batch(np.random.default_rng(0), 2, 128, 512, 1, dev)
        launches.reset()
        losses[str(dev)] = [float(step(batch)[0]) for _ in range(2)]
        if dev is card:
            assert all(launches.KERNEL[k] > 0 for k in (
                "rms_norm", "rms_norm_bwd", "flash_attention_fwd", "flash_attention_bwd"))
            assert sum(launches.PLAIN.values()) == 0
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], atol=2e-2)
