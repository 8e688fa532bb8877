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
K1, the flash backward and the RMSNorm backward (both its variants) must
repeat bitwise.
And the toy model served on the card in f32 gives the CPU run's greedy
tokens, through the kernels only. muP's attention scale (1/32 for the
0.5B widths from a 256-wide base) through K1 and through K4/K5, and the
MoE layer at those widths in f32 on the card against its CPU run: at
least 0.999 of the tokens routed alike, their outputs within 1e-4 of max
|y| (f32 sums in another order). A checkpoint exported to the reference's
format and imported back serves on the card the CPU's tokens of the
original weights, and the C++ pack-index builder equals its plain loop on
the card's host.
"""

import importlib

import pytest
import torch

from scaling_tpu_torch.nn.attention import kv_quantize_int8
from scaling_tpu_torch.ops import (
    flash_attention,
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


# h, n, n_kv, s, block_size, max_blocks, rows' (context, new tokens); None:
# rows idle, fresh decode, a chunk at 3, a short chunk at 17, a chunk
# ending on the window
PAGED_CASES = {
    "h64-gqa2-s8-bs4": (64, 4, 2, 8, 4, 16, None),
    "h128-gqa4-s32-bs16": (128, 16, 4, 32, 16, 16, None),
    "h128-mha-s1-bs16": (128, 8, 8, 1, 16, 16, None),
    "h64-nkv1-s40-bs8": (64, 4, 1, 40, 8, 16, None),
    "h128-bs32": (128, 16, 4, 32, 32, 32, None),  # a 1024-slot window: 2 splits
    "h128-bs64": (128, 16, 4, 32, 64, 32, None),  # 2048 slots: 4 splits
    "one-2048-slot-row": (128, 16, 4, 32, 16, 128, ((2048 - 32, 32),)),
    "split-edges": (128, 16, 4, 32, 16, 128, (
        (512 - 32, 32), (511 - 32, 32), (513 - 32, 32), (1023, 1), (1024, 1), (0, 0))),
    "tile-edges": (128, 16, 4, 32, 16, 16, ((64 - 32, 32), (63 - 9, 9), (65 - 32, 32), (0, 0))),
    "nrep4-decode": (128, 16, 4, 1, 16, 128, ((700, 1), (2047, 1), (0, 0))),
    "nrep8": (128, 16, 2, 32, 16, 64, None),      # 256 query vectors: 2 query tiles
    "nrep8-h64": (64, 8, 1, 32, 32, 48, None),
    # the 0.5B model's serving shapes: the separate decode forward (s = 1)
    # and a speculative decode row of spec_k 4 (s = 5), drafts 0..4
    "serving-decode-s1": (128, 16, 4, 1, 16, 128, ((0, 0), (0, 1), (130, 1), (2047, 1))),
    "serving-spec4-s5": (128, 16, 4, 5, 16, 128, (
        (0, 0), (40, 1), (97, 3), (500, 5), (2043, 5))),
}


def paged_case(card, quantized, dtype, h, n, n_kv, s, bs, max_blocks, contexts, seed):
    """K1 operands on the card: a pool, rows of the given contexts, tables
    that point past the context at the trash block 0."""
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    window = max_blocks * bs
    if contexts is None:
        contexts = ((0, 0), (0, 1), (3, s), (17, min(s, 5)), (window - s, s))
    ctx = torch.tensor([c for c, _ in contexts], device=card)
    new = torch.tensor([k for _, k in contexts], device=card)
    rows, num_blocks = len(contexts), max(64, max_blocks + 1)
    q = torch.randn(rows, s, n, h, generator=gen, device=card).to(dtype)
    pk = torch.randn(num_blocks, bs, n_kv, h, generator=gen, device=card)
    pv = torch.randn(num_blocks, bs, n_kv, h, generator=gen, device=card)
    valid = ctx + new
    nblk = (valid + bs - 1) // bs
    table = torch.randint(1, num_blocks, (rows, max_blocks), generator=gen, device=card)
    table = torch.where(torch.arange(max_blocks, device=card)[None] < nblk[:, None], table, 0)
    kw = dict(sm_scale=h ** -0.5, num_repeat_kv=n // n_kv)
    if quantized:
        (pk, kw["scale_k"]), (pv, kw["scale_v"]) = kv_quantize_int8(pk), kv_quantize_int8(pv)
    else:
        pk, pv = pk.to(dtype), pv.to(dtype)
    return (q, pk, pv, table.int(), valid.int(), ctx.int()), kw


@pytest.mark.parametrize("quantized", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_attention_kernel_matches_plain(card, quantized, dtype, case):
    h, n, n_kv, s, bs, max_blocks, contexts = PAGED_CASES[case]
    args, kw = paged_case(card, quantized, dtype, h, n, n_kv, s, bs, max_blocks, contexts,
                          seed=h + n + s + bs)
    if dtype == torch.float32 and bs * h > 4096:
        # f32 takes the exact kernel, whose K/V prefetch admits bs x h <= 4096
        with pytest.raises(ValueError, match="exact kernel"):
            paged_attention(*args, **kw)
        return
    launches.reset()
    out = paged_attention(*args, **kw)
    ref = paged_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert sum(launches.KERNEL.values()) == 1
    valid = args[4]
    assert bool((out[valid == 0] == 0).all())  # valid_len 0: zeros, not nan
    torch.testing.assert_close(out.float(), ref.float(), atol=tol(dtype), rtol=tol(dtype))


@pytest.mark.parametrize("quantized", [False, True], ids=["native", "int8"])
def test_paged_attention_repeats_bitwise(card, quantized):
    """The split kernel's partials are merged in a fixed order, without
    atomics: two calls give the same bits, also for rows over 4 splits."""
    args, kw = paged_case(card, quantized, torch.bfloat16, *PAGED_CASES["split-edges"][:6],
                          ((2048 - 32, 32), (1000, 32), (5, 32), (0, 0)), seed=9)
    first = paged_attention(*args, **kw)
    again = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def test_paged_attention_rejects_what_it_cannot_run(card):
    """Head dims other than 64 and 128, f32 q past the exact kernel's
    block_size x head_dim <= 4096, and query heads that are no multiple of
    the kv heads raise, naming the cause; bf16 and int8 take any block size
    (64 at head dim 128 here)."""
    idx = torch.zeros(1, dtype=torch.int32, device=card)
    table = torch.zeros(1, 2, dtype=torch.int32, device=card)
    q = torch.randn(1, 1, 2, 32, device=card)  # head dim 32: not built
    pool = torch.randn(4, 4, 2, 32, device=card)
    with pytest.raises(ValueError, match="head dim"):
        paged_attention(q, pool, pool, table, idx, idx, sm_scale=1.0)
    q = torch.randn(1, 1, 2, 128, device=card)
    pool = torch.randn(4, 64, 2, 128, device=card)
    with pytest.raises(ValueError, match="exact kernel"):
        paged_attention(q, pool, pool, table, idx, idx, sm_scale=1.0)
    with pytest.raises(ValueError, match="query heads"):
        paged_attention(q.bfloat16(), pool.bfloat16(), pool.bfloat16(), table, idx, idx,
                        sm_scale=1.0, num_repeat_kv=2)
    out = paged_attention(q.bfloat16(), pool.bfloat16(), pool.bfloat16(), table,
                          idx + 70, idx + 69, sm_scale=1.0)
    assert out.shape == q.shape and bool(torch.isfinite(out.float()).all())


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


# (x and g, w) dtypes of K3's cases
K3_DTYPES = {"f32": (torch.float32, torch.float32), "bf16": (torch.bfloat16, torch.bfloat16),
             "f16": (torch.float16, torch.float16), "bf16-f32w": (torch.bfloat16, torch.float32)}


@pytest.mark.parametrize("dtypes", list(K3_DTYPES))
@pytest.mark.parametrize("rows,d", [(rows, d) for rows in (1, 333, 8191, 8192)
                                    for d in (128, 2048, 8192, 32768)] + [(7, 256)])
def test_rms_norm_bwd_kernel_matches_plain(card, dtypes, rows, d):
    """K3 with dw and dx-only: dx and dw against the plain version, every
    output equal to itself on a repeat (no atomics on values: dw's partials
    are added in a fixed order), and the dx-only variant's dx the full
    one's. d 32768 takes the chunked walk."""
    dtype, w_dtype = K3_DTYPES[dtypes]
    x = (3 * torch.randn(rows, d, device=card)).to(dtype)
    w = (1.0 + 0.1 * torch.randn(d, device=card)).to(w_dtype)
    g = torch.randn(rows, d, device=card).to(dtype)
    launches.reset()
    dx, dw = rms_norm_bwd(x, w, g, 1e-5)
    dx2, dw2 = rms_norm_bwd(x, w, g, 1e-5)
    dx_only, none = rms_norm_bwd(x, w, g, 1e-5, need_dw=False)
    dx_only2, _ = rms_norm_bwd(x, w, g, 1e-5, need_dw=False)
    ref_dx, ref_dw = rms_norm_bwd_plain(x, w, g, 1e-5)
    torch.cuda.synchronize()
    assert launches.KERNEL["rms_norm_bwd"] == 4
    assert launches.VARIANTS[("rms_norm_bwd", "dx_only")] == 2
    assert dx.dtype == dtype and dw.dtype == w_dtype and dw.shape == (d,) and none is None
    assert torch.equal(dw, dw2) and torch.equal(dx, dx2) and torch.equal(dx_only, dx_only2)
    assert torch.equal(dx_only, dx)
    torch.testing.assert_close(dx.float(), ref_dx.float(), atol=tol(dtype), rtol=tol(dtype))
    # dw sums over the rows: the tolerance scales with its magnitude
    scale = ref_dw.float().abs().max().item()
    assert (dw.float() - ref_dw.float()).abs().max().item() <= tol(dtype) * max(scale, 1.0)


def test_rms_norm_bwd_reads_a_misaligned_view(card):
    """x and g whose storage offset leaves them off a 16-byte boundary are
    copied to aligned buffers, not refused."""
    flat = torch.randn(3 * 2048 + 1, device=card).bfloat16()
    x = flat[1:].view(3, 2048)
    g = torch.randn(3, 2048, device=card).bfloat16()
    w = torch.ones(2048, device=card).bfloat16()
    assert x.data_ptr() % 16 != 0
    dx, dw = rms_norm_bwd(x, w, g, 1e-5)
    ref_dx, ref_dw = rms_norm_bwd_plain(x, w, g, 1e-5)
    torch.testing.assert_close(dx.float(), ref_dx.float(), atol=1e-2, rtol=1e-2)
    scale = ref_dw.float().abs().max().item()
    assert (dw.float() - ref_dw.float()).abs().max().item() <= 1e-2 * max(scale, 1.0)


def flash_inputs(card, b, s, n, n_kv, d, segments, seed):
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    q = (torch.randn(b, s, n, d, generator=gen, device=card) * d ** -0.5).bfloat16()
    k = torch.randn(b, s, n_kv, d, generator=gen, device=card).bfloat16()
    v = torch.randn(b, s, n_kv, d, generator=gen, device=card).bfloat16()
    seg = torch.zeros(b, s, dtype=torch.int32, device=card)
    # segments: a number of documents (cut off the tile edges) or the cuts
    cuts = segments if isinstance(segments, tuple) else [
        cut * s // segments + 7 for cut in range(1, segments)]
    for cut in cuts:
        seg[:, cut:] += 1
    return q, k, v, seg


def rel_err(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


FLASH_CASES = [  # b, s, n, n_kv, d, segments, local heads, window
    (1, 128, 2, 2, 64, 1, 0, None),
    (2, 256, 4, 2, 64, 3, 0, None),
    (2, 192, 4, 1, 128, 2, 2, 40),
    (1, 512, 16, 4, 128, 1, 4, 100),
    (1, 320, 4, 2, 64, 1, 0, None),          # s not a multiple of 128
    (2, 256, 4, 2, 128, (64, 128), 0, None),  # segment boundaries on tile edges
    (1, 256, 4, 2, 64, 2, 2, 16),            # a window smaller than a tile
    (1, 256, 16, 1, 128, 1, 0, None),        # one kv head for 16 query heads
    (4, 2048, 16, 4, 128, 1, 0, None),       # the training shape
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


def test_head_dim_96_trains_on_the_card_unfused(card, monkeypatch):
    """The bf16 toy at hidden 384 has head dim 96, which K4/K5 are not
    built for: its layer routes to the unfused path by shape, so two train
    steps on the card run without a raise, with finite losses, K2 and K3
    launched, no flash kernel and no plain version."""
    import numpy as np

    from scaling_tpu_torch.models.transformer import loss_function
    from scaling_tpu_torch.train import bench

    monkeypatch.setitem(bench.MODELS, "toy_d96", dict(bench.MODELS["toy"], hidden_size=384))
    _, module, optimizer = bench.build("toy_d96", 128, 2, device=card)
    step = module.build_train_step(optimizer, loss_function)
    batch = bench.synth_batch(np.random.default_rng(0), 2, 128, 512, 1, card)
    launches.reset()
    losses = [float(step(batch)[0]) for _ in range(2)]
    assert all(np.isfinite(losses)), losses
    assert launches.KERNEL["rms_norm"] > 0 and launches.KERNEL["rms_norm_bwd"] > 0
    assert launches.KERNEL["flash_attention_fwd"] == 0 and launches.KERNEL["flash_attention_bwd"] == 0
    assert sum(launches.PLAIN.values()) == 0


@pytest.mark.parametrize("hidden,kernel_route", [(320, False), (384, True)])
def test_fused_rms_norm_routes_by_width_on_the_card(card, monkeypatch, hidden, kernel_route):
    """A fused-RMS toy at hidden 320 (not a multiple of 128) trains on the
    card through the plain ops, with no K2/K3 launch and no plain-version
    count; at 384 through K2 and K3. Two steps, finite losses."""
    import numpy as np

    from scaling_tpu_torch.models.transformer import loss_function
    from scaling_tpu_torch.train import bench

    monkeypatch.setitem(bench.MODELS, "toy_w", dict(bench.MODELS["toy"], hidden_size=hidden,
                                                    num_attention_heads=hidden // 64,
                                                    attention_num_kv_heads=1))
    _, module, optimizer = bench.build("toy_w", 128, 2, device=card)
    step = module.build_train_step(optimizer, loss_function)
    batch = bench.synth_batch(np.random.default_rng(0), 2, 128, 512, 1, card)
    launches.reset()
    losses = [float(step(batch)[0]) for _ in range(2)]
    assert all(np.isfinite(losses)), losses
    assert (launches.KERNEL["rms_norm"] > 0) == kernel_route
    assert (launches.KERNEL["rms_norm_bwd"] > 0) == kernel_route
    assert sum(launches.PLAIN.values()) == 0


@pytest.mark.parametrize("precision", ["float32", "float16"])
def test_non_bf16_flash_model_trains_unfused_on_the_card(card, monkeypatch, precision):
    """K4/K5 take bf16 only: a flash toy in f32 or f16 at head dim 128 and
    seq 128 trains on the card unfused (no flash launch, no plain version),
    its losses within 2e-2 of the same steps on the CPU."""
    import numpy as np

    from scaling_tpu_torch.models.transformer import init_optimizer, loss_function
    from scaling_tpu_torch.parallel import ParallelModule
    from scaling_tpu_torch.train import bench

    monkeypatch.setitem(bench.MODELS, "toy_p", dict(bench.MODELS["toy"], precision=precision,
                                                    num_attention_heads=2))
    losses = {}
    for dev in ("cpu", card):
        config, module, _ = bench.build("toy_p", 128, 2, device="cpu")
        module = ParallelModule(module.model.to(dev), config.topology)
        step = module.build_train_step(init_optimizer(config, module.model), loss_function)
        batch = bench.synth_batch(np.random.default_rng(0), 2, 128, 512, 1, dev)
        launches.reset()
        losses[str(dev)] = [float(step(batch)[0]) for _ in range(2)]
        assert launches.KERNEL["flash_attention_fwd"] == 0
        assert launches.PLAIN["flash_attention_fwd"] == 0
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], atol=2e-2)


def test_generate_on_the_card_gives_the_cpu_tokens(card):
    """The f32 toy with a tied head and key/query norm generates on the card
    the CPU's greedy tokens for a ragged batch, with the fused decode, the
    per-step decode and without the cache; no plain version runs."""
    import numpy as np

    from scaling_tpu_torch.models.transformer import (
        TransformerArchitectureConfig,
        TransformerInferenceModule,
    )
    from scaling_tpu_torch.serve.bench import MODELS

    arch = TransformerArchitectureConfig.from_dict(dict(
        MODELS["toy"], norm_type="layernorm", mlp_type="default", weight_tying=True,
        key_query_norm=True))
    cpu = TransformerInferenceModule.random_init(arch, seed=0, device="cpu")
    gpu = TransformerInferenceModule.from_state_dict(arch, cpu.model.state_dict(), device=card)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 512, size=n).tolist() for n in (5, 40, 17)]
    ref = [o.completion_ids for o in cpu.generate(prompts, max_tokens=12)]
    launches.reset()
    for kw in ({}, {"fused_decode": False}, {"use_cache": False}):
        assert [o.completion_ids for o in gpu.generate(prompts, max_tokens=12, **kw)] == ref, kw
    assert sum(launches.PLAIN.values()) == 0


def test_bf16_generate_prefill_runs_k4_on_the_card(card):
    """The bf16 toy (fused RMS, flash): a ragged batch whose longest prompt
    is 128 tokens prefills through K4 and K2, decodes through K2, and the
    fused and per-step decodes give the same tokens bitwise."""
    import numpy as np

    from scaling_tpu_torch.models.transformer import (
        TransformerArchitectureConfig,
        TransformerInferenceModule,
    )
    from scaling_tpu_torch.train.bench import MODELS

    inf = TransformerInferenceModule.random_init(
        TransformerArchitectureConfig.from_dict(MODELS["toy"]), seed=0, device=card)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 512, size=n).tolist() for n in (128, 37, 90)]
    launches.reset()
    fused = inf.generate(prompts, max_tokens=16)
    assert launches.KERNEL["flash_attention_fwd"] == 2  # one prefill, two layers
    assert launches.KERNEL["rms_norm"] > 0 and sum(launches.PLAIN.values()) == 0
    per_step = inf.generate(prompts, max_tokens=16, fused_decode=False)
    assert [o.completion_ids for o in fused] == [o.completion_ids for o in per_step]
    assert all(len(o.completion_ids) == 16 for o in fused)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dropout_draws_on_the_card(card, dtype):
    """A CUDA tensor's mask is drawn on the card by a generator there: the
    result stays on the card in x's dtype, the kept values are x / keep,
    the zero share within 5 sigma of the rate, and the same (key, site)
    gives the same mask, another site another."""
    from scaling_tpu_torch.nn.base_layer import DropoutContext, dropout_key

    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    x = torch.randn(4, 512, 512, generator=gen, device=card).to(dtype)
    ctx = DropoutContext(dropout_key(0, 3)).for_micro_batch(1)
    y = ctx.dropout(x, 0.1, "layer_1.after_mlp")
    assert y.device == x.device and y.dtype == dtype
    kept = y != 0
    assert torch.equal(y[kept], (x / 0.9)[kept])
    share = 1.0 - kept.float().mean().item()
    assert abs(share - 0.1) <= 5 * (0.1 * 0.9 / x.numel()) ** 0.5
    assert torch.equal(y, ctx.dropout(x, 0.1, "layer_1.after_mlp"))
    assert not torch.equal(y, ctx.dropout(x, 0.1, "layer_2.after_mlp"))


def lora_toy_step(card):
    """One bf16 LoRA finetune step of the toy with dropout on the card:
    (the model's state before, after)."""
    from scaling_tpu_torch.models.transformer import loss_function
    from scaling_tpu_torch.models.transformer.config import TransformerConfig
    from scaling_tpu_torch.models.transformer.model import init_model, init_optimizer
    from scaling_tpu_torch.nn.base_layer import dropout_key
    from scaling_tpu_torch.serve.bench import MODELS

    arch = dict(MODELS["toy"], precision="bfloat16", sequence_length=128,
                masked_softmax={"kernel": "flash_attention"},
                lora_config={"name": "lora", "rank": 8, "dropout": 0.05},
                dropout_embedding=0.1, dropout_after_attention=0.1, dropout_after_mlp=0.1)
    config = TransformerConfig.from_dict({
        "topology": {"micro_batch_size": 2, "gradient_accumulation_steps": 1},
        "transformer_architecture": arch,
        "training": {"finetune": True}, "trainer": {"seed": 0},
        # constant: the cosine default with no decay iterations gives step 1 a rate of 0
        "learning_rate_scheduler": {"learning_rate": 1e-3,
                                    "learning_rate_decay_style": "constant"}})
    module = init_model(config, device=card)
    before = {k: v.clone() for k, v in module.model.state_dict().items()}
    optimizer = init_optimizer(config, module.model)
    step = module.build_train_step(optimizer, loss_function)
    tokens = torch.randint(1, 512, (1, 2, 129), device=card)
    batch = {"token_ids": tokens[..., :-1], "target_token_ids": tokens[..., 1:]}
    launches.reset()
    loss = step(batch, dropout_key(0, 0))[0]
    assert torch.isfinite(loss)
    return before, module.model.state_dict()


def test_lora_finetune_step_with_dropout_on_the_card(card):
    """A bf16 LoRA finetune step of the toy with dropout on the card: the
    flash and RMSNorm kernels run, no plain version; of all the leaves the
    LoRA B factors alone move (A's gradient is 0 while B is)."""
    before, after = lora_toy_step(card)
    for k in ("rms_norm", "rms_norm_bwd", "flash_attention_fwd", "flash_attention_bwd"):
        assert launches.KERNEL[k] > 0, k
    assert sum(launches.PLAIN.values()) == 0
    for k, v in after.items():
        assert torch.equal(v, before[k]) != k.endswith("lora_b"), k


def test_lora_step_takes_k3_dx_only_for_frozen_gains(card):
    """The LoRA step's norm gains are frozen: every K3 launch is the
    dx-only variant, no plain version runs, and the gains stay bitwise."""
    before, after = lora_toy_step(card)
    assert launches.VARIANTS[("rms_norm_bwd", "dx_only")] == launches.KERNEL["rms_norm_bwd"] > 0
    assert launches.VARIANTS[("rms_norm_bwd", "dx_dw")] == 0
    assert sum(launches.PLAIN.values()) == 0
    gains = [k for k in after if "norm" in k and k.endswith("weight")]
    assert gains and all(torch.equal(after[k], before[k]) for k in gains)


def test_whole_prompt_prefill_runs_k4_and_agrees_with_chunks(card):
    """A bf16 toy of head dim 128 (fused RMS, flash) served with
    ``prefill_chunk=None``: prompts of 100-128 tokens fill the 128 bucket,
    whose prefill runs K4 (the bucket's pads in their own segment) and K2,
    and the decodes run K1 at s = 1. Its greedy tokens equal the chunked
    engine's, or part first where the card's ``logits()`` put the two
    candidates within 0.05 of max |logit| (bf16 through two paths)."""
    import numpy as np

    from scaling_tpu_torch.models.transformer import (
        TransformerArchitectureConfig,
        TransformerInferenceModule,
    )
    from scaling_tpu_torch.serve import EngineConfig, ServeEngine
    from scaling_tpu_torch.serve.bench import MODELS

    arch = TransformerArchitectureConfig.from_dict(dict(
        MODELS["toy"], precision="bfloat16", masked_softmax={"kernel": "flash_attention"},
        num_attention_heads=2, attention_num_kv_heads=1))
    inf = TransformerInferenceModule.random_init(arch, seed=0, device=card)
    rng = np.random.default_rng(2)
    work = [(rng.integers(1, 512, size=int(rng.integers(100, 129))).tolist(), 12)
            for _ in range(6)]
    cfg = dict(num_slots=4, block_size=16, num_blocks=96, max_blocks_per_seq=16)

    def serve(**kw):
        engine = ServeEngine(inf, EngineConfig(**cfg, **kw), device=card)
        for prompt, n in work:
            engine.submit(prompt, n)
        return {s.request.req_id: list(s.generated) for s in engine.run_until_done()}

    launches.reset()
    whole = serve(prefill_chunk=None)
    torch.cuda.synchronize()
    assert launches.KERNEL["flash_attention_fwd"] == 2 * len(work)  # one bucket, two layers
    assert launches.WIDTHS[("paged_attention", 1)] > 0 and launches.KERNEL["rms_norm"] > 0
    assert sum(launches.PLAIN.values()) == 0
    chunked = serve(prefill_chunk=32)
    for i, (prompt, n) in enumerate(work):
        got, want = whole[i], chunked[i]
        assert len(got) == len(want) == n
        t = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if t is not None:
            logits = inf.logits(prompt + got[:t])[0, -1].float()
            gap = abs(logits[got[t]] - logits[want[t]]).item()
            assert gap <= 0.05 * logits.abs().max().item(), (i, t, gap)


def test_process_fleet_serves_through_the_kernels_in_each_worker(card, tmp_path):
    """``serve bench --replicas-proc 2 --model toy`` on the card: both
    workers serve (on ``cuda:0`` each with one card), each launched K1 and
    K2 and no plain version (from its stats), every request completed, and
    the host never initialised CUDA."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items() if not k.startswith("SCALING_TPU_")}
    proc = subprocess.run(
        [sys.executable, "-m", "scaling_tpu_torch.serve", "bench", "--model", "toy",
         "--replicas-proc", "2", "--requests", "16", "--rate", "200", "--prompt-len", "16", "64",
         "--output-len", "8", "16", "--num-slots", "4", "--num-blocks", "64",
         "--max-blocks-per-seq", "8", "--json", str(tmp_path / "stats.json")],
        cwd=repo, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    stats = json.loads((tmp_path / "stats.json").read_text())
    assert stats["requests"] == 16 and stats["host_cuda_initialized"] is False
    for row in stats["replica_stats"]:
        assert row["device"] == f"cuda:{row['replica'] % torch.cuda.device_count()}"
        assert row["dispatches"] > 0, row
        assert row["kernel_launches"].get("paged_attention", 0) > 0, row
        assert row["kernel_launches"].get("rms_norm", 0) > 0, row
        assert sum(row["plain_launches"].values()) == 0, row


MUP_SCALE = 1 / 32  # sqrt(256 / 16) / 128: the 0.5B widths under muP from a 256-wide base


@pytest.mark.parametrize("quantized", [False, True], ids=["native", "int8"])
def test_paged_attention_takes_the_mup_scale(card, quantized):
    case = PAGED_CASES["h128-gqa4-s32-bs16"][:6]
    args, kw = paged_case(card, quantized, torch.bfloat16, *case, None, seed=32)
    kw["sm_scale"] = MUP_SCALE
    out = paged_attention(*args, **kw)
    ref = paged_attention_plain(*args, **kw)
    default = paged_attention_plain(*args, **dict(kw, sm_scale=128 ** -0.5))
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
    assert (out.float() - default.float()).abs().max() > 0.1  # the scale moved it


def test_flash_attention_takes_the_mup_scale(card):
    """``flash_attention(..., sm_scale=1/32)`` at the training shape: q is
    scaled before K4, and autograd carries the scale into K5's dq."""
    q, k, v, seg = flash_inputs(card, 4, 2048, 16, 4, 128, 1, seed=32)
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    dout = torch.randn_like(q)
    launches.reset()
    out = flash_attention(q, k, v, seg, sm_scale=MUP_SCALE)
    out.backward(dout)
    torch.cuda.synchronize()
    assert launches.KERNEL["flash_attention_fwd"] == 1
    assert launches.KERNEL["flash_attention_bwd"] == 1
    qs = (q.detach() * MUP_SCALE).bfloat16()
    ref, lse = flash_attention_plain(qs, k.detach(), v.detach(), seg, 0, None)
    torch.testing.assert_close(out.detach().float(), ref.float(), atol=1e-2, rtol=1e-2)
    dq, dk, dv = flash_attention_bwd_plain(qs, k.detach(), v.detach(), ref, lse, dout, seg, 0,
                                           None)
    for name, g, r in (("dq", q.grad, dq.float() * MUP_SCALE), ("dk", k.grad, dk),
                       ("dv", v.grad, dv)):
        assert rel_err(g, r) <= 2e-2, (name, rel_err(g, r))


def test_moe_layer_on_the_card_matches_the_cpu(card):
    """The 0.5B MoE layer (h 2048, 8 experts of 5632, top-2, capacity 1.25)
    in f32 at b 4, s 2048 on the card and on the CPU from the same
    weights and input."""
    import copy

    from scaling_tpu_torch.nn.moe import ParallelMoEMLP, capacity

    layer = ParallelMoEMLP(2048, 2.75, 8, top_k=2, capacity_factor=1.25)
    layer.init_(torch.Generator().manual_seed(0))
    x = torch.randn(4, 2048, 2048, generator=torch.Generator().manual_seed(1))
    on_card = copy.deepcopy(layer).to(card)
    with torch.no_grad():
        y, aux = layer(x)
        y_card, aux_card = on_card(x.to(card))
        routed = []
        for m, xx in ((layer, x), (on_card, x.to(card))):
            _, experts, positions, _ = m.route(xx)
            kept = positions < capacity(1.25, 2, 2048, 8)
            experts, order = experts.sort(-1)
            routed.append(torch.cat([experts, kept.gather(-1, order).long()], -1).cpu())
    alike = (routed[0] == routed[1]).all(-1)
    assert alike.float().mean().item() >= 0.999
    err = (y_card.cpu() - y).abs().amax(-1)[alike].max() / y.abs().max()
    assert err.item() <= 1e-4, err.item()
    assert abs(aux_card.item() - aux.item()) <= 1e-3 * aux.item()


def _toy_steps(card, steps: int, **topology):
    """The bf16 toy's train steps on the card from seed 0, the launch
    counters reset just before: (losses, parameters after, kernel and
    plain counters)."""
    import numpy as np

    from scaling_tpu_torch.models.transformer import loss_function
    from scaling_tpu_torch.train.bench import build, synth_batch

    config, module, optimizer = build("toy", 128, 2, device=card, seed=0, **topology)
    step = module.build_train_step(optimizer, loss_function)
    batch = synth_batch(np.random.default_rng(0), 2, 128, 512, 1, card)
    launches.reset()
    losses = [float(step(batch)[0]) for _ in range(steps)]
    params = {n: p.detach().clone() for n, p in module.model.named_parameters()}
    return losses, params, dict(launches.KERNEL), dict(launches.PLAIN)


def test_save_dots_step_launches_every_layers_kernels(card):
    """Two bf16 toy steps under ``every_layer_save_dots``: K2-K5 launched as
    often as under ``every_layer`` (the recompute runs the kernels again,
    as JAX's policy recomputes its ``pallas_call`` s), more K4 than without
    remat, no plain version; losses and parameters those of
    ``every_layer``, bitwise (the saved products are the recompute's)."""
    dots = _toy_steps(card, 2, remat="every_layer_save_dots")
    layer = _toy_steps(card, 2, remat="every_layer")
    off = _toy_steps(card, 2)
    for k in ("rms_norm", "rms_norm_bwd", "flash_attention_fwd", "flash_attention_bwd"):
        assert dots[2].get(k, 0) == layer[2].get(k, 0) > 0, k
    assert dots[2]["flash_attention_fwd"] > off[2]["flash_attention_fwd"]
    assert sum(dots[3].values()) == 0
    assert dots[0] == layer[0]
    assert all(torch.equal(v, layer[1][n]) for n, v in dots[1].items())


def test_local_window_prefill_runs_k4_with_local_heads(card):
    """A bf16 toy of head dim 128 with 2 of 4 heads local (window 32): a
    128-token prompt prefills through K4 with ``num_local_heads`` 2, the
    cached decode gives the uncached decode's tokens, no plain version."""
    import numpy as np

    from scaling_tpu_torch.models.transformer import (
        TransformerArchitectureConfig,
        TransformerInferenceModule,
    )
    from scaling_tpu_torch.train.bench import MODELS

    flash_module = importlib.import_module("scaling_tpu_torch.ops.flash_attention")

    arch = TransformerArchitectureConfig.from_dict(dict(
        MODELS["toy"], hidden_size=512, num_local_attention_heads=2,
        local_attention_window_size=32))
    inf = TransformerInferenceModule.random_init(arch, seed=0, device=card)
    seen = []
    launch = flash_module.flash_attention_fwd

    def spy(*args, **kwargs):
        seen.append(kwargs.get("num_local_heads", args[4] if len(args) > 4 else 0))
        return launch(*args, **kwargs)

    flash_module.flash_attention_fwd = spy
    try:
        prompts = np.random.default_rng(2).integers(1, 512, size=(2, 128)).tolist()
        launches.reset()
        cached = inf.generate(prompts, max_tokens=16)
        kernel, plain = dict(launches.KERNEL), dict(launches.PLAIN)
    finally:
        flash_module.flash_attention_fwd = launch
    assert kernel["flash_attention_fwd"] == 2 and seen and all(n == 2 for n in seen)
    assert sum(plain.values()) == 0
    uncached = inf.generate(prompts, max_tokens=16, use_cache=False)
    for a, b in zip(cached, uncached):
        # bf16 (K4 or the unfused path, other sums): the logits agree within
        # 5e-2 of max |logit| up to where the tokens part, and they part, if
        # at all, at a near tie of the random-weight model's flat logits
        t = next((i for i, (x, y) in enumerate(zip(a.completion_ids, b.completion_ids))
                  if x != y), len(a.completion_ids))
        ref = b.logits[:t + 1].float()
        err = (a.logits[:t + 1].float() - ref).abs().max().item()
        assert err <= 5e-2 * ref.abs().max().item(), (t, err)


def test_multimodal_step_runs_no_plain_version(card):
    """Two bf16 steps of the toy with a ViT image encoder (one 384 x 384
    image a row, 144 tokens at position 8 of 256): K2-K5 launched, no plain
    version, finite losses, the encoder's weights moved."""
    import numpy as np

    from scaling_tpu_torch.models.transformer import (
        TransformerConfig,
        init_model,
        init_optimizer,
        loss_function,
    )
    from scaling_tpu_torch.train.bench import MODELS

    config = TransformerConfig.from_dict({
        "topology": {"micro_batch_size": 2, "gradient_accumulation_steps": 1},
        "transformer_architecture": dict(MODELS["toy"], sequence_length=256, image_encoder=True,
                                         image_encoder_width=128, image_encoder_layers=1,
                                         image_encoder_heads=4),
        # a rate at which one step moves a bf16 weight past its rounding
        "learning_rate_scheduler": {"learning_rate": 1e-3, "learning_rate_warmup_steps": 1}})
    module = init_model(config, device=card)
    step = module.build_train_step(init_optimizer(config, module.model), loss_function)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(1, 512, size=(1, 2, 256))).to(card)
    batch = {"token_ids": tokens, "target_token_ids": tokens.roll(-1, -1),
             "input_images": torch.from_numpy(rng.normal(size=(1, 2, 1, 384, 384, 3)).astype(
                 np.float32)).to(card),
             "input_image_locations": torch.full((1, 2, 1), 8, device=card),
             "input_image_mask": torch.ones(1, 2, 1, dtype=torch.bool, device=card)}
    before = module.model.embedding.image_encoder.patch_proj.weight.detach().clone()
    launches.reset()
    losses = [float(step(batch)[0]) for _ in range(2)]
    assert all(np.isfinite(losses))
    for k in ("rms_norm", "rms_norm_bwd", "flash_attention_fwd", "flash_attention_bwd"):
        assert launches.KERNEL[k] > 0, k
    assert sum(launches.PLAIN.values()) == 0
    assert not torch.equal(module.model.embedding.image_encoder.patch_proj.weight, before)


def test_imported_reference_checkpoint_serves_on_the_card(card, tmp_path):
    """The toy model's checkpoint exported to the reference's format and
    imported back loads on the card and serves through the kernels the CPU
    run's greedy tokens of the original weights."""
    import yaml

    from scaling_tpu_torch.checkpoint import save_model_checkpoint
    from scaling_tpu_torch.checkpoint.export_reference import export_reference_checkpoint
    from scaling_tpu_torch.checkpoint.import_reference import convert_reference_checkpoint
    from scaling_tpu_torch.models.transformer import (
        TransformerArchitectureConfig,
        TransformerInferenceModule,
    )
    from scaling_tpu_torch.parallel.parallel_module import jax_param_key
    from scaling_tpu_torch.serve import EngineConfig, ServeEngine
    from scaling_tpu_torch.serve.bench import MODELS

    arch = TransformerArchitectureConfig.from_dict(MODELS["toy"])
    source = TransformerInferenceModule.random_init(arch, seed=0, device="cpu")
    save_model_checkpoint(tmp_path / "npz", {jax_param_key(source.model, n): p
                                             for n, p in source.model.named_parameters()})
    config = yaml.safe_dump({"transformer_architecture": MODELS["toy"]})
    (tmp_path / "npz" / "config.yml").write_text(config)
    export_reference_checkpoint(tmp_path / "npz", tmp_path / "ref")
    convert_reference_checkpoint(tmp_path / "ref", tmp_path / "imported")
    (tmp_path / "imported" / "config.yml").write_text(config)

    def serve(inf, device):
        engine = ServeEngine(inf, EngineConfig(num_slots=2, block_size=16, num_blocks=16,
                                               max_blocks_per_seq=4), device=device)
        engine.submit(list(range(1, 40)), 12)
        return [s.generated for s in engine.run_until_done()]

    want = serve(source, torch.device("cpu"))
    launches.reset()
    got = serve(TransformerInferenceModule.from_checkpoint(tmp_path / "imported", device=card),
                card)
    assert launches.KERNEL["paged_attention"] > 0 and launches.KERNEL["rms_norm"] > 0
    assert sum(launches.PLAIN.values()) == 0
    assert got == want and len(got[0]) == 12


def test_cpp_pack_builder_equals_the_plain_loop_on_the_cards_host(card, tmp_path):
    """The C++ builder, compiled with the host's g++, against the Python
    loop over 200,000 document sizes of 16-8192 tokens at sequence 2048."""
    import numpy as np

    from scaling_tpu_torch.native import build_pack_index, build_pack_index_plain

    sizes = np.random.default_rng(0).integers(16, 8193, size=200_000)
    for every_n in (0, 4):
        got = build_pack_index(sizes, 2048, every_n, build_dir=tmp_path)
        want = build_pack_index_plain(sizes, 2048, every_n)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
