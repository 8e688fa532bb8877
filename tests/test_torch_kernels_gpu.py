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
K1, the flash backward and the RMSNorm backward's dw must repeat bitwise.
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
