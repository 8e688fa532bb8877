"""The port's kernels on the card (marked ``gpu``; they skip without an
sm_90 CUDA device). Run there with
``python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py``
(``--noconftest``: the card's machine has no JAX, which the repository's
conftest imports).

Each kernel against its plain version on the same CUDA tensors. f32: atol
1e-5 (summation order only). bf16: atol and rtol 1e-2, one rounding of
the output. And the toy model served on the card in f32 gives the CPU
run's greedy tokens, through the kernels only.
"""

import pytest
import torch

from scaling_tpu_torch.nn.attention import kv_quantize_int8
from scaling_tpu_torch.ops import (
    launches,
    paged_attention,
    paged_attention_plain,
    rms_norm,
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
