"""Import and export of reference ("Scaling") PyTorch checkpoints in the
port against the JAX package's converters.

A JAX model at toy widths draws its weights from a seed; the port takes
them through ``params_from_jax``. Each package saves its own checkpoint
and exports it through its own exporter: the ``.pt`` files are equal
tensor for tensor (names, dtypes, shapes, values), in f32 and in bf16,
untied and tied. The port imports JAX's export, loads it and its logits
equal JAX's within 1e-5 in f32 (summation order only); the import is
served by the port's engine with the original weights' greedy tokens.
Export then import is bit-exact, bf16 goes out as ``torch.bfloat16``,
the tied head's repeat of the table is written, and adapter names, PEFT
suffix files and legacy whole-model state dicts map as in the JAX
package (tests/transformer/test_reference_weight_import.py), each
compared with the JAX converter's output on the same input.
"""

import numpy as np
import pytest
import torch
import yaml

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from scaling_tpu.checkpoint import export_reference as jax_export  # noqa: E402
from scaling_tpu.checkpoint import import_reference as jax_import  # noqa: E402
from scaling_tpu.checkpoint.checkpoint import save_model_checkpoint as jax_save  # noqa: E402
from scaling_tpu.models.transformer.inference import (  # noqa: E402
    TransformerInferenceModule as JaxInference,
)
from scaling_tpu_torch.checkpoint import load_model_checkpoint, save_model_checkpoint  # noqa: E402
from scaling_tpu_torch.checkpoint.export_reference import (  # noqa: E402
    export_layer,
    export_reference_checkpoint,
)
from scaling_tpu_torch.checkpoint.import_reference import (  # noqa: E402
    convert_legacy_state_dict,
    convert_reference_checkpoint,
    convert_reference_layer,
    write_converted_layers,
)
from scaling_tpu_torch.models.transformer import (  # noqa: E402
    TransformerArchitectureConfig,
    TransformerInferenceModule,
)
from scaling_tpu_torch.models.transformer.convert import params_from_jax  # noqa: E402
from scaling_tpu_torch.parallel.parallel_module import jax_param_key  # noqa: E402
from scaling_tpu_torch.serve import EngineConfig, ServeEngine  # noqa: E402

from .test_torch_parity_helpers import draw_weights, one_torch_thread  # noqa: E402,F401

ARCH = {
    "vocab_size": 96, "hidden_size": 64, "num_layers": 2, "num_attention_heads": 4,
    "attention_num_kv_heads": 2, "sequence_length": 32, "precision": "float32",
    "mlp_type": "swiglu", "mlp_factor": 2.0, "norm_type": "rms", "weight_tying": False,
}
CASES = {"f32": {}, "f32-tied": {"weight_tying": True}, "bf16": {"precision": "bfloat16"},
         "bf16-tied": {"precision": "bfloat16", "weight_tying": True},
         "default-arch": {"norm_type": "layernorm", "mlp_type": "default", "mlp_factor": 4.0,
                          "attention_qkv_in_one": True, "weight_tying": True}}


def port_params(model) -> dict:
    return {jax_param_key(model, name): p for name, p in model.named_parameters()}


def saved_pair(tmp_path, arch: dict, seed: int = 0):
    """The drawn weights saved by each package (with a config.yml), and
    the JAX inference module and the port's model on them."""
    config, module, np_params = draw_weights(arch, seed)
    dtype = jnp.bfloat16 if arch["precision"] == "bfloat16" else jnp.float32
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), np_params)
    dirs = {name: tmp_path / name for name in ("jax_npz", "port_npz")}
    jax_save(dirs["jax_npz"], module.ckpt_view(params), module.ckpt_metas())
    port_arch = TransformerArchitectureConfig.from_dict(arch)
    port = TransformerInferenceModule.from_state_dict(
        port_arch, params_from_jax(np_params, port_arch), device="cpu")
    save_model_checkpoint(dirs["port_npz"], port_params(port.model))
    for d in dirs.values():
        (d / "config.yml").write_text(yaml.safe_dump({"transformer_architecture": arch}))
    return dirs, JaxInference(config, module, params), port


def load_pt(path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def assert_same_pt_files(got_dir, want_dir) -> None:
    names = sorted(p.name for p in want_dir.glob("*.pt"))
    assert sorted(p.name for p in got_dir.glob("*.pt")) == names and names
    for name in names:
        got, want = load_pt(got_dir / name), load_pt(want_dir / name)
        assert sorted(got) == sorted(want), name
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, f"{name}:{k}"
            assert torch.equal(got[k], want[k]), f"{name}:{k}"


def assert_same_npz_dirs(got_dir, want_dir) -> None:
    names = sorted(p.name for p in want_dir.glob("*.npz"))
    assert sorted(p.name for p in got_dir.glob("*.npz")) == names and names
    for name in names:
        with np.load(got_dir / name) as got, np.load(want_dir / name) as want:
            assert sorted(got.files) == sorted(want.files), name
            for k in want.files:
                assert got[k].dtype == want[k].dtype, f"{name}:{k}"
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}:{k}")


@pytest.mark.parametrize("case", list(CASES))
def test_both_exporters_write_the_same_pt_files(tmp_path, case):
    arch = {**ARCH, **CASES[case]}
    dirs, _, _ = saved_pair(tmp_path, arch)
    n_port = export_reference_checkpoint(dirs["port_npz"], tmp_path / "port_pt")
    n_jax = jax_export.export_reference_checkpoint(dirs["jax_npz"], tmp_path / "jax_pt")
    assert n_port == n_jax == arch["num_layers"] + 3  # embedding, layers, norm, head
    assert_same_pt_files(tmp_path / "port_pt", tmp_path / "jax_pt")
    want = torch.bfloat16 if arch["precision"] == "bfloat16" else torch.float32
    layer = load_pt(tmp_path / "port_pt" / "model_state_layer_1_TransformerLayer.pt")
    assert {t.dtype for t in layer.values()} == {want}
    assert any(k.startswith("self_attention.") for k in layer)
    if arch["weight_tying"]:
        head = load_pt(tmp_path / "port_pt"
                       / f"model_state_layer_{arch['num_layers'] + 2}_TransformerLMHeadTied.pt")
        emb = load_pt(tmp_path / "port_pt" / "model_state_layer_0_EmbeddingInput.pt")
        assert torch.equal(head["embedding.weight"], emb["embedding.weight"])


@pytest.mark.parametrize("case", ["f32", "f32-tied", "default-arch"])
def test_the_ports_import_of_jaxs_export_gives_jaxs_logits(tmp_path, case):
    arch = {**ARCH, **CASES[case]}
    dirs, jax_inf, port = saved_pair(tmp_path, arch, seed=1)
    jax_export.export_reference_checkpoint(dirs["jax_npz"], tmp_path / "ref")
    imported = tmp_path / "imported"
    tied = 1 if arch["weight_tying"] else 0
    assert convert_reference_checkpoint(tmp_path / "ref", imported) == arch["num_layers"] + 3 - tied
    assert_same_npz_dirs(imported, dirs["port_npz"])  # the tied head's repeat dropped
    fresh = TransformerInferenceModule.random_init(
        TransformerArchitectureConfig.from_dict(arch), seed=9, device="cpu")
    load_model_checkpoint(imported, port_params(fresh.model))
    tokens = np.random.default_rng(4).integers(1, arch["vocab_size"], size=(2, 20))
    ref = np.asarray(jax_inf.logits(tokens))
    out = fresh.logits(tokens).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)  # f32: summation order only


def test_an_imported_checkpoint_is_served_with_the_original_weights_tokens(tmp_path):
    dirs, _, port = saved_pair(tmp_path, ARCH, seed=2)
    export_reference_checkpoint(dirs["port_npz"], tmp_path / "ref")
    imported = tmp_path / "imported"
    convert_reference_checkpoint(tmp_path / "ref", imported)
    (imported / "config.yml").write_text((dirs["port_npz"] / "config.yml").read_text())
    served = {}
    for name, inf in (("imported", TransformerInferenceModule.from_checkpoint(
            imported, device="cpu")), ("original", port)):
        engine = ServeEngine(inf, EngineConfig(num_slots=2, block_size=4, num_blocks=32,
                                               max_blocks_per_seq=8), device="cpu")
        for prompt in ([1, 2, 3, 4, 5], [9, 8, 7]):
            engine.submit(prompt, 6)
        served[name] = [s.generated for s in engine.run_until_done()]
    assert served["imported"] == served["original"]
    assert [len(g) for g in served["original"]] == [6, 6]


@pytest.mark.parametrize("case", ["f32", "bf16-tied"])
def test_export_then_import_is_bit_exact(tmp_path, case):
    arch = {**ARCH, **CASES[case]}
    dirs, _, _ = saved_pair(tmp_path, arch, seed=3)
    src = dirs["port_npz"]
    rng = np.random.default_rng(0)
    # a PEFT side file and adapters travel too
    np.savez(src / "model_state_layer_1_TransformerLayer__lora.npz", **{
        "attention.dense.bias_lora": rng.normal(size=(64,)).astype(np.float32)})
    np.savez(src / "model_state_layer_2_TransformerLayer__adapter.npz", **{
        "adapter_attention_a.down": rng.normal(size=(64, 4)).astype(np.float32),
        "adapter_mlp_a.up": rng.normal(size=(4, 64)).astype(np.float32)})
    if arch["precision"] == "bfloat16":  # what a bf16 save holds: bf16 values widened
        for f in src.glob("*__*.npz"):
            with np.load(f) as z:
                rounded = {k: torch.from_numpy(z[k]).bfloat16().float().numpy() for k in z.files}
            np.savez(f, **rounded)
    n = export_reference_checkpoint(src, tmp_path / "ref")
    names = sorted(p.name for p in (tmp_path / "ref").glob("*.pt"))
    assert "model_state_layer_1_TransformerLayer_lora.pt" in names
    sd = load_pt(tmp_path / "ref" / "model_state_layer_2_TransformerLayer_adapter.pt")
    assert sd["attn_adapter_a.dense_in.weight"].shape == (4, 64)  # torch (out, in)
    assert sd["mlp_adapter_a.dense_out.weight"].shape == (64, 4)
    back = tmp_path / "back"
    tied = 1 if arch["weight_tying"] else 0
    assert convert_reference_checkpoint(tmp_path / "ref", back) == n - tied
    assert_same_npz_dirs(back, src)


def test_export_layer_keeps_bf16_tensors_as_jax_keeps_bf16_arrays():
    """Live bf16 parameters export as ``torch.bfloat16``, the tensors JAX's
    exporter makes of the same values in bf16 arrays."""
    rng = np.random.default_rng(3)
    weight = torch.from_numpy(rng.normal(size=(16, 32)).astype(np.float32)).bfloat16()
    bias = torch.from_numpy(rng.normal(size=(16,)).astype(np.float32)).bfloat16()
    out = export_layer({"mlp.dense_in.weight": weight, "attention.dense.bias": bias})
    assert out["mlp.dense_in.weight"].dtype == out["self_attention.dense.bias"].dtype
    assert out["self_attention.dense.bias"].dtype == torch.bfloat16
    assert torch.equal(out["mlp.dense_in.weight"], weight.T)  # torch (out, in)
    ref = jax_export.export_layer({k: np.asarray(v.float()).astype(jnp.bfloat16) for k, v in (
        ("mlp.dense_in.weight", weight), ("attention.dense.bias", bias))})
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert torch.equal(out[k], ref[k]), k


def reference_layer_state(rng) -> dict:
    """A reference TransformerLayer's state dict: fused qkv under
    ``self_attention.``, legacy MLP names, a rotary buffer, adapters."""
    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)

    return {
        "self_attention.query_key_value.weight": t(48, 16),
        "self_attention.dense.weight": t(16, 16, dtype=torch.bfloat16),
        "self_attention.dense.bias": t(16),
        "self_attention.rotary_emb.inv_freq": t(4),
        "mlp.dense_h_to_4h.weight": t(64, 16),
        "mlp.dense_4h_to_h.weight": t(16, 64),
        "input_layernorm.weight": t(16),
        "attn_adapter_ad.dense_in.weight": t(4, 16),
        "attn_adapter_ad.dense_out.weight": t(16, 4),
        "mlp_adapter_ad.dense_in.weight": t(4, 16),
    }


def test_layer_conversion_maps_names_as_jax_does():
    sd = reference_layer_state(np.random.default_rng(5))
    out, ref = convert_reference_layer(sd), jax_import.convert_reference_layer(sd)
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype == np.float32, k
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert out["attention.query_key_value.weight"].shape == (16, 48)  # (in, out)
    assert out["adapter_attention_ad.down"].shape == (16, 4)
    assert out["adapter_attention_ad.up"].shape == (4, 16)
    assert out["adapter_mlp_ad.down"].shape == (16, 4)
    assert "mlp.dense_in.weight" in out and not any("inv_freq" in k for k in out)


def test_checkpoint_conversion_writes_jaxs_files_for_peft_and_bf16(tmp_path):
    rng = np.random.default_rng(6)
    src = tmp_path / "ref"
    src.mkdir()
    emb = {"embedding.weight": torch.from_numpy(rng.normal(size=(8, 16)).astype(
        np.float32)).bfloat16()}
    torch.save(emb, src / "model_state_layer_0_EmbeddingInput.pt")
    torch.save(reference_layer_state(rng), src / "model_state_layer_1_TransformerLayer.pt")
    torch.save({"attention.dense_lora.lora_a": torch.zeros(4, 2, dtype=torch.bfloat16)},
               src / "model_state_layer_1_TransformerLayer_lora.pt")
    torch.save({"norm.weight": torch.ones(16)}, src / "model_state_layer_2_LayerNormWrapper.pt")
    torch.save(emb, src / "model_state_layer_3_TransformerLMHeadTied.pt")
    torch.save({"bias_b.weight": torch.zeros(4)},
               src / "model_state_layer_3_TransformerLMHeadTied_b.pt")
    assert convert_reference_checkpoint(src, tmp_path / "port") == 5  # the tied head skipped
    assert jax_import.convert_reference_checkpoint(src, tmp_path / "jax") == 5
    assert_same_npz_dirs(tmp_path / "port", tmp_path / "jax")
    names = sorted(p.name for p in (tmp_path / "port").glob("*.npz"))
    assert "model_state_layer_1_TransformerLayer__lora.npz" in names
    assert "model_state_layer_3_TransformerLMHeadTied__b.npz" in names
    with np.load(tmp_path / "port" / "model_state_layer_0_EmbeddingInput.npz") as z:
        assert z["embedding.weight"].dtype == np.float32


def test_legacy_state_dict_converts_as_jax_does(tmp_path):
    rng = np.random.default_rng(7)
    sd = {"transformer.embeddings.word_embeddings.weight": torch.randn(96, 16)}
    for i in range(2):
        sd.update({f"transformer.layer{i}.{k.replace('self_attention.', 'attention.')}": v
                   for k, v in reference_layer_state(rng).items()})
    sd["transformer.norm.weight"] = torch.ones(16)
    sd["transformer.norm.bias"] = torch.zeros(16)
    out = convert_legacy_state_dict(sd, num_layers=2)
    ref = jax_import.convert_legacy_state_dict(sd, num_layers=2)
    assert sorted(out) == sorted(ref) == [
        "model_state_layer_0_EmbeddingInput", "model_state_layer_1_TransformerLayer",
        "model_state_layer_2_TransformerLayer", "model_state_layer_3_LayerNormWrapper"]
    write_converted_layers(out, tmp_path / "port")
    jax_import.write_converted_layers(ref, tmp_path / "jax")
    assert_same_npz_dirs(tmp_path / "port", tmp_path / "jax")
    with pytest.raises(ValueError, match="unrecognized"):
        convert_legacy_state_dict({"transformer.other": torch.zeros(1)}, num_layers=1)
