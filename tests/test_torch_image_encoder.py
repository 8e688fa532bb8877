"""The image encoder and multimodal finetuning of the port against the JAX
package, on the CPU in f32.

Weights are drawn with numpy from a seed in the shapes of the JAX tree and
carried to the port through ``params_from_jax``; images, token ids and
data files come from numpy seeds too. Pretrained CLIP weights are drawn by
a tiny seeded ``transformers.CLIPVisionModel`` (no download). Tolerances,
each stated where it is used:

- each backbone's forward and the embedding splice: atol 2e-5 (the same
  f32 products summed in another order, through up to 3 blocks);
- the CLIP ViT import against the ``CLIPVisionModel``'s features: atol
  1e-4, as the JAX package's own test holds it; the imported weights equal
  the JAX import's exactly (the position interpolation included);
- three multimodal train steps: losses within rtol 1e-4 and each
  parameter's gradient norm (``optimizer.debug_log``, after clipping)
  within rtol 1e-4 and atol 1e-8 of the JAX step's;
- checkpoints, parameter groups, the partition specs of ``MESH.json``
  and the finetuning batches: exact.
"""

import json
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from scaling_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from scaling_tpu.models.transformer.clip_resnet import (  # noqa: E402
    ClipResNetEncoder as JaxClipResNet,
)
from scaling_tpu.models.transformer.clip_resnet import (  # noqa: E402
    import_clip_resnet_weights as jax_import_resnet,
)
from scaling_tpu.models.transformer.clip_vision import (  # noqa: E402
    ClipVisionEncoder as JaxClipVision,
)
from scaling_tpu.models.transformer.clip_vision import (  # noqa: E402
    import_clip_vision_weights as jax_import_clip,
)
from scaling_tpu.models.transformer.image_encoder import ImageEncoder as JaxImageEncoder  # noqa: E402
from scaling_tpu.models.transformer.image_encoder import patchify as jax_patchify  # noqa: E402
from scaling_tpu.models.transformer.layers.embedding import (  # noqa: E402
    EmbeddingInput as JaxEmbeddingInput,
)
from scaling_tpu.models.transformer.model import (  # noqa: E402
    get_parameter_groups as jax_parameter_groups,
)
from scaling_tpu.models.transformer.model import init_model as jax_init_model  # noqa: E402
from scaling_tpu.models.transformer.model import init_optimizer as jax_init_optimizer  # noqa: E402
from scaling_tpu.models.transformer.model import loss_function as jax_loss  # noqa: E402
from scaling_tpu.nn.base_layer import ForwardContext  # noqa: E402
from scaling_tpu.nn.param import ParamMeta  # noqa: E402
from scaling_tpu.topology import Topology  # noqa: E402
from scaling_tpu_torch.data import MemoryMapDatasetBuilder  # noqa: E402
from scaling_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig,
    TransformerModel,
    get_parameter_groups,
    init_optimizer,
    loss_function,
)
from scaling_tpu_torch.models.transformer.clip_resnet import (  # noqa: E402
    ClipResNetEncoder,
    import_clip_resnet_weights,
)
from scaling_tpu_torch.models.transformer.clip_vision import (  # noqa: E402
    ClipVisionEncoder,
    import_clip_vision_weights,
)
from scaling_tpu_torch.models.transformer.convert import params_from_jax  # noqa: E402
from scaling_tpu_torch.models.transformer.image_encoder import ImageEncoder, patchify  # noqa: E402
from scaling_tpu_torch.models.transformer.layers.embedding import EmbeddingInput  # noqa: E402
from scaling_tpu_torch.models.transformer.train import build_trainer  # noqa: E402
from scaling_tpu_torch.models.transformer.train import main as port_main  # noqa: E402
from scaling_tpu_torch.parallel import ParallelModule  # noqa: E402
from scaling_tpu_torch.parallel.parallel_module import (  # noqa: E402
    jax_param_key,
    jax_partition_spec,
)

from .test_torch_checkpoint import assert_states_equal, jax_state, jax_trainer  # noqa: E402
from .test_torch_checkpoint import port_state as port_trainer_state  # noqa: E402
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401

CTX = ForwardContext()
FWD_ATOL = 2e-5
STEP_RTOL = 1e-4
BACKBONES = ["vit", "clip", "clip_resnet"]
# the encoder cut to CPU size: widths 32, 2 blocks, a 4-stage ResNet of 8 channels
ENCODER = dict(width=32, layers=2, heads=4, resnet_stages=(1, 2, 1, 1), resnet_channels=8)


def arch(backbone: str, **extra) -> dict:
    """A toy multimodal LM: 160 positions hold one image (144 tokens) and text."""
    return {"vocab_size": 96, "hidden_size": 32, "num_layers": 2, "num_attention_heads": 4,
            "sequence_length": 160, "precision": "float32", "image_encoder": True,
            "image_encoder_width": 32, "image_encoder_layers": 2, "image_encoder_heads": 4,
            "image_encoder_backbone": backbone, "image_encoder_resnet_stages": [1, 2, 1, 1],
            "image_encoder_resnet_channels": 8, **extra}


def draw_tree(tree, rng):
    """Numpy weights shaped like a JAX tree: He-scaled kernels, xavier-scaled
    matrices, gains near 1, BatchNorm variances in [1, 1.6), small biases
    and means (nonzero, so that their plumbing shows)."""
    def draw(path, leaf):
        key, shape = jax.tree_util.keystr(path), leaf.shape
        if key.endswith("['var']"):
            return (1.0 + 0.2 * np.abs(rng.normal(size=shape))).astype(np.float32)
        if len(shape) == 4:
            return (rng.normal(size=shape) * np.sqrt(2.0 / np.prod(shape[:3]))).astype(np.float32)
        if len(shape) == 2:
            return (rng.normal(size=shape) * np.sqrt(2.0 / sum(shape))).astype(np.float32)
        gain = key.endswith("['weight']") and ("norm" in key or "bn" in key or "ln" in key)
        if gain:
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.02 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.tree.map(np.asarray, tree))


def port_layout(tree) -> dict:
    """A JAX subtree as the matching port module's state dict."""
    state = params_from_jax({"m": tree}, types.SimpleNamespace(dtype=torch.float32))
    return {k[len("layers.m."):]: v for k, v in state.items()}


def images(rng, *shape) -> np.ndarray:
    return rng.normal(size=shape).astype(np.float32)


def jax_config(a: dict, mbs: int = 2, gas: int = 1, **sections) -> dict:
    return {
        "topology": {"model_parallel_size": 1, "pipe_parallel_size": 1,
                     "data_parallel_size": 1, "micro_batch_size": mbs,
                     "gradient_accumulation_steps": gas},
        "transformer_architecture": a,
        "optimizer": {"gradient_clipping": 1.0, "loss_scaler": {"enable": False},
                      "debug_log": True},
        "learning_rate_scheduler": {"learning_rate": 3e-3, "learning_rate_warmup_steps": 10,
                                    "learning_rate_decay_iters": 1000},
        "trainer": {"seed": 0},
        **sections,
    }


def draw_model(a: dict, seed: int = 0):
    """(JAX config, module, numpy weights) of the architecture ``a``."""
    config = JaxConfig.from_dict(jax_config(a))
    module = jax_init_model(config, None)
    return config, module, draw_tree(module.init_params(jax.random.PRNGKey(0)),
                                     np.random.default_rng(seed))


# ------------------------------------------------------------ the encoders
def test_patchify_flattens_like_jax():
    x = images(np.random.default_rng(0), 2, 64, 96, 3)
    np.testing.assert_array_equal(patchify(torch.from_numpy(x), 32).numpy(),
                                  np.asarray(jax_patchify(jnp.asarray(x), 32)))


@pytest.mark.parametrize("backbone", BACKBONES)
def test_encoder_forward_matches_jax(backbone):
    """Each backbone on 384 x 384 images: 144 tokens, within FWD_ATOL."""
    ref = JaxImageEncoder(24, backbone=backbone, **ENCODER)
    tree = draw_tree(ref.init(jax.random.PRNGKey(0)), np.random.default_rng(0))
    enc = ImageEncoder(24, backbone=backbone, **ENCODER)
    enc.load_state_dict(port_layout(tree))
    x = images(np.random.default_rng(1), 2, 384, 384, 3)
    want = np.asarray(ref(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), CTX))
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 144, 24)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)


def tiny_hf_clip(image_size, width=64, layers=2, heads=4, intermediate=128):
    """A seeded ``CLIPVisionModel`` at patch 32: the pretrained weights'
    stand-in (as the JAX package's tests draw it)."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.CLIPVisionConfig(hidden_size=width, intermediate_size=intermediate,
                                        num_hidden_layers=layers, num_attention_heads=heads,
                                        image_size=image_size, patch_size=32)
    torch.manual_seed(7)
    return transformers.CLIPVisionModel(cfg).eval()


def clip_pair(image_size, **geometry):
    g = {**dict(width=64, layers=2, heads=4, patch_size=32, image_size=image_size,
                intermediate=128), **geometry}
    return ClipVisionEncoder(**g), JaxClipVision(**g)


@pytest.mark.parametrize("source_size", [96, 64], ids=["same_grid", "interpolated"])
def test_clip_import_reproduces_hf_features_and_jax(source_size):
    """A ``CLIPVisionModel`` state dict into a 96-pixel tower: the import
    equals the JAX import's exactly, the position grid bicubic-interpolated
    where the checkpoint's (64 pixels: 2 x 2) differs; the features equal
    the model's ``last_hidden_state[:, 1:]`` within 1e-4 on its own grid,
    and the JAX tower's on the imported weights within FWD_ATOL."""
    model = tiny_hf_clip(source_size)
    enc, ref = clip_pair(96)
    state = import_clip_vision_weights(enc, model.state_dict())
    ref_tree = jax_import_clip(ref, model.state_dict())
    want_state = port_layout(jax.tree.map(np.asarray, ref_tree))
    assert state.keys() == want_state.keys()
    for k, v in want_state.items():
        np.testing.assert_array_equal(state[k].numpy(), v.numpy(), err_msg=k)
    enc.load_state_dict(state)
    pixels = images(np.random.default_rng(0), 2, 3, 96, 96)
    with torch.no_grad():
        got = enc(torch.from_numpy(pixels).permute(0, 2, 3, 1)).numpy()
        if source_size == 96:
            hf = model(torch.from_numpy(pixels)).last_hidden_state[:, 1:].numpy()
            np.testing.assert_allclose(got, hf, atol=1e-4)
    want = np.asarray(ref(ref_tree, jnp.asarray(pixels.transpose(0, 2, 3, 1)), CTX))
    assert got.shape == (2, 9, 64)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)


@pytest.mark.parametrize("geometry,match", [
    (dict(layers=3), "encoder layers"), (dict(width=32, heads=4), "width"),
    (dict(intermediate=256), "mlp width")], ids=["depth", "width", "mlp"])
def test_clip_import_refuses_another_geometry(geometry, match):
    """A tower that is not the checkpoint's shape refuses it by name, as the
    JAX import does."""
    model = tiny_hf_clip(96)
    enc, ref = clip_pair(96, **geometry)
    with pytest.raises(ValueError, match=match):
        import_clip_vision_weights(enc, model.state_dict())
    with pytest.raises(ValueError, match=match):
        jax_import_clip(ref, model.state_dict())


def openai_resnet_dict(tree) -> dict:
    """A JAX ClipResNet tree written as an OpenAI-CLIP ModifiedResNet state
    dict (kernels OIHW, ``running_mean``/``running_var``, ``layerN.j``)."""
    sd = {}

    def bn(ours, theirs):
        for leaf, key in (("weight", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                          ("var", "running_var")):
            sd[f"{theirs}.{key}"] = torch.from_numpy(np.asarray(ours[leaf]))

    def conv(w):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)))

    for i in (1, 2, 3):
        sd[f"conv{i}.weight"] = conv(tree["stem"][f"conv{i}"]["weight"])
        bn(tree["stem"][f"bn{i}"], f"bn{i}")
    for stage in (1, 2, 3, 4):
        for j, block in enumerate(tree[f"layer{stage}"].values()):
            base = f"layer{stage}.{j}"
            for c in (1, 2, 3):
                sd[f"{base}.conv{c}.weight"] = conv(block[f"conv{c}"]["weight"])
                bn(block[f"bn{c}"], f"{base}.bn{c}")
            if "downsample_conv" in block:
                sd[f"{base}.downsample.0.weight"] = conv(block["downsample_conv"]["weight"])
                bn(block["downsample_bn"], f"{base}.downsample.1")
    return sd


def resnet_pair(stages=(1, 2, 1, 1), channels=8):
    return (ClipResNetEncoder(stage_blocks=stages, channels=channels, image_size=64),
            JaxClipResNet(stage_blocks=stages, channels=channels, image_size=64))


@pytest.mark.parametrize("prefix", ["", "visual.", "input_encoder.", "module.visual."])
def test_clip_resnet_import_takes_prefixed_dicts(prefix):
    """The full CLIP model's, a magma image encoder's and a wrapped
    module's keys import to the tree they were written from, as the JAX
    import reads them; the tower then computes the JAX tower's tokens."""
    enc, ref = resnet_pair()
    tree = draw_tree(ref.init(jax.random.PRNGKey(0)), np.random.default_rng(3))
    sd = {prefix + k: v for k, v in openai_resnet_dict(tree).items()}
    state = import_clip_resnet_weights(enc, sd)
    want = port_layout(tree)
    assert state.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(state[k].numpy(), v.numpy(), err_msg=k)
    ref_state = port_layout(jax.tree.map(np.asarray, jax_import_resnet(ref, sd)))
    assert all(torch.equal(state[k], v) for k, v in ref_state.items())
    enc.load_state_dict(state)
    x = images(np.random.default_rng(4), 2, 64, 64, 3)
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref(tree, jnp.asarray(x), CTX)), atol=FWD_ATOL)


@pytest.mark.parametrize("what", ["stem", "depth", "downsample", "trunk"])
def test_clip_resnet_import_refuses_another_geometry(what):
    """Another stem width, stage depth or shortcut, or no trunk at all, is
    refused by name in both packages."""
    enc, ref = resnet_pair()
    sd = openai_resnet_dict(draw_tree(ref.init(jax.random.PRNGKey(0)),
                                      np.random.default_rng(3)))
    if what == "stem":
        enc, ref = resnet_pair(channels=16)
        match = "channel mismatch"
    elif what == "depth":
        enc, ref = resnet_pair(stages=(1, 1, 1, 1))
        match = "stage depth mismatch"
    elif what == "downsample":
        sd = {k: v for k, v in sd.items() if not k.startswith("layer2.0.downsample")}
        match = "downsample mismatch"
    else:
        sd = {k: v for k, v in sd.items() if not k.startswith("conv1")}
        match = "no ModifiedResNet trunk"
    with pytest.raises(ValueError, match=match):
        import_clip_resnet_weights(enc, sd)
    with pytest.raises(ValueError, match=match):
        jax_import_resnet(ref, sd)


# ---------------------------------------------------- the embedding splice
def test_embedding_splice_matches_jax():
    """Two image slots a row over 320 positions: row 0 two images, row 1 its
    second slot padded (masked: nothing written from it), row 2 a start
    past ``s - 144`` (clamped, as JAX's ``dynamic_update_slice`` clamps).
    The activations equal JAX's within FWD_ATOL, and every position that no
    image covers is the token embedding, bitwise."""
    a = arch("vit", sequence_length=320)
    config = JaxConfig.from_dict(jax_config(a))
    ref = JaxEmbeddingInput(config.transformer_architecture)
    tree = draw_tree(ref.init(jax.random.PRNGKey(0)), np.random.default_rng(0))
    layer = EmbeddingInput(TransformerConfig.from_dict(jax_config(a)).transformer_architecture)
    layer.load_state_dict(port_layout(tree))
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, 96, size=(3, 320))
    imgs = images(rng, 3, 2, 384, 384, 3)
    locs = np.array([[4, 160], [10, 0], [250, 0]], np.int32)
    mask = np.array([[True, True], [True, False], [True, False]])
    batch = {"token_ids": jnp.asarray(tokens, jnp.int32), "position_ids": None,
             "segment_ids": None, "loss_weights": None, "input_images": jnp.asarray(imgs),
             "input_image_locations": jnp.asarray(locs), "input_image_mask": jnp.asarray(mask)}
    want = np.asarray(ref(jax.tree.map(jnp.asarray, tree), batch, CTX)["activations"])
    with torch.no_grad():
        got = layer(torch.from_numpy(tokens), None, torch.from_numpy(imgs),
                    torch.from_numpy(locs), torch.from_numpy(mask)).numpy()
        plain = layer(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)
    covered = np.zeros((3, 320), bool)
    for row, starts in ((0, (4, 160)), (1, (10,)), (2, (176,))):
        for st in starts:
            covered[row, st:st + 144] = True
    np.testing.assert_array_equal(got[~covered], plain[~covered])
    assert not np.allclose(got[covered], plain[covered])


# ------------------------------------------------------------- training
def multimodal_batches(a: dict, steps: int, gas: int, mbs: int, seed: int = 9) -> list:
    """Micro-batches of token ids with two image slots a row, the second
    padded in odd rows; loss weights 0 on the image placeholders."""
    rng = np.random.default_rng(seed)
    s = a["sequence_length"]
    out = []
    for _ in range(steps):
        tokens = rng.integers(1, a["vocab_size"], size=(gas, mbs, s))
        weights = np.ones((gas, mbs, s), np.float32)
        weights[..., 8:8 + 144] = 0.0
        mask = np.ones((gas, mbs, 2), bool)
        mask[:, 1::2, 1] = False
        out.append({
            "token_ids": tokens, "target_token_ids": np.roll(tokens, -1, axis=-1),
            "position_ids": np.broadcast_to(np.arange(s), (gas, mbs, s)),
            "segment_ids": np.zeros((gas, mbs, s)), "loss_weights": weights,
            "input_images": images(rng, gas, mbs, 2, 384, 384, 3),
            "input_image_locations": np.broadcast_to(np.array([8, 12], np.int32),
                                                     (gas, mbs, 2)),
            "input_image_mask": mask})
    return out


def _as_jax(b):
    return {k: jnp.asarray(v, jnp.float32 if k in ("loss_weights", "input_images") else
                           bool if k == "input_image_mask" else jnp.int32)
            for k, v in b.items()}


def _as_port(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        torch.float32 if k in ("loss_weights", "input_images") else
        torch.bool if k == "input_image_mask" else torch.int64) for k, v in b.items()}


@pytest.mark.parametrize("backbone", BACKBONES)
def test_multimodal_train_steps_match_jax(backbone):
    """3 steps at gas 2 of both packages' train steps on carried weights, two
    image slots a row: the losses within STEP_RTOL and each parameter's
    gradient norm (``debug_log``) within rtol STEP_RTOL, atol 1e-8; the
    BatchNorm statistics of ``clip_resnet`` take no gradient and stay as
    they were, bitwise."""
    a = arch(backbone)
    cfg = jax_config(a, gas=2)
    config = JaxConfig.from_dict(cfg)
    _, _, np_params = draw_model(a)
    batches = multimodal_batches(a, 3, 2, 2)
    topology = Topology(config.topology)
    module = jax_init_model(config, topology)
    optimizer = jax_init_optimizer(config, module, topology)
    params = jax.tree.map(jnp.asarray, np_params)
    state = optimizer.init_state(params)
    step = module.build_train_step(optimizer, jax_loss, donate=False)
    ref = []
    for b in batches:
        params, state, loss, _, out = step(params, state, _as_jax(b), jax.random.PRNGKey(0))
        ref.append((float(loss), {k: float(v) for k, v in out.debug_dict.items()}))
    port_config = TransformerConfig.from_dict(cfg)
    model = TransformerModel(port_config.transformer_architecture)
    model.load_state_dict(params_from_jax(np_params, port_config.transformer_architecture))
    stats = {n: p.detach().clone() for n, p in model.named_parameters()
             if n.endswith((".mean", ".var"))}
    assert bool(stats) == (backbone == "clip_resnet")
    port_step = ParallelModule(model, port_config.topology).build_train_step(
        init_optimizer(port_config, model), loss_function)
    for b, (ref_loss, ref_norms) in zip(batches, ref):
        loss, _, out = port_step(_as_port(b))
        norms = {k: float(v) for k, v in out.debug_dict.items()}
        np.testing.assert_allclose(float(loss), ref_loss, rtol=STEP_RTOL)
        assert norms.keys() == ref_norms.keys()
        keys = sorted(ref_norms)
        np.testing.assert_allclose([norms[k] for k in keys], [ref_norms[k] for k in keys],
                                   rtol=STEP_RTOL, atol=1e-8)
        assert any(norms[k] > 0 for k in keys if ".image_encoder." in k)
    for n, p in model.named_parameters():
        if n in stats:
            assert torch.equal(p, stats[n]) and ref_norms[jax_param_key(model, n)] == 0.0, n


def test_remat_and_dropout_draw_the_image_encoders_masks_again():
    """Under ``every_layer`` remat the embedding (and its image encoder) is
    recomputed in the backward: with ``dropout_image_encoder`` the step is
    the one without remat, bitwise in loss, the parameters within 1e-6."""
    from scaling_tpu_torch.nn.base_layer import dropout_key

    a = arch("vit", dropout_image_encoder=0.1)
    _, _, np_params = draw_model(a)
    batch = _as_port(multimodal_batches(a, 1, 1, 2)[0])
    results = []
    for remat in ("disabled", "every_layer"):
        cfg = jax_config(a)
        cfg["topology"]["activation_checkpointing_type"] = remat
        config = TransformerConfig.from_dict(cfg)
        model = TransformerModel(config.transformer_architecture)
        model.load_state_dict(params_from_jax(np_params, config.transformer_architecture))
        step = ParallelModule(model, config.topology).build_train_step(
            init_optimizer(config, model), loss_function)
        loss = float(step(batch, dropout_key(0, 0))[0])
        results.append((loss, {n: p.detach().clone() for n, p in model.named_parameters()}))
    (l0, p0), (l1, p1) = results
    assert l0 == l1
    for n in p0:
        torch.testing.assert_close(p0[n], p1[n], rtol=0, atol=1e-6)


@pytest.mark.parametrize("backbone", BACKBONES)
def test_parameter_groups_and_specs_match_jax(backbone):
    """Under muP (base width 16: m = 2) the groups hold the JAX groups' keys
    with their ``lr_scale``: every image-encoder leaf at the base rate, the
    BatchNorm parameters and CLIP's norms in the no-decay group; and
    ``jax_partition_spec`` gives each image-encoder leaf its JAX meta's
    spec (the CLIP tower replicated, ``proj`` row-parallel)."""
    a = arch(backbone, mup={"base_hidden_size": 16})
    config = JaxConfig.from_dict(jax_config(a))
    module = jax_init_model(config, None)
    want = {g.name: (set(g.keys), g.lr_scale) for g in jax_parameter_groups(config, module)}
    port_config = TransformerConfig.from_dict(jax_config(a))
    model = TransformerModel(port_config.transformer_architecture)
    got = {g.name: ({jax_param_key(model, n) for n in g.keys}, g.lr_scale)
           for g in get_parameter_groups(port_config, model)}
    assert got == want
    assert not any("image_encoder" in k for k in want["weight_decay_params"][0] |
                   want.get("no_weight_decay_params_width_scaled", (set(),))[0])
    metas = {m.key: m for m in jax.tree.leaves(module.param_metas(),
                                               is_leaf=lambda x: isinstance(x, ParamMeta))}
    for name, p in model.named_parameters():
        key = jax_param_key(model, name)
        if ".image_encoder." in key:
            assert jax_partition_spec(key, p.ndim) == tuple(metas[key].partition_spec), key


# -------------------------------------------------------------- checkpoints
@pytest.fixture(scope="module")
def tokens(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokens")
    rng = np.random.default_rng(17)
    with MemoryMapDatasetBuilder(root / "a", dtype=np.uint16) as builder:
        for _ in range(32):
            builder.add(np.append(rng.integers(1, 96, size=rng.integers(8, 200)), 0))
    return [str(root / "a")]


def trainer_dict(a, data, save_dir=None, load_dir=None, iterations=1, **trainer):
    return {**jax_config(a, mbs=2), "data": {"data_prefixes": data}, "logger": {"log_dir": None},
            "optimizer": {"gradient_clipping": 1.0},
            "learning_rate_scheduler": {"learning_rate": 0.01, "learning_rate_warmup_steps": 2,
                                        "learning_rate_decay_iters": 50},
            "trainer": {"train_iterations": iterations, "seed": 42,
                        "save_dir": None if save_dir is None else str(save_dir),
                        "save_interval": 1,
                        "load_dir": None if load_dir is None else str(load_dir),
                        "assert_checkpoint_loaded": load_dir is not None,
                        "delete_past_optimizer_states": False, **trainer}}


@pytest.mark.parametrize("backbone", ["vit", "clip_resnet"])
def test_checkpoints_cross_between_packages(backbone, tokens, tmp_path):
    """A port checkpoint restores in the JAX trainer and a JAX checkpoint in
    the port, parameters and optimizer state exact (the ResNet's kernels
    permuted between the layouts); the two ``MESH.json`` files record the
    same shape and spec for every image-encoder leaf."""
    a = arch(backbone)
    port = build_trainer(TransformerConfig.from_dict(trainer_dict(a, tokens)), device="cpu")
    port.save_checkpoint(tmp_path / "port")
    ref = jax_trainer(trainer_dict(a, tokens, load_dir=tmp_path / "port"), load=True)
    arch_cfg = port.module.model.architecture
    assert_states_equal(port_trainer_state(port), jax_state(ref, arch_cfg))
    ref.save_checkpoint(tmp_path / "jax")
    back = build_trainer(TransformerConfig.from_dict(trainer_dict(
        a, tokens, load_dir=tmp_path / "jax")), device="cpu")
    assert_states_equal(port_trainer_state(back), jax_state(ref, arch_cfg))
    mesh = [json.loads(next((tmp_path / d).glob("global_step*/MESH.json")).read_text())
            for d in ("port", "jax")]
    image_keys = [k for k in mesh[1]["params"] if ".image_encoder." in k]
    assert image_keys and sorted(image_keys) == sorted(
        k for k in mesh[0]["params"] if ".image_encoder." in k)
    for k in image_keys:
        assert mesh[0]["params"][k] == mesh[1]["params"][k], k


# --------------------------------------------------- pretrained CLIP at start
def class_embedding(trainer) -> np.ndarray:
    return trainer.module.model.embedding.image_encoder.clip.class_embedding.detach().numpy()


def test_pretrained_clip_is_spliced_on_fresh_runs_only(tokens, tmp_path):
    """``image_encoder_clip_checkpoint`` through the port's ``main``: a
    fresh run takes the checkpoint's trunk (text data: the trunk rides
    along); a resume does not splice a shifted checkpoint over it; a finetune
    (``load_context: false``) that restored the trunk keeps it and its
    moments; one that ignored the trunk's keys splices it and keeps the LM's
    moments. A directory holding ``pytorch_model.bin`` is read; one without
    it is refused by name."""
    model = tiny_hf_clip(384, intermediate=256)
    sd = model.state_dict()
    ckpt = tmp_path / "clip.pt"
    torch.save(sd, ckpt)
    shifted = tmp_path / "shifted.pt"
    torch.save({k: v + 1.0 if k.endswith("class_embedding") else v for k, v in sd.items()},
               shifted)
    want = sd["vision_model.embeddings.class_embedding"].numpy()
    a = arch("clip", image_encoder_width=64, image_encoder_clip_checkpoint=str(ckpt))

    def run(path, **kw):
        return port_main(TransformerConfig.from_dict(trainer_dict(
            {**a, "image_encoder_clip_checkpoint": str(path)}, tokens, **kw)), device="cpu")

    first = run(ckpt, save_dir=tmp_path / "ckpt")
    np.testing.assert_allclose(class_embedding(first), want, atol=1e-5)
    resumed = run(shifted, load_dir=tmp_path / "ckpt", iterations=2)
    np.testing.assert_allclose(class_embedding(resumed), want, atol=1e-4)
    kept = run(shifted, load_dir=tmp_path / "ckpt", iterations=0, load_context=False)
    np.testing.assert_allclose(class_embedding(kept), want, atol=1e-4)
    assert max(t.abs().max().item() for t in kept.optimizer.state.exp_avg.values()) > 0
    spliced = run(shifted, load_dir=tmp_path / "ckpt", iterations=0, load_context=False,
                  ignore_keys_in_checkpoint=[".*image_encoder.*"])
    np.testing.assert_allclose(class_embedding(spliced), want + 1.0, atol=1e-5)
    opt = spliced.optimizer.state
    assert max(t.abs().max().item() for n, t in opt.exp_avg.items()
               if "image_encoder" not in n) > 0
    assert all(t.abs().max().item() == 0 for n, t in opt.exp_avg.items()
               if ".image_encoder.clip." in n)
    hf_dir = tmp_path / "hf"
    hf_dir.mkdir()
    torch.save(sd, hf_dir / "pytorch_model.bin")
    np.testing.assert_allclose(class_embedding(run(hf_dir, iterations=0)), want, atol=1e-6)
    (hf_dir / "pytorch_model.bin").rename(hf_dir / "model.safetensors")
    with pytest.raises(ValueError, match="pytorch_model.bin"):
        run(hf_dir, iterations=0)


# ------------------------------------------------------ finetuning datasets
@pytest.fixture(scope="module")
def chat_files(tmp_path_factory):
    """Chat transcripts with images (PNG files of several sizes and modes
    from a seed): none, one, two, one at the start, and one the cut at the
    sequence's end drops; and the vocabulary file."""
    pil = pytest.importorskip("PIL.Image")
    pytest.importorskip("tokenizers")
    from scaling_tpu_torch.models.transformer.tokenizer import Tokenizer

    root = tmp_path_factory.mktemp("chat_images")
    (root / "vocab.json").write_text(Tokenizer.default().tokenizer.to_str())
    rng = np.random.default_rng(0)
    for i, (size, mode) in enumerate((((40, 30), "RGB"), ((400, 500), "RGB"),
                                      ((64, 64), "L"))):
        pixels = rng.integers(0, 256, size=size[::-1] + ((3,) if mode == "RGB" else ()))
        pil.fromarray(pixels.astype(np.uint8), mode).save(root / f"img{i}.png")

    def text(content, loss=False):
        return {"type": "text", "content": content, "has_loss": loss}

    def image(i):
        return {"type": "image", "content": f"img{i}.png"}

    lines = [
        [text("Q: the sky\nA:"), text(" blue<|endoftext|>", True)],
        [text("Look:"), image(0), text(" a cat<|endoftext|>", True)],
        [image(1), text(" and"), image(2), text(" two<|endoftext|>", True)],
        [text("the sky is blue " * 50), image(0), text(" cut<|endoftext|>", True)],
    ]
    (root / "chat.jsonl").write_text("\n".join(json.dumps(line) for line in lines))
    return root


@pytest.mark.parametrize("softprompt", [0, 3])
def test_chat_images_match_jax_batches(chat_files, softprompt):
    """Items (token ids, targets, weights, images and their starts, an image
    past the cut dropped) and the collated batches (``max_images`` slots,
    images, starts and mask) equal the JAX chat dataset's, exactly."""
    from scaling_tpu.models.transformer.data import finetuning as jax_ft
    from scaling_tpu_torch.models.transformer.data import finetuning as port_ft

    kw = dict(data_prefix=chat_files / "chat.jsonl", sequence_length=320,
              vocab_file=chat_files / "vocab.json", softprompt_n_tokens=softprompt)
    port, ref = port_ft.FinetuningChatDataset(**kw), jax_ft.FinetuningChatDataset(**kw)
    assert port.max_images == ref.max_images == 2
    dropped = 0
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        for field in ("token_ids", "target_token_ids", "loss_weights"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        assert a.image_locations == b.image_locations
        assert len(a.images or []) == len(b.images or [])
        for x, y in zip(a.images or [], b.images or []):
            assert x.shape == (384, 384, 3)
            np.testing.assert_array_equal(x, y)
        dropped += len(port._samples[i]["image_paths"]) - len(a.images or [])
    assert dropped == 1
    got = port.collate([port[i] for i in range(len(port))])
    want = ref.collate([ref[i] for i in range(len(ref))])
    for field in ("token_ids", "target_token_ids", "position_ids", "segment_ids",
                  "loss_weights", "input_images", "input_image_locations", "input_image_mask"):
        x, y = getattr(got, field), getattr(want, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)
    model_input = got.as_model_input("cpu")
    assert model_input["input_images"].shape == (4, 2, 384, 384, 3)
    assert model_input["input_image_mask"].tolist() == want.input_image_mask.tolist()
    stacked = type(got).stack([got, got])
    assert stacked.input_images.shape == (2, 4, 2, 384, 384, 3)
    text_only = type(got).stack([port.collate([port[0]])] * 2)
    assert text_only.input_images is not None  # a dataset with images keeps its slots


def test_multimodal_chat_finetune_through_both_trainers(chat_files):
    """The chat data with images through the Trainer of each package (the
    port's on the JAX trainer's initial weights): 3 steps at micro-batch 2,
    the losses within STEP_RTOL a step; the image encoder's weights move."""
    from .test_torch_finetune import jax_trainer as jax_example_trainer
    from .test_torch_finetune import losses, port_from_jax_weights

    a = dict(arch("vit", image_encoder_width=64, image_encoder_layers=1, vocab_size=257,
                  sequence_length=320), vocab_file=str(chat_files / "vocab.json"))
    cfg = {**jax_config(a, mbs=2), "logger": {"log_dir": None},
           "data": {"finetuning_chat_dataset": True,
                    "data_prefixes": [str(chat_files / "chat.jsonl")]},
           "trainer": {"train_iterations": 3, "seed": 42, "save_dir": None}}
    ref = jax_example_trainer(cfg)
    port = port_from_jax_weights(cfg, ref)
    before = port.module.model.embedding.image_encoder.patch_proj.weight.detach().clone()
    got, want = losses(port, 3), losses(ref, 3)
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL)
    assert not torch.equal(port.module.model.embedding.image_encoder.patch_proj.weight, before)
