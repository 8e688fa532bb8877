"""The finetuning slice as a whole, on ``examples/finetune_example``'s two
configs (read, never written: the paths point into ``tmp_path`` and the
iterations are cut to 4 + 4). The data is written as the example's
``run.py`` writes it, with the port's ``Tokenizer.default()`` and
``prepare``.

- Pretrain: the JAX trainer's initial weights go into the port by
  ``params_from_jax``; 4 steps in each package, losses within rtol 1e-4.
- Finetune: each package loads the JAX base checkpoint (no optimizer
  state, no context, the LoRA keys allowed missing); the JAX trainer's
  freshly initialised LoRA leaves go into the port the same way; 4 LoRA
  steps on the chat data, losses within rtol 1e-4, only the LoRA leaves
  moving.
- The LoRA checkpoints cross both ways: the port's loads into the JAX
  trainer and the JAX one's into the port's, parameters and optimizer
  state exact, the frozen base's (0,) placeholders included.
- The tuned checkpoint gives the same greedy tokens in both packages.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

jax = pytest.importorskip("jax")
pytest.importorskip("tokenizers")

from scaling_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from scaling_tpu.models.transformer.context import TransformerContext as JaxContext  # noqa: E402
from scaling_tpu.models.transformer.inference import (  # noqa: E402
    TransformerInferenceModule as JaxInference,
)
from scaling_tpu.models.transformer.model import init_model as jax_init_model  # noqa: E402
from scaling_tpu.models.transformer.model import init_optimizer as jax_init_optimizer  # noqa: E402
from scaling_tpu.models.transformer.model import loss_function as jax_loss  # noqa: E402
from scaling_tpu.models.transformer.train import TransformerTrainer as JaxTrainer  # noqa: E402
from scaling_tpu.models.transformer.train import _read_dataset as jax_read_dataset  # noqa: E402
from scaling_tpu.models.transformer.train import batch_to_model_input as jax_to_input  # noqa: E402
from scaling_tpu.topology import Topology  # noqa: E402
from scaling_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig,
    TransformerInferenceModule,
)
from scaling_tpu_torch.models.transformer.convert import params_from_jax  # noqa: E402
from scaling_tpu_torch.models.transformer.data.prepare import prepare  # noqa: E402
from scaling_tpu_torch.models.transformer.tokenizer import Tokenizer  # noqa: E402
from scaling_tpu_torch.models.transformer.train import build_trainer  # noqa: E402

from .test_torch_checkpoint import assert_states_equal, jax_state, port_state  # noqa: E402
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401

EXAMPLE = Path(__file__).resolve().parent.parent / "examples" / "finetune_example"
QA = [("what color is the sky?", "blue"), ("what color is grass?", "green"),
      ("how many legs has a cat?", "four"), ("what is 2 plus 2?", "four"),
      ("what is the opposite of hot?", "cold"), ("what do bees make?", "honey")]
STEPS, RTOL = 4, 1e-4


def write_example_data(root: Path) -> dict:
    """``run.py``'s data: the fallback tokenizer, a pretraining token stream
    of random words from seed 0 and the chat jsonl."""
    root.mkdir(parents=True, exist_ok=True)
    vocab = root / "vocab.json"
    vocab.write_text(Tokenizer.default().tokenizer.to_str())
    rng = np.random.default_rng(0)
    words = ["the", "sky", "is", "blue", "grass", "green", "cats", "have", "four", "legs",
             "bees", "make", "honey", "hot", "cold"]
    docs = root / "pretrain_docs.txt"
    docs.write_text("\n".join(" ".join(rng.choice(words, size=int(rng.integers(4, 12))))
                              for _ in range(256)))
    prepare([docs], vocab, root / "pretrain")
    (root / "chat.jsonl").write_text("\n".join(json.dumps([
        {"type": "text", "content": f"Q: {q}\nA:", "has_loss": False},
        {"type": "text", "content": f" {a}<|endoftext|>", "has_loss": True}]) for q, a in QA * 8))
    return {"vocab": str(vocab), "pretrain": str(root / "pretrain"),
            "chat": str(root / "chat.jsonl")}


def example_config(name: str, files: dict, tmp: Path, **trainer) -> dict:
    cfg = yaml.safe_load((EXAMPLE / f"config_{name}.yml").read_text())
    cfg["transformer_architecture"]["vocab_file"] = files["vocab"]
    cfg["data"]["data_prefixes"] = [files["pretrain" if name == "pretrain" else "chat"]]
    cfg["trainer"].update({"train_iterations": STEPS, "save_interval": STEPS, "save_dir": None,
                           **trainer})
    if name == "finetune" and "load_dir" not in trainer:
        cfg["trainer"]["load_dir"] = str(tmp / "jax_base")
    cfg["logger"] = {"log_dir": None}
    return cfg


def jax_trainer(cfg: dict):
    config = JaxConfig.from_dict(cfg)
    topology = Topology(config.topology)
    module = jax_init_model(config, topology)
    trainer = JaxTrainer(config=config.trainer, context=JaxContext(config=config, topology=topology),
                         parallel_module=module,
                         optimizer=jax_init_optimizer(config, module, topology),
                         loss_function=jax_loss,
                         dataset=jax_read_dataset(config, config.data.data_prefixes),
                         batch_to_model_input=jax_to_input)
    trainer.initialize(load_checkpoint=config.trainer.load_dir is not None)
    return trainer


def port_from_jax_weights(cfg: dict, jax_run):
    """The port's trainer of ``cfg``, its weights the JAX trainer's and its
    optimizer state fresh from them."""
    port = build_trainer(TransformerConfig.from_dict(cfg), device="cpu")
    arch = port.context.config.transformer_architecture
    port.module.model.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, jax_run.params), arch))
    port.optimizer.state = port.optimizer.init_state()
    return port


def losses(trainer, steps: int) -> list:
    return [float(trainer.train_step().loss) for _ in range(steps)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("finetune_example")
    files = write_example_data(tmp / "data")
    out = {"tmp": tmp, "files": files}
    # pretrain: 4 steps from the JAX trainer's initial weights
    cfg = example_config("pretrain", files, tmp)
    jax_base = jax_trainer(cfg)
    port_base = port_from_jax_weights(cfg, jax_base)
    out["pretrain"] = (losses(port_base, STEPS), losses(jax_base, STEPS))
    jax_base.save_checkpoint(tmp / "jax_base")
    # finetune: the JAX base checkpoint in each package, JAX's LoRA init
    cfg = example_config("finetune", files, tmp)
    jax_lora = jax_trainer(cfg)
    port_lora = port_from_jax_weights(cfg, jax_lora)
    out["loaded_base"] = {n: p.detach().clone()
                          for n, p in port_lora.module.model.named_parameters()}
    out["finetune"] = (losses(port_lora, STEPS), losses(jax_lora, STEPS))
    port_lora.save_checkpoint(tmp / "port_lora")
    jax_lora.save_checkpoint(tmp / "jax_lora")
    out["port_lora"], out["jax_lora"] = port_lora, jax_lora
    return out


@pytest.mark.parametrize("phase", ["pretrain", "finetune"])
def test_example_configs_train_as_in_jax(runs, phase):
    got, ref = runs[phase]
    assert len(got) == STEPS and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_the_finetune_moves_only_the_lora_leaves(runs):
    model = runs["port_lora"].module.model
    assert sorted(runs["port_lora"].optimizer.optimized) == sorted(
        n for n, _ in model.named_parameters() if "_lora." in n)
    for name, p in model.named_parameters():
        moved = not torch.equal(p, runs["loaded_base"][name])
        assert moved == (name.endswith("lora_b") or name.endswith("lora_a")), name


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_lora_checkpoints_cross_both_ways(runs, direction):
    tmp, files = runs["tmp"], runs["files"]
    src = tmp / ("port_lora" if direction == "port_to_jax" else "jax_lora")
    with np.load(src / f"global_step{STEPS}" / "optimizer_state_layer_1.npz") as z:
        assert z["master.attention.query_key_value.weight"].shape == (0,)  # frozen: a placeholder
        assert z["master.attention.query_lora.lora_a"].shape == (128, 4)  # the JAX layout
    cfg = example_config("finetune", files, tmp, load_dir=str(src), train_iterations=2 * STEPS,
                         load_optimizer_states=True, load_context=True)
    if direction == "port_to_jax":
        loaded = jax_trainer(cfg)
        assert int(loaded.opt_state.step) == STEPS and loaded.optimizer_states_loaded
        arch = runs["port_lora"].context.config.transformer_architecture
        assert_states_equal(port_state(runs["port_lora"]), jax_state(loaded, arch))
    else:
        loaded = build_trainer(TransformerConfig.from_dict(cfg), device="cpu")
        assert loaded.optimizer.state.step == STEPS and loaded.optimizer_states_loaded
        arch = loaded.context.config.transformer_architecture
        assert_states_equal(port_state(loaded), jax_state(runs["jax_lora"], arch))
        # the architecture from the config.yml the JAX trainer dumped, every key present
        served = TransformerInferenceModule.from_checkpoint(src, device="cpu")
        assert served.architecture.lora_config == arch.lora_config
        params = dict(loaded.module.model.named_parameters())
        for name, p in served.model.named_parameters():
            assert torch.equal(p, params[name]), name


def test_the_tuned_checkpoint_generates_the_same_greedy_tokens(runs):
    ckpt = runs["tmp"] / "port_lora"
    port = TransformerInferenceModule.from_checkpoint(ckpt, device="cpu",
                                                      vocab_file=runs["files"]["vocab"])
    ref = JaxInference.from_checkpoint(ckpt, vocab_file=runs["files"]["vocab"])
    assert port.model.layers["layer_1"].attention.query_lora.lora_b.any()
    prompts = [port.tokenizer.encode(f"Q: {q}\nA:") for q, _ in QA[:3]]
    got = [o.completion_ids for o in port.generate(prompts, max_tokens=6)]
    want = [list(o.completion_ids) for o in ref.generate(prompts, max_tokens=6)]
    assert got == want and all(len(t) == 6 for t in got)
