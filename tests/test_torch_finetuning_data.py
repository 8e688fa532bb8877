"""The finetuning datasets of the port against the JAX package's, from the
same files and seed: prompt/completion jsonl (string and list prompts),
its memory map, chat jsonl with ``has_loss`` flags, each with and without
soft-prompt placeholders, and the two blended classes. Every item's
token ids, targets and loss weights, and the collated batches (those and
the position and segment ids) are equal, exactly. Items longer than the
sequence are cut as the JAX package cuts them (a text item from the
front, a chat item from the back). An image entry in a text prompt and an
element of an unknown type raise by name, as in the JAX package (chat
images: ``tests/test_torch_image_encoder.py``)."""

import json

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("tokenizers")

from scaling_tpu.data.blended_dataset import BlendedDatasetConfig as JaxBlendedConfig  # noqa: E402
from scaling_tpu.models.transformer.data import finetuning as jax_ft  # noqa: E402
from scaling_tpu_torch.data import BlendedDatasetConfig, MemoryMapDatasetBuilder  # noqa: E402
from scaling_tpu_torch.models.transformer.data import finetuning as port_ft  # noqa: E402
from scaling_tpu_torch.models.transformer.tokenizer import Tokenizer  # noqa: E402

SEQ = 24
WORDS = ["the", "sky", "is", "blue", "grass", "green", "cats", "have", "four", "legs"]
FIELDS = ("token_ids", "target_token_ids", "position_ids", "segment_ids", "loss_weights")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("finetuning")
    tok = Tokenizer.default()
    (root / "vocab.json").write_text(tok.tokenizer.to_str())
    rng = np.random.default_rng(0)

    def words(lo, hi):
        return " ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi))))

    out = {"vocab": root / "vocab.json"}
    for name in ("text_a", "text_b"):
        records = []
        for i in range(7):
            prompt = [words(1, 3), " " + words(1, 3)] if i % 3 == 0 else words(1, 4)
            # every fourth item outgrows the sequence: cut from the front
            records.append({"prompt": prompt,
                            "completion": " " + words(8, 12) if i % 4 == 0 else " " + words(1, 3)})
        (root / f"{name}.jsonl").write_text("\n".join(json.dumps(r) for r in records))
        out[name] = root / f"{name}.jsonl"
        with MemoryMapDatasetBuilder(root / f"{name}_mmap", dtype=np.uint16) as builder:
            for r in records:
                p = r["prompt"] if isinstance(r["prompt"], str) else "".join(r["prompt"])
                ids = tok.encode(p)
                builder.add(np.array([len(ids)] + ids + tok.encode(r["completion"]), np.uint16))
        out[f"{name}_mmap"] = root / f"{name}_mmap"
    for name in ("chat_a", "chat_b"):
        lines = []
        for i in range(6):
            eos = "" if i == 5 else "<|endoftext|>"  # one line without EOS
            lines.append(json.dumps([
                {"type": "text", "content": f"Q: {words(1, 4 if i % 2 else 12)}\nA:",
                 "has_loss": False},
                {"type": "text", "content": f" {words(1, 3)}{eos}", "has_loss": True},
                {"type": "text", "content": " ok", "has_loss": i % 2 == 0}]))
        (root / f"{name}.jsonl").write_text("\n".join(lines))
        out[name] = root / f"{name}.jsonl"
    return out


def assert_items_equal(port, ref):
    assert len(port) == len(ref)
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        for field in ("token_ids", "target_token_ids", "loss_weights"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                          err_msg=f"item {i} {field}")
    idx = list(range(min(4, len(ref))))
    got, want = port.collate([port[i] for i in idx]), ref.collate([ref[i] for i in idx])
    for field in FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def pair(kind: str, files, prefix: str, softprompt: int):
    kw = dict(data_prefix=files[prefix], sequence_length=SEQ, vocab_file=files["vocab"],
              seed=3, softprompt_n_tokens=softprompt)
    if kind == "chat":
        return port_ft.FinetuningChatDataset(**kw), jax_ft.FinetuningChatDataset(**kw)
    kw["memory_map_dataset"] = prefix.endswith("_mmap")
    return port_ft.FinetuningTextDataset(**kw), jax_ft.FinetuningTextDataset(**kw)


@pytest.mark.parametrize("softprompt", [0, 3], ids=["plain", "softprompt"])
@pytest.mark.parametrize("kind,prefix", [("text", "text_a"), ("text", "text_a_mmap"),
                                         ("chat", "chat_a")],
                         ids=["text_jsonl", "text_memory_map", "chat"])
def test_items_and_batches_equal_jax(files, kind, prefix, softprompt):
    port, ref = pair(kind, files, prefix, softprompt)
    assert port.ident() == ref.ident() and port.eod_token_id == ref.eod_token_id
    assert_items_equal(port, ref)
    if softprompt and kind == "chat":  # the head is kept: placeholders 0 lead, untrained
        for i in range(len(port)):
            assert not port[i].token_ids[:softprompt].any()
            assert not port[i].loss_weights[:softprompt].any()


@pytest.mark.parametrize("kind", ["text", "chat"])
def test_blended_datasets_equal_jax(files, kind):
    prefixes = ("text_a", "text_b") if kind == "text" else ("chat_a", "chat_b")
    parts = [pair(kind, files, p, 0) for p in prefixes]
    port_cls, jax_cls = ((port_ft.FinetuningTextBlendedDataset,
                          jax_ft.FinetuningTextBlendedDataset) if kind == "text" else
                         (port_ft.FinetuningChatBlendedDataset,
                          jax_ft.FinetuningChatBlendedDataset))
    weights = {"weight_by_num_documents": False, "weights": [1.0, 2.0]}
    port = port_cls(seed=5, config=BlendedDatasetConfig.from_dict(weights),
                    datasets=[p for p, _ in parts])
    ref = jax_cls(seed=5, config=JaxBlendedConfig(**weights), datasets=[r for _, r in parts])
    assert_items_equal(port, ref)


def test_image_entries_raise_by_name(files, tmp_path):
    text = tmp_path / "img.jsonl"
    text.write_text(json.dumps({"prompt": [{"image": "x.png"}], "completion": " a"}))
    ds = port_ft.FinetuningTextDataset(text, SEQ, files["vocab"])
    with pytest.raises(NotImplementedError, match="image"):
        ds[0]
    chat = tmp_path / "img_chat.jsonl"
    chat.write_text(json.dumps([{"type": "video", "content": "x.mp4"}]))
    with pytest.raises(NotImplementedError, match="video"):
        port_ft.FinetuningChatDataset(chat, SEQ, files["vocab"])
    with pytest.raises(NotImplementedError, match="video"):
        jax_ft.FinetuningChatDataset(chat, SEQ, files["vocab"])
