"""The port's standalone ``evaluate``, its tokenizer wrapper and the
``prepare`` data tool against the JAX package's.

- ``evaluate`` on the committed golden checkpoint (layernorm, GELU MLP,
  f32) and its data: loss and accuracy within rtol 1e-4 of JAX
  ``evaluate``, the token and batch counts equal, with a batch size that
  leaves a short last batch and with ``max_batches``; the command line
  prints the same JSON line;
- the tokenizer: the same ids, eos and decoded text as JAX's wrapper;
- ``prepare``: ``.bin``, ``.idx`` and ``.meta.json`` byte-equal to JAX's on
  a small jsonl and a small txt.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from scaling_tpu.models.transformer.data.prepare import prepare as jax_prepare  # noqa: E402
from scaling_tpu.models.transformer.evaluate import evaluate as jax_evaluate  # noqa: E402
from scaling_tpu.models.transformer.tokenizer import Tokenizer as JaxTokenizer  # noqa: E402
from scaling_tpu.models.transformer.tokenizer import (  # noqa: E402
    load_tokenizers as jax_load_tokenizers,
)
from scaling_tpu_torch.models.transformer.data.prepare import prepare  # noqa: E402
from scaling_tpu_torch.models.transformer.evaluate import evaluate  # noqa: E402
from scaling_tpu_torch.models.transformer.tokenizer import Tokenizer, load_tokenizers  # noqa: E402
from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "transformer" / "files" / "backward_compatibility_checkpoint"
TEXTS = ["hello world", "The quick brown fox jumps over the lazy dog.",
         "émoji 🙂 and <|endoftext|> inside", "  leading spaces\tand tabs"]


@pytest.mark.parametrize("batch_size,max_batches", [(8, None), (3, None), (2, 2)])
def test_evaluate_matches_jax_on_the_golden_checkpoint(batch_size, max_batches):
    ref = jax_evaluate(GOLDEN / "ckpt", GOLDEN / "data", batch_size, max_batches)
    out = evaluate(GOLDEN / "ckpt", GOLDEN / "data", batch_size, max_batches, device="cpu")
    assert (out["tokens"], out["batches"]) == (ref["tokens"], ref["batches"])
    np.testing.assert_allclose([out["loss"], out["accuracy"]], [ref["loss"], ref["accuracy"]],
                               rtol=1e-4)
    assert np.isfinite(out["perplexity"])


def test_evaluate_command_line_prints_one_json_line():
    proc = subprocess.run(
        [sys.executable, "-m", "scaling_tpu_torch.models.transformer.evaluate",
         "--checkpoint", str(GOLDEN / "ckpt"), "--data", str(GOLDEN / "data"),
         "--batch-size", "4", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["checkpoint"] == str(GOLDEN / "ckpt")
    assert line == {"checkpoint": line["checkpoint"],
                    **evaluate(GOLDEN / "ckpt", GOLDEN / "data", 4, device="cpu")}


def test_tokenizer_encodes_and_decodes_as_jax(tmp_path):
    ref, tok = JaxTokenizer.default(), Tokenizer.default()
    assert (tok.eos_token, tok.eos_token_id, len(tok)) == (ref.eos_token, ref.eos_token_id,
                                                           len(ref))
    for text in TEXTS:
        ids = tok.encode(text)
        assert ids == ref.encode(text)
        assert tok.decode(ids) == ref.decode(ids)
    path = tmp_path / "vocab.json"
    ref.tokenizer.save(str(path))
    for (a, b) in zip(load_tokenizers(path), jax_load_tokenizers(path)):
        assert [a.encode(t) for t in TEXTS] == [b.encode(t) for t in TEXTS]
    assert Tokenizer.from_str(path.read_text()).encode(TEXTS[1]) == ref.encode(TEXTS[1])


@pytest.mark.parametrize("suffix", [".jsonl", ".txt"])
def test_prepare_writes_the_jax_packages_bytes(tmp_path, suffix):
    vocab = tmp_path / "vocab.json"
    JaxTokenizer.default().tokenizer.save(str(vocab))
    docs = tmp_path / f"docs{suffix}"
    lines = [json.dumps({"text": t}) if suffix == ".jsonl" else t.replace("\t", " ")
             for t in TEXTS * 3]
    docs.write_text("\n".join(lines + [""]) + "\n")
    ref = jax_prepare([docs], vocab, tmp_path / "jax" / "out")
    out = prepare([docs], vocab, tmp_path / "port" / "out")
    assert out == ref and out["documents"] == len(lines)
    for ext in (".bin", ".idx", ".meta.json"):
        assert (tmp_path / "port" / f"out{ext}").read_bytes() == \
            (tmp_path / "jax" / f"out{ext}").read_bytes(), ext
