"""The HF ``tokenizers`` wrapper (counterpart of
scaling_tpu/models/transformer/tokenizer.py): eos detection, encode and
decode, and the (normal, no-prefix-space) pair of chat templating.

``tokenizers`` is imported inside the functions that build a tokenizer,
so the package imports, generates and evaluates on token ids without it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Tuple, Union

EOS_CANDIDATES = ("<|endoftext|>", "</s>")


class Tokenizer:
    def __init__(self, tokenizer) -> None:
        self.tokenizer = tokenizer
        self.eos_token = None
        self.eos_token_id: Optional[int] = None
        for candidate in EOS_CANDIDATES:
            token_id = self.tokenizer.token_to_id(candidate)
            if token_id is not None:
                self.eos_token = candidate
                self.eos_token_id = token_id
                break

    @classmethod
    def from_file(cls, vocab_file: Union[Path, str]) -> "Tokenizer":
        from tokenizers import Tokenizer as HFTokenizer

        try:
            return cls(HFTokenizer.from_file(str(vocab_file)))
        except Exception as e:
            # the rust parser's bare "expected `,` or `}` at line 1" gives
            # no hint WHAT format was expected or WHICH file failed
            raise ValueError(
                f"{vocab_file} is not a serialized huggingface tokenizer "
                f"(tokenizer.json format, as written by "
                f"tokenizers.Tokenizer.save or shipped with hf models); "
                f"a bare vocab map is not loadable ({e})"
            ) from e

    @classmethod
    def from_str(cls, json_str: str) -> "Tokenizer":
        """Build from a serialized tokenizer json."""
        from tokenizers import Tokenizer as HFTokenizer

        return cls(HFTokenizer.from_str(json_str))

    @classmethod
    def default(cls) -> "Tokenizer":
        """A functional byte-level fallback tokenizer (256 byte tokens +
        ``<|endoftext|>``), built in code: no model asset is bundled."""
        from tokenizers import Tokenizer as HFTokenizer
        from tokenizers.decoders import ByteLevel as ByteLevelDecoder
        from tokenizers.models import BPE
        from tokenizers.pre_tokenizers import ByteLevel

        alphabet = ByteLevel.alphabet()
        vocab = {ch: i for i, ch in enumerate(sorted(alphabet))}
        vocab["<|endoftext|>"] = len(vocab)
        tok = HFTokenizer(BPE(vocab, merges=[]))
        tok.pre_tokenizer = ByteLevel(add_prefix_space=False)
        tok.decoder = ByteLevelDecoder()
        # registered as special so the literal text "<|endoftext|>" encodes
        # to the single eos id instead of byte tokens (id unchanged: it is
        # already in the vocab)
        tok.add_special_tokens(["<|endoftext|>"])
        return cls(tok)

    def __len__(self) -> int:
        return self.tokenizer.get_vocab_size()

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.get_vocab_size()

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        return self.tokenizer.encode(text, add_special_tokens=add_special_tokens).ids

    def decode(self, token_ids: List[int], skip_special_tokens: bool = False) -> str:
        return self.tokenizer.decode(
            list(token_ids), skip_special_tokens=skip_special_tokens
        )

    def token_to_id(self, token: str) -> Optional[int]:
        return self.tokenizer.token_to_id(token)


def load_tokenizers(vocab_file: Union[Path, str]) -> Tuple[Tokenizer, Tokenizer]:
    """(normal, no-prefix-space) pair; llama2-style tokenizer jsons get
    their Metaspace prefix space turned off in the second."""
    tokenizer = Tokenizer.from_file(vocab_file)

    data = json.loads(Path(vocab_file).read_text())
    changed = False

    def strip_prefix(entry: dict) -> bool:
        if entry.get("type") != "Metaspace":
            return False
        touched = False
        # modern tokenizers serialize prepend_scheme; legacy files carry
        # add_prefix_space — the two must stay consistent or from_str rejects
        if entry.get("prepend_scheme", "always") != "never":
            entry["prepend_scheme"] = "never"
            touched = True
        if entry.get("add_prefix_space", True):
            entry["add_prefix_space"] = False
            touched = True
        return touched

    decoder = data.get("decoder") or {}
    for entry in decoder.get("decoders", []) if decoder else []:
        changed |= strip_prefix(entry)
    pre = data.get("pre_tokenizer") or {}
    for entry in [pre] + list(pre.get("pretokenizers", []) or []):
        changed |= strip_prefix(entry)

    if changed:
        from tokenizers import Tokenizer as HFTokenizer

        no_prefix = Tokenizer(HFTokenizer.from_str(json.dumps(data)))
    else:
        no_prefix = tokenizer
    return tokenizer, no_prefix
