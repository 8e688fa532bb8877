"""Offline dataset preparation: text/jsonl -> tokenized memory map
(counterpart of scaling_tpu/models/transformer/data/prepare.py, writing
the same files). Each input document is tokenized, EOS-terminated (the
EOD boundary the packed TextDataset splits on, data/text_dataset.py), and
appended to the port's ``MemoryMapDatasetBuilder``:

    python -m scaling_tpu_torch.models.transformer.data.prepare \
        --input docs.jsonl --vocab tokenizer.json --output data/train

Input formats (by extension): ``.jsonl`` with a text field per line
(``--field``, default "text"), or plain ``.txt`` with one document per
line. The token dtype sizes itself to the tokenizer vocabulary.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

from ....data.memory_map import MemoryMapDatasetBuilder
from ..tokenizer import Tokenizer


def iter_documents(path: Path, field: str) -> Iterator[str]:
    if path.suffix in (".jsonl", ".ndjson"):
        for line_no, line in enumerate(path.open(), 1):
            if not line.strip():
                continue
            record = json.loads(line)
            if not isinstance(record, dict):
                raise ValueError(
                    f"{path}:{line_no} is a JSON {type(record).__name__}, "
                    "not an object — this tool consumes pretraining jsonl "
                    "({'text': ...} per line); chat finetuning jsonl (a "
                    "list per line) is read directly by the chat dataset"
                )
            if field not in record:
                raise KeyError(
                    f"{path}:{line_no} has no {field!r} field "
                    f"(keys: {sorted(record)}; set --field)"
                )
            yield record[field]
    elif path.suffix in (".txt", ".text"):
        for line in path.open():
            if line.strip():
                yield line.rstrip("\n")
    else:
        # an explicit error beats tokenizing raw JSON (or gzip bytes) as
        # document text and writing a silently-corrupt dataset
        raise ValueError(
            f"unsupported input extension {path.suffix!r} for {path}: "
            "expected .jsonl/.ndjson (one JSON object per line) or "
            ".txt/.text (one document per line); decompress .gz first"
        )


def prepare(
    inputs: List[Path],
    vocab_file: Path,
    output_prefix: Path,
    field: str = "text",
    append_eos: bool = True,
) -> dict:
    tokenizer = Tokenizer.from_file(vocab_file)
    eos = tokenizer.eos_token_id
    if append_eos and eos is None:
        raise ValueError(
            f"{vocab_file} has no EOS token; pass --no-append-eos to pack "
            "documents without EOD boundaries"
        )
    dtype = np.uint16 if len(tokenizer) < 2**16 else np.uint32
    docs = tokens = 0
    with MemoryMapDatasetBuilder(output_prefix, dtype=dtype) as builder:
        for path in inputs:
            for text in iter_documents(path, field):
                ids = tokenizer.encode(text)
                if not ids:
                    continue
                if append_eos:
                    ids = ids + [eos]
                builder.add(np.asarray(ids, dtype=dtype))
                docs += 1
                tokens += len(ids)
    return {"documents": docs, "tokens": tokens, "dtype": str(np.dtype(dtype))}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="tokenize documents into a training memory map"
    )
    ap.add_argument("--input", nargs="+", required=True, type=Path,
                    help=".jsonl or .txt document files")
    ap.add_argument("--vocab", required=True, type=Path,
                    help="HF-tokenizers json")
    ap.add_argument("--output", required=True, type=Path,
                    help="output prefix for .bin/.idx/.meta.json")
    ap.add_argument("--field", default="text",
                    help="jsonl field holding the document text")
    ap.add_argument("--no-append-eos", dest="append_eos", action="store_false",
                    help="do not append EOS after each document")
    args = ap.parse_args(argv)
    stats = prepare(args.input, args.vocab, args.output, args.field,
                    args.append_eos)
    print(json.dumps({"output": str(args.output), **stats}))


if __name__ == "__main__":
    sys.exit(main())
