"""Import checkpoints of the reference PyTorch framework ("Scaling") into
the port's npz layout (the port's copy of
scaling_tpu/checkpoint/import_reference.py).

The reference writes one ``model_state_layer_{i}_{Class}.pt`` a layer,
and older versions one whole-model state dict under ``transformer.*``
names. Both convert into the npz files ``checkpoint.load_model_checkpoint``
reads (the JAX package's layout). The layer classes match one to one;
within a layer:

- torch ``nn.Linear`` stores ``(out, in)``, the npz layout ``(in, out)``:
  2-D projection weights are transposed;
- the reference's attention attribute is ``self_attention.``, ours
  ``attention.`` (the fused query_key_value layout, head-major
  ``[q|k|v]``, is the same on both sides);
- rotary ``inv_freq`` buffers are derived here and are dropped;
- a tied LM head's file repeats the embedding table; tying is
  structural here, so the repeat is not written;
- the reference's adapters (``{attn,mlp}_adapter_{n}.dense_{in,out}``)
  become bottleneck ``adapter_{attention,mlp}_{n}.{down,up}`` factors;
- a PEFT side file ``{Class}_{name}.pt`` (one underscore) becomes
  ``{Class}__{name}.npz`` (two);
- bf16 ``.pt`` tensors are widened to float32, which holds them exactly.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

PathLike = Union[Path, str]
LINEAR_HOSTS = ("attention.", "mlp.", "linear", "embedding_head")
_ADAPTER_RE = re.compile(r"(attn|mlp)_adapter_([^.]+)\.dense_(in|out)\.weight$")


def is_projection(name: str, arr: np.ndarray) -> bool:
    """Whether ``name`` is a 2-D linear weight, transposed between the two
    layouts (the embedding table is not)."""
    return (arr.ndim == 2 and name.endswith(".weight")
            and any(h in name for h in LINEAR_HOSTS) and not name.startswith("embedding."))


def _map_param(name: str, arr: np.ndarray) -> Optional[Tuple[str, np.ndarray]]:
    """A reference parameter name and array -> ours, or None when dropped."""
    if name.endswith(".inv_freq"):
        return None
    name = name.replace("self_attention.", "attention.")
    # the legacy MLP names
    name = name.replace("dense_h_to_4h", "dense_in").replace("dense_4h_to_h", "dense_out")
    m = _ADAPTER_RE.match(name)
    if m:
        host = "attention" if m.group(1) == "attn" else "mlp"
        direction = "down" if m.group(3) == "in" else "up"
        return f"adapter_{host}_{m.group(2)}.{direction}", np.ascontiguousarray(arr.T)
    if is_projection(name, arr):
        arr = np.ascontiguousarray(arr.T)
    return name, arr


def _to_numpy(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:  # numpy has no bf16; f32 holds it exactly
            value = value.float()
        return value.numpy()
    return np.asarray(value)


def convert_reference_layer(state_dict: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """One reference layer's state dict -> our parameter names and arrays."""
    out: Dict[str, np.ndarray] = {}
    for name, value in state_dict.items():
        mapped = _map_param(name, _to_numpy(value))
        if mapped is not None:
            out[mapped[0]] = mapped[1]
    return out


# the reference's layer classes, longest first so that a PEFT suffix splits off
LAYER_CLASSES = (
    "TransformerLMHeadTied",
    "TransformerEmbeddingHead",
    "TransformerLMHead",
    "TransformerLayer",
    "LayerNormWrapper",
    "EmbeddingInput",
)


def _split_class_suffix(stem: str) -> Tuple[str, Optional[str]]:
    """``TransformerLayer_lora`` -> (``TransformerLayer``, ``lora``)."""
    for cls in LAYER_CLASSES:
        if stem == cls:
            return cls, None
        if stem.startswith(cls + "_"):
            return cls, stem[len(cls) + 1:]
    return stem, None


def convert_reference_checkpoint(src_dir: PathLike, dst_dir: PathLike) -> int:
    """A reference checkpoint directory -> npz files in ``dst_dir``;
    returns the number of files written. A tied head's base file is
    skipped (the embedding layer holds the one table); its PEFT side
    files convert."""
    src, dst = Path(src_dir), Path(dst_dir)
    dst.mkdir(parents=True, exist_ok=True)
    written = 0
    for f in sorted(src.glob("model_state_layer_*.pt")):
        m = re.fullmatch(r"model_state_layer_(\d+)_(.+)\.pt", f.name)
        if m is None:
            continue
        layer_class, peft_suffix = _split_class_suffix(m.group(2))
        if layer_class == "TransformerLMHeadTied" and peft_suffix is None:
            continue
        arrays = convert_reference_layer(torch.load(f, map_location="cpu", weights_only=True))
        stem = f"model_state_layer_{int(m.group(1))}_{layer_class}"
        if peft_suffix is not None:
            stem += f"__{peft_suffix}"
        np.savez(dst / f"{stem}.npz", **arrays)
        written += 1
    return written


def convert_legacy_state_dict(state_dict: Dict[str, Any], num_layers: int
                              ) -> Dict[str, Dict[str, np.ndarray]]:
    """A legacy whole-model ``transformer.*`` state dict -> {layer file
    stem: arrays}: the word embeddings to layer 0, ``transformer.layerN``
    to layer N+1, the final norm to layer num_layers+1. The tied head the
    reference appends is implicit here."""
    layers: Dict[int, Dict[str, Any]] = {}
    for k, v in state_dict.items():
        if k.endswith(".inv_freq"):
            continue
        if k == "transformer.embeddings.word_embeddings.weight":
            layers.setdefault(0, {})["embedding.weight"] = v
        elif m := re.fullmatch(r"transformer\.layer(\d+)\.(.+)", k):
            layers.setdefault(1 + int(m.group(1)), {})[m.group(2)] = v
        elif m := re.fullmatch(r"transformer\.norm\.(.+)", k):
            layers.setdefault(1 + num_layers, {})[f"norm.{m.group(1)}"] = v
        else:
            raise ValueError(f"unrecognized legacy parameter {k!r}")
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for idx, sd in layers.items():
        cls = ("EmbeddingInput" if idx == 0 else
               "LayerNormWrapper" if idx == 1 + num_layers else "TransformerLayer")
        out[f"model_state_layer_{idx}_{cls}"] = convert_reference_layer(sd)
    return out


def write_converted_layers(layers: Dict[str, Dict[str, np.ndarray]], dst_dir: PathLike) -> None:
    dst = Path(dst_dir)
    dst.mkdir(parents=True, exist_ok=True)
    for stem, arrays in layers.items():
        np.savez(dst / f"{stem}.npz", **arrays)
