"""Export the port's checkpoints to the reference PyTorch framework's
format (the port's copy of scaling_tpu/checkpoint/export_reference.py).

The importer's mapping (``import_reference.py``) inverted, into one
``model_state_layer_{i}_{Class}.pt`` a layer:

- ``(in, out)`` projection weights transpose back to ``nn.Linear``'s
  ``(out, in)``;
- ``attention.`` becomes the reference's ``self_attention.``;
- bottleneck adapter ``down`` / ``up`` factors become
  ``{attn,mlp}_adapter_{n}.dense_{in,out}.weight``;
- a PEFT side file ``{Class}__{name}.npz`` becomes ``{Class}_{name}.pt``;
- a tied model regains the reference's repeat of the embedding table in
  ``TransformerLMHeadTied.pt``, at the slot after the final norm;
- a checkpoint whose ``config.yml`` says ``precision: bfloat16`` (stored
  widened to float32) is written as ``torch.bfloat16``, as an export of
  the live bf16 tensors is.

Export then import gives back every array bit for bit.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch
import yaml

from ..resilience.guards import retry_io
from .import_reference import is_projection

PathLike = Union[Path, str]


def _unmap_param(name: str, arr: torch.Tensor) -> Tuple[str, torch.Tensor]:
    """Our parameter name and array -> the reference's."""
    m = re.fullmatch(r"adapter_(attention|mlp)_([^.]+)\.(down|up)", name)
    if m:
        host = "attn" if m.group(1) == "attention" else "mlp"
        direction = "in" if m.group(3) == "down" else "out"
        return f"{host}_adapter_{m.group(2)}.dense_{direction}.weight", arr.T
    if is_projection(name, arr):
        arr = arr.T
    return name.replace("attention.", "self_attention."), arr


def export_layer(arrays: Dict[str, Any], bf16: bool = False) -> Dict[str, torch.Tensor]:
    """One layer's arrays (numpy arrays or torch tensors, in our layout;
    a bf16 tensor stays bf16) -> a reference state dict. ``bf16`` casts
    float32 values to ``torch.bfloat16``."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in arrays.items():
        t = (value.detach().cpu() if isinstance(value, torch.Tensor)
             else torch.from_numpy(np.asarray(value)))
        ref_name, t = _unmap_param(name, t)
        t = t.contiguous()
        out[ref_name] = t.to(torch.bfloat16) if bf16 and t.dtype == torch.float32 else t
    return out


def export_reference_checkpoint(src_dir: PathLike, dst_dir: PathLike) -> int:
    """Our npz checkpoint directory (a save root with a ``latest`` pointer,
    or a ``global_step{N}`` directory) -> reference ``.pt`` files in
    ``dst_dir``; returns the number of files written."""
    src = Path(src_dir)
    latest = src / "latest"
    if latest.is_file():
        src = src / retry_io(latest.read_text, what="latest pointer read").strip()
    dst = Path(dst_dir)
    dst.mkdir(parents=True, exist_ok=True)
    config_file = src / "config.yml"
    cfg = (yaml.safe_load(retry_io(config_file.read_text, what="export config read")) or {}
           if config_file.is_file() else {})
    arch = cfg.get("transformer_architecture", {})
    bf16 = arch.get("precision") == "bfloat16"

    written = 0
    embedding_table = None
    norm_index = None
    for f in sorted(src.glob("model_state_layer_*.npz")):
        m = re.fullmatch(r"model_state_layer_(\d+)_(.+)\.npz", f.name)
        if m is None:
            continue
        index, stem = int(m.group(1)), m.group(2)
        if "__" in stem:  # a PEFT side file: our double underscore -> one
            cls, suffix = stem.split("__", 1)
            ref_stem = f"model_state_layer_{index}_{cls}_{suffix}"
        else:
            ref_stem = f"model_state_layer_{index}_{stem}"
            if stem == "LayerNormWrapper":
                norm_index = index
        with np.load(f, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
        if index == 0 and "embedding.weight" in arrays:
            embedding_table = arrays["embedding.weight"]
        torch.save(export_layer(arrays, bf16), dst / f"{ref_stem}.pt")
        written += 1

    # the tied head's slot: the final norm's index + 1 (embedding, layers,
    # norm, head[, embedding head]); not the largest index + 1, which an
    # embedding head or a PEFT side file would push past the head's hole
    if arch.get("weight_tying") and embedding_table is not None:
        if norm_index is None:
            raise ValueError("weight-tied checkpoint without a LayerNormWrapper layer file: "
                             "cannot place the tied head's slot")
        torch.save(export_layer({"embedding.weight": embedding_table}, bf16),
                   dst / f"model_state_layer_{norm_index + 1}_TransformerLMHeadTied.pt")
        written += 1
    return written
