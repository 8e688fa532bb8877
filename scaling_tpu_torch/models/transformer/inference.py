"""Inference over the paged KV pool (counterpart of the serving half of
scaling_tpu/models/transformer/inference.py): one pass through the layer
stack (``_run_layers``), the batch it consumes (``_make_batch``) and the
per-row sampler (``sample_rows``).

Sampling: greedy rows take the argmax, exactly as the JAX package does.
Rows with temperature > 0 draw with Gumbel-max noise from a counter-based
hash of ``(sample_seed, req_id, position)`` (``request_uniforms``), so a
row's draw depends only on its request and position: a preempted and
resumed sequence draws the same tokens, on the CPU and on the card alike.
The draws are not JAX's threefry draws.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Union

import torch
import yaml

from ... import resolve_device
from ...checkpoint import load_model_checkpoint
from ...nn.attention import PagedKVCacheView
from ...parallel.parallel_module import jax_param_key
from .config import TransformerArchitectureConfig
from .model import TransformerModel

_MASK32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (two multiply-xorshift rounds) on int64
    tensors holding values in [0, 2**32); exact on every device."""
    x = x & _MASK32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _MASK32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _MASK32
    return x ^ (x >> 16)


def request_uniforms(sample_seed: int, req_ids: torch.Tensor,
                     positions: torch.Tensor, vocab: int) -> torch.Tensor:
    """(rows, vocab) uniforms in (0, 1), a pure function of
    (sample_seed, req_id, position, token index)."""
    dev = req_ids.device
    row_key = _mix32(_mix32(_mix32(torch.full_like(req_ids.long(), sample_seed))
                            ^ req_ids.long()) ^ positions.long())
    idx = torch.arange(vocab, dtype=torch.int64, device=dev)
    bits = _mix32(row_key[:, None] ^ _mix32(idx + 0x9E3779B9)[None, :])
    # 24 bits: exactly representable in f32, never 0 or 1
    return ((bits >> 8).float() + 0.5) / float(1 << 24)


def sample_rows(logits: torch.Tensor, temperatures: torch.Tensor,
                top_ks: torch.Tensor, uniforms: torch.Tensor,
                top_ps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row temperature / top-k / top-p sampling; ``temperature <= 0``
    is greedy. The masks follow the JAX ``sample_rows`` op for op
    (temperature clamp, sort-based top-k cutoff, nucleus cutoff over the
    descending sort after top-k); the draw is Gumbel-max over
    ``uniforms`` (rows, vocab)."""
    vocab = logits.shape[-1]
    greedy = logits.argmax(dim=-1)
    scaled = logits.float() / temperatures.float().clamp_min(1e-6)[:, None]
    sorted_scaled = scaled.sort(dim=-1).values
    k_active = (top_ks > 0) & (top_ks < vocab)
    k_idx = (vocab - top_ks.long()).clamp(0, vocab - 1)
    kth = sorted_scaled.gather(-1, k_idx[:, None])
    scaled = torch.where(k_active[:, None] & (scaled < kth), float("-inf"), scaled)
    if top_ps is not None:
        p_active = (top_ps > 0.0) & (top_ps < 1.0)
        sorted_desc = scaled.sort(dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        keep = (probs.cumsum(dim=-1) - probs) < top_ps.float()[:, None]
        kept = keep.sum(dim=-1, keepdim=True)
        cutoff = sorted_desc.gather(-1, (kept - 1).clamp_min(0))
        scaled = torch.where(p_active[:, None] & (scaled < cutoff),
                             float("-inf"), scaled)
    gumbel = -torch.log(-torch.log(uniforms))
    sampled = (scaled + gumbel).argmax(dim=-1)
    return torch.where(temperatures <= 0.0, greedy, sampled).int()


class TransformerInferenceModule:
    """The model on one device, run over block-paged KV pools."""

    def __init__(self, architecture: TransformerArchitectureConfig,
                 model: TransformerModel):
        self.architecture = architecture
        self.model = model.eval().requires_grad_(False)
        self.device = next(model.parameters()).device

    @classmethod
    def random_init(cls, architecture: TransformerArchitectureConfig,
                    seed: int = 0, device=None) -> "TransformerInferenceModule":
        """Random weights from a seeded generator (nothing is downloaded)."""
        model = TransformerModel(architecture, device=resolve_device(device))
        return cls(architecture, model.init_random_(seed))

    @classmethod
    def from_state_dict(cls, architecture: TransformerArchitectureConfig,
                        state_dict: Dict[str, torch.Tensor],
                        device=None) -> "TransformerInferenceModule":
        model = TransformerModel(architecture, device=resolve_device(device))
        model.load_state_dict(state_dict)
        return cls(architecture, model)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: Union[Path, str],
                        device=None) -> "TransformerInferenceModule":
        """The model of a checkpoint of either package: ``latest`` is
        followed when ``checkpoint_dir`` holds one, the architecture comes
        from its ``config.yml`` and the weights from its layer npz files,
        cast to the architecture's dtype."""
        ckpt = Path(checkpoint_dir)
        if (ckpt / "latest").is_file():
            ckpt = ckpt / (ckpt / "latest").read_text().strip()
        config_file = ckpt / "config.yml"
        if not config_file.is_file():
            raise FileNotFoundError(f"no config.yml in {ckpt}")
        architecture = TransformerArchitectureConfig.from_dict(
            yaml.safe_load(config_file.read_text())["transformer_architecture"])
        model = TransformerModel(architecture, device=resolve_device(device))
        load_model_checkpoint(ckpt, {jax_param_key(model, name): p
                                     for name, p in model.named_parameters()})
        return cls(architecture, model)

    def _make_batch(self, token_ids: torch.Tensor,
                    position_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {
            "token_ids": token_ids.to(self.device, torch.int64),
            "position_ids": position_ids.to(self.device, torch.int32),
        }

    @torch.no_grad()
    def _run_layers(self, batch: Dict[str, torch.Tensor],
                    caches: List[PagedKVCacheView],
                    gather_start: Optional[torch.Tensor] = None,
                    gather_width: Optional[int] = None) -> torch.Tensor:
        """One pass through the stack over paged KV views (one per
        transformer layer; the pools are written in place). Returns logits.

        ``gather_start`` (rows,) with ``gather_width`` slices each row's
        window of trunk activations after the last transformer layer and
        before the final norm and head, which are position-wise: only the
        positions that will be sampled pay the vocab projection. The
        logits then cover positions ``gather_start .. + gather_width - 1``."""
        m = self.model
        layers = m.transformer_layers
        if len(caches) != len(layers):
            raise ValueError(
                f"{len(caches)} KV views for {len(layers)} transformer layers"
            )
        pos = batch["position_ids"]
        h = m.embedding(batch["token_ids"])
        for layer, view in zip(layers, caches):
            h = layer(h, pos, view)
        if gather_start is not None:
            idx = gather_start.long()[:, None] + torch.arange(
                gather_width, device=h.device
            )[None, :]
            h = h.gather(1, idx[:, :, None].expand(-1, -1, h.shape[-1]))
        return m.lm_head(m.final_norm(h))
