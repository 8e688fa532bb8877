"""Block-paged KV cache pools (counterpart of scaling_tpu/serve/kvcache.py).

One pool per transformer layer, ``(num_blocks, block_size, n_kv, h)`` for
keys and for values, carved into fixed-size blocks that sequences of any
length share through per-sequence block tables. Block 0 is the trash
block. ``kv_dtype='int8'`` stores int8 values with f32 per-slot-per-head
scales (``nn.attention.kv_quantize_int8``).

Shapes come from the architecture (kv heads, head dim, model dtype).
The pools are updated in place by the attention layers, so the engine
never takes updated pools back.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..models.transformer.config import TransformerArchitectureConfig
from ..nn.attention import PagedKVCacheView, paged_flat_slots, paged_scatter_kv


class PagedKVPools:
    def __init__(self, pool_k: List[torch.Tensor], pool_v: List[torch.Tensor],
                 scale_k: Optional[List[torch.Tensor]],
                 scale_v: Optional[List[torch.Tensor]], block_size: int):
        self.pool_k = pool_k
        self.pool_v = pool_v
        self.scale_k = scale_k
        self.scale_v = scale_v
        self.block_size = block_size

    @property
    def num_layers(self) -> int:
        return len(self.pool_k)

    @property
    def quantized(self) -> bool:
        return self.scale_k is not None

    @property
    def num_blocks(self) -> int:
        return self.pool_k[0].shape[0]

    def tensors(self) -> List[torch.Tensor]:
        """Every pool tensor (K, V and, for int8, the scales)."""
        out = list(self.pool_k) + list(self.pool_v)
        if self.quantized:
            out += list(self.scale_k) + list(self.scale_v)
        return out

    def views(self, block_table: torch.Tensor, context_len: torch.Tensor,
              new_len: Optional[torch.Tensor] = None) -> List[PagedKVCacheView]:
        """Per-layer views over the pools with this batch's addressing."""
        return [
            PagedKVCacheView(
                pool_k=self.pool_k[i], pool_v=self.pool_v[i],
                block_table=block_table, context_len=context_len,
                scale_k=self.scale_k[i] if self.quantized else None,
                scale_v=self.scale_v[i] if self.quantized else None,
                new_len=new_len,
            )
            for i in range(self.num_layers)
        ]

    @torch.no_grad()
    def copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write fork: duplicate pool block ``src`` into ``dst`` in
        every layer (K, V and the int8 scales)."""
        for t in self.tensors():
            t[dst].copy_(t[src])


def init_pools(arch: TransformerArchitectureConfig, num_blocks: int,
               block_size: int, kv_dtype: str = "native",
               device=None) -> PagedKVPools:
    """Zeroed pools for every transformer layer of ``arch``: in the model
    dtype (``native``) or int8 with f32 scales (``int8``)."""
    if kv_dtype not in ("native", "int8"):
        raise ValueError(f"kv_dtype must be 'native' or 'int8', got {kv_dtype!r}")
    quantized = kv_dtype == "int8"
    shape = (num_blocks, block_size, arch.num_kv_heads, arch.head_dim)
    store = torch.int8 if quantized else arch.dtype

    def zeros(shp, dtype):
        return [torch.zeros(shp, dtype=dtype, device=device)
                for _ in range(arch.num_layers)]

    return PagedKVPools(
        zeros(shape, store), zeros(shape, store),
        zeros(shape[:3], torch.float32) if quantized else None,
        zeros(shape[:3], torch.float32) if quantized else None,
        block_size,
    )


@torch.no_grad()
def write_prompt_kv(view: PagedKVCacheView, k: torch.Tensor, v: torch.Tensor,
                    block_row: torch.Tensor, prompt_len: int, block_size: int) -> None:
    """Scatter one prefilled prompt's K/V ``(1, L_padded, n_kv, h)`` into
    the pool through its block-table row ``(max_blocks,)``, in place (int8
    pools quantise with per-slot scales). Positions past ``prompt_len``,
    the length bucket's padding, go to the trash block, so one bucket
    serves every prompt length in it."""
    L = k.shape[1]
    positions = torch.arange(L, dtype=torch.int32, device=k.device)[None, :]
    flat = paged_flat_slots(block_row[None, :], positions, block_size)
    flat = torch.where(positions < prompt_len, flat, 0).reshape(-1)
    paged_scatter_kv(view, flat, k.reshape(L, *k.shape[2:]), v.reshape(L, *v.shape[2:]))
