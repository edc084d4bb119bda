"""Fixed-buffer KV cache.

Port of `plangen_tpu/runtime/kvcache.py::init_kv_cache` (the bf16 form).
`{"k", "v"}`: [L, B, S_max, Hkv, D], zero-filled; slot s holds the key/value
of absolute position s of the left-padded sequence. The decoder writes rows
into it in place (`torch.Tensor.index_copy_`), so the buffer is allocated
once per generation and never copied.
"""

from __future__ import annotations

from typing import Dict

import torch

from plangen_tpu.config import LlamaConfig

KVCache = Dict[str, torch.Tensor]


def init_kv_cache(
    cfg: LlamaConfig,
    batch: int,
    max_len: int,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> KVCache:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }
