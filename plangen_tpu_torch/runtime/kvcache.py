"""Fixed-buffer KV cache.

Port of `plangen_tpu/runtime/kvcache.py::init_kv_cache`. Slot s holds the
key/value of absolute position s of the left-padded sequence. Under tensor
parallelism a rank's cache holds its own KV heads (`num_kv_heads`, from
`models/llama.py::local_kv_heads`). The decoder
writes rows into it in place (`torch.Tensor.index_copy_`), so the buffer is
allocated once per generation and never copied. Layouts, zero-filled:

  dense:                  {"k", "v"}: [L, B, S_max, Hkv, D] in `dtype`
  int8 (quantized=True):  {"k", "v"}: int8 [L, B, S_max, Hkv, D] and
                          {"k_scale", "v_scale"}: fp32 [L, B, S_max, Hkv]
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from plangen_tpu_torch.config import LlamaConfig

KVCache = Dict[str, torch.Tensor]


def init_kv_cache(
    cfg: LlamaConfig,
    batch: int,
    max_len: int,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
    quantized: bool = False,
    num_kv_heads: Optional[int] = None,  # the heads a rank holds under TP
) -> KVCache:
    heads = cfg.num_kv_heads if num_kv_heads is None else num_kv_heads
    shape = (cfg.num_layers, batch, max_len, heads, cfg.head_dim)
    if quantized:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }
