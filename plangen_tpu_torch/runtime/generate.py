"""Prefill and the CFG image-token decode loop.

Port of `plangen_tpu/runtime/generate.py` (`prefill`,
`generate_image_tokens`) in the configuration `growing_cache=False,
paged=True`: one fixed [L, 2B, S, H, D] cache, rounded up to a multiple of
128 slots with a zero mask tail, whose live prefix the prefix
decode-attention kernel reads at every step. The JAX package's default
`growing_cache=True` computes the same function over a segmented cache, so
both settings map to this one loop.

Each of the `num_tokens` steps: gen_head on the last hidden state -> CFG
combine -> fp32 sampling (or teacher forcing) -> the token fed back through
gen_embed + gen_aligner to BOTH rows of its cond/uncond pair -> one decoder
step that writes and attends at position `L + i`. The last step's hidden
state is unused, as in the JAX loop, so a generation makes exactly
`num_tokens * num_layers` decode-attention calls.

With `quantized_cache` the cache is the int8 layout of `runtime/kvcache.py`
(the JAX package's `quantized_cache=True`, which every quantized serving
mode sets): prefill writes quantized rows and attends over them, and each
decode step reads through the int8-cache kernel K1-q8.

The loop is plain Python over eager ops; capturing a step in a CUDA graph
is later work.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from plangen_tpu_torch.config import PlanGenModelConfig
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.ops.sampling import (
    Generators, apply_teacher_forcing, cfg_combine, sample_categorical,
)
from plangen_tpu_torch.runtime.kvcache import KVCache, init_kv_cache

CACHE_ALIGN = 128  # the prefix kernel reads the cache in 128-slot chunks


def cache_length(prompt_len: int, num_tokens: int) -> int:
    """Cache slots for a prompt plus `num_tokens`, rounded up to 128."""
    return -(-(prompt_len + num_tokens) // CACHE_ALIGN) * CACHE_ALIGN


def prefill(
    model: PlanGenModel,
    inputs_embeds: torch.Tensor,  # [B, L, H]
    attn_mask: torch.Tensor,  # [B, S_max]
    cache: KVCache,
) -> torch.Tensor:
    """Run the prompt through the decoder, filling cache slots [0, L).

    Returns the last position's hidden state [B, H]."""
    L = inputs_embeds.shape[1]
    positions = torch.arange(L, dtype=torch.int32, device=inputs_embeds.device)
    hidden = model.language_model(inputs_embeds, attn_mask, positions, cache)
    return hidden[:, -1]


@torch.inference_mode()
def generate_image_tokens(
    model: PlanGenModel,
    cfg: PlanGenModelConfig,
    cfg_embeds: torch.Tensor,  # [2B, L, H] interleaved cond/uncond prompt
    attn_mask: torch.Tensor,  # [2B, L + num_tokens] pad mask (image region 1)
    generator: Optional[Generators],  # one for the batch, or one per row
    cfg_weight: float,
    temperature: float,
    gt_tokens: Optional[torch.Tensor] = None,  # [B, num_tokens] forced ids
    regen_mask: Optional[torch.Tensor] = None,  # [B, num_tokens] 1 = sample
    num_tokens: int = 576,
    quantized_cache: bool = False,  # int8 KV cache with fp32 scales
) -> torch.Tensor:
    """Prefill + `num_tokens` KV-cached CFG decode steps; [B, N] int64 ids."""
    B2, L, _ = cfg_embeds.shape
    device = cfg_embeds.device
    if attn_mask.shape != (B2, L + num_tokens):
        raise ValueError(
            f"attn_mask must be [{B2}, {L + num_tokens}], got "
            f"{tuple(attn_mask.shape)}"
        )
    if (gt_tokens is None) != (regen_mask is None):
        raise ValueError("gt_tokens and regen_mask go together")
    if temperature != 0 and generator is None:
        raise ValueError("sampling at temperature > 0 needs a generator")
    if gt_tokens is not None:
        gt_tokens = torch.as_tensor(gt_tokens, device=device)
        regen_mask = torch.as_tensor(regen_mask, device=device)

    S = cache_length(L, num_tokens)
    mask = torch.as_tensor(attn_mask, device=device).to(torch.int32)
    mask = F.pad(mask, (0, S - mask.shape[1])).contiguous()  # zero tail
    cache = init_kv_cache(cfg.llama, B2, S, dtype=cfg_embeds.dtype, device=device,
                          quantized=quantized_cache)
    last_hidden = prefill(model, cfg_embeds, mask, cache)

    positions = torch.arange(L, L + num_tokens, dtype=torch.int32, device=device)
    tokens = []
    for i in range(num_tokens):
        combined = cfg_combine(model.image_gen_logits(last_hidden), cfg_weight)
        token = sample_categorical(combined, temperature, generator)
        if gt_tokens is not None:
            token = apply_teacher_forcing(token, gt_tokens[:, i], regen_mask[:, i])
        tokens.append(token)
        pair_token = token.repeat_interleave(2)  # [2B]: cond and uncond rows
        next_embeds = model.gen_img_embeds(pair_token[:, None]).to(cfg_embeds.dtype)
        hidden = model.language_model(
            next_embeds, mask, positions[i:i + 1], cache
        )
        last_hidden = hidden[:, -1]
    return torch.stack(tokens, dim=1)
