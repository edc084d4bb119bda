"""Jacobi (parallel fixed-point) decoding for greedy text generation.

Port of `plangen_tpu/runtime/jacobi.py`. The greedy trajectory is the
unique fixed point of

    y  <-  sticky_eos(argmax(lm_head(forward(prompt ++ embed(y)))))

so instead of up to T sequential KV-cached steps
(`runtime/generate.py::greedy_decode_text`), each pass runs one forward
without a cache over the prompt and the whole token buffer, and the
passes repeat until the buffer stops changing. Each pass fixes at least
one more position, so T passes always reach the fixed point, which equals
the sequential decoder's output, EOS handling included: rows keep emitting
EOS after their first, as the sequential loop embeds its forced EOS.

A pass embeds y with the text embedding, runs the decoder over positions
0 .. L + T - 1 with the pad mask (the dense causal + pad attention, as the
JAX Jacobi passes no flash mask), takes the fp32 `lm_head` logits of
hidden[:, L - 1 : L + T - 1] and their first argmax (JAX's tie rule).
Passes run eagerly; after each the host reads whether the buffer changed,
as the JAX `while_loop`'s `cond` does. Opt-in: with random weights a pass
fixes about one position, so the speed depends on trained weights.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from plangen_tpu_torch.config import PlanGenModelConfig
from plangen_tpu_torch.models.vlm import PlanGenModel


def sticky_eos(tokens: torch.Tensor, eos_id: int) -> torch.Tensor:
    """EOS at every position after a row's first EOS."""
    seen = torch.cumsum((tokens == eos_id).to(torch.int32), dim=1)
    prev_seen = F.pad(seen, (1, 0))[:, :tokens.shape[1]]
    return torch.where(prev_seen > 0, eos_id, tokens)


@torch.inference_mode()
def jacobi_decode_text(
    model: PlanGenModel,
    cfg: PlanGenModelConfig,
    inputs_embeds: torch.Tensor,  # [B, L, H]
    attn_mask: torch.Tensor,  # [B, L + max_new_tokens]
    eos_id: int,
    max_new_tokens: int = 512,
    max_iters: Optional[int] = None,  # default: max_new_tokens (the exact bound)
    return_iters: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, int]]:
    """Greedy text decode by Jacobi iteration; [B, max_new_tokens] int32,
    and the passes run under `return_iters`. With `max_iters >=
    max_new_tokens` (the default) the tokens are `greedy_decode_text`'s."""
    B, L, _ = inputs_embeds.shape
    T = max_new_tokens
    device = inputs_embeds.device
    if attn_mask.shape != (B, L + T):
        raise ValueError(f"attn_mask must be [{B}, {L + T}], got {tuple(attn_mask.shape)}")
    if max_iters is None:
        max_iters = T
    mask = torch.as_tensor(attn_mask, device=device).to(torch.int32)
    positions = torch.arange(L + T, dtype=torch.int32, device=device)
    lm = model.language_model

    def one_pass(y: torch.Tensor) -> torch.Tensor:
        full = torch.cat([inputs_embeds, model.embed_text(y).to(inputs_embeds.dtype)], dim=1)
        hidden = lm(full, mask, positions)
        logits = lm.logits(hidden[:, L - 1:L + T - 1])
        return sticky_eos(logits.argmax(dim=-1).to(torch.int32), eos_id)

    y = torch.zeros((B, T), dtype=torch.int32, device=device)
    iters, converged = 0, False
    while iters < max_iters and not converged:
        y_new = one_pass(y)
        iters += 1
        converged = torch.equal(y_new, y)  # the host reads it, as the JAX cond does
        y = y_new
    return (y, iters) if return_iters else y
