"""Attention primitives in plain PyTorch.

Port of `plangen_tpu/ops/attention.py`: `dot_product_attention` (einsum with
an fp32 softmax) and `make_causal_bias`. Prefill runs through these, as it
runs through plain XLA in the JAX package; decode steps go to the prefix
kernel in `ops/decode_attention.py`.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large-but-finite; avoids NaN from all-masked rows


def dot_product_attention(
    q: torch.Tensor,  # [B, Q, H, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,  # [B, S, Hkv, D]
    bias: Optional[torch.Tensor] = None,  # [B, 1|H, Q, S] additive
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-head attention with GQA support and an fp32 softmax.

    Both products take fp32 inputs (exact for bf16 operands) and accumulate
    in fp32, like `preferred_element_type=float32`; the probabilities are
    rounded to `v.dtype` before the PV product; the output is cast to
    `q.dtype`.
    """
    B, Q, H, D = q.shape
    Hkv = k.shape[2]
    if scale is None:
        scale = D ** -0.5
    if Hkv != H:
        rep = H // Hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def make_causal_bias(
    pad_mask: torch.Tensor,  # [B, S] 1 = attend, 0 = pad
    q_positions: torch.Tensor,  # [Q] absolute positions of the queries
    kv_positions: torch.Tensor,  # [S] absolute positions of the kv slots
) -> torch.Tensor:
    """Additive [B, 1, Q, S] bias: 0 where `q_pos >= kv_pos` and the slot is
    not a pad, NEG_INF elsewhere (HF left-padded cache semantics)."""
    causal = q_positions[:, None] >= kv_positions[None, :]  # [Q, S]
    allowed = causal[None] & (pad_mask[:, None, :] > 0)  # [B, Q, S]
    zero = torch.zeros((), dtype=torch.float32, device=pad_mask.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=pad_mask.device)
    return torch.where(allowed, zero, neg)[:, None]
