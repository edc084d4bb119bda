"""Attention primitives in plain PyTorch.

Port of `plangen_tpu/ops/attention.py`: `dot_product_attention` (einsum with
an fp32 softmax), `make_causal_bias`, and for the int8 KV cache `quantize_kv`
and `dot_product_attention_q8`, with its `a8` option (the query and the
probabilities quantized to int8 rows by `_quantize_rows_s8`, both products
s8 x s8 -> s32). Prefill runs through these, as it runs through plain XLA in
the JAX package; decode steps go to the prefix kernels in
`ops/decode_attention.py`.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def _quantize_rows_s8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row (last axis) int8 quantization with fp32 scales:
    s = absmax / 127 (1 for an all-zero row), q8 = clip(round(x / s)),
    rounding half to even. Returns (q8, s[..., 1])."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    # divided by a tensor: on the card PyTorch turns a division by a Python
    # number into a product by its reciprocal, one rounding apart
    s = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0), 1.0)
    q8 = torch.round(x / s).clamp_(-127, 127).to(torch.int8)
    return q8, s.float()


def s8_dot(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The s8 x s8 -> s32 einsum, in fp32: each sum is an integer below
    2**53, so float64 holds it exactly (the card has no int32 einsum), and
    the cast to fp32 rounds it as the s32 result's `astype(float32)` does."""
    return torch.einsum(equation, a.double(), b.double()).float()


def dot_product_attention_q8(
    q: torch.Tensor,  # [B, Q, H, D]
    k_q8: torch.Tensor,  # [B, S, Hkv, D] int8
    k_scale: torch.Tensor,  # [B, S, Hkv] fp32
    v_q8: torch.Tensor,  # [B, S, Hkv, D] int8
    v_scale: torch.Tensor,  # [B, S, Hkv] fp32
    bias: Optional[torch.Tensor] = None,  # [B, 1|H, Q, S] additive
    scale: Optional[float] = None,
    a8: bool = False,
) -> torch.Tensor:
    """Attention over an int8 KV cache with per-(position, head) scales.

    The scales fold into the softmax instead of dequantizing K/V:
    logits = (q . k_q8) * k_scale * scale + bias in fp32, then
    out = ((softmax * v_scale) in q.dtype) . v_q8 with fp32 accumulation.

    `a8=True` (the JAX package's s8 x s8 decode attention) quantizes the
    query per (row, head) over D and the normalized, v_scale-folded
    probabilities per (row, head) over all S slots: logits =
    s32(q8 . k_q8) * q_s * k_scale * scale + bias, out = s32(p8 . v_q8) * p_s,
    with no division by the softmax sum afterwards."""
    B, Q, H, D = q.shape
    Hkv = k_q8.shape[2]
    if scale is None:
        scale = D ** -0.5
    if Hkv != H:
        rep = H // Hkv
        k_q8, v_q8 = k_q8.repeat_interleave(rep, 2), v_q8.repeat_interleave(rep, 2)
        k_scale = k_scale.repeat_interleave(rep, 2)
        v_scale = v_scale.repeat_interleave(rep, 2)
    if a8:
        q_q8, q_s = _quantize_rows_s8(q.float())  # q_s [B, Q, H, 1]
        logits = s8_dot("bqhd,bshd->bhqs", q_q8, k_q8) * q_s.transpose(1, 2)
    else:
        logits = torch.einsum("bqhd,bshd->bhqs", q.float(), k_q8.float())
    logits = logits * k_scale.transpose(1, 2)[:, :, None, :]  # [B, H, 1, S]
    logits = logits * scale
    if bias is not None:
        logits = logits + bias.float()
    if a8:
        # jax.nn.softmax's order: exp(x - max) divided by its sum
        # (torch.softmax multiplies by the reciprocal, one rounding apart)
        e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        probs = e / e.sum(dim=-1, keepdim=True) * v_scale.transpose(1, 2)[:, :, None, :]
        p_q8, p_s = _quantize_rows_s8(probs)  # over S; p_s [B, H, Q, 1]
        out = s8_dot("bhqs,bshd->bqhd", p_q8, v_q8) * p_s.transpose(1, 2)
        return out.to(q.dtype)
    probs = torch.softmax(logits, dim=-1) * v_scale.transpose(1, 2)[:, :, None, :]
    out = torch.einsum("bhqs,bshd->bqhd", probs.to(q.dtype).float(), v_q8.float())
    return out.to(q.dtype)


def quantize_kv(
    k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of K/V rows, one scale per (batch,
    position, head) over D: (k_q8, k_scale, v_q8, v_scale), scales fp32."""

    # k and v in one pass: every op below is elementwise or per row, so
    # stacking them changes no value and halves the launches of a step
    xf = torch.stack([k, v]).float()
    absmax = xf.abs().amax(dim=-1)
    s = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.round(xf / s[..., None]).clamp_(-127, 127).to(torch.int8)
    return q[0], s[0], q[1], s[1]
