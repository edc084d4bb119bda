"""LLaMA decoder (Janus-Pro language backbone) as PyTorch modules.

Port of `plangen_tpu/models/llama.py`. Submodule names follow HF
`LlamaForCausalLM` (`model.layers.{i}.self_attn.q_proj`, ...), so
`load_state_dict` takes the HF-named state dict directly.

Numerics mirror the JAX package:
  * RMSNorm in fp32, output cast back to the input dtype.
  * RoPE tables in fp32 (HF half-split layout), applied in fp32, cast back.
  * Attention softmax in fp32 (ops.attention / ops.decode_attention).
  * Positions are ABSOLUTE indices into the left-padded sequence (HF
    cache_position), not derived from the pad mask.

Without a cache (training) the attention is causal + pad over the Q
queries, through the bias or, with `use_flash` and the JAX package's own
condition (head_dim 128, a [B, Q] mask), through the flash kernel
(`ops/flash_attention.py`).

With a cache, prefill (Q > 1) writes its rows and attends over the full
cache buffer with a causal + pad bias, as the JAX package's XLA branch does;
a decode step (Q == 1) writes its row and reads the live prefix through the
prefix decode-attention kernel. The JAX package's `growing_cache` and
`paged` options are two read strategies of this one function, so the port
has no branch for them. With the int8 cache (`k_scale` in the cache) the
rows are written quantized (`quantize_kv`), prefill attends over the
quantized K/V it has just written (`dot_product_attention_q8`), and a decode
step reads through the int8-cache kernel K1-q8, or with `kv_a8` (the JAX
package's s8 x s8 decode attention) through K1-a8.

`ops/quant.py::quantize_model_` may replace the projections by quantized
modules, with same-input projections fused (`qkv_proj`, `k_v_proj`,
`gate_up_proj`); the layer slices the fused outputs as the JAX layer does.

LoRA (`train/lora.py::add_lora`): each attention may hold adapters
`self_attn.lora.<q|k|v|o>_proj.{a [in, r], b [r, out]}` and the model one
`lora_scaling` (alpha / r); the delta `((x @ a) @ b) * scaling` is added to
the projection's output, dense or quantized, with or without a cache, as
the JAX layer adds `_lora_delta`. Under TP (`parallel/mesh.py`) a pair's
forward is its split one, and the delta is this rank's columns of the
projection's output.

`remat` (training, no cache) runs each layer under `ops/remat.py`, as the
JAX package wraps its layer-scan body in `jax.checkpoint`.

`layers_limit` K exits after the first K layers through the shared final
norm, as the JAX `forward` does for the self-speculative draft; a cached
Q = 1 call still reads through the prefix kernel in each of its K layers.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from plangen_tpu_torch.config import LlamaConfig
from plangen_tpu_torch.ops.attention import (
    dot_product_attention, dot_product_attention_q8, make_causal_bias, quantize_kv,
)
from plangen_tpu_torch.ops.decode_attention import (
    prefix_decode_attention, prefix_decode_attention_a8, prefix_decode_attention_q8,
)
from plangen_tpu_torch.ops.flash_attention import flash_attention
from plangen_tpu_torch.ops.remat import Remat, remat_call

KVCache = Dict[str, torch.Tensor]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (fp32) for absolute positions [Q] -> [Q, D]."""
    exponent = torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=positions.device
    ) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    freqs = positions.float()[..., None] * inv_freq  # [Q, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)  # HF half-split layout
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF-style rotate_half RoPE. x: [B, Q, H, D]; cos/sin: [Q, D]."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return (x.float() * c + rotated.float() * s).to(x.dtype)


def _linear(in_dim: int, out_dim: int, dtype, device) -> nn.Linear:
    return nn.Linear(in_dim, out_dim, bias=False, dtype=dtype, device=device)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype=None, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=None, device=None):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _linear(h, i, dtype, device)
        self.up_proj = _linear(h, i, dtype, device)
        self.down_proj = _linear(i, h, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "gate_up_proj"):  # fused int4 pair
            gu = self.gate_up_proj(x)
            half = gu.shape[-1] // 2
            gate, up = F.silu(gu[..., :half]), gu[..., half:]
        else:
            gate, up = F.silu(self.gate_proj(x)), self.up_proj(x)
        return self.down_proj(gate * up)


class LoRAPair(nn.Module):
    """One projection's adapters, in the JAX layout: a [in, r], b [r, out]."""

    def __init__(self, in_dim: int, out_dim: int, rank: int, dtype=None, device=None):
        super().__init__()
        self.a = nn.Parameter(torch.zeros((in_dim, rank), dtype=dtype, device=device))
        self.b = nn.Parameter(torch.zeros((rank, out_dim), dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, scaling: torch.Tensor) -> torch.Tensor:
        return ((x @ self.a) @ self.b) * scaling


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=None, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.q_proj = _linear(h, cfg.q_dim, dtype, device)
        self.k_proj = _linear(h, cfg.kv_dim, dtype, device)
        self.v_proj = _linear(h, cfg.kv_dim, dtype, device)
        self.o_proj = _linear(cfg.q_dim, h, dtype, device)
        self.lora: Optional[nn.ModuleDict] = None  # {target: LoRAPair}, add_lora

    def qkv(self, x: torch.Tensor, cfg: LlamaConfig, scaling=None):
        """Flat q, k, v projections of x, from the split or fused modules,
        each with its LoRA delta when the layer has adapters."""
        if hasattr(self, "qkv_proj"):  # fused int4 triple (MHA: equal thirds)
            qkv = self.qkv_proj(x)
            d = qkv.shape[-1] // 3  # q_dim, or this rank's share under TP
            q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        elif hasattr(self, "k_v_proj"):  # GQA: only k|v fuse
            q = self.q_proj(x)
            kv = self.k_v_proj(x)
            kd = kv.shape[-1] // 2
            k, v = kv[..., :kd], kv[..., kd:]
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        if self.lora is None:
            return q, k, v
        lora = self.lora
        return (q + lora["q_proj"](x, scaling), k + lora["k_proj"](x, scaling),
                v + lora["v_proj"](x, scaling))

    def out(self, x: torch.Tensor, attn: torch.Tensor, scaling=None) -> torch.Tensor:
        """The residual x plus o_proj of the attention output (and its LoRA
        delta)."""
        x = x + self.o_proj(attn)
        return x if self.lora is None else x + self.lora["o_proj"](attn, scaling)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.self_attn = LlamaAttention(cfg, dtype, device)
        self.mlp = LlamaMLP(cfg, dtype, device)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype, device)
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, dtype, device
        )

    def forward(
        self,
        x: torch.Tensor,  # [B, Q, hidden]
        cos: torch.Tensor,
        sin: torch.Tensor,
        bias: Optional[torch.Tensor],  # [B, 1, Q, S]; None for decode steps
        positions: torch.Tensor,  # [Q] int32 absolute positions
        attn_mask: torch.Tensor,  # [B, S] pad mask of the cache (or [B, Q])
        cache: Optional[KVCache] = None,
        layer_idx: int = 0,
        flash_mask: Optional[torch.Tensor] = None,  # [B, Q]: no cache, flash kernel
        lora_scaling: Optional[torch.Tensor] = None,  # alpha / r, with adapters
        kv_a8: bool = False,  # s8 x s8 decode steps over the int8 cache (K1-a8)
    ) -> torch.Tensor:
        cfg = self.cfg
        B, Q, _ = x.shape
        attn_in = self.input_layernorm(x)
        sa = self.self_attn
        q, k, v = sa.qkv(attn_in, cfg, lora_scaling)
        # the heads this rank holds: all of them, or H/tp under TP
        q = q.reshape(B, Q, -1, cfg.head_dim)
        k = k.reshape(B, Q, -1, cfg.head_dim)
        v = v.reshape(B, Q, -1, cfg.head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if cache is None and flash_mask is not None:
            attn = flash_attention(q, k, v, flash_mask, causal=True)
        elif cache is None:
            attn = dot_product_attention(q, k, v, bias=bias)
        elif "k_scale" in cache:
            attn = self._attend_q8(q, k, v, bias, positions, attn_mask, cache, layer_idx,
                                   kv_a8)
        else:
            # in-place row writes at the absolute positions; index_copy_ takes
            # the device tensor, so no host sync and no cache copy
            k_layer, v_layer = cache["k"][layer_idx], cache["v"][layer_idx]
            write_idx = positions.long()
            k_layer.index_copy_(1, write_idx, k.to(k_layer.dtype))
            v_layer.index_copy_(1, write_idx, v.to(v_layer.dtype))
            if Q == 1:
                attn = prefix_decode_attention(
                    q, cache["k"], cache["v"], attn_mask, layer_idx, positions
                )
            else:
                attn = dot_product_attention(q, k_layer, v_layer, bias=bias)
        x = sa.out(x, attn.reshape(B, Q, -1), lora_scaling)
        return x + self.mlp(self.post_attention_layernorm(x))

    @staticmethod
    def _attend_q8(q, k, v, bias, positions, attn_mask, cache, layer_idx, kv_a8=False):
        """Write the quantized rows into the int8 cache, then attend over it
        (prefill reads the quantized K/V it has just written, as JAX does).
        With `kv_a8` a decode step (Q == 1) goes through K1-a8; prefill keeps
        the plain int8 path, as JAX's `a8 = kv_a8 and Q == 1`."""
        k_q8, k_s, v_q8, v_s = quantize_kv(k, v)
        write_idx = positions.long()
        names = ("k", "k_scale", "v", "v_scale")
        for name, rows in zip(names, (k_q8, k_s, v_q8, v_s)):
            cache[name][layer_idx].index_copy_(1, write_idx, rows)
        if q.shape[1] == 1:
            attend = prefix_decode_attention_a8 if kv_a8 else prefix_decode_attention_q8
            return attend(
                q, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"],
                attn_mask, layer_idx, positions,
            )
        k_l, ks_l, v_l, vs_l = (cache[name][layer_idx] for name in names)
        return dot_product_attention_q8(q, k_l, ks_l, v_l, vs_l, bias=bias)


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(
            cfg.vocab_size, cfg.hidden_size, dtype=dtype, device=device
        )
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(cfg, dtype, device) for _ in range(cfg.num_layers)
        )
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype, device)
        self.lora_scaling: Optional[nn.Parameter] = None  # 0-d alpha / r, add_lora

    def forward(
        self,
        inputs_embeds: torch.Tensor,  # [B, Q, hidden]
        attn_mask: torch.Tensor,  # [B, Q] pad mask (no cache) or [B, S] (cache)
        positions: Optional[torch.Tensor] = None,  # [Q] absolute positions
        kv_cache: Optional[KVCache] = None,  # written in place
        use_flash: bool = False,  # the flash kernel on the no-cache path
        remat: Remat = False,  # no cache: each layer under ops/remat.py
        layers_limit: Optional[int] = None,  # early exit after the first K layers
        kv_a8: bool = False,  # decode steps over the int8 cache through K1-a8
    ) -> torch.Tensor:
        """Run the decoder stack (final RMSNorm applied, no head).

        Without a cache: causal + pad attention over the Q queries, through
        the flash kernel when `use_flash`, head_dim is 128 and the mask is
        [B, Q] (the JAX package's condition), else through the bias. With a
        cache: the queries' rows are written at `positions`; prefill attends
        over the whole buffer with a causal + pad bias, a decode step
        (Q == 1) reads the live prefix through the prefix kernel with
        `q_pos = positions`. Returns hidden [B, Q, hidden].

        `layers_limit` K runs the first K layers only, then the shared final
        norm (the self-speculative draft, `runtime/speculative.py`); with a
        cache only layers [0, K) are written. K must be in [1, num_layers]."""
        n_layers = self.cfg.num_layers if layers_limit is None else layers_limit
        if not 1 <= n_layers <= self.cfg.num_layers:
            raise ValueError(f"layers_limit must be in [1, {self.cfg.num_layers}], "
                             f"got {layers_limit}")
        B, Q, _ = inputs_embeds.shape
        device = inputs_embeds.device
        if positions is None:
            positions = torch.arange(Q, dtype=torch.int32, device=device)
        flash_mask = None
        if kv_cache is None and use_flash and self.cfg.head_dim == 128 \
                and attn_mask.shape[1] == Q:
            flash_mask, bias = attn_mask, None
        elif kv_cache is None:
            bias = make_causal_bias(attn_mask, positions, positions)
        elif Q == 1:
            bias = None  # the prefix kernel masks by pad and position itself
        else:
            S = kv_cache["k"].shape[2]
            kv_positions = torch.arange(S, dtype=torch.int32, device=device)
            bias = make_causal_bias(attn_mask, positions, kv_positions)
        cos, sin = rope_cos_sin(positions, self.cfg.head_dim, self.cfg.rope_theta)
        x = inputs_embeds
        remat = remat if kv_cache is None else False
        for i, layer in enumerate(self.layers[:n_layers]):
            x = remat_call(layer, remat, x, cos, sin, bias, positions, attn_mask, kv_cache,
                           i, flash_mask, self.lora_scaling, kv_a8)
        return self.norm(x)


def local_kv_heads(lm: "LlamaForCausalLM") -> int:
    """The KV heads this rank's layers produce: all of them, or the rank's
    share under TP (the local width of k_proj, or of the fused k|v or q|k|v
    projection of a quantized model, over head_dim)."""
    cfg = lm.model.cfg
    sa = lm.model.layers[0].self_attn
    name, parts = next((n, p) for n, p in (("k_proj", 1), ("k_v_proj", 2), ("qkv_proj", 3))
                       if hasattr(sa, n))
    proj = getattr(sa, name)
    weight = getattr(proj, "weight", None)
    if weight is not None:  # dense [out, in], or a DTensor's local shard
        width = (weight.to_local() if hasattr(weight, "to_local") else weight).shape[0]
    else:  # quantized (`ops/quant.py`): its local out features
        width = proj.out_features
    return width // parts // cfg.head_dim


class LlamaForCausalLM(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=None, device=None):
        super().__init__()
        self.model = LlamaModel(cfg, dtype, device)
        self.lm_head = _linear(cfg.hidden_size, cfg.vocab_size, dtype, device)

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.model.embed_tokens(ids)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """LM logits in fp32."""
        return self.lm_head(hidden).float()

    def forward(self, inputs_embeds, attn_mask, positions=None, kv_cache=None,
                use_flash=False, remat: Remat = False, layers_limit: Optional[int] = None,
                kv_a8: bool = False):
        return self.model(inputs_embeds, attn_mask, positions, kv_cache, use_flash, remat,
                          layers_limit, kv_a8)
