"""Weights into the port: from the JAX parameter tree, or seeded random.

`load_jax_params` turns a JAX `vlm.init`-style tree into the HF-named state
dict with `convert/export.py::export_state_dict`, the port's copy of the
JAX package's exporter (linear [in, out] -> [out, in], conv HWIO -> OIHW,
stacked [L, ...] unstacked), and loads every exported key with
`strict=True`. A real Janus-Pro checkpoint, being HF-named, loads by the
same `load_state_dict`.

`load_jax_quantized_params` loads a tree that the JAX package's
`quantize_lm_params` (int8 `{w_q8, scale}` leaves) or
`quantize_lm_params_int4` (int4 `{w_p4, s_lo, s_hi16[, a8]}` leaves, fused
keys) produced: the quantized leaves go into the quantized modules of
`ops/quant.py` as they are, unstacked per layer, and the dense rest goes
through `load_jax_params`' exporter.

`init_params` fills a model with seeded random weights at the JAX `init`
scales, for runs at full width without a checkpoint.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from plangen_tpu_torch.config import PlanGenModelConfig
from plangen_tpu_torch.models.llama import RMSNorm
from plangen_tpu_torch.models.siglip import VisionTransformer
from plangen_tpu_torch.ops.quant import (
    LM_QUANT_KEYS, quant_form, quantized_structure_,
)

# HF-named prefixes of exported keys the port's model does not own: none,
# since the model holds every module of the JAX tree.
SKIPPED_PREFIXES: tuple = ()


def load_jax_params(
    model: nn.Module, params_np: Dict[str, Any], cfg: PlanGenModelConfig
) -> List[str]:
    """Load a JAX parameter tree into `model`; returns the skipped keys.

    Every key the model owns must be present and every exported key outside
    SKIPPED_PREFIXES must be owned by the model (strict loading). Values are
    cast to each parameter's dtype on copy."""
    from plangen_tpu_torch.convert.export import export_state_dict

    sd = export_state_dict(params_np, cfg)
    skipped = sorted(k for k in sd if k.startswith(SKIPPED_PREFIXES))
    kept = {
        k: torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in sd.items() if not k.startswith(SKIPPED_PREFIXES)
    }
    model.load_state_dict(kept, strict=True)
    return skipped


_ATTN_LEAVES = ("q_proj", "k_proj", "v_proj", "o_proj", "qkv_proj", "k_v_proj")


def _is_quantized_leaf(leaf) -> bool:
    return isinstance(leaf, dict) and ("w_q8" in leaf or "w_p4" in leaf)


def jax_quant_form(params: Dict[str, Any]) -> str:
    """'int8', 'int4' or 'int4_a8' of a quantized JAX tree (raises if the
    tree is dense)."""
    layers = params["language_model"]["layers"]
    q = layers.get("qkv_proj", layers.get("q_proj"))
    if not _is_quantized_leaf(q):
        raise ValueError("the JAX tree is not quantized: load it with load_jax_params")
    if "w_q8" in q:
        return "int8"
    return "int4_a8" if "a8" in q else "int4"


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable copy


def load_jax_quantized_params(
    model: nn.Module, params_np: Dict[str, Any], cfg: PlanGenModelConfig
) -> List[str]:
    """Load a quantized JAX tree into `model`; returns the skipped keys.

    A dense model is first given the tree's quantized structure
    (`quantized_structure_`, which frees its dense weights); a model that is
    already quantized must have the tree's form. Loading is strict: every
    buffer and parameter of the model is filled and every leaf is used."""
    from plangen_tpu_torch.convert.export import export_state_dict

    form = jax_quant_form(params_np)
    have = quant_form(model)
    if have is None:
        quantized_structure_(model, form)
    elif have != form:
        raise ValueError(f"the model is {have}-quantized but the tree is {form}")

    lm = dict(params_np["language_model"])
    layers = dict(lm["layers"])
    quantized = {}  # module path -> leaf, stacked over layers where [L, ...]
    for key in list(layers):
        if _is_quantized_leaf(layers[key]):
            leaf = layers.pop(key)
            sub = "self_attn" if key in _ATTN_LEAVES else "mlp"
            for i in range(cfg.llama.num_layers):
                quantized[f"language_model.model.layers.{i}.{sub}.{key}"] = {
                    n: a[i] for n, a in leaf.items() if n != "a8"}
    quantized["language_model.lm_head"] = dict(lm["lm_head"])
    head = dict(params_np["gen_head"])
    head["fc2"] = dict(head["fc2"])
    quantized["gen_head.vision_head"] = dict(head["fc2"]["w"])

    # export_state_dict refuses quantized trees: hand it zero-cost
    # placeholders of the dense shapes, and drop what they export
    def placeholder(shape):
        return np.broadcast_to(np.float32(0), shape)

    L, h = cfg.llama.num_layers, cfg.llama.hidden_size
    dense_shapes = {
        "q_proj": (h, cfg.llama.q_dim), "k_proj": (h, cfg.llama.kv_dim),
        "v_proj": (h, cfg.llama.kv_dim), "o_proj": (cfg.llama.q_dim, h),
        "gate_proj": (h, cfg.llama.intermediate_size),
        "up_proj": (h, cfg.llama.intermediate_size),
        "down_proj": (cfg.llama.intermediate_size, h),
    }
    for key in LM_QUANT_KEYS:
        layers[key] = placeholder((L,) + dense_shapes[key])
    lm["layers"] = layers
    lm["lm_head"] = placeholder((h, cfg.llama.vocab_size))
    head["fc2"]["w"] = placeholder((cfg.image_token_embed, cfg.image_token_size))
    dense_tree = {**params_np, "language_model": lm, "gen_head": head}
    sd = export_state_dict(dense_tree, cfg)

    placeholders = tuple(
        f".{sub}.{key}.weight" for key in LM_QUANT_KEYS
        for sub in ("self_attn", "mlp")
    ) + ("language_model.lm_head.weight", "gen_head.vision_head.weight")
    skipped = sorted(k for k in sd if k.startswith(SKIPPED_PREFIXES))
    kept = {
        k: torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in sd.items()
        if not k.startswith(SKIPPED_PREFIXES) and not k.endswith(placeholders)
    }
    for path, leaf in quantized.items():
        for name, arr in leaf.items():
            if name == "a8":
                continue  # the form, checked above
            kept[f"{path}.{name}"] = _tensor(arr)
    model.load_state_dict(kept, strict=True)
    return skipped


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights at the JAX `init` scales.

    Linear and conv weights: normal * fan_in^-0.5, except SigLIP's patch
    embedding: normal * 0.02; embeddings and SigLIP's pos_embed: normal *
    0.02; the VQ codebook: uniform(-1/N, 1/N); norm scales 1 and biases 0.
    Draws go through `generator` (on the parameters' device) in module
    order."""

    def normal(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * std)

    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            normal(mod.weight, 0.02 if name.endswith("patch_embed.proj") else fan_in ** -0.5)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, VisionTransformer):
            normal(mod.pos_embed, 0.02)
        elif isinstance(mod, nn.Embedding):
            if name.endswith("quantize.embedding"):
                n = mod.weight.shape[0]
                u = torch.rand(mod.weight.shape, generator=generator,
                               device=mod.weight.device)
                mod.weight.copy_((2 * u - 1) / n)
            else:
                normal(mod.weight, 0.02)
        elif isinstance(mod, RMSNorm):
            mod.weight.fill_(1.0)
        elif isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    return model
