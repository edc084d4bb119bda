"""LoRA adapters for the LM attention projections.

Port of `plangen_tpu/train/lora.py`. The recipe's 'lora' tuning mode: rank
`lora_rank` (256), alpha `lora_alpha` (128), A gaussian with std 1/rank and
B zero, on q/k/v/o_proj of every LLaMA layer. The adapters live in the
model (`models/llama.py`): `self_attn.lora.<target>.{a, b}` per layer, in
the JAX layout (a [in, r], b [r, out]), and one `lora_scaling` = alpha / r
on the LLaMA model, as the JAX tree holds `language_model/lora` with its
stacked [L, in, r] / [L, r, out] leaves and one `scaling`.

`add_lora` builds zero adapters, `init_lora` draws them (torch's generator:
JAX's draws cannot be reproduced), `merge_lora` folds `W + A @ B * scaling`
into the base weights, of a model or of a JAX-layout numpy tree (what the
exporter does before writing HF weights).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from plangen_tpu_torch.models.llama import LoRAPair

TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj")


def _llama(model: nn.Module) -> nn.Module:
    """The LlamaModel of a PlanGenModel."""
    return model.language_model.model


def has_lora(model: nn.Module) -> bool:
    return _llama(model).lora_scaling is not None


def add_lora(model: nn.Module, rank: int = 256, alpha: float = 128) -> nn.Module:
    """Give every LLaMA layer zero adapters of rank `rank` (in the dtype and
    on the device of the token embeddings: the projections may be
    quantized) and the model `lora_scaling` = alpha / rank; returns the
    model."""
    lm = _llama(model)
    cfg = lm.cfg
    dims = {"q_proj": (cfg.hidden_size, cfg.q_dim), "k_proj": (cfg.hidden_size, cfg.kv_dim),
            "v_proj": (cfg.hidden_size, cfg.kv_dim), "o_proj": (cfg.q_dim, cfg.hidden_size)}
    like = lm.embed_tokens.weight
    kw = dict(dtype=like.dtype, device=like.device)
    for layer in lm.layers:
        layer.self_attn.lora = nn.ModuleDict(
            {t: LoRAPair(*dims[t], rank, **kw) for t in TARGETS})
    lm.lora_scaling = nn.Parameter(torch.tensor(alpha / rank, **kw))
    return model


@torch.no_grad()
def init_lora(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """A ~ normal * (1 / rank) (drawn in fp32, then cast), B = 0, layer by
    layer and target by target."""
    for layer in _llama(model).layers:
        for t in TARGETS:
            pair = layer.self_attn.lora[t]
            rank = pair.a.shape[1]
            pair.a.copy_(torch.randn(pair.a.shape, generator=generator,
                                     device=pair.a.device) * (1.0 / rank))
            pair.b.zero_()
    return model


def merge_lora(params):
    """Fold `W + (A @ B) * scaling` into the base weights and drop the
    adapters, as the JAX package's `merge_lora`: the sum in fp32, cast back
    to W's dtype.

    A model (`nn.Module`) is merged in place and returned; its projections
    must be dense. A JAX-layout tree (nested dicts of arrays) gives a new
    tree without `language_model/lora`. Without adapters either comes back
    as it is."""
    if isinstance(params, nn.Module):
        return _merge_model(params)
    return _merge_tree(params)


@torch.no_grad()
def _merge_model(model: nn.Module) -> nn.Module:
    lm = _llama(model)
    if lm.lora_scaling is None:
        return model
    scaling = lm.lora_scaling
    for i, layer in enumerate(lm.layers):
        sa = layer.self_attn
        for t in TARGETS:
            proj = getattr(sa, t, None)
            if type(proj) is not nn.Linear:
                raise ValueError(f"layer {i} {t}: cannot merge adapters into a quantized "
                                 "projection: merge before quantizing")
            pair = sa.lora[t]
            delta = (pair.a @ pair.b) * scaling  # [in, out], in the adapters' dtype
            proj.weight.copy_((proj.weight.float() + delta.float().T).to(proj.weight.dtype))
        sa.lora = None
    lm.lora_scaling = None
    return model


def _merge_tree(params: Dict[str, Any]) -> Dict[str, Any]:
    lm = dict(params["language_model"])
    lora = lm.pop("lora", None)
    if lora is None:
        return params
    scale = np.asarray(lora["scaling"])
    layers = dict(lm["layers"])
    for name in TARGETS:
        if name in lora:
            a, b = np.asarray(lora[name]["a"]), np.asarray(lora[name]["b"])
            delta = np.einsum("lir,lro->lio", a, b) * scale
            w = np.asarray(layers[name])
            layers[name] = (w.astype(np.float32) + delta.astype(np.float32)).astype(w.dtype)
    lm["layers"] = layers
    return {**params, "language_model": lm}
