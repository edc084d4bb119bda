"""Weights into the port: from the JAX parameter tree, or seeded random.

`load_jax_params` turns a JAX `vlm.init`-style tree into the HF-named state
dict with `plangen_tpu.convert.jax_to_torch.export_state_dict` (linear
[in, out] -> [out, in], conv HWIO -> OIHW, stacked [L, ...] unstacked; it
imports no jax) and loads the keys this slice's modules own with
`strict=True`. A real Janus-Pro checkpoint, being HF-named, loads by the
same `load_state_dict`.

`init_params` fills a model with seeded random weights at the JAX `init`
scales, for runs at full width without a checkpoint.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from plangen_tpu.config import PlanGenModelConfig
from plangen_tpu_torch.models.llama import RMSNorm

# HF-named prefixes of modules that belong to later slices: SigLIP, the
# understanding aligner and the VQ encoder side.
SKIPPED_PREFIXES = (
    "vision_model.",
    "aligner.",
    "gen_vision_model.encoder.",
    "gen_vision_model.quant_conv.",
)


def load_jax_params(
    model: nn.Module, params_np: Dict[str, Any], cfg: PlanGenModelConfig
) -> List[str]:
    """Load a JAX parameter tree into `model`; returns the skipped keys.

    Every key the model owns must be present and every exported key outside
    SKIPPED_PREFIXES must be owned by the model (strict loading). Values are
    cast to each parameter's dtype on copy."""
    from plangen_tpu.convert.jax_to_torch import export_state_dict

    sd = export_state_dict(params_np, cfg)
    skipped = sorted(k for k in sd if k.startswith(SKIPPED_PREFIXES))
    kept = {
        k: torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in sd.items() if not k.startswith(SKIPPED_PREFIXES)
    }
    model.load_state_dict(kept, strict=True)
    return skipped


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights at the JAX `init` scales.

    Linear and conv weights: normal * fan_in^-0.5; embeddings: normal * 0.02;
    the VQ codebook: uniform(-1/N, 1/N); norm scales 1 and biases 0. Draws
    go through `generator` (on the parameters' device) in module order."""

    def normal(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * std)

    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            normal(mod.weight, fan_in ** -0.5)
            if mod.bias is not None:
                mod.bias.zero_()
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
        elif isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    return model
