"""MLP projector (gen_aligner) and the gen_head image-token classifier.

Port of `plangen_tpu/models/projector.py`: `forward` is `MlpProjector`,
`gen_head_forward` is `GenHead`. Module names follow HF Janus
(`layers.{0,2}` of an `nn.Sequential` with the GELU at index 1;
`output_mlp_projector` / `vision_head`). GELU is the exact (erf) form.
Under a quantized serving mode `vision_head` (fc2) is an `Int8Linear` or
`Int4Linear` carrying the dense bias (`ops/quant.py`); the logits stay fp32.
"""

from __future__ import annotations

import torch
from torch import nn

from plangen_tpu_torch.config import ProjectorConfig


class MlpProjector(nn.Module):
    def __init__(self, cfg: ProjectorConfig, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        if cfg.projector_type == "identity":
            self.layers = nn.Identity()
        elif cfg.projector_type == "linear":
            self.layers = nn.Linear(cfg.input_dim, cfg.n_embed, **kw)
        elif cfg.projector_type == "mlp_gelu":
            mods = [nn.Linear(cfg.input_dim, cfg.n_embed, **kw)]
            for _ in range(1, cfg.depth):
                mods += [nn.GELU(), nn.Linear(cfg.n_embed, cfg.n_embed, **kw)]
            self.layers = nn.Sequential(*mods)
        else:
            raise ValueError(f"unknown projector type {cfg.projector_type}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


class GenHead(nn.Module):
    """Linear -> GELU -> Linear to the image codebook; fp32 logits."""

    def __init__(self, n_embed: int, image_token_embed: int, image_token_size: int,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.output_mlp_projector = nn.Linear(n_embed, image_token_embed, **kw)
        self.vision_activation = nn.GELU()
        self.vision_head = nn.Linear(image_token_embed, image_token_size, **kw)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        x = self.vision_activation(self.output_mlp_projector(hidden))
        return self.vision_head(x).float()
