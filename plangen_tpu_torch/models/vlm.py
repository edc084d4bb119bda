"""PlanGen model composition root, layout-to-image slice.

Port of `plangen_tpu/models/vlm.py`: a `MultiModalityCausalLM`-named module
holding `language_model`, `gen_embed`, `gen_aligner`, `gen_head` and
`gen_vision_model` (VQ decode side). SigLIP (`vision_model`), the
understanding `aligner` and the VQ encoder belong to later slices.
"""

from __future__ import annotations

import torch
from torch import nn

from plangen_tpu.config import PlanGenModelConfig
from plangen_tpu_torch.models.llama import LlamaForCausalLM
from plangen_tpu_torch.models.projector import GenHead, MlpProjector
from plangen_tpu_torch.models.vq import VQDecoderModel


class PlanGenModel(nn.Module):
    def __init__(self, cfg: PlanGenModelConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        self.language_model = LlamaForCausalLM(cfg.llama, **kw)
        self.gen_embed = nn.Embedding(cfg.image_token_size, cfg.gen_embed_dim, **kw)
        self.gen_aligner = MlpProjector(cfg.gen_aligner, **kw)
        self.gen_head = GenHead(
            cfg.llama.hidden_size, cfg.image_token_embed, cfg.image_token_size, **kw
        )
        self.gen_vision_model = VQDecoderModel(cfg.vq, **kw)

    def embed_text(self, ids: torch.Tensor) -> torch.Tensor:
        """Token ids -> LLM embeddings [B, L, H]."""
        return self.language_model.embed(ids)

    def gen_img_embeds(self, image_ids: torch.Tensor) -> torch.Tensor:
        """VQ code ids -> LLM-dim embeddings via gen_embed + gen_aligner."""
        return self.gen_aligner(self.gen_embed(image_ids))

    def image_gen_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """gen_head image-token logits (fp32)."""
        return self.gen_head(hidden)
