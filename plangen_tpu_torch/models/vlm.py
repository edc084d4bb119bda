"""PlanGen model composition root.

Port of `plangen_tpu/models/vlm.py`: a `MultiModalityCausalLM`-named module
holding `language_model`, `gen_embed`, `gen_aligner`, `gen_head`,
`gen_vision_model` (the VQ tokenizer), `vision_model` (SigLIP) and the
understanding `aligner`, plus the embedding-splice helpers of the
understanding flow.
"""

from __future__ import annotations

import torch
from torch import nn

from plangen_tpu_torch.config import PlanGenModelConfig
from plangen_tpu_torch.models.llama import LlamaForCausalLM
from plangen_tpu_torch.models.projector import GenHead, MlpProjector
from plangen_tpu_torch.models.siglip import SigLIPVisionModel
from plangen_tpu_torch.models.vq import VQModel


def splice_image_embeddings(
    token_embeds: torch.Tensor,  # [B, L, H]
    image_embeds: torch.Tensor,  # [B, N, H]
    images_seq_mask: torch.Tensor,  # [B, L] bool, True at image placeholders
) -> torch.Tensor:
    """Fill each row's masked positions with that row's image embeddings in
    order: a gather by the running count of masked positions, as the JAX
    package writes `inputs_embeds[images_seq_mask] = images_embeds`."""
    mask = images_seq_mask.bool()
    idx = (torch.cumsum(mask.long(), dim=1) - 1).clamp(0, image_embeds.shape[1] - 1)
    gathered = torch.gather(
        image_embeds, 1, idx[..., None].expand(-1, -1, image_embeds.shape[-1]))
    return torch.where(mask[..., None], gathered.to(token_embeds.dtype), token_embeds)


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
        self.gen_vision_model = VQModel(cfg.vq, **kw)
        self.vision_model = SigLIPVisionModel(cfg.vision, **kw)
        self.aligner = MlpProjector(cfg.aligner, **kw)

    def embed_text(self, ids: torch.Tensor) -> torch.Tensor:
        """Token ids -> LLM embeddings [B, L, H]."""
        return self.language_model.embed(ids)

    def gen_img_embeds(self, image_ids: torch.Tensor) -> torch.Tensor:
        """VQ code ids -> LLM-dim embeddings via gen_embed + gen_aligner."""
        return self.gen_aligner(self.gen_embed(image_ids))

    def image_gen_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """gen_head image-token logits (fp32)."""
        return self.gen_head(hidden)

    def encode_images_for_understanding(
        self, images: torch.Tensor, use_flash: bool = False
    ) -> torch.Tensor:
        """SigLIP features -> aligner -> LLM-dim embeddings [B, N, H].
        images: [B, H, W, 3] NHWC, CLIP-normalized."""
        return self.aligner(self.vision_model(images, use_flash))

    def prepare_inputs_embeds(
        self,
        input_ids: torch.Tensor,  # [B, L]
        pixel_values: torch.Tensor,  # [B, H, W, 3]
        images_seq_mask: torch.Tensor,  # [B, L] bool
        use_flash: bool = False,
    ) -> torch.Tensor:
        """Text embeddings with SigLIP image features spliced in (one image
        per row)."""
        image_embeds = self.encode_images_for_understanding(pixel_values, use_flash)
        return splice_image_embeddings(self.embed_text(input_ids), image_embeds,
                                       images_seq_mask)
