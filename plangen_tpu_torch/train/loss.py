"""Task losses.

Port of `plangen_tpu/train/loss.py`. Each loss takes the `PlanGenModel`
whose parameters are the compute copy (the train step calls them through
`torch.func.functional_call`):

  * shift-by-one cross entropy in fp32 with pad-id ignore;
  * 'uni'/'t2i' — gen_head CE over the last N + 1 positions against
    [0, vq_ids] labels (the VQ encoder gives the labels, with no gradient),
    plus (uni only) lm_head CE over the text positions;
  * 'mmu' — lm_head CE over the SigLIP-spliced sequence with the
    image-placeholder positions remapped to pad (ignored);
  * 'plan' — lm_head CE over the text-only uni prompt.

All forwards are cache-free and full-sequence. `use_flash` sends the
attention of the LLaMA stack and of SigLIP to the flash kernel; the chunked
`fused_ce` form and the JAX package's diagnostic ablations are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from plangen_tpu_torch.models.vlm import PlanGenModel

Losses = Dict[str, torch.Tensor]


def shift_cross_entropy(
    logits: torch.Tensor,  # [B, L, V]
    labels: torch.Tensor,  # [B, L] int
    ignore_id: int,
) -> torch.Tensor:
    """Mean CE of logits[:, :-1] predicting labels[:, 1:], fp32, pad-ignored."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:]
    valid = (targets != ignore_id).float()
    logp = torch.log_softmax(logits, dim=-1)
    tgt = targets.clamp(0, logits.shape[-1] - 1).long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    return torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1.0)


def _lm_shift_ce(model: PlanGenModel, hidden, labels, pad_id: int) -> torch.Tensor:
    return shift_cross_entropy(model.language_model.logits(hidden), labels, pad_id)


def t2i_loss(
    model: PlanGenModel,
    input_ids: torch.Tensor,  # [B, L]
    attn_mask: torch.Tensor,  # [B, L + N]
    images: torch.Tensor,  # [B, H, W, 3] in [-1, 1]
    pad_id: int,
    is_uni: bool = True,
    local_edit_region: Optional[torch.Tensor] = None,  # [B, N] optional loss mask
    use_flash: bool = False,
) -> Losses:
    """Image-generation loss (reference forward_t2i)."""
    B, L = input_ids.shape
    n_img = model.cfg.image_seq_len
    with torch.no_grad():  # the VQ tokenizer is frozen; its ids are labels
        vq_ids = model.gen_vision_model.encode_to_indices(images)  # [B, N]

    text_embeds = model.embed_text(input_ids)
    img_embeds = model.gen_img_embeds(vq_ids).to(text_embeds.dtype)
    embeds = torch.cat([text_embeds, img_embeds], dim=1)  # [B, L + N]
    hidden = model.language_model(embeds, attn_mask, use_flash=use_flash)

    img_logits = model.image_gen_logits(hidden[:, -(n_img + 1):])  # fp32
    img_labels = vq_ids
    if local_edit_region is not None:  # only the edit region counts
        img_labels = torch.where(local_edit_region > 0, img_labels, pad_id)
    img_labels = torch.cat([torch.zeros_like(img_labels[:, :1]), img_labels], dim=1)
    loss_img = shift_cross_entropy(img_logits, img_labels, pad_id)
    if not is_uni:
        return {"loss_t2i": loss_img}
    loss_lm = _lm_shift_ce(model, hidden[:, :-n_img], input_ids, pad_id)
    return {"loss_uni_t2i": loss_img, "loss_uni_lm": loss_lm}


def uni_loss(model, input_ids, attn_mask, images, pad_id, use_flash=False) -> Losses:
    return t2i_loss(model, input_ids, attn_mask, images, pad_id, is_uni=True,
                    use_flash=use_flash)


def mmu_loss(
    model: PlanGenModel,
    input_ids: torch.Tensor,  # [B, L] (image tags expanded)
    attn_mask: torch.Tensor,  # [B, L]
    images: torch.Tensor,  # [B, H, W, 3]
    images_seq_mask: torch.Tensor,  # [B, L] bool
    pad_id: int,
    use_flash: bool = False,
) -> Losses:
    """Understanding loss (reference forward_mmu): LM CE over the spliced
    sequence; image-placeholder ids -> pad (ignored)."""
    embeds = model.prepare_inputs_embeds(input_ids, images, images_seq_mask, use_flash)
    hidden = model.language_model(embeds, attn_mask, use_flash=use_flash)
    labels = torch.where(images_seq_mask.bool(), pad_id, input_ids)
    return {"loss_mmu": _lm_shift_ce(model, hidden, labels, pad_id)}


def plan_loss(
    model: PlanGenModel,
    input_ids: torch.Tensor,  # [B, L] text-only uni prompt
    attn_mask: torch.Tensor,  # [B, L]
    pad_id: int,
    use_flash: bool = False,
) -> Losses:
    """Planning loss (reference forward_plan -> forward_mmu(is_plan=True))."""
    embeds = model.embed_text(input_ids)
    hidden = model.language_model(embeds, attn_mask, use_flash=use_flash)
    return {"loss_plan_lm": _lm_shift_ce(model, hidden, input_ids, pad_id)}
