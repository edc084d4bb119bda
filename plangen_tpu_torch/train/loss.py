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
attention of the LLaMA stack and of SigLIP to the flash kernel; `remat`
rematerializes each of their layers (`ops/remat.py`); `fused_ce` takes the
lm_head CE in 256-position chunks (`shift_cross_entropy_fused`) when
`lm_head` is a plain `nn.Linear`. The JAX package's diagnostic ablations
are not ported.

Every mean is over the global batch, as JAX's losses are: under a data
`group` each rank divides its local sum of token losses by the valid
targets of all ranks (`token_count`), and the train step sums the
gradients and the losses over the group. A mean of per-rank means would
part from JAX's as soon as the ranks' rows hold different numbers of valid
tokens.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from plangen_tpu_torch.models.vlm import PlanGenModel

Losses = Dict[str, torch.Tensor]


def token_count(valid: torch.Tensor, group=None) -> torch.Tensor:
    """The valid targets of the global batch, at least 1: the local count,
    summed over the data group's ranks when `group` is given."""
    count = torch.sum(valid)
    if group is not None:
        count = count.detach().clone()
        dist.all_reduce(count, group=group)
    return torch.clamp(count, min=1.0)


def shift_cross_entropy(
    logits: torch.Tensor,  # [B, L, V]
    labels: torch.Tensor,  # [B, L] int
    ignore_id: int,
    group=None,
) -> torch.Tensor:
    """Mean CE of logits[:, :-1] predicting labels[:, 1:], fp32, pad-ignored;
    over the global batch under a data `group` (this rank's share of it)."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:]
    valid = (targets != ignore_id).float()
    logp = torch.log_softmax(logits, dim=-1)
    tgt = targets.clamp(0, logits.shape[-1] - 1).long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    return torch.sum(nll * valid) / token_count(valid, group)


def _chunk_nll_sum(h, w_head, targets, valid) -> torch.Tensor:
    logits = F.linear(h, w_head).float()  # the matmul dtype, then fp32, as logits()
    logp = torch.log_softmax(logits, dim=-1)
    tgt = targets.clamp(0, logits.shape[-1] - 1).long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    return torch.sum(nll * valid)


def shift_cross_entropy_fused(
    hidden: torch.Tensor,  # [B, S, H]
    w_head: torch.Tensor,  # [V, H], the lm_head nn.Linear weight
    labels: torch.Tensor,  # [B, S] int
    ignore_id: int,
    chunk: int = 256,
    group=None,
) -> torch.Tensor:
    """`shift_cross_entropy` of the lm_head logits without the [B, S, V]
    logits: the positions go in `chunk`-position blocks, each block's
    logits live only inside its checkpointed forward and are recomputed in
    the backward (the JAX package's rematerialized `lax.scan`)."""
    h = hidden[:, :-1]
    targets = labels[:, 1:]
    valid = (targets != ignore_id).float()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, h.shape[1], chunk):
        part = slice(start, start + chunk)
        total = total + checkpoint(_chunk_nll_sum, h[:, part], w_head, targets[:, part],
                                   valid[:, part], use_reentrant=False)
    return total / token_count(valid, group)


def _lm_shift_ce(model: PlanGenModel, hidden, labels, pad_id: int,
                 fused: bool = False, group=None) -> torch.Tensor:
    """lm_head CE; `fused` takes the chunked form when lm_head is a plain
    Linear (a quantized head takes the materialized one, as in JAX). A
    TP-split head weight is gathered whole for the chunks."""
    head = model.language_model.lm_head
    if fused and type(head) is nn.Linear:
        w = head.weight
        w = w.full_tensor() if isinstance(w, DTensor) else w
        return shift_cross_entropy_fused(hidden, w, labels, pad_id, group=group)
    return shift_cross_entropy(model.language_model.logits(hidden), labels, pad_id, group)


def t2i_loss(
    model: PlanGenModel,
    input_ids: torch.Tensor,  # [B, L]
    attn_mask: torch.Tensor,  # [B, L + N]
    images: torch.Tensor,  # [B, H, W, 3] in [-1, 1]
    pad_id: int,
    is_uni: bool = True,
    local_edit_region: Optional[torch.Tensor] = None,  # [B, N] optional loss mask
    use_flash: bool = False,
    remat=False,
    fused_ce: bool = False,
    group=None,
) -> Losses:
    """Image-generation loss (reference forward_t2i)."""
    B, L = input_ids.shape
    n_img = model.cfg.image_seq_len
    with torch.no_grad():  # the VQ tokenizer is frozen; its ids are labels
        vq_ids = model.gen_vision_model.encode_to_indices(images)  # [B, N]

    text_embeds = model.embed_text(input_ids)
    img_embeds = model.gen_img_embeds(vq_ids).to(text_embeds.dtype)
    embeds = torch.cat([text_embeds, img_embeds], dim=1)  # [B, L + N]
    hidden = model.language_model(embeds, attn_mask, use_flash=use_flash, remat=remat)

    img_logits = model.image_gen_logits(hidden[:, -(n_img + 1):])  # fp32
    img_labels = vq_ids
    if local_edit_region is not None:  # only the edit region counts
        img_labels = torch.where(local_edit_region > 0, img_labels, pad_id)
    img_labels = torch.cat([torch.zeros_like(img_labels[:, :1]), img_labels], dim=1)
    loss_img = shift_cross_entropy(img_logits, img_labels, pad_id, group)
    if not is_uni:
        return {"loss_t2i": loss_img}
    loss_lm = _lm_shift_ce(model, hidden[:, :-n_img], input_ids, pad_id, fused_ce, group)
    return {"loss_uni_t2i": loss_img, "loss_uni_lm": loss_lm}


def uni_loss(model, input_ids, attn_mask, images, pad_id, use_flash=False, remat=False,
             fused_ce=False, group=None) -> Losses:
    return t2i_loss(model, input_ids, attn_mask, images, pad_id, is_uni=True,
                    use_flash=use_flash, remat=remat, fused_ce=fused_ce, group=group)


def mmu_loss(
    model: PlanGenModel,
    input_ids: torch.Tensor,  # [B, L] (image tags expanded)
    attn_mask: torch.Tensor,  # [B, L]
    images: torch.Tensor,  # [B, H, W, 3]
    images_seq_mask: torch.Tensor,  # [B, L] bool
    pad_id: int,
    use_flash: bool = False,
    remat=False,
    fused_ce: bool = False,
    group=None,
) -> Losses:
    """Understanding loss (reference forward_mmu): LM CE over the spliced
    sequence; image-placeholder ids -> pad (ignored)."""
    embeds = model.prepare_inputs_embeds(input_ids, images, images_seq_mask, use_flash,
                                         remat)
    hidden = model.language_model(embeds, attn_mask, use_flash=use_flash, remat=remat)
    labels = torch.where(images_seq_mask.bool(), pad_id, input_ids)
    return {"loss_mmu": _lm_shift_ce(model, hidden, labels, pad_id, fused_ce, group)}


def plan_loss(
    model: PlanGenModel,
    input_ids: torch.Tensor,  # [B, L] text-only uni prompt
    attn_mask: torch.Tensor,  # [B, L]
    pad_id: int,
    use_flash: bool = False,
    remat=False,
    fused_ce: bool = False,
    group=None,
) -> Losses:
    """Planning loss (reference forward_plan -> forward_mmu(is_plan=True))."""
    embeds = model.embed_text(input_ids)
    hidden = model.language_model(embeds, attn_mask, use_flash=use_flash, remat=remat)
    return {"loss_plan_lm": _lm_shift_ce(model, hidden, input_ids, pad_id, fused_ce, group)}
