"""The multi-task train step.

Port of `plangen_tpu/train/step.py`: one optimizer step is one forward per
task flow, the weighted loss sum, one backward, and AdamW after a global-norm
clip (`train/optim.py`).

Mixed precision follows the JAX package: the parameters live in fp32 (the
optimizer's masters) and the loss runs on a copy cast to `compute_dtype`
(bf16). The copy is made inside the step by `torch.func.functional_call`
with {name: p.to(compute_dtype)}: trainable parameters are cast
differentiably, frozen ones detached first (the JAX package's `_cast` after
`stop_gradient`), so the gradient lands on the fp32 masters in fp32 and no
frozen module does weight-gradient work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from plangen_tpu_torch.config import PlanGenModelConfig, TrainConfig
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.train.loss import mmu_loss, plan_loss, t2i_loss
from plangen_tpu_torch.train.optim import AdamW

Batches = Dict[int, Dict[str, torch.Tensor]]


@dataclass
class TrainState:
    model: PlanGenModel  # the fp32 masters
    opt: AdamW
    step: int = 0


class _FlowLosses(nn.Module):
    """Holds the model so that `functional_call` can swap in the compute copy."""

    def __init__(self, model: PlanGenModel, run: Callable):
        super().__init__()
        self.model = model
        self._run = run

    def forward(self, batches: Batches):
        return self._run(self.model, batches)


def _check_train_config(train_cfg: TrainConfig) -> None:
    """Options of the JAX package's train step that the port does not have."""
    if train_cfg.gradient_checkpointing:
        raise NotImplementedError("gradient_checkpointing (remat) is not ported")
    if train_cfg.fused_lm_ce:
        raise NotImplementedError("fused_lm_ce (the chunked lm_head CE) is not ported")


def make_loss_fn(
    model_cfg: PlanGenModelConfig,
    train_cfg: TrainConfig,
    pad_id: int,
    flows: Sequence[Tuple[int, str]],  # (flow_id, task_type)
    compute_dtype: torch.dtype = torch.bfloat16,
    trainable_mask: Optional[Dict[str, bool]] = None,
) -> Callable:
    """Build `loss_fn(model, batches) -> (total, loss_dict)` over the fp32
    masters of `model`.

    Batch format per flow (tensors on the model's device):
      uni/t2i: {input_ids [B,L], attn_mask [B,L+N], images [B,H,W,3]}
      mmu:     {input_ids, attn_mask, images, images_seq_mask}
      plan:    {input_ids, attn_mask}

    Loss weighting: per-key `loss_scales[f"{key}_{flow_id}"]`, then
    `plan_lr_scale` on every '*lm*' key. Without `trainable_mask` every
    parameter takes a gradient."""
    _check_train_config(train_cfg)
    flows = tuple(flows)
    scales = dict(train_cfg.loss_scales)
    plan_lr_scale = train_cfg.plan_lr_scale
    use_flash = train_cfg.use_flash_attention
    use_local_edit_loss = train_cfg.use_local_edit_loss

    def run(model: PlanGenModel, batches: Batches):
        loss_dict: Dict[str, torch.Tensor] = {}
        for flow_id, task in flows:
            b = batches[flow_id]
            if task in ("uni", "t2i"):
                ld = t2i_loss(
                    model, b["input_ids"], b["attn_mask"], b["images"].to(compute_dtype),
                    pad_id, is_uni=(task == "uni"),
                    local_edit_region=(b["edit_region"] if use_local_edit_loss
                                       and "edit_region" in b else None),
                    use_flash=use_flash,
                )
            elif task == "mmu":
                ld = mmu_loss(
                    model, b["input_ids"], b["attn_mask"], b["images"].to(compute_dtype),
                    b["images_seq_mask"], pad_id, use_flash=use_flash,
                )
            elif task == "plan":
                ld = plan_loss(model, b["input_ids"], b["attn_mask"], pad_id,
                               use_flash=use_flash)
            else:
                raise ValueError(f"unknown task type {task!r}")
            loss_dict.update({f"{k}_{flow_id}": v for k, v in ld.items()})

        total = torch.zeros((), dtype=torch.float32, device=next(iter(loss_dict.values())).device)
        for k, v in loss_dict.items():
            v = v * scales.get(k, 1.0)
            if plan_lr_scale is not None and "lm" in k:
                v = v * plan_lr_scale
            loss_dict[k] = v
            total = total + v
        return total, loss_dict

    def loss_fn(model: PlanGenModel, batches: Batches):
        params = {}
        for name, p in model.named_parameters():
            if trainable_mask is not None and not trainable_mask[name]:
                p = p.detach()
            params["model." + name] = p.to(compute_dtype) if p.is_floating_point() else p
        return torch.func.functional_call(_FlowLosses(model, run), params, (batches,))

    return loss_fn


def make_train_step(
    model_cfg: PlanGenModelConfig,
    train_cfg: TrainConfig,
    pad_id: int,
    flows: Sequence[Tuple[int, str]],
    compute_dtype: torch.dtype = torch.bfloat16,
    trainable_mask: Optional[Dict[str, bool]] = None,
) -> Callable:
    """Build `train_step(state, batches) -> (state, metrics)`; the state is
    updated in place. metrics: {"loss": total, **loss_dict}, 0-d tensors."""
    loss_fn = make_loss_fn(model_cfg, train_cfg, pad_id, flows, compute_dtype,
                           trainable_mask=trainable_mask)

    def train_step(state: TrainState, batches: Batches):
        model = state.model
        model.zero_grad(set_to_none=True)
        loss, loss_dict = loss_fn(model, batches)
        loss.backward()
        state.opt.step({n: p.grad for n, p in model.named_parameters()})
        model.zero_grad(set_to_none=True)
        state.step += 1
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in loss_dict.items()}}
        return state, metrics

    return train_step


def init_train_state(model: PlanGenModel, opt: AdamW) -> TrainState:
    """The train state over fp32 masters (the model must already be fp32:
    the optimizer holds its parameters)."""
    for name, p in model.named_parameters():
        if p.is_floating_point() and p.dtype != torch.float32:
            raise ValueError(f"fp32 masters required, {name} is {p.dtype}")
    return TrainState(model=model, opt=opt, step=0)
