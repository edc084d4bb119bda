"""The multi-task train step.

Port of `plangen_tpu/train/step.py`: one optimizer step is one forward per
task flow, the weighted loss sum, one backward, and the optimizer after a
global-norm clip (`train/optim.py`: AdamW or Adafactor, with gradient
accumulation the update lands on every k-th step).

Mixed precision follows the JAX package: the parameters live in the master
dtype (fp32, or bf16 with `master_dtype="bfloat16"`) and the loss runs on a
copy cast to `compute_dtype` (bf16; the identity for bf16 masters). The copy
is made inside the step by `torch.func.functional_call` with
{name: p.to(compute_dtype)}: trainable parameters are cast differentiably,
frozen ones detached first (the JAX package's `_cast` after
`stop_gradient`), so the gradient lands on the masters in their dtype and
no frozen module does weight-gradient work. Under FSDP2
(`parallel/mesh.py::shard_params`) the model's `MixedPrecisionPolicy` makes
the same cast after each all-gather, and frozen parameters take no
gradient because they do not require one (the Trainer sets that); the
parameters FSDP2 ignores (the TP-split ones on a data x model mesh and
those kept whole under `fsdp_min_size`, `fsdp_ignored`) are cast here as
without FSDP.

`gradient_checkpointing` rematerializes every LLaMA layer and SigLIP block
by `remat_policy` (`ops/remat.py`), `fused_lm_ce` takes the lm_head CE in
chunks (`train/loss.py`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.fsdp import FSDPModule
from torch.distributed.tensor import DTensor

from plangen_tpu_torch.config import PlanGenModelConfig, TrainConfig
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.ops.remat import policy_name
from plangen_tpu_torch.parallel.mesh import fsdp_ignored
from plangen_tpu_torch.train.loss import mmu_loss, plan_loss, t2i_loss

Batches = Dict[int, Dict[str, torch.Tensor]]


@dataclass
class TrainState:
    model: PlanGenModel  # the masters
    opt: object  # train/optim.py: AdamW, Adafactor or Accumulate
    step: int = 0


def make_loss_fn(
    model_cfg: PlanGenModelConfig,
    train_cfg: TrainConfig,
    pad_id: int,
    flows: Sequence[Tuple[int, str]],  # (flow_id, task_type)
    compute_dtype: torch.dtype = torch.bfloat16,
    trainable_mask: Optional[Dict[str, bool]] = None,
    group=None,
) -> Callable:
    """Build `loss_fn(model, batches) -> (total, loss_dict)` over the fp32
    masters of `model`; under a data `group` (a process group) this rank's
    share of the global-batch losses (`train/loss.py`).

    Batch format per flow (tensors on the model's device):
      uni/t2i: {input_ids [B,L], attn_mask [B,L+N], images [B,H,W,3]}
      mmu:     {input_ids, attn_mask, images, images_seq_mask}
      plan:    {input_ids, attn_mask}

    Loss weighting: per-key `loss_scales[f"{key}_{flow_id}"]`, then
    `plan_lr_scale` on every '*lm*' key. Without `trainable_mask` every
    parameter takes a gradient."""
    flows = tuple(flows)
    scales = dict(train_cfg.loss_scales)
    plan_lr_scale = train_cfg.plan_lr_scale
    use_flash = train_cfg.use_flash_attention
    use_local_edit_loss = train_cfg.use_local_edit_loss
    remat = policy_name(train_cfg.remat_policy) if train_cfg.gradient_checkpointing else False
    kw = dict(use_flash=use_flash, remat=remat, fused_ce=train_cfg.fused_lm_ce, group=group)

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
                    **kw,
                )
            elif task == "mmu":
                ld = mmu_loss(
                    model, b["input_ids"], b["attn_mask"], b["images"].to(compute_dtype),
                    b["images_seq_mask"], pad_id, **kw,
                )
            elif task == "plan":
                ld = plan_loss(model, b["input_ids"], b["attn_mask"], pad_id, **kw)
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
        fsdp = isinstance(model, FSDPModule)  # FSDP2 gathers and casts its own
        ignored = fsdp_ignored(model)
        params = {}
        for name, p in model.named_parameters():
            if fsdp and name not in ignored:
                continue
            if trainable_mask is not None and not trainable_mask[name]:
                p = p.detach()
            params[name] = p.to(compute_dtype) if p.is_floating_point() else p
        return torch.func.functional_call(model, params, (run, batches))

    return loss_fn


def make_train_step(
    model_cfg: PlanGenModelConfig,
    train_cfg: TrainConfig,
    pad_id: int,
    flows: Sequence[Tuple[int, str]],
    compute_dtype: torch.dtype = torch.bfloat16,
    trainable_mask: Optional[Dict[str, bool]] = None,
    group=None,
) -> Callable:
    """Build `train_step(state, batches) -> (state, metrics)`; the state is
    updated in place. metrics: {"loss": total, **loss_dict}, 0-d tensors.

    Under a data `group` each rank's batches are its rows of the global
    batch: the gradients are summed over the group (by FSDP2's
    reduce-scatter, or here by one all-reduce per dtype: every gradient
    without FSDP, those of `fsdp_ignored` with it), as are the metrics, so
    every rank reports the global-batch losses."""
    loss_fn = make_loss_fn(model_cfg, train_cfg, pad_id, flows, compute_dtype,
                           trainable_mask=trainable_mask, group=group)

    def train_step(state: TrainState, batches: Batches):
        model = state.model
        model.zero_grad(set_to_none=True)
        loss, loss_dict = loss_fn(model, batches)
        loss.backward()
        if group is not None:
            sum_gradients(model, group, fsdp_ignored(model)
                          if isinstance(model, FSDPModule) else None)
        state.opt.step({n: p.grad for n, p in model.named_parameters()})
        model.zero_grad(set_to_none=True)
        state.step += 1
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in loss_dict.items()}}
        if group is not None:
            metrics = dict(zip(metrics, sum_over(list(metrics.values()), group)))
        return state, metrics

    return train_step


def sum_over(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The tensors (each a local tensor, or a DTensor's local shard) summed
    over `group`, one all-reduce for each dtype."""
    locals_ = [t.to_local() if isinstance(t, DTensor) else t for t in tensors]
    out = list(locals_)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(locals_):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([locals_[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        for i, part in zip(idx, flat.split([locals_[i].numel() for i in idx])):
            out[i] = part.view_as(locals_[i])
    return out


@torch.no_grad()
def sum_gradients(model: nn.Module, group, names=None) -> None:
    """Sum every gradient (or those of the parameters in `names`) over the
    data group in place (data parallelism without FSDP, or the parameters
    FSDP2 ignores; a TP-split gradient is summed shard by shard)."""
    grads = [p.grad for n, p in model.named_parameters()
             if p.grad is not None and (names is None or n in names)]
    if not grads:
        return
    for g, total in zip(grads, sum_over(grads, group)):
        (g.to_local() if isinstance(g, DTensor) else g).copy_(total)


def init_train_state(model: PlanGenModel, opt,
                     master_dtype: torch.dtype = torch.float32) -> TrainState:
    """The train state over masters in `master_dtype`. The JAX package casts
    its parameters here; in the port the model must already be in that dtype,
    since the optimizer holds its parameters and made its state in their
    dtype (the Trainer builds the model in it)."""
    for name, p in model.named_parameters():
        if p.is_floating_point() and p.dtype != master_dtype:
            raise ValueError(f"{master_dtype} masters required, {name} is {p.dtype}")
    return TrainState(model=model, opt=opt, step=0)
