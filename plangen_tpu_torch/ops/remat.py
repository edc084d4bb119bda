"""Rematerialization policies for the training forwards.

Port of `plangen_tpu/ops/remat.py`. `remat_call(module, remat, *args)` runs
one LLaMA layer or SigLIP block under `torch.utils.checkpoint` (the
non-reentrant form), where the JAX package wraps its layer-scan body in
`jax.checkpoint`:

  full          save the layer's inputs only, recompute the whole layer
                in the backward
  dots          also save the output of every matmul (`dots_saveable`):
                the weight products and the batched attention products of
                the plain attention path
  dots_no_batch save the outputs of the weight matmuls only
                (`dots_with_no_batch_dims_saveable`: x [B, T, H] @ W has no
                batch dimension, the attention's [B, H, ...] products do)

The module's parameters reach the checkpointed function as an argument and
go back in through `torch.func.functional_call` at the recompute: the train
step swaps the compute copy into the model only for the forward, so a
recompute that read the module's attributes would see the masters. Of an
FSDP2 unit (`parallel/mesh.py`) only the parameters FSDP2 ignores (the
TP-split ones on a data x model mesh and those JAX's `fsdp_min_size` rule
keeps whole, `unit.fsdp_ignored`) go in so: its own hooks gather and cast
the others at the forward and at the recompute.

The flash-attention kernel (`ops/flash_attention.py`) is an
`autograd.Function` around an extension call, which no policy can save: its
forward runs again in every recompute.
"""

from __future__ import annotations

import functools
from typing import Union

import torch
from torch import nn
from torch.distributed.fsdp import FSDPModule
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

Remat = Union[bool, str]  # False | True ("full") | policy name

_aten = torch.ops.aten
_WEIGHT_DOTS = frozenset({_aten.mm.default, _aten.addmm.default})
_BATCHED_DOTS = frozenset({_aten.bmm.default, _aten.baddbmm.default})
POLICIES = {
    "full": None,
    "dots": _WEIGHT_DOTS | _BATCHED_DOTS,
    "dots_no_batch": _WEIGHT_DOTS,
}


def policy_name(remat: Remat) -> str:
    """The policy a truthy `remat` names; unknown names raise ValueError."""
    name = remat if isinstance(remat, str) else "full"
    if name not in POLICIES:
        raise ValueError(f"unknown remat policy {name!r}; options: {sorted(POLICIES)}")
    return name


def _functional(module: nn.Module, params, *args):
    return torch.func.functional_call(module, params, args)


def remat_call(module: nn.Module, remat: Remat, *args):
    """`module(*args)`, rematerialized in the backward as `remat` says
    (False: a plain call)."""
    if not remat:
        return module(*args)
    saved = POLICIES[policy_name(remat)]
    kwargs = {}
    if saved is not None:
        kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 sorted(saved, key=str))
    params = dict(module.named_parameters())
    if isinstance(module, FSDPModule):
        # FSDP2 all-gathers the parameters it manages in its own pre-forward
        # hook, at the forward and again at the recompute
        ignored = getattr(module, "fsdp_ignored", frozenset())
        params = {n: p for n, p in params.items() if n in ignored}
    return checkpoint(_functional, module, params, *args, use_reentrant=False, **kwargs)
