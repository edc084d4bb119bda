"""Checkpointing with FIFO rotation and latest-resume.

Port of `plangen_tpu/train/checkpoint.py` (orbax there, `torch.save` here):
`save` writes the full train state (model state dict with any LoRA
adapters, in the master dtype; the optimizer's state: AdamW's moments or
Adafactor's statistics, its count, and under gradient accumulation the
running mean and the micro-step; the step) under
`<directory>/<step>/state.pt`, keeps the newest `total_limit` steps and
deletes older ones; `restore` loads the newest step
(or a given one) into a train state, or returns None when there is none.
`save_params_only` writes the model alone (or its masked part) as the
port's weight artifact (`convert/params.py`) under
`<directory>/params-<step>`, which `params_path` loads.

With a process `group` (a Trainer on a mesh) every rank takes part and the
checkpoint is the same `state.pt` a one-device run writes: each sharded
tensor (a DTensor of TP or FSDP2: parameters, AdamW moments, the
accumulated gradient; on a data x model mesh each over one of its dims) is
gathered whole, tensor by tensor, to the CPU of rank 0, which alone writes,
then all ranks wait for it. `restore` loads such a file into any mesh, or
none: each rank takes its shard of every tensor its live state holds
sharded.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from plangen_tpu_torch.parallel.mesh import distribute_like, full_tensor
from plangen_tpu_torch.train.step import TrainState

_FILE = "state.pt"


def _gathered(tree, lead: bool):
    """The state with every DTensor gathered whole (a collective: every
    rank calls it), on the CPU of the lead rank; None elsewhere."""
    if isinstance(tree, dict):
        return {k: _gathered(v, lead) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        full = full_tensor(tree)
        return full.cpu() if lead else None
    return tree.cpu() if lead and isinstance(tree, torch.Tensor) else tree


def _sharded_like(live, saved):
    """`saved` (whole tensors) with each tensor that `live` holds as a
    DTensor placed as it is (`distribute_like`: each rank cuts its shard)."""
    if isinstance(saved, dict):
        live = live if isinstance(live, dict) else {}
        return {k: _sharded_like(live.get(k), v) for k, v in saved.items()}
    if isinstance(live, DTensor):
        return distribute_like(saved, live)
    return saved


class PlanGenCheckpointer:
    def __init__(self, directory: str, total_limit: int = 3, group=None):
        self.directory = os.path.abspath(directory)
        self.total_limit = total_limit
        self.group = group  # the ranks that share the directory; its rank 0 writes
        self.lead = group is None or dist.get_rank(group) == 0
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(
            int(d) for d in os.listdir(self.directory)
            if d.isdigit() and os.path.isfile(os.path.join(self.directory, d, _FILE))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> None:
        """Write step `step` (replacing one of that number), then drop the
        oldest steps beyond `total_limit`."""
        payload = {"model": state.model.state_dict(), "optimizer": state.opt.state_dict(),
                   "step": state.step}
        if self.group is not None:
            payload = _gathered(payload, self.lead)
        if self.lead:
            final = os.path.join(self.directory, str(step))
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(payload, os.path.join(tmp, _FILE))
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for old in self.all_steps()[:-self.total_limit]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        if self.group is not None:
            dist.barrier(group=self.group)

    def restore(self, state: TrainState, step: Optional[int] = None) -> Optional[TrainState]:
        """Load a saved step into `state` (in place); None when no
        checkpoint exists (a fresh start)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        payload = torch.load(os.path.join(self.directory, str(step), _FILE),
                             map_location="cpu", weights_only=True)
        state.model.load_state_dict(_sharded_like(state.model.state_dict(), payload["model"]),
                                    strict=True)
        state.opt.load_state_dict(_sharded_like(state.opt.state_dict(), payload["optimizer"]))
        state.step = int(payload["step"])
        return state

    def save_params_only(self, step: int, model: nn.Module,
                         mask: Optional[Dict[str, bool]] = None) -> str:
        """Save the model's weights (with `mask`, {name: trainable}, only
        the masked-in ones) as a standalone artifact; returns its path."""
        from plangen_tpu_torch.convert.params import save_params

        return save_params(model, os.path.join(self.directory, f"params-{step}"), mask)
