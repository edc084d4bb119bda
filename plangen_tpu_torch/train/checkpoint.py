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
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional

import torch
from torch import nn

from plangen_tpu_torch.train.step import TrainState

_FILE = "state.pt"


class PlanGenCheckpointer:
    def __init__(self, directory: str, total_limit: int = 3):
        self.directory = os.path.abspath(directory)
        self.total_limit = total_limit
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
        final = os.path.join(self.directory, str(step))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"model": state.model.state_dict(), "optimizer": state.opt.state_dict(),
                    "step": state.step}, os.path.join(tmp, _FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.total_limit]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, state: TrainState, step: Optional[int] = None) -> Optional[TrainState]:
        """Load a saved step into `state` (in place); None when no
        checkpoint exists (a fresh start)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        payload = torch.load(os.path.join(self.directory, str(step), _FILE),
                             map_location="cpu", weights_only=True)
        state.model.load_state_dict(payload["model"], strict=True)
        state.opt.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state

    def save_params_only(self, step: int, model: nn.Module,
                         mask: Optional[Dict[str, bool]] = None) -> str:
        """Save the model's weights (with `mask`, {name: trainable}, only
        the masked-in ones) as a standalone artifact; returns its path."""
        from plangen_tpu_torch.convert.params import save_params

        return save_params(model, os.path.join(self.directory, f"params-{step}"), mask)
