"""Checkpointing with FIFO rotation and latest-resume.

Port of `plangen_tpu/train/checkpoint.py` (orbax there, `torch.save` here):
`save` writes the full train state (model state dict, optimizer moments and
count, step) under `<directory>/<step>/state.pt`, keeps the newest
`total_limit` steps and deletes older ones; `restore` loads the newest step
(or a given one) into a train state, or returns None when there is none.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional

import torch

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
