"""Metrics logging: JSONL + stdout, optional TensorBoard.

A copy of `plangen_tpu/train/metrics.py` (which imports no jax; the copy
keeps the port's training package self-contained).

Replaces the reference's `accelerator.log` -> tensorboard/wandb plumbing
(train.py:212-215, cfg/base.py:48). JSONL is the primary artifact (grep-able,
no deps); TensorBoard event files are written when torch.utils.tensorboard is
importable (torch is a baked-in dep).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, output_dir: str, use_tensorboard: bool = True):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(output_dir, "tb"))
            except Exception:
                self._tb = None

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": step, "ts": time.time(), **metrics}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        parts = " ".join(
            f"{k}={v:.4g}" for k, v in metrics.items() if isinstance(v, (int, float))
        )
        print(f"[step {step}] {parts}", flush=True)
        if self._tb is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)

    def close(self):
        if self._tb is not None:
            self._tb.close()
