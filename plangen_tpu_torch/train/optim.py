"""Optimizer construction: AdamW + clip + trainable-subset masking.

Port of `plangen_tpu/train/optim.py`. The recipe (cfg/base.py:53-60): AdamW
lr 5e-5, betas (0.9, 0.999), eps 1e-8, weight decay 0.01, gradient clip 1.0,
constant schedule with optional warmup. Tuning modes freeze top-level
modules by name, as the JAX package's path predicates do:

  all    — everything trainable
  lm     — language_model only
  stage1 — aligner + gen_aligner + gen_head
  stage2 — all but vision_model and gen_vision_model
  stage3 — all but gen_vision_model        (the released recipe)

`AdamW.step` computes what the JAX package's
`masked(chain(clip_by_global_norm, adamw))` + `masked(set_to_zero)` computes
in optax: the global norm covers the trainable set only, frozen parameters
get no update and no decay, and the moments exist for trainable parameters
only. Adafactor, gradient accumulation and the LoRA modes are not ported and
raise `NotImplementedError`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, Optional

import torch
from torch import nn

from plangen_tpu_torch.config import OptimConfig

TUNING_MODES: Dict[str, Callable[[str], bool]] = {
    "all": lambda p: True,
    "lm": lambda p: p.startswith("language_model"),
    "stage1": lambda p: p.startswith(("aligner", "gen_aligner", "gen_head")),
    "stage2": lambda p: not p.startswith(("vision_model", "gen_vision_model")),
    "stage3": lambda p: not p.startswith("gen_vision_model"),
}
_NOT_PORTED_MODES = ("lora", "lora_tokens")


def trainable_mask(model: nn.Module, tuning_mode: str) -> Dict[str, bool]:
    """{parameter name: trainable} under the given tuning mode."""
    if tuning_mode in _NOT_PORTED_MODES:
        raise NotImplementedError(f"tuning_mode {tuning_mode!r} (LoRA) is not ported")
    if tuning_mode not in TUNING_MODES:
        raise ValueError(
            f"unknown tuning_mode {tuning_mode!r}; options: {sorted(TUNING_MODES)}")
    pred = TUNING_MODES[tuning_mode]
    return {name: pred(name) for name, _ in model.named_parameters()}


def count_params(model: nn.Module, mask: Optional[Dict[str, bool]] = None) -> Dict[str, int]:
    """Trainable/frozen parameter counts."""
    sizes = {name: p.numel() for name, p in model.named_parameters()}
    total = sum(sizes.values())
    if mask is None:
        return {"total": total, "trainable": total}
    return {"total": total, "trainable": sum(s for n, s in sizes.items() if mask[n])}


def make_lr_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """step -> learning rate, as the optax schedules the JAX package builds."""
    lr, warmup = cfg.learning_rate, cfg.lr_warmup_steps

    def linear(step: int) -> float:  # optax.linear_schedule(0, lr, warmup)
        return lr * min(max(step, 0), warmup) / warmup

    if cfg.lr_scheduler == "constant":
        return linear if warmup > 0 else (lambda step: lr)
    if cfg.lr_scheduler == "cosine":
        decay = 1_000_000 - warmup  # warmup_cosine_decay_schedule(0, lr, w, 1e6)

        def cosine(step: int) -> float:
            if step < warmup:
                return linear(step)
            t = min(step - warmup, decay)
            return lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))

        return cosine
    raise ValueError(f"unknown lr_scheduler {cfg.lr_scheduler}")


class AdamW:
    """optax's clip_by_global_norm + adamw over the trainable parameters of
    a model whose fp32 masters it updates in place."""

    def __init__(self, cfg: OptimConfig, model: nn.Module, mask: Dict[str, bool]):
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg)
        self.params = {n: p for n, p in model.named_parameters() if mask[n]}
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, Optional[torch.Tensor]]) -> None:
        """One update from {name: gradient} (None = zero gradient). The
        gradients are clipped in place."""
        for _, p, u in self.updates(grads):
            p.add_(u)  # apply_updates

    @torch.no_grad()
    def updates(self, grads: Dict[str, Optional[torch.Tensor]]) -> Iterator:
        """Advance the moments and yield (name, parameter, update) for each
        trainable parameter; `step` adds each update to its parameter."""
        cfg = self.cfg
        g = {n: grads.get(n) if grads.get(n) is not None else torch.zeros_like(p)
             for n, p in self.params.items()}
        # clip_by_global_norm: t / norm * max_norm unless norm < max_norm
        norm = torch.sqrt(sum(torch.sum(t * t) for t in g.values()))
        if not bool(norm < cfg.max_grad_norm):
            for t in g.values():
                t.div_(norm).mul_(cfg.max_grad_norm)
        # scale_by_adam, with the bias corrections in fp32 as optax computes them
        t = self.count + 1
        one = torch.ones((), dtype=torch.float32)
        bc1 = float(one - torch.tensor(cfg.adam_beta1, dtype=torch.float32) ** t)
        bc2 = float(one - torch.tensor(cfg.adam_beta2, dtype=torch.float32) ** t)
        lr = self.schedule(self.count)
        for n, p in self.params.items():
            mu, nu = self.mu[n], self.nu[n]
            mu.mul_(cfg.adam_beta1).add_((1 - cfg.adam_beta1) * g[n])
            nu.mul_(cfg.adam_beta2).add_((1 - cfg.adam_beta2) * (g[n] * g[n]))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.adam_epsilon)
            u = u + cfg.adam_weight_decay * p  # add_decayed_weights
            yield n, p, u * -lr  # scale_by_learning_rate
        self.count = t

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        for n in self.params:
            self.mu[n].copy_(sd["mu"][n])
            self.nu[n].copy_(sd["nu"][n])


def make_optimizer(cfg: OptimConfig, model: nn.Module, tuning_mode: str = "stage3"):
    """Returns (optimizer, trainable mask {name: bool})."""
    mask = trainable_mask(model, tuning_mode)
    if cfg.optimizer == "adafactor":
        raise NotImplementedError("optimizer 'adafactor' is not ported")
    if cfg.optimizer != "adamw":
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}; options: adamw, adafactor")
    if cfg.gradient_accumulation_steps > 1:
        raise NotImplementedError("gradient_accumulation_steps > 1 is not ported")
    return AdamW(cfg, model, mask), mask
