"""Sampling primitives for the image-token decode loop.

Port of `plangen_tpu/ops/sampling.py`. CFG combine over interleaved
even (cond) / odd (uncond) rows, fp32 temperature sampling (temperature 0 is
argmax) and teacher forcing.

Randomness comes from `torch.Generator`s passed in, never from global state:
one generator for the whole batch, or one per row. With one per row, each
row draws from its own generator once per step, so a row's stream depends
only on its seed and the step, not on what else is in the batch. The torch
and JAX streams differ, so sampled runs are compared at the level of
probabilities; greedy and teacher-forced runs are token-exact.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

Generators = Union[torch.Generator, Sequence[torch.Generator]]


def cfg_combine(logits: torch.Tensor, cfg_weight: float) -> torch.Tensor:
    """[2B, V] cond/uncond interleaved -> [B, V] fp32 `uncond + w (cond - uncond)`."""
    logits = logits.float()
    cond, uncond = logits[0::2], logits[1::2]
    return uncond + cfg_weight * (cond - uncond)


def sample_categorical(
    logits: torch.Tensor,  # [B, V], already CFG-combined
    temperature: float,
    generator: Generators,
) -> torch.Tensor:
    """Draw from softmax(logits / temperature) in fp32; [B] int64 ids.

    `generator` is one generator for the batch or a sequence with one per
    row. temperature == 0 is argmax and draws nothing."""
    logits = logits.float()
    if temperature == 0:
        return logits.argmax(dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    if isinstance(generator, torch.Generator):
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    if len(generator) != probs.shape[0]:
        raise ValueError(
            f"{len(generator)} generators for {probs.shape[0]} rows"
        )
    return torch.cat([
        torch.multinomial(row[None], 1, generator=g)[:, 0]
        for row, g in zip(probs, generator)
    ])


def apply_teacher_forcing(
    sampled: torch.Tensor,  # [B]
    gt_tokens: torch.Tensor,  # [B] ground-truth VQ ids at this step
    regen_mask: torch.Tensor,  # [B] 1 = keep the sample, 0 = ground truth
) -> torch.Tensor:
    return torch.where(regen_mask > 0, sampled, gt_tokens.to(sampled.dtype))
