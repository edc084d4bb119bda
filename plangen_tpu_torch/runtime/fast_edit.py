"""Fast teacher-forced editing: the frozen chunks as one forward each.

Port of `plangen_tpu/runtime/fast_edit.py`. In editing and removal most
image tokens are forced to the VQ codes of the image (regen mask 0). The
standard loop (`runtime/generate.py::generate_image_tokens`) still runs all
576 steps. A forced token does not depend on the model's output, so a
16-token chunk that is forced in every row can be run like a prefill: one
Q = 16 forward at positions `L + start + arange(16)` through the cache
branch of `models/llama.py` (the plain prefill attention, or its int8-cache
counterpart), which writes the chunk's K/V and gives the hidden state that
enters the next position. A chunk with any sampled position (a mixed chunk)
runs `image_decode_step` position by position.

`frozen_chunk_schedule` and `canonicalize_schedule` are copies of the JAX
functions (numpy). The JAX pipeline canonicalizes the schedule because each
distinct schedule is a TPU compile; the port compiles nothing per schedule,
so its pipeline passes the raw one. Both give the same tokens.

Streams. The sampler's generators are sequential: every step's draw moves
each generator by one `exponential_` over its rows' [rows, V] noise
(`ops/sampling.py::draw`). At each position of a frozen chunk
`ops/sampling.py::skip_categorical` makes the same calls, so the next mixed
position draws exactly what it draws in the full loop.

On CUDA tensors the mixed steps are the CUDA graph of the standard loop:
the first mixed step runs eagerly on the capture stream
(`cuda_graph.eager_step`), the second is captured (`cuda_graph.StepGraph`,
with the generators registered) and replayed, and each later mixed step is
a replay. The frozen chunks run eagerly between replays on the current
stream, writing the step's static buffers in place (`last_hidden`, `q_pos`,
`step` and the chunk's columns of `tokens`), so the next replay reads them
as it would read its own step's. `eager=True` runs every mixed step eagerly
on the card, to compare the two.

Exactness. The forced tokens and the streams are exactly the full loop's.
The frozen chunk's forward computes the same function as its 16 decode
steps, but not in the same order of floating-point operations (Q = 16
matmuls and the plain attention instead of 16 single-row steps through the
decode kernel), so its K/V and hidden states may differ from the loop's in
their last bits, and a later sampled token may then differ where two
candidates nearly tie.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from plangen_tpu_torch.config import PlanGenModelConfig
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.ops.sampling import Generators, skip_categorical
from plangen_tpu_torch.runtime.cuda_graph import StepGraph, eager_step
from plangen_tpu_torch.runtime.generate import start_image_loop

CHUNK = 16


def frozen_chunk_schedule(regen_mask: np.ndarray, chunk: int = CHUNK) -> Tuple[bool, ...]:
    """Host-side static schedule: True where a chunk is fully frozen for
    EVERY batch row. regen_mask: [B, N] (1 = sample)."""
    m = np.asarray(regen_mask)
    B, N = m.shape
    pad = (-N) % chunk
    if pad:
        m = np.concatenate([m, np.ones((B, pad), dtype=m.dtype)], axis=1)
    chunks = m.reshape(B, -1, chunk)
    return tuple(bool(x) for x in (chunks.sum(axis=(0, 2)) == 0))


def canonicalize_schedule(
    schedule: Tuple[bool, ...], granularity: int = 8
) -> Tuple[bool, ...]:
    """Collapse a schedule to `frozen prefix + mixed middle + frozen suffix`
    with boundaries rounded to `granularity` chunks. Marking a frozen chunk
    as mixed keeps the tokens (the mixed steps force the same codes), so the
    result gives the same tokens as `schedule`; the JAX package uses it to
    bound its compiles."""
    n = len(schedule)
    mixed = [i for i, frozen in enumerate(schedule) if not frozen]
    if not mixed:
        return (True,) * n  # fully frozen: single canonical program
    first = (mixed[0] // granularity) * granularity
    last = min(n, -(-(mixed[-1] + 1) // granularity) * granularity)
    return tuple(i < first or i >= last for i in range(n))


@torch.inference_mode()
def generate_image_tokens_fast_edit(
    model: PlanGenModel,
    cfg: PlanGenModelConfig,
    cfg_embeds: torch.Tensor,  # [2B, L, H] interleaved cond/uncond prompt
    attn_mask: torch.Tensor,  # [2B, L + num_tokens] pad mask (image region 1)
    generator: Optional[Generators],  # one for the batch, or one per row
    cfg_weight: float,
    temperature: float,
    gt_tokens: torch.Tensor,  # [B, num_tokens] forced ids
    regen_mask: torch.Tensor,  # [B, num_tokens] 1 = sample
    num_tokens: int = 576,
    schedule: Tuple[bool, ...] = (),  # from frozen_chunk_schedule
    quantized_cache: bool = False,  # int8 KV cache with fp32 scales
    eager: bool = False,  # on the card, the mixed steps eagerly, not the graph
) -> torch.Tensor:
    """Teacher-forced generation with each frozen chunk one forward; [B, N]
    int64 ids, the standard loop's tokens (module docstring)."""
    if len(schedule) != -(-num_tokens // CHUNK):
        raise ValueError(f"a schedule of {len(schedule)} chunks for {num_tokens} tokens")
    buffers, step, mask, cache, generators = start_image_loop(
        model, cfg, cfg_embeds, attn_mask, generator, cfg_weight, temperature,
        gt_tokens, regen_mask, num_tokens, quantized_cache)
    gt_tokens = torch.as_tensor(gt_tokens, device=cfg_embeds.device)
    B2, L, _ = cfg_embeds.shape
    device = cfg_embeds.device
    lm = model.language_model

    def frozen_chunk(start: int, size: int) -> None:
        chunk = gt_tokens[:, start:start + size]
        pair = chunk.repeat_interleave(2, dim=0)  # [2B, size], as jnp.repeat
        embeds = model.gen_img_embeds(pair).to(cfg_embeds.dtype)
        positions = torch.arange(L + start, L + start + size, dtype=torch.int32,
                                 device=device)
        buffers.last_hidden.copy_(lm(embeds, mask, positions, cache)[:, -1])
        buffers.tokens[:, start:start + size] = chunk
        buffers.q_pos.add_(size)
        buffers.step.add_(size)
        for _ in range(size):
            skip_categorical(B2 // 2, cfg.image_token_size, temperature, generator, device)

    on_graph = device.type == "cuda" and not eager
    stepped, graph = False, None
    for ci, frozen in enumerate(schedule):
        start = ci * CHUNK
        size = min(CHUNK, num_tokens - start)
        if frozen:
            frozen_chunk(start, size)
            continue
        for _ in range(size):
            if not on_graph:
                step()
            elif not stepped:
                eager_step(step)
            else:
                if graph is None:
                    graph = StepGraph(step, generators)
                graph.replay()
            stepped = True
    return buffers.tokens
