"""Prefill, the CFG image-token decode loop and the greedy text decode.

Port of `plangen_tpu/runtime/generate.py` (`prefill`,
`generate_image_tokens`, `greedy_decode_text`) in the configuration
`growing_cache=False, paged=True`: one fixed [L, B, S, H, D] cache, rounded
up to a multiple of 128 slots with a zero mask tail, whose live prefix the
prefix decode-attention kernel reads at every step. The JAX package's
`growing_cache=True` computes the same function over a segmented cache, so
both settings map to these loops.

Each of the `num_tokens` steps: gen_head on the last hidden state -> CFG
combine -> fp32 sampling (or teacher forcing) -> the token fed back through
gen_embed + gen_aligner to BOTH rows of its cond/uncond pair -> one decoder
step that writes and attends at position `L + i`. The last step's hidden
state is unused, as in the JAX loop, so a generation makes exactly
`num_tokens * num_layers` decode-attention calls.

With `quantized_cache` the cache is the int8 layout of `runtime/kvcache.py`
(the JAX package's `quantized_cache=True`, which every quantized serving
mode sets): prefill writes quantized rows and attends over them, and each
decode step reads through the int8-cache kernel K1-q8.

`greedy_decode_text` (layout planning, understanding): each step takes the
fp32 `lm_head` logits of the last hidden state, their argmax (the first
maximal index, as `jnp.argmax`), EOS for rows already done, and feeds the
token back through the text embedding to one decoder step at `L + i`. The
output is pre-filled with EOS, and the loop stops once every row has
emitted EOS, as the JAX `while_loop` does: the host reads the all-done
flag, one byte, after every step.

Each step of either loop reads and writes only static buffers in place,
every index on the device: `image_decode_step` over `StepBuffers` (the last
hidden state, the query position `q_pos`, the step index and the [B, N]
token buffer) and `text_decode_step` over `TextStepBuffers` (the same, and
the per-row done flags and the all-done flag). On CPU tensors a loop calls
its step once a token. On CUDA tensors step 0 runs eagerly, one step is
captured in a CUDA graph and the graph is replayed for the later steps
(`runtime/cuda_graph.py`): the counterpart of the JAX package's one jitted
program. A text decode that is done after step 0, or has a budget of 1,
captures nothing. `eager=True` runs the eager loop on the card too, to
compare the two; the pipeline never sets it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from plangen_tpu_torch.config import PlanGenModelConfig
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.ops.sampling import (
    Generators, apply_teacher_forcing, cfg_combine, sample_categorical,
)
from plangen_tpu_torch.runtime.cuda_graph import StepGraph, eager_step
from plangen_tpu_torch.runtime.kvcache import KVCache, init_kv_cache

CACHE_ALIGN = 128  # the prefix kernel reads the cache in 128-slot chunks


def cache_length(prompt_len: int, num_tokens: int) -> int:
    """Cache slots for a prompt plus `num_tokens`, rounded up to 128."""
    return -(-(prompt_len + num_tokens) // CACHE_ALIGN) * CACHE_ALIGN


def prefill(
    model: PlanGenModel,
    inputs_embeds: torch.Tensor,  # [B, L, H]
    attn_mask: torch.Tensor,  # [B, S_max]
    cache: KVCache,
) -> torch.Tensor:
    """Run the prompt through the decoder, filling cache slots [0, L).

    Returns the last position's hidden state [B, H]."""
    L = inputs_embeds.shape[1]
    positions = torch.arange(L, dtype=torch.int32, device=inputs_embeds.device)
    hidden = model.language_model(inputs_embeds, attn_mask, positions, cache)
    return hidden[:, -1]


@dataclass
class StepBuffers:
    """What an image decode step reads and writes in place: the static
    buffers a CUDA graph of the step is captured over."""

    last_hidden: torch.Tensor  # [2B, H]: the hidden state the step's head reads
    q_pos: torch.Tensor  # int32 [1]: the cache slot the step writes, L + i
    step: torch.Tensor  # int64 [1]: i, the column of `tokens` it writes
    tokens: torch.Tensor  # int64 [B, N]


def image_decode_step(
    model: PlanGenModel,
    buffers: StepBuffers,
    mask: torch.Tensor,  # [2B, S] int32 pad mask of the cache
    cache: KVCache,
    cfg_weight: float,
    temperature: float,
    generator: Optional[Generators],
    dtype: torch.dtype,  # of the embeds fed back
    gt_tokens: Optional[torch.Tensor] = None,  # [B, N] forced ids
    regen_mask: Optional[torch.Tensor] = None,  # [B, N] 1 = sample
) -> None:
    """Step i = `buffers.step`: gen_head -> CFG combine -> fp32 sampling (or
    teacher forcing) into column i of `buffers.tokens` -> the token fed back
    through gen_embed + gen_aligner to both rows of its cond/uncond pair ->
    one decoder step at `buffers.q_pos`, whose hidden state becomes
    `buffers.last_hidden`; then `q_pos` and `step` advance by one. Every
    index stays on the device."""
    b = buffers
    combined = cfg_combine(model.image_gen_logits(b.last_hidden), cfg_weight)
    token = sample_categorical(combined, temperature, generator)
    if gt_tokens is not None:
        token = apply_teacher_forcing(token, gt_tokens.index_select(1, b.step)[:, 0],
                                      regen_mask.index_select(1, b.step)[:, 0])
    b.tokens.index_copy_(1, b.step, token[:, None])
    pair_token = token[:, None].expand(-1, 2).reshape(-1)  # [2B], repeat_interleave(2)
    next_embeds = model.gen_img_embeds(pair_token[:, None]).to(dtype)
    hidden = model.language_model(next_embeds, mask, b.q_pos, cache)
    b.last_hidden.copy_(hidden[:, -1])
    b.q_pos.add_(1)
    b.step.add_(1)


def start_image_loop(
    model: PlanGenModel,
    cfg: PlanGenModelConfig,
    cfg_embeds: torch.Tensor,
    attn_mask: torch.Tensor,
    generator: Optional[Generators],
    cfg_weight: float,
    temperature: float,
    gt_tokens: Optional[torch.Tensor],
    regen_mask: Optional[torch.Tensor],
    num_tokens: int,
    quantized_cache: bool,
) -> Tuple[StepBuffers, Callable[[], None], torch.Tensor, KVCache, List[torch.Generator]]:
    """The arguments checked, the cache allocated and prefilled, the step's
    buffers: (buffers, the step as a closure, the zero-tailed mask, the
    cache, every generator the step draws from)."""
    B2, L, _ = cfg_embeds.shape
    device = cfg_embeds.device
    if attn_mask.shape != (B2, L + num_tokens):
        raise ValueError(
            f"attn_mask must be [{B2}, {L + num_tokens}], got "
            f"{tuple(attn_mask.shape)}"
        )
    if (gt_tokens is None) != (regen_mask is None):
        raise ValueError("gt_tokens and regen_mask go together")
    if temperature != 0 and generator is None:
        raise ValueError("sampling at temperature > 0 needs a generator")
    if gt_tokens is not None:
        gt_tokens = torch.as_tensor(gt_tokens, device=device)
        regen_mask = torch.as_tensor(regen_mask, device=device)

    S = cache_length(L, num_tokens)
    mask = torch.as_tensor(attn_mask, device=device).to(torch.int32)
    mask = F.pad(mask, (0, S - mask.shape[1])).contiguous()  # zero tail
    cache = init_kv_cache(cfg.llama, B2, S, dtype=cfg_embeds.dtype, device=device,
                          quantized=quantized_cache)
    buffers = StepBuffers(
        last_hidden=prefill(model, cfg_embeds, mask, cache).clone(
            memory_format=torch.contiguous_format),
        q_pos=torch.full((1,), L, dtype=torch.int32, device=device),
        step=torch.zeros(1, dtype=torch.int64, device=device),
        tokens=torch.zeros((B2 // 2, num_tokens), dtype=torch.int64, device=device),
    )

    def step():
        image_decode_step(model, buffers, mask, cache, cfg_weight, temperature, generator,
                          cfg_embeds.dtype, gt_tokens, regen_mask)

    generators = [] if temperature == 0 else (
        [generator] if isinstance(generator, torch.Generator) else list(generator))
    return buffers, step, mask, cache, generators


@torch.inference_mode()
def generate_image_tokens(
    model: PlanGenModel,
    cfg: PlanGenModelConfig,
    cfg_embeds: torch.Tensor,  # [2B, L, H] interleaved cond/uncond prompt
    attn_mask: torch.Tensor,  # [2B, L + num_tokens] pad mask (image region 1)
    generator: Optional[Generators],  # one for the batch, or one per row
    cfg_weight: float,
    temperature: float,
    gt_tokens: Optional[torch.Tensor] = None,  # [B, num_tokens] forced ids
    regen_mask: Optional[torch.Tensor] = None,  # [B, num_tokens] 1 = sample
    num_tokens: int = 576,
    quantized_cache: bool = False,  # int8 KV cache with fp32 scales
    eager: bool = False,  # on the card, the eager loop instead of the graph
) -> torch.Tensor:
    """Prefill + `num_tokens` KV-cached CFG decode steps; [B, N] int64 ids.

    On CUDA tensors steps 1 .. N-1 replay a CUDA graph of one step, unless
    `eager`; a step that cannot be captured raises."""
    buffers, step, _, _, generators = start_image_loop(
        model, cfg, cfg_embeds, attn_mask, generator, cfg_weight, temperature,
        gt_tokens, regen_mask, num_tokens, quantized_cache)
    if cfg_embeds.device.type == "cuda" and not eager and num_tokens > 1:
        # every generator the step draws from, so each replay draws afresh
        eager_step(step)
        graph = StepGraph(step, generators)
        for _ in range(num_tokens - 1):
            graph.replay()
    else:
        for _ in range(num_tokens):
            step()
    return buffers.tokens


def text_decode_steps(tokens, eos_id: int) -> int:
    """Decoder steps `greedy_decode_text` runs for its output `tokens`
    [B, N]: up to the column where the last row first emits `eos_id`, or
    all N if a row never does."""
    tokens = torch.as_tensor(tokens)
    hit = tokens == eos_id
    if not bool(hit.any(dim=1).all()):
        return tokens.shape[1]
    return int(hit.int().argmax(dim=1).max()) + 1


@dataclass
class TextStepBuffers:
    """What a text decode step reads and writes in place: the static
    buffers a CUDA graph of the step is captured over."""

    last_hidden: torch.Tensor  # [B, H]: the hidden state `lm_head` reads
    q_pos: torch.Tensor  # int32 [1]: the cache slot the step writes, L + i
    step: torch.Tensor  # int64 [1]: i, the column of `tokens` it writes
    tokens: torch.Tensor  # int32 [B, budget], pre-filled with EOS
    done: torch.Tensor  # bool [B]: the row has emitted EOS
    all_done: torch.Tensor  # bool []: every row has, the byte the host reads


def text_decode_step(
    model: PlanGenModel,
    buffers: TextStepBuffers,
    mask: torch.Tensor,  # [B, S] int32 pad mask of the cache
    cache: KVCache,
    eos_id: int,
    dtype: torch.dtype,  # of the embeds fed back
) -> None:
    """Step i = `buffers.step`: fp32 `lm_head` logits -> their first argmax
    -> EOS for the rows already done, into column i of `buffers.tokens` ->
    the done flags -> the token fed back through the text embedding to one
    decoder step at `buffers.q_pos`, whose hidden state becomes
    `buffers.last_hidden`; then `q_pos` and `step` advance by one. Every
    index stays on the device."""
    b = buffers
    lm = model.language_model
    token = lm.logits(b.last_hidden).argmax(dim=-1).to(torch.int32)
    token = torch.where(b.done, eos_id, token)
    b.done.logical_or_(token == eos_id)
    b.all_done.copy_(b.done.all())
    b.tokens.index_copy_(1, b.step, token[:, None])
    next_embeds = model.embed_text(token[:, None]).to(dtype)
    b.last_hidden.copy_(lm(next_embeds, mask, b.q_pos, cache)[:, -1])
    b.q_pos.add_(1)
    b.step.add_(1)


@torch.inference_mode()
def greedy_decode_text(
    model: PlanGenModel,
    cfg: PlanGenModelConfig,
    inputs_embeds: torch.Tensor,  # [B, L, H]
    attn_mask: torch.Tensor,  # [B, L + max_new_tokens] pad mask (budget 1)
    eos_id: int,
    max_new_tokens: int = 512,
    quantized_cache: bool = False,  # int8 KV cache with fp32 scales
    eager: bool = False,  # on the card, the eager loop instead of the graph
) -> torch.Tensor:
    """Greedy KV-cached text decode; [B, max_new_tokens] int32 ids, EOS
    after each row's first EOS. It stops once every row has emitted EOS.

    On CUDA tensors the steps after step 0 replay a CUDA graph of one step,
    unless `eager`; a step that cannot be captured raises."""
    B, L, _ = inputs_embeds.shape
    device = inputs_embeds.device
    if attn_mask.shape != (B, L + max_new_tokens):
        raise ValueError(
            f"attn_mask must be [{B}, {L + max_new_tokens}], got "
            f"{tuple(attn_mask.shape)}"
        )
    S = cache_length(L, max_new_tokens)
    mask = torch.as_tensor(attn_mask, device=device).to(torch.int32)
    mask = F.pad(mask, (0, S - mask.shape[1])).contiguous()  # zero tail
    cache = init_kv_cache(cfg.llama, B, S, dtype=inputs_embeds.dtype, device=device,
                          quantized=quantized_cache)
    buffers = TextStepBuffers(
        last_hidden=prefill(model, inputs_embeds, mask, cache).clone(
            memory_format=torch.contiguous_format),
        q_pos=torch.full((1,), L, dtype=torch.int32, device=device),
        step=torch.zeros(1, dtype=torch.int64, device=device),
        tokens=torch.full((B, max_new_tokens), eos_id, dtype=torch.int32, device=device),
        done=torch.zeros(B, dtype=torch.bool, device=device),
        all_done=torch.zeros((), dtype=torch.bool, device=device),
    )

    def step():
        text_decode_step(model, buffers, mask, cache, eos_id, inputs_embeds.dtype)

    on_graph = device.type == "cuda" and not eager and max_new_tokens > 1
    graph = None
    for i in range(max_new_tokens):
        if i and bool(buffers.all_done):
            break
        if not on_graph:
            step()
        elif i == 0:
            eager_step(step)
        else:
            if graph is None:
                graph = StepGraph(step)
            graph.replay()
    return buffers.tokens
