"""Self-speculative image-token decoding (B = 1 with its CFG pair, opt-in).

Port of `plangen_tpu/runtime/speculative.py`. Each round drafts `draft_len`
tokens d with the FIRST `draft_layers` decoder layers K (an early exit
through the shared final norm and gen_head: `models/llama.py`'s
`layers_limit`, no extra weights), then verifies them with ONE full-stack
forward at Q = d + 1 and keeps a prefix by exact speculative sampling
(Leviathan et al.): draft token x is kept when `u * q(x) < p(x)`, the first
rejection resamples from normalize(max(p - q, 0)), and a round whose drafts
all pass draws a bonus token from the verify's last distribution. The
output is distributed as plain sampling from the full model. Two
identities pin the mechanism down without trained weights:

  * a full-depth draft (K = num_layers): q equals p, every draft passes,
    and the tokens equal `runtime/generate.py::generate_image_tokens`'s,
    since the drafts and bonus tokens draw from the request's generator in
    token order, as the base loop draws;
  * greedy (temperature 0): acceptance is argmax agreement, so the tokens
    equal base greedy for any draft.

Whether it is faster depends on how often the draft agrees, a property of
trained weights; random weights almost never agree.

Cache: one fixed [L, 2, S, H, D] bf16 cache of S = L + num_tokens + d + 1
slots (rounded up to 128 for the prefix kernel; the last round may
overshoot, and its tail is cut off), the mask's tail zero. A draft step
(Q = 1) writes layers [0, K) at its position and reads through the prefix
kernel K1 in each of its K layers; the verify rewrites every layer at
positions L - 1 + n .. L - 1 + n + d and attends over the whole cache with
the causal + pad bias, as prefill does. Slots of rejected drafts hold stale
rows at positions later queries either mask causally or rewrite first.

Randomness: three streams. Drafts and bonus tokens draw from the request's
generator through `ops/sampling.py::draw`; the accept uniforms and the
residual draws come from generators of their own, seeded by
`ops/sampling.py::mix_seed` from the request generator's seed and the
stream numbers of the JAX package's `fold_in(rng, 1 << 20)` and
`fold_in(rng, 2 << 20)`. Every round draws its bonus and its residual
token, whichever it keeps, so the streams do not depend on the data.

A round reads and writes only static buffers (`RoundBuffers`: n, the
previous token, the draft tokens, q [d, V] fp32 and the token buffer), every
index on the device. On CPU tensors the rounds run eagerly. On the card the
first round runs eagerly on the capture stream, one round is captured in a
CUDA graph (`runtime/cuda_graph.py`) and replayed: the counterpart of the
JAX `while_loop`. Between rounds the host reads n and stops at
`n >= num_tokens`. `eager=True` keeps the eager round loop on the card;
a round that cannot be captured raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from plangen_tpu_torch.config import PlanGenModelConfig
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.ops.sampling import (
    Generators, cfg_combine, draw, mix_seed, sample_categorical,
)
from plangen_tpu_torch.runtime.cuda_graph import StepGraph, eager_step
from plangen_tpu_torch.runtime.generate import cache_length, prefill
from plangen_tpu_torch.runtime.kvcache import KVCache, init_kv_cache

ACCEPT_STREAM = 1 << 20  # fold_in(rng, 1 << 20): the accept uniforms
RESIDUAL_STREAM = 2 << 20  # fold_in(rng, 2 << 20): the residual draws


class SpecResult(NamedTuple):
    tokens: torch.Tensor  # [1, num_tokens] int64
    rounds: int  # verify rounds run (num_tokens / rounds: tokens a round)


@dataclass
class RoundBuffers:
    """What a round reads and writes in place: the static buffers a CUDA
    graph of the round is captured over."""

    n: torch.Tensor  # int64 [1]: tokens final so far; the round's first index
    prev: torch.Tensor  # int64 [1]: token n - 1, fed to the first draft step
    draft: torch.Tensor  # int64 [d]
    q: torch.Tensor  # fp32 [d, V]: the draft's distributions
    tokens: torch.Tensor  # int64 [num_tokens + d + 1]


@dataclass
class RoundGenerators:
    draft: torch.Generator  # the request's: drafts and bonus tokens
    accept: torch.Generator
    residual: torch.Generator


def stream_generator(generator: torch.Generator, stream: int) -> torch.Generator:
    """A generator on `generator`'s device seeded from its seed and `stream`."""
    g = torch.Generator(device=generator.device)
    g.manual_seed(mix_seed(generator.initial_seed(), stream))
    return g


def probs(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """The sampling distribution in fp32 over the last axis, with the JAX
    decoder's `max(T, 1e-6)` clamp (greedy compares argmaxes)."""
    return torch.softmax(logits.float() / max(temperature, 1e-6), dim=-1)


def accept_length(p: torch.Tensor, q: torch.Tensor, draft: torch.Tensor,
                  u: Optional[torch.Tensor], greedy: bool) -> torch.Tensor:
    """a, the drafts kept: the index of the first rejection, d when every
    draft passes (0-d int64). p [d + 1, V] and q [d, V] are the verify's and
    the draft's distributions, u [d] the accept uniforms (unused when
    greedy). Sampled: draft x passes when `u * q(x) < p(x)`; greedy: when it
    is p's argmax."""
    d = draft.shape[0]
    if greedy:
        ok = p[:d].argmax(dim=-1) == draft
    else:
        at = draft[:, None]
        ok = u * q.gather(1, at)[:, 0] < p[:d].gather(1, at)[:, 0]
    return torch.cumprod(ok.to(torch.int64), 0).sum()


def residual(p: torch.Tensor, q: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """normalize(max(p_a - q_a, 0)) [V], or p_a where that sums to 0 (q_a is
    q's last row when a == d, where the residual is not drawn from)."""
    d = q.shape[0]
    p_a = p.index_select(0, a.reshape(1))[0]
    r = (p_a - q.index_select(0, a.clamp(max=d - 1).reshape(1))[0]).clamp(min=0)
    total = r.sum()
    return torch.where(total > 0, r / total, p_a)


def next_tokens(draft: torch.Tensor, a: torch.Tensor, extra: torch.Tensor) -> torch.Tensor:
    """The round's d + 1 candidate tokens for indices n .. n + d: the kept
    drafts, then `extra` (the bonus or the resample) at a; the slots after
    a hold junk (draft or extra values) that later rounds overwrite."""
    d = draft.shape[0]
    idx = torch.arange(d + 1, device=draft.device)
    padded = torch.cat([draft, extra.reshape(1)])
    cand = torch.where(idx < a, padded, extra)
    return torch.where(idx <= a, cand, padded)


def speculative_round(
    model: PlanGenModel,
    b: RoundBuffers,
    mask: torch.Tensor,  # [2, S] int32 pad mask of the cache
    cache: KVCache,
    prompt_len: int,
    cfg_weight: float,
    temperature: float,
    draft_layers: int,
    gens: Optional[RoundGenerators],  # None when greedy
    dtype: torch.dtype,  # of the embeds fed back
) -> None:
    """One round over `b` in place: d draft steps at positions
    L - 1 + n + j, the verify at Q = d + 1, the accept / resample, the
    candidates written at n, then n advances by a + 1."""
    greedy = temperature == 0
    d = b.draft.shape[0]
    lm = model.language_model
    n32 = b.n.to(torch.int32)
    prev = b.prev
    for j in range(d):
        embeds = model.gen_img_embeds(prev.view(1, 1).expand(2, 1)).to(dtype)
        hidden = lm(embeds, mask, n32 + (prompt_len - 1 + j), cache,
                    layers_limit=draft_layers)
        q_logits = cfg_combine(model.image_gen_logits(hidden[:, -1]), cfg_weight)  # [1, V]
        q = probs(q_logits, temperature)
        prev = q_logits.argmax(dim=-1) if greedy else draw(q, gens.draft)
        b.q[j].copy_(q[0])
        b.draft[j:j + 1].copy_(prev)

    seq = torch.cat([b.prev, b.draft])  # [d + 1]
    embeds = model.gen_img_embeds(seq[None].expand(2, d + 1)).to(dtype)
    positions = n32 + (prompt_len - 1) + torch.arange(d + 1, dtype=torch.int32,
                                                      device=seq.device)
    hidden = lm(embeds, mask, positions, cache)
    p = probs(cfg_combine(model.image_gen_logits(hidden), cfg_weight)[0], temperature)

    u = None if greedy else torch.rand(d, generator=gens.accept, device=p.device)
    a = accept_length(p, b.q, b.draft, u, greedy)
    if greedy:
        extra = p.index_select(0, a.reshape(1))[0].argmax()
    else:
        bonus = draw(p[d:d + 1], gens.draft)
        resample = draw(residual(p, b.q, a)[None], gens.residual)
        extra = torch.where(a == d, bonus, resample)[0]
    cand = next_tokens(b.draft, a, extra)
    b.tokens.index_copy_(0, b.n + torch.arange(d + 1, device=cand.device), cand)
    b.prev.copy_(cand.index_select(0, a.reshape(1)))
    b.n.add_(a + 1)


@torch.inference_mode()
def generate_image_tokens_spec(
    model: PlanGenModel,
    cfg: PlanGenModelConfig,
    cfg_embeds: torch.Tensor,  # [2, L, H] cond/uncond prompt embeds (B = 1)
    attn_mask: torch.Tensor,  # [2, L + num_tokens]
    generator: Optional[Generators],  # the request's (or a sequence of it alone)
    cfg_weight: float,
    temperature: float,
    num_tokens: int = 576,
    draft_layers: int = 8,
    draft_len: int = 4,
    eager: bool = False,  # on the card, the eager round loop instead of the graph
) -> SpecResult:
    """Prefill, token 0 from the prefill's hidden state as the base loop
    draws it, then rounds until `num_tokens` tokens are final (module
    docstring). On CUDA tensors the rounds after the first replay a CUDA
    graph of one round, unless `eager`; a round that cannot be captured
    raises."""
    B2, L, _ = cfg_embeds.shape
    device = cfg_embeds.device
    if B2 != 2:
        raise ValueError(f"speculative decode supports B = 1 (the CFG pair), got {B2} rows")
    if attn_mask.shape != (2, L + num_tokens):
        raise ValueError(f"attn_mask must be [2, {L + num_tokens}], got "
                         f"{tuple(attn_mask.shape)}")
    if not 1 <= draft_layers <= cfg.llama.num_layers:
        raise ValueError(f"draft_layers must be in [1, {cfg.llama.num_layers}], "
                         f"got {draft_layers}")
    if draft_len < 1:
        raise ValueError(f"draft_len must be >= 1, got {draft_len}")
    greedy = temperature == 0
    if not isinstance(generator, torch.Generator) and generator is not None:
        if len(generator) != 1:
            raise ValueError(f"{len(generator)} generators for one request")
        generator = generator[0]
    if not greedy and generator is None:
        raise ValueError("sampling at temperature > 0 needs a generator")

    d = draft_len
    S = cache_length(L, num_tokens + d + 1)
    mask = torch.as_tensor(attn_mask, device=device).to(torch.int32)
    mask = F.pad(mask, (0, S - mask.shape[1])).contiguous()  # zero tail
    cache = init_kv_cache(cfg.llama, 2, S, dtype=cfg_embeds.dtype, device=device)
    last_hidden = prefill(model, cfg_embeds, mask, cache)
    logits0 = cfg_combine(model.image_gen_logits(last_hidden), cfg_weight)
    tok0 = sample_categorical(logits0, temperature, generator)  # [1]

    b = RoundBuffers(
        n=torch.ones(1, dtype=torch.int64, device=device),
        prev=tok0.clone(),
        draft=torch.zeros(d, dtype=torch.int64, device=device),
        q=torch.zeros((d, cfg.image_token_size), dtype=torch.float32, device=device),
        tokens=torch.zeros(num_tokens + d + 1, dtype=torch.int64, device=device),
    )
    b.tokens[:1].copy_(tok0)
    gens = None if greedy else RoundGenerators(
        generator, stream_generator(generator, ACCEPT_STREAM),
        stream_generator(generator, RESIDUAL_STREAM))
    draws: List[torch.Generator] = [] if gens is None else [gens.draft, gens.accept,
                                                            gens.residual]

    def round_():
        speculative_round(model, b, mask, cache, L, cfg_weight, temperature, draft_layers,
                          gens, cfg_embeds.dtype)

    on_graph = device.type == "cuda" and not eager
    graph = None
    rounds = 0
    while int(b.n) < num_tokens:  # the host reads n between rounds
        if not on_graph:
            round_()
        elif rounds == 0:
            eager_step(round_)
        else:
            if graph is None:
                graph = StepGraph(round_, draws)
            graph.replay()
        rounds += 1
    return SpecResult(tokens=b.tokens[None, :num_tokens], rounds=rounds)
