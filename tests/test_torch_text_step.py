"""The text decode step that the port captures in a CUDA graph, on the CPU.

The static-buffer step (`runtime/generate.py::text_decode_step`) on the
dense and the int8 cache, and the loop of steps against the JAX package's
one-program `while_loop`, token for token, with and without its early exit.
The JAX text loop reaches no Pallas kernel: its decode attention is XLA's
over the fixed cache (`paged` is an option of the image loop only). The
card runs the same step function; its graph is held against its eager loop
in `tests/test_torch_gpu.py`.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from plangen_tpu.config import PlanGenModelConfig
from plangen_tpu.models import vlm as jvlm
from plangen_tpu.runtime import generate as jgen
from plangen_tpu_torch.convert import load_jax_params
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.runtime import generate as gen
from plangen_tpu_torch.runtime.kvcache import init_kv_cache

CFG = PlanGenModelConfig.tiny()
EOS = 1  # the byte-fallback tokenizer's EOS id; the random model never emits it
PROMPT_LEN = 10
BUDGET = 24


@functools.lru_cache(maxsize=None)
def _load():
    params = jvlm.init(jax.random.PRNGKey(0), CFG, dtype=jnp.float32)
    model = PlanGenModel(CFG, dtype=torch.float32)
    load_jax_params(model, params, CFG)
    return params, model.eval()


@functools.lru_cache(maxsize=None)
def _prompt(shared: bool):
    """Left-padded text embeds [3, 10, H] and mask [3, 10 + BUDGET]. With
    `shared` every row is the same 7 prompt tokens behind 3 pads, so the
    rows emit the same stream."""
    params, _ = _load()
    rs = np.random.RandomState(7)
    ids = rs.randint(0, CFG.llama.vocab_size, size=(3, PROMPT_LEN))
    mask = np.ones((3, PROMPT_LEN + BUDGET), dtype=np.int32)
    if shared:
        ids[:] = ids[0]
        mask[:, :3] = 0
    else:
        mask[1, :2] = 0
        mask[2, :5] = 0
    return np.array(jvlm.embed_text(params, jnp.asarray(ids))), mask


@functools.lru_cache(maxsize=None)
def _jax_text(shared: bool, eos: int, quantized: bool):
    params, _ = _load()
    embeds, mask = _prompt(shared)
    return np.asarray(jgen.greedy_decode_text(
        params, CFG, jnp.asarray(embeds), jnp.asarray(mask), jnp.int32(eos),
        max_new_tokens=BUDGET, quantized_cache=quantized))


@pytest.mark.parametrize("quantized", [False, True], ids=["dense_cache", "int8_cache"])
def test_text_step_advances_its_buffers(quantized):
    """One step at i = 2 with row 1 already done: column 2 of the tokens
    holds the argmax of the fp32 logits (EOS for row 1) and nothing else
    changes; the done flags and the all-done flag follow; a new hidden state
    and the cache row at slot L + 2; q_pos and the step index advance."""
    _, model = _load()
    embeds, mask = _prompt(shared=False)
    B, L, _ = embeds.shape
    S = gen.cache_length(L, BUDGET)
    full_mask = torch.from_numpy(np.pad(mask, ((0, 0), (0, S - mask.shape[1]))))
    cache = init_kv_cache(CFG.llama, B, S, dtype=torch.float32, quantized=quantized)
    i = 2
    with torch.inference_mode():
        last = gen.prefill(model, torch.from_numpy(embeds), full_mask, cache)
        want = model.language_model.logits(last).argmax(dim=-1).to(torch.int32)
        buffers = gen.TextStepBuffers(
            last_hidden=last.clone(memory_format=torch.contiguous_format),
            q_pos=torch.tensor([L + i], dtype=torch.int32),
            step=torch.tensor([i]),
            tokens=torch.full((B, BUDGET), EOS, dtype=torch.int32),
            done=torch.tensor([False, True, False]),
            all_done=torch.tensor(False),
        )
        before = buffers.last_hidden.clone()
        gen.text_decode_step(model, buffers, full_mask, cache, EOS, torch.float32)
    assert buffers.q_pos.tolist() == [L + i + 1] and buffers.q_pos.dtype == torch.int32
    assert buffers.step.tolist() == [i + 1] and buffers.step.dtype == torch.int64
    tokens = buffers.tokens.numpy()
    assert buffers.tokens.dtype == torch.int32
    assert tokens[:, i].tolist() == [int(want[0]), EOS, int(want[2])]
    assert EOS not in (int(want[0]), int(want[2]))
    assert (np.delete(tokens, i, axis=1) == EOS).all()
    assert buffers.done.tolist() == [False, True, False] and not bool(buffers.all_done)
    assert not torch.equal(buffers.last_hidden, before)
    assert cache["k"][:, :, L + i].abs().sum() > 0
    assert cache["k"][:, :, L + i + 1:].abs().sum() == 0

    # every row done: the step writes EOS and raises the all-done flag
    with torch.inference_mode():
        buffers.done.fill_(True)
        gen.text_decode_step(model, buffers, full_mask, cache, EOS, torch.float32)
    assert (buffers.tokens[:, i + 1] == EOS).all() and bool(buffers.all_done)
    assert buffers.step.tolist() == [i + 2]


def _first(row, token):
    return int(np.flatnonzero(row == token)[0])


@pytest.mark.parametrize("exit_at", ["no_eos", "one_row", "every_row", "step_0"])
@pytest.mark.parametrize("quantized", [False, True], ids=["dense_cache", "int8_cache"])
def test_text_step_loop_equals_jax(quantized, exit_at, monkeypatch):
    """The loop of `text_decode_step` (one call a step) against the JAX
    package's `while_loop`: the same tokens, and exactly its steps. EOS is
    a token the no-EOS stream of row 0 emits first from column 8 on: one no
    other row emits (the loop runs on for them), or one every row emits
    (rows of one prompt: the loop exits early); or the first token of rows
    of one prompt (the loop ends after step 0)."""
    params, model = _load()
    shared = exit_at in ("every_row", "step_0")
    embeds, mask = _prompt(shared)
    free = _jax_text(shared, EOS, quantized)
    assert not (free == EOS).any()
    eos = EOS
    if exit_at == "step_0":
        eos = int(free[0, 0])
    elif exit_at != "no_eos":
        new = [int(t) for c, t in enumerate(free[0]) if c >= 8 and _first(free[0], t) == c]
        eos = next(t for t in new if (not (free[1:] == t).any() if exit_at == "one_row"
                                      else all((r == t).any() for r in free)))
    calls = []
    step = gen.text_decode_step
    monkeypatch.setattr(gen, "text_decode_step",
                        lambda *a, **kw: calls.append(1) or step(*a, **kw))
    got = gen.greedy_decode_text(model, CFG, torch.from_numpy(embeds), torch.from_numpy(mask),
                                 eos, max_new_tokens=BUDGET, quantized_cache=quantized)
    assert got.dtype == torch.int32 and got.shape == (3, BUDGET)
    got = got.numpy()
    want = _jax_text(shared, eos, quantized)
    np.testing.assert_array_equal(got, want)
    jax_steps = BUDGET
    if shared:
        jax_steps = max(_first(r, eos) for r in free) + 1
        assert jax_steps == 1 if exit_at == "step_0" else 1 < jax_steps < BUDGET
    assert len(calls) == jax_steps == gen.text_decode_steps(got, eos)


def test_budget_of_one_runs_one_step(monkeypatch):
    """A budget of 1: one step, its argmax, no step after it."""
    _, model = _load()
    embeds, mask = _prompt(shared=False)
    free = _jax_text(False, EOS, False)
    calls = []
    step = gen.text_decode_step
    monkeypatch.setattr(gen, "text_decode_step",
                        lambda *a, **kw: calls.append(1) or step(*a, **kw))
    got = gen.greedy_decode_text(model, CFG, torch.from_numpy(embeds),
                                 torch.from_numpy(mask[:, :PROMPT_LEN + 1]), EOS,
                                 max_new_tokens=1)
    assert len(calls) == 1
    np.testing.assert_array_equal(got.numpy(), free[:, :1])
