"""The image decode step that the port captures in a CUDA graph, on the CPU.

The capture-safe draw against `torch.multinomial`, the static-buffer step
(`runtime/generate.py::image_decode_step`), and the loop of steps against
the JAX package's one-program loop, token for token, on the dense cache
(the JAX loop with its Pallas prefix kernel in interpret mode) and on the
int8 cache. The card runs the same step function; its graph is held
against its eager loop in `tests/test_torch_gpu.py`.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import plangen_tpu.ops.pallas_decode_attention as pda
from plangen_tpu.config import PlanGenModelConfig
from plangen_tpu.models import vlm as jvlm
from plangen_tpu.runtime import generate as jgen
from plangen_tpu_torch.convert import load_jax_params
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.ops.sampling import draw, sample_categorical
from plangen_tpu_torch.runtime import generate as gen
from plangen_tpu_torch.runtime.kvcache import init_kv_cache

CFG = PlanGenModelConfig.tiny()
NUM_TOKENS = 6
CFG_WEIGHT = 5.0


# ------------------------------------------------------------ the draw


@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("per_row", [False, True], ids=["one_generator", "per_row"])
def test_draw_equals_multinomial(per_row, temperature):
    """The same tokens as `torch.multinomial(probs, 1, generator=g)`, and the
    same generator state after, step after step."""
    B, V = 4, 16384
    for seed in range(5):
        rs = np.random.RandomState(seed)
        mine = [torch.Generator().manual_seed(seed * 10 + r) for r in range(B)]
        theirs = [torch.Generator().manual_seed(seed * 10 + r) for r in range(B)]
        for _ in range(3):
            logits = torch.from_numpy(rs.randn(B, V).astype(np.float32) * 4)
            probs = torch.softmax(logits / temperature, dim=-1)
            if per_row:
                got = sample_categorical(logits, temperature, mine)
                want = torch.cat([torch.multinomial(p[None], 1, generator=g)[:, 0]
                                  for p, g in zip(probs, theirs)])
            else:
                got = sample_categorical(logits, temperature, mine[0])
                want = torch.multinomial(probs, 1, generator=theirs[0])[:, 0]
            torch.testing.assert_close(got, want, rtol=0, atol=0)
            for a, b in zip(mine, theirs):
                assert torch.equal(a.get_state(), b.get_state())


def test_draw_keeps_zero_probabilities_out():
    probs = torch.tensor([[0.0, 0.5, 0.0, 0.5], [0.0, 0.0, 1.0, 0.0]])
    g = torch.Generator().manual_seed(0)
    for _ in range(50):
        token = draw(probs, g)
        assert token[0].item() in (1, 3) and token[1].item() == 2


# ------------------------------------------------------------ the step


@functools.lru_cache(maxsize=None)
def _load():
    params = jvlm.init(jax.random.PRNGKey(0), CFG, dtype=jnp.float32)
    model = PlanGenModel(CFG, dtype=torch.float32)
    load_jax_params(model, params, CFG)
    return params, model.eval()


@functools.lru_cache(maxsize=None)
def _prompt():
    """A left-padded CFG dual batch: embeds [4, 10, H], mask [4, 10 + N]."""
    params, _ = _load()
    rs = np.random.RandomState(0)
    ids = rs.randint(0, CFG.llama.vocab_size, size=(4, 10))
    mask = np.ones((4, 10 + NUM_TOKENS), dtype=np.int32)
    mask[1, :2] = 0
    mask[2, :4] = 0
    mask[3, :1] = 0
    return np.array(jvlm.embed_text(params, jnp.asarray(ids))), mask


@pytest.mark.parametrize("quantized", [False, True], ids=["dense_cache", "int8_cache"])
def test_step_advances_its_buffers(quantized):
    """One step at i = 2 writes column 2 of the tokens and nothing else, a
    new hidden state, and advances q_pos and the step index by one."""
    _, model = _load()
    embeds, mask = _prompt()
    B2, L, _ = embeds.shape
    S = gen.cache_length(L, NUM_TOKENS)
    full_mask = torch.from_numpy(np.pad(mask, ((0, 0), (0, S - mask.shape[1]))))
    cache = init_kv_cache(CFG.llama, B2, S, dtype=torch.float32, quantized=quantized)
    i = 2
    with torch.inference_mode():
        last = gen.prefill(model, torch.from_numpy(embeds), full_mask, cache)
        buffers = gen.StepBuffers(
            last_hidden=last.clone(memory_format=torch.contiguous_format),
            q_pos=torch.tensor([L + i], dtype=torch.int32),
            step=torch.tensor([i]),
            tokens=torch.full((B2 // 2, NUM_TOKENS), -1, dtype=torch.int64),
        )
        before = buffers.last_hidden.clone()
        gen.image_decode_step(model, buffers, full_mask, cache, CFG_WEIGHT, 0.0, None,
                              torch.float32)
    assert buffers.q_pos.tolist() == [L + i + 1] and buffers.q_pos.dtype == torch.int32
    assert buffers.step.tolist() == [i + 1]
    tokens = buffers.tokens.numpy()
    assert (tokens[:, i] >= 0).all() and (tokens[:, i] < CFG.image_token_size).all()
    assert (np.delete(tokens, i, axis=1) == -1).all()
    assert not torch.equal(buffers.last_hidden, before)
    # the step wrote its row of the cache at slot L + i
    assert cache["k"][:, :, L + i].abs().sum() > 0
    assert cache["k"][:, :, L + i + 1:].abs().sum() == 0


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the JAX loop's Pallas prefix kernel in interpret mode (CPU)."""
    monkeypatch.setattr(
        pda, "prefix_decode_attention",
        functools.partial(pda.prefix_decode_attention, interpret=True),
    )


def _forcing(kind):
    if kind == "greedy":
        return None, None
    rs = np.random.RandomState(1)
    gt = rs.randint(0, CFG.image_token_size, size=(2, NUM_TOKENS)).astype(np.int32)
    regen = np.array([[1, 0, 1, 1, 0, 0], [0, 0, 1, 0, 1, 1]], dtype=np.int32)
    return gt, regen


@pytest.mark.parametrize("kind", ["greedy", "teacher_forced"])
@pytest.mark.parametrize("quantized", [False, True], ids=["dense_cache", "int8_cache"])
def test_step_loop_equals_jax(quantized, kind, pallas_interpret, monkeypatch):
    """The loop of `image_decode_step` (one call a token) against the JAX
    package's scan: the dense cache through its Pallas prefix kernel, the
    int8 cache through its XLA path."""
    params, model = _load()
    embeds, mask = _prompt()
    gt, regen = _forcing(kind)
    calls = []
    step = gen.image_decode_step
    monkeypatch.setattr(gen, "image_decode_step",
                        lambda *a, **kw: calls.append(1) or step(*a, **kw))
    got = gen.generate_image_tokens(
        model, CFG, torch.from_numpy(embeds), torch.from_numpy(mask),
        generator=None, cfg_weight=CFG_WEIGHT, temperature=0.0,
        gt_tokens=None if gt is None else torch.from_numpy(gt),
        regen_mask=None if regen is None else torch.from_numpy(regen),
        num_tokens=NUM_TOKENS, quantized_cache=quantized,
    ).numpy()
    assert len(calls) == NUM_TOKENS
    want = np.asarray(jgen.generate_image_tokens(
        params, CFG, jnp.asarray(embeds), jnp.asarray(mask),
        rng=jax.random.PRNGKey(0), cfg_weight=jnp.float32(CFG_WEIGHT),
        temperature=jnp.float32(0.0),
        gt_tokens=None if gt is None else jnp.asarray(gt),
        regen_mask=None if regen is None else jnp.asarray(regen),
        num_tokens=NUM_TOKENS, quantized_cache=quantized, paged=not quantized,
    ).tokens)
    np.testing.assert_array_equal(got, want)
    if gt is not None:
        np.testing.assert_array_equal(got[regen == 0], gt[regen == 0])
