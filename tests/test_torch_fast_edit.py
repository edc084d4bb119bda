"""`fast_edit` on the CPU: the frozen chunks as one forward each.

  * the schedules equal the JAX package's on seeded masks;
  * the tokens equal the port's own standard loop (`generate_image_tokens`)
    bit for bit, at temperature 0 and at temperature 1 with one generator
    or one per row, for the raw and the canonical schedule, on the dense
    and the int8 cache, with fp32 weights (the JAX package's own test of
    the identity uses fp32: in bf16 the 16-row forward rounds apart from
    the loop's single rows, and a later sampled token may then differ; the
    forced tokens and the streams are still the loop's);
  * at temperature 0, and fully frozen, the tokens equal the JAX
    package's `generate_image_tokens_fast_edit`;
  * `PlanGenPipeline` with `fast_edit` runs the fast path with teacher
    forcing, in every quantized form and on both `auto` routes, and its
    tokens equal the standard pipeline's.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from plangen_tpu.config import PlanGenModelConfig
from plangen_tpu.models import vlm as jvlm
from plangen_tpu.runtime import fast_edit as jfe
from plangen_tpu_torch.config import GenerationConfig
from plangen_tpu_torch.config import PlanGenModelConfig as TConfig
from plangen_tpu_torch.convert import load_jax_params
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.ops import decode_attention as da
from plangen_tpu_torch.ops.sampling import skip_categorical
from plangen_tpu_torch.runtime import fast_edit as fe
from plangen_tpu_torch.runtime.generate import generate_image_tokens
from plangen_tpu_torch.tasks import pipeline as tpipeline
from plangen_tpu_torch.tasks.pipeline import PlanGenPipeline
from plangen_tpu_torch.tasks.processor import PlanGenProcessor
from plangen_tpu_torch.text.tokenizer import ByteFallbackTokenizer

CFG = PlanGenModelConfig.tiny()
TCFG = TConfig.tiny()
N, B, L = 64, 2, 7


# ------------------------------------------------------------------ schedules


def _masks():
    rs = np.random.RandomState(0)
    out = []
    for k in range(40):
        n = (64, 576, 20, 100)[k % 4]
        m = (rs.rand(1 + k % 3, n) < rs.choice([0.0, 0.02, 0.2])).astype(np.int32)
        if k % 5 == 0:  # a box on a 24 x 24 grid, the removal sets' shape
            g = np.zeros((24, 24), np.int32)
            y, x = rs.randint(0, 16, 2)
            g[y:y + rs.randint(3, 8), x:x + rs.randint(3, 8)] = 1
            m = g.reshape(1, -1)
        out.append(m)
    return out


def test_schedules_equal_jax():
    for m in _masks():
        raw = fe.frozen_chunk_schedule(m)
        assert raw == jfe.frozen_chunk_schedule(m)
        assert fe.frozen_chunk_schedule(m, 8) == jfe.frozen_chunk_schedule(m, 8)
        for g in (1, 2, 8):
            assert fe.canonicalize_schedule(raw, g) == jfe.canonicalize_schedule(raw, g)


def test_skip_categorical_moves_the_stream_as_a_draw():
    """Skipping a position leaves each generator where a draw leaves it."""
    from plangen_tpu_torch.ops.sampling import sample_categorical

    logits = torch.randn(3, 64, generator=torch.Generator().manual_seed(1))
    for gens in (lambda: torch.Generator().manual_seed(5),
                 lambda: [torch.Generator().manual_seed(s) for s in (5, 6, 7)]):
        a, b = gens(), gens()
        sample_categorical(logits, 1.0, a)
        skip_categorical(3, 64, 1.0, b, "cpu")
        for x, y in zip(a if isinstance(a, list) else [a], b if isinstance(b, list) else [b]):
            assert torch.equal(x.get_state(), y.get_state())
        before = [g.get_state() for g in (b if isinstance(b, list) else [b])]
        skip_categorical(3, 64, 0.0, b, "cpu")  # temperature 0 draws nothing
        assert all(torch.equal(s, g.get_state())
                   for s, g in zip(before, b if isinstance(b, list) else [b]))


# ------------------------------------------------------------------ the loop


@functools.lru_cache(maxsize=None)
def _load():
    params = jvlm.init(jax.random.PRNGKey(42), CFG, dtype=jnp.float32)
    model = PlanGenModel(TCFG, dtype=torch.float32)
    load_jax_params(model, params, TCFG)
    return params, model.eval()


@functools.lru_cache(maxsize=None)
def _inputs():
    """A left-padded CFG prompt [2B, L, H], its mask, gt codes and a regen
    mask with sampled positions in chunks 1 and 2 (chunks 0 and 3 frozen)."""
    params, _ = _load()
    rs = np.random.RandomState(3)
    ids = rs.randint(0, 100, (2 * B, L))
    embeds = np.array(jvlm.embed_text(params, jnp.asarray(ids)), np.float32)
    mask = np.ones((2 * B, L + N), np.int32)
    mask[2:4, :2] = 0
    gt = rs.randint(0, CFG.image_token_size, (B, N)).astype(np.int64)
    regen = np.zeros((B, N), np.int32)
    regen[:, 20:28] = 1
    regen[0, 40:44] = 1
    return embeds, mask, gt, regen


def _generators(kind):
    if kind == "per_row":
        return [torch.Generator().manual_seed(s) for s in (11, 12)]
    return torch.Generator().manual_seed(11)


def _loop_args(quantized, temperature):
    _, model = _load()
    embeds, mask, gt, regen = _inputs()
    args = (model, TCFG, torch.from_numpy(embeds), torch.from_numpy(mask))
    kw = dict(cfg_weight=5.0, temperature=temperature, gt_tokens=torch.from_numpy(gt),
              regen_mask=torch.from_numpy(regen), num_tokens=N, quantized_cache=quantized)
    return args, kw


@functools.lru_cache(maxsize=None)
def _standard_loop(quantized, temperature, kind):
    """The standard loop's tokens from fresh generators: both schedules'
    cases compare against the same decode."""
    args, kw = _loop_args(quantized, temperature)
    return generate_image_tokens(*args, _generators(kind), **kw)


@pytest.mark.parametrize("schedule", ["raw", "canonical"])
@pytest.mark.parametrize("sampling", [(0.0, "one"), (1.0, "one"), (1.0, "per_row")],
                         ids=["greedy", "t1_one_generator", "t1_per_row"])
@pytest.mark.parametrize("quantized", [False, True], ids=["dense_cache", "int8_cache"])
def test_tokens_equal_the_standard_loop(quantized, sampling, schedule):
    _, _, gt, regen = _inputs()
    temperature, kind = sampling
    raw = fe.frozen_chunk_schedule(regen)
    assert raw == (True, False, False, True)
    sched = raw if schedule == "raw" else fe.canonicalize_schedule(raw, 2)
    args, kw = _loop_args(quantized, temperature)
    want = _standard_loop(quantized, temperature, kind)
    got = fe.generate_image_tokens_fast_edit(*args, _generators(kind), schedule=sched, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    keep = torch.from_numpy(regen) == 0
    assert torch.equal(got[keep], torch.from_numpy(gt)[keep])


def test_bf16_forced_tokens_and_the_first_mixed_chunk_equal_the_loop():
    """In bf16 the forced tokens are the codes and the mixed chunk before
    any frozen chunk is the loop's (same operations); later sampled tokens
    are not claimed (module docstring)."""
    model = PlanGenModel(TCFG, dtype=torch.bfloat16)
    model.load_state_dict(_load()[1].state_dict())
    embeds, mask, gt, regen = _inputs()
    regen = regen.copy()
    regen[:, 3] = 1  # chunk 0 mixed too
    sched = fe.frozen_chunk_schedule(regen)
    assert sched == (False, False, False, True)
    args = (model.eval(), TCFG, torch.from_numpy(embeds).bfloat16(), torch.from_numpy(mask))
    kw = dict(cfg_weight=5.0, temperature=1.0, gt_tokens=torch.from_numpy(gt),
              regen_mask=torch.from_numpy(regen), num_tokens=N)
    want = generate_image_tokens(*args, _generators("per_row"), **kw)
    got = fe.generate_image_tokens_fast_edit(*args, _generators("per_row"), schedule=sched,
                                             **kw)
    keep = torch.from_numpy(regen) == 0
    assert torch.equal(got[keep], torch.from_numpy(gt)[keep])
    assert torch.equal(got[:, :48], want[:, :48])  # no frozen chunk before column 48


@pytest.mark.parametrize("case", ["mixed", "all_frozen"])
def test_greedy_tokens_equal_jax(case):
    params, model = _load()
    embeds, mask, gt, regen = _inputs()
    if case == "all_frozen":
        regen = np.zeros_like(regen)
    sched = fe.frozen_chunk_schedule(regen)
    want = jfe.generate_image_tokens_fast_edit(
        params, CFG, jnp.asarray(embeds), jnp.asarray(mask), rng=jax.random.PRNGKey(0),
        cfg_weight=jnp.float32(5.0), temperature=jnp.float32(0.0),
        gt_tokens=jnp.asarray(gt, jnp.int32), regen_mask=jnp.asarray(regen), num_tokens=N,
        schedule=sched).tokens
    got = fe.generate_image_tokens_fast_edit(
        model, TCFG, torch.from_numpy(embeds), torch.from_numpy(mask), None, 5.0, 0.0,
        torch.from_numpy(gt), torch.from_numpy(regen), num_tokens=N, schedule=sched)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "all_frozen":
        np.testing.assert_array_equal(got.numpy(), gt)


def test_schedule_of_the_wrong_length_raises():
    _, model = _load()
    embeds, mask, gt, regen = _inputs()
    with pytest.raises(ValueError, match="schedule"):
        fe.generate_image_tokens_fast_edit(
            model, TCFG, torch.from_numpy(embeds), torch.from_numpy(mask), None, 5.0, 0.0,
            torch.from_numpy(gt), torch.from_numpy(regen), num_tokens=N, schedule=(True,))


# ------------------------------------------------------------------ pipeline


def _pipeline(quantize, fast):
    _, dense = _load()
    model = PlanGenModel(TCFG, dtype=torch.float32)
    model.load_state_dict(dense.state_dict())
    gen = GenerationConfig(temperature=1.0, max_new_text_tokens=4, quantize=quantize,
                           fast_edit=fast)
    tok = ByteFallbackTokenizer(vocab_size=TCFG.llama.vocab_size)
    proc = PlanGenProcessor(tok, image_tokens=TCFG.image_seq_len, gen=gen)
    return PlanGenPipeline(model.eval(), TCFG, proc, gen_cfg=gen)


@pytest.mark.parametrize("quantize,n", [(None, 2), ("int8", 2), ("int8_kv", 2), ("int4", 2),
                                        ("int4_a8", 2), ("auto", 2), ("auto", 40)],
                         ids=["bf16", "int8", "int8_kv", "int4", "int4_a8", "auto_int4",
                              "auto_dense"])
def test_pipeline_fast_edit_equals_standard(quantize, n, monkeypatch):
    """`fast_edit` with teacher forcing takes the fast path, on the model
    `_model_for` routes to (under 'auto' the int4 view at <= 64 rows, the
    dense model above), and gives the standard pipeline's tokens."""
    size = TCFG.vision.image_size
    rs = np.random.RandomState(7)
    images = rs.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
    region = np.zeros((n, TCFG.image_seq_len), np.int32)
    region[::2, 1] = 1  # one sampled position in every other row
    captions = [f"caption {i}" for i in range(n)]
    groundings = ["<grounding><ref>x</ref><box>[0, 0, 500, 500]</box></grounding>"] * n
    seeds = list(range(n))
    want = _pipeline(quantize, False).edit_image(captions, groundings, images, region,
                                                 seeds=seeds)
    fast = _pipeline(quantize, True)
    calls = []
    inner = tpipeline.generate_image_tokens_fast_edit

    def spy(model, *args, **kw):
        calls.append(model)
        return inner(model, *args, **kw)

    monkeypatch.setattr(tpipeline, "generate_image_tokens_fast_edit", spy)
    got = fast.edit_image(captions, groundings, images, region, seeds=seeds)
    assert calls == [fast._model_for(2 * n)]
    if quantize == "auto":
        assert (calls[0] is fast.model_int4) == (n == 2)
    np.testing.assert_array_equal(got.image_tokens, want.image_tokens)
    np.testing.assert_array_equal(got.edit_mask, want.edit_mask)
    # without teacher forcing the flag changes nothing: the standard loop
    calls.clear()
    fast.layout_to_image(captions[:1], groundings[:1], seeds=seeds[:1])
    assert calls == []


def test_fast_edit_flag_is_accepted_with_kv_a8_and_speculative(monkeypatch):
    """`fast_edit` with `kv_a8` (and int8) reaches
    `generate_image_tokens_fast_edit` with the flag. With `fast_edit` and
    `speculative` both on, a teacher-forced call of one image takes
    `fast_edit`, as in JAX (speculative decoding is for calls without
    teacher forcing), and gives the plain `fast_edit` pipeline's tokens."""
    assert dataclasses.replace(_pipeline(None, True).gen).fast_edit
    a8 = _pipeline("int8", True)
    a8 = PlanGenPipeline(a8.model, TCFG, a8.proc,
                         gen_cfg=dataclasses.replace(a8.gen, kv_a8=True))
    flags = []
    inner = tpipeline.generate_image_tokens_fast_edit
    monkeypatch.setattr(tpipeline, "generate_image_tokens_fast_edit", lambda *a, **kw: (
        flags.append(kw["kv_a8"]), inner(*a, **kw))[1])
    size = TCFG.vision.image_size
    image = np.random.RandomState(8).uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    region = np.zeros((1, TCFG.image_seq_len), np.int32)
    region[0, 2] = 1
    grounding = ["<grounding><ref>x</ref><box>[0, 0, 500, 500]</box></grounding>"]
    calls = da.prefix_decode_attention_a8_reference.calls
    a8.edit_image(["c"], grounding, image, region, seeds=[3])
    assert flags == [True]
    # the one chunk (4 tokens) holds a sampled position: each of its decode
    # steps through K1-a8 (its plain version here)
    assert (da.prefix_decode_attention_a8_reference.calls - calls
            == TCFG.image_seq_len * TCFG.llama.num_layers)
    monkeypatch.setattr(tpipeline, "generate_image_tokens_fast_edit", inner)
    fast = _pipeline(None, True)
    gen = dataclasses.replace(fast.gen, speculative=True, spec_draft_layers=1)
    both = PlanGenPipeline(fast.model, TCFG, fast.proc, gen_cfg=gen)
    calls = []
    for name in ("generate_image_tokens_fast_edit", "generate_image_tokens_spec"):
        inner = getattr(tpipeline, name)
        monkeypatch.setattr(tpipeline, name, lambda *a, _n=name, _f=inner, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    got = both.edit_image(["c"], grounding, image, region, seeds=[3])
    want = fast.edit_image(["c"], grounding, image, region, seeds=[3])
    assert calls == ["generate_image_tokens_fast_edit"] * 2
    np.testing.assert_array_equal(got.image_tokens, want.image_tokens)
    calls.clear()
    both.layout_to_image(["c"], grounding, seeds=[3])  # no teacher forcing
    assert calls == ["generate_image_tokens_spec"]
