"""The port's text paths and teacher-forced editing against the JAX package.

Same weights (JAX `vlm.init`, fp32, through `load_jax_params`), same
prompts, the byte-fallback tokenizer. Greedy and teacher-forced outputs are
deterministic, so they must be equal token for token:

  * `greedy_decode_text` on `tiny` and `tiny_7b`, against the JAX loop with
    `growing_cache` on and off, at a budget inside one 128-slot chunk and
    one whose cache crosses into a second, over the dense and the int8 KV
    cache; with an EOS the stream emits mid-way, the port runs exactly the
    decoder steps the JAX `while_loop` runs;
  * the pipeline's `plan`, `joint_generate`, `understand` (its SigLIP
    embeds to 1e-5) and teacher-forced `layout_to_image` / `edit_image`;
  * `plan` in the `int4` and `int4_a8` forms, on the lane-aligned config of
    tests/test_torch_quant_models.py (the JAX int4 kernel runs in interpret
    mode, the port's K2 / K4 through their plain versions);
  * K2's and K4's launch plans at `lm_head`'s Janus-Pro-1B shape.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from plangen_tpu.config import (
    GenerationConfig, LlamaConfig, PlanGenModelConfig, ProjectorConfig,
    SigLIPConfig, VQConfig,
)
from plangen_tpu.models import vlm as jvlm
from plangen_tpu.models import vq as jvq
from plangen_tpu.ops import quant as jquant
from plangen_tpu.runtime import generate as jgen
from plangen_tpu.tasks.pipeline import PlanGenPipeline as JaxPipeline
from plangen_tpu.tasks.processor import PlanGenProcessor as JaxProcessor
from plangen_tpu.text.tokenizer import ByteFallbackTokenizer
from plangen_tpu_torch.convert import load_jax_params
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.ops import decode_attention as da
from plangen_tpu_torch.ops import int4_matmul as im
from plangen_tpu_torch.runtime.generate import (
    cache_length, greedy_decode_text, text_decode_steps,
)
from plangen_tpu_torch.tasks.pipeline import PlanGenPipeline
from plangen_tpu_torch.tasks.processor import PlanGenProcessor

CONFIGS = {"tiny": PlanGenModelConfig.tiny(), "tiny_7b": PlanGenModelConfig.tiny_7b()}
EOS = 1  # the byte-fallback tokenizer's EOS id; the random models never emit it
PROMPT_LEN = 10
# a budget whose cache stays in one 128-slot chunk, and one that crosses it
BUDGETS = (16, 124)


@functools.lru_cache(maxsize=None)
def _load(name):
    cfg = CONFIGS[name]
    params = jvlm.init(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    model = PlanGenModel(cfg, dtype=torch.float32)
    load_jax_params(model, params, cfg)
    return cfg, params, model.eval()


@functools.lru_cache(maxsize=None)
def _prompt(name, budget, shared=False):
    """Left-padded text embeds [3, 10, H] and mask [3, 10 + budget]. With
    `shared` every row is the same 7 prompt tokens behind 3 pads, so the
    rows emit the same stream."""
    cfg, params, _ = _load(name)
    rs = np.random.RandomState(budget)
    ids = rs.randint(0, cfg.llama.vocab_size, size=(3, PROMPT_LEN))
    mask = np.ones((3, PROMPT_LEN + budget), dtype=np.int32)
    if shared:
        ids[:] = ids[0]
        mask[:, :3] = 0
    else:
        mask[1, :2] = 0
        mask[2, :5] = 0
    embeds = np.array(jvlm.embed_text(params, jnp.asarray(ids)))
    return embeds, mask


def _jax_text(name, embeds, mask, eos, budget, **kw):
    cfg, params, _ = _load(name)
    out = jgen.greedy_decode_text(params, cfg, jnp.asarray(embeds), jnp.asarray(mask),
                                  jnp.int32(eos), max_new_tokens=budget, **kw)
    return np.asarray(out)


def _port_text(model, cfg, embeds, mask, eos, budget, **kw):
    """(tokens, decoder steps run): one K1 call per layer and step."""
    calls = (da.prefix_decode_attention_reference.calls
             + da.prefix_decode_attention_q8_reference.calls)
    out = greedy_decode_text(model, cfg, torch.from_numpy(embeds), torch.from_numpy(mask),
                             eos, max_new_tokens=budget, **kw)
    calls = (da.prefix_decode_attention_reference.calls
             + da.prefix_decode_attention_q8_reference.calls - calls)
    assert calls % cfg.llama.num_layers == 0
    return out.numpy(), calls // cfg.llama.num_layers


@functools.lru_cache(maxsize=None)
def _port_greedy(name, budget, quantized):
    """`_port_text` on `_prompt(name, budget)`: the port has one loop for
    both JAX cache forms, so their two cases share its decode."""
    cfg, _, model = _load(name)
    embeds, mask = _prompt(name, budget)
    return _port_text(model, cfg, embeds, mask, EOS, budget, quantized_cache=quantized)


@pytest.mark.parametrize("quantized", [False, True], ids=["dense_cache", "int8_cache"])
@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("growing", [True, False], ids=["growing_cache", "fixed_cache"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_greedy_decode_text_equals_jax(name, growing, budget, quantized):
    embeds, mask = _prompt(name, budget)
    got, steps = _port_greedy(name, budget, quantized)
    want = _jax_text(name, embeds, mask, EOS, budget, growing_cache=growing,
                     quantized_cache=quantized)
    assert got.dtype == np.int32 and got.shape == (3, budget)
    np.testing.assert_array_equal(got, want)
    assert not (want == EOS).any() and steps == budget  # no EOS: every step runs
    if budget == BUDGETS[1]:
        assert cache_length(PROMPT_LEN, budget) == 2 * 128


def _first(row, token):
    return int(np.flatnonzero(row == token)[0])


@pytest.mark.parametrize("quantized", [False, True], ids=["dense_cache", "int8_cache"])
@pytest.mark.parametrize("rows", ["one_row", "every_row"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_early_exit_equals_jax(name, rows, quantized):
    """An EOS the no-EOS stream emits mid-way: in row 0 only (the loop runs
    on for the other rows), or in every row (rows of one prompt: the loop
    exits early). The output is JAX's (EOS from each row's first EOS on),
    and the port ran exactly the steps of the JAX `while_loop`: up to the
    last row's first EOS."""
    cfg, _, model = _load(name)
    budget = 40
    embeds, mask = _prompt(name, budget, shared=rows == "every_row")
    kw = dict(quantized_cache=quantized)
    free = _jax_text(name, embeds, mask, EOS, budget, **kw)
    # a token row 0 emits first at a column from 10 on: no other row emits
    # it (one_row), or every row does (every_row)
    new = [int(t) for c, t in enumerate(free[0]) if c >= 10 and _first(free[0], t) == c]
    if rows == "one_row":
        eos = next(t for t in new if not (free[1:] == t).any())
    else:
        eos = next(t for t in new if all((r == t).any() for r in free))
    first = [_first(r, eos) if (r == eos).any() else None for r in free]

    got, steps = _port_text(model, cfg, embeds, mask, eos, budget, **kw)
    want = _jax_text(name, embeds, mask, eos, budget, **kw)
    np.testing.assert_array_equal(got, want)
    for r, f in enumerate(first):
        if f is not None:  # the first run's prefix, then EOS
            np.testing.assert_array_equal(got[r, :f], free[r, :f])
            assert (got[r, f:] == eos).all()
    if rows == "one_row":
        jax_steps = budget
    else:
        jax_steps = max(first) + 1
        assert jax_steps < budget  # the exit comes early
    assert steps == jax_steps == text_decode_steps(got, eos)


def test_text_decode_steps_counts_the_exit_check():
    eos = 7
    tokens = np.full((2, 20), 3, dtype=np.int32)
    assert text_decode_steps(tokens, eos) == 20  # no row ends
    tokens[0, 5:] = eos
    assert text_decode_steps(tokens, eos) == 20  # row 1 never ends
    tokens[1, 9:] = eos
    assert text_decode_steps(tokens, eos) == 10
    tokens[1, 1:] = eos
    assert text_decode_steps(tokens, eos) == 6  # the last row to end


def test_greedy_decode_text_rejects_a_mask_of_another_length():
    cfg, _, model = _load("tiny")
    embeds, mask = _prompt("tiny", 16)
    with pytest.raises(ValueError):
        greedy_decode_text(model, cfg, torch.from_numpy(embeds),
                           torch.from_numpy(mask[:, :-1]), EOS, max_new_tokens=16)


# ------------------------------------------------------------ the pipeline

CAPTIONS = ["a cat", "two dogs on the grass"]
GROUNDINGS = [
    "<grounding><ref>cat</ref><box>[100, 100, 500, 500]</box></grounding>",
    "<grounding><ref>dog</ref><box>[0, 0, 480, 500]</box>"
    "<ref>dog</ref><box>[520, 500, 900, 900]</box></grounding>",
]
TEXT_BUDGET = 24


def _pipelines(name="tiny", **gen_kw):
    cfg, params, model = _load(name)
    gen = GenerationConfig(temperature=0.0, max_new_text_tokens=TEXT_BUDGET, **gen_kw)
    tok = ByteFallbackTokenizer(vocab_size=cfg.llama.vocab_size)
    jax_pipe = JaxPipeline(params, cfg, JaxProcessor(tok, image_tokens=cfg.image_seq_len,
                                                     gen=gen),
                           compute_dtype=jnp.float32)
    port = PlanGenPipeline(model, cfg, PlanGenProcessor(tok, image_tokens=cfg.image_seq_len,
                                                        gen=gen))
    return jax_pipe, port


def _recording_text_decode(pipe, decoded, name):
    """Wrap `pipe._text_decode` so that `decoded[name]` keeps the tokens of
    its last decode, which `plan` then detokenizes: one decode gives both
    the tokens and the strings."""
    inner = pipe._text_decode

    def run(*args):
        tokens = inner(*args)
        decoded[name] = np.asarray(tokens)
        return tokens

    pipe._text_decode = run



@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plan_equals_jax(name):
    jax_pipe, port = _pipelines(name)
    want_prep, got_prep = jax_pipe.prepare_plan(CAPTIONS), port.prepare_plan(CAPTIONS)
    assert got_prep["budget"] == want_prep["budget"] == TEXT_BUDGET
    np.testing.assert_array_equal(got_prep["mask"].numpy(), np.asarray(want_prep["mask"]))
    np.testing.assert_array_equal(got_prep["embeds"].numpy(), np.asarray(want_prep["embeds"]))
    decoded = {}
    _recording_text_decode(port, decoded, "port")
    _recording_text_decode(jax_pipe, decoded, "jax")
    assert port.plan_from_prepared(got_prep) == jax_pipe.plan_from_prepared(want_prep)
    got = decoded["port"]
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, decoded["jax"])


@pytest.mark.parametrize("kw", [dict(seed=3), dict(seeds=[5, 6], parallel_size=2)],
                         ids=["seed", "seeds_ps2"])
def test_joint_generate_equals_jax(kw):
    jax_pipe, port = _pipelines()
    want = jax_pipe.joint_generate(CAPTIONS, **kw)
    got = port.joint_generate(CAPTIONS, **kw)
    assert got.groundings == want.groundings == jax_pipe.plan(CAPTIONS)
    assert got.image_tokens.dtype == np.int32
    np.testing.assert_array_equal(got.image_tokens, want.image_tokens)
    np.testing.assert_allclose(got.images, want.images, atol=1e-4)


def _clip_images(n, seed=4):
    """Seeded noise, CLIP-normalized: (u - mean) / std per channel."""
    size = CONFIGS["tiny"].vision.image_size
    u = np.random.RandomState(seed).uniform(size=(n, size, size, 3))
    mean = np.array([0.48145466, 0.4578275, 0.40821073])
    std = np.array([0.26862954, 0.26130258, 0.27577711])
    return ((u - mean) / std).astype(np.float32)


@pytest.mark.parametrize("question", [None, "Where is the dog?"], ids=["default", "question"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_understand_equals_jax(name, question):
    jax_pipe, port = _pipelines(name)
    images = _clip_images(2)
    want_prep = jax_pipe.prepare_understand(images, question)
    got_prep = port.prepare_understand(images, question)
    np.testing.assert_array_equal(got_prep["mask"].numpy(), np.asarray(want_prep["mask"]))
    np.testing.assert_allclose(got_prep["embeds"].numpy(), np.asarray(want_prep["embeds"]),
                               atol=1e-5, rtol=0)
    decoded = {}
    _recording_text_decode(port, decoded, "port")
    _recording_text_decode(jax_pipe, decoded, "jax")
    got = port.understand_from_prepared(got_prep)
    want = jax_pipe.understand_from_prepared(want_prep)
    np.testing.assert_array_equal(decoded["port"], decoded["jax"])
    assert got.texts == want.texts and got.groundings == want.texts
    assert got.images is None and got.image_tokens is None


def _edit_inputs(n, seed=3):
    cfg = CONFIGS["tiny"]
    rs = np.random.RandomState(seed)
    size = cfg.vision.image_size
    gt = rs.uniform(-1, 1, size=(n, size, size, 3)).astype(np.float32)
    region = (rs.uniform(size=(n, cfg.image_seq_len)) > 0.5).astype(np.int32)
    return gt, region


def test_vq_codes_of_the_edit_images_equal_jax():
    """The teacher-forcing codes: the port's VQ encode gives JAX's codes on
    the edit tests' images (no near-tie flips)."""
    cfg, params, model = _load("tiny")
    gt, _ = _edit_inputs(len(CAPTIONS))
    with torch.no_grad():
        got = model.gen_vision_model.encode_to_indices(torch.from_numpy(gt)).numpy()
    want = np.asarray(jvq.encode_to_indices(params["gen_vision_model"], cfg.vq,
                                            jnp.asarray(gt)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(seed=3), dict(seeds=[5, 6], parallel_size=2)],
                         ids=["seed", "seeds_ps2"])
@pytest.mark.parametrize("how", ["edit_image", "layout_to_image", "config", "no_region"])
def test_teacher_forced_generation_equals_jax(how, kw):
    """`edit_image`; `layout_to_image(teacher_forcing=True)`; teacher
    forcing from `use_teacher_forcing`; and no `edit_region` (every token
    forced). Tokens, pixels and `edit_mask` are JAX's, and every token
    outside the region is the VQ code of the given image."""
    ps = kw.get("parallel_size", 1)
    gen_kw = dict(use_teacher_forcing=how == "config")
    if how == "edit_image":  # it takes parallel_size from the config
        kw = {k: v for k, v in kw.items() if k != "parallel_size"}
        gen_kw["parallel_size"] = ps
    jax_pipe, port = _pipelines(**gen_kw)
    gt, region = _edit_inputs(len(CAPTIONS))
    if how == "edit_image":
        want = jax_pipe.edit_image(CAPTIONS, GROUNDINGS, gt, region, **kw)
        got = port.edit_image(CAPTIONS, GROUNDINGS, gt, region, **kw)
    else:
        args = dict(gt_images=gt, **kw)
        if how != "no_region":
            args["edit_region"] = region
        if how != "config":
            args["teacher_forcing"] = True
        want = jax_pipe.layout_to_image(CAPTIONS, GROUNDINGS, **args)
        got = port.layout_to_image(CAPTIONS, GROUNDINGS, **args)
        if how == "no_region":
            region = np.zeros_like(region)
    np.testing.assert_array_equal(got.image_tokens, want.image_tokens)
    np.testing.assert_allclose(got.images, want.images, atol=1e-4)
    assert got.edit_mask.dtype == np.int32
    np.testing.assert_array_equal(got.edit_mask, want.edit_mask)
    np.testing.assert_array_equal(got.edit_mask, np.concatenate([region] * ps))
    codes = np.asarray(jax_pipe.prepare_layout_to_image(
        CAPTIONS, GROUNDINGS, gt_images=gt, parallel_size=1, teacher_forcing=True).gt_tokens)
    codes = np.concatenate([codes] * ps)
    keep = got.edit_mask == 0
    np.testing.assert_array_equal(got.image_tokens[keep], codes[keep])


# -------------------------------------------------- quantized text decode

QCFG = PlanGenModelConfig(
    llama=LlamaConfig(vocab_size=1024, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=2, num_kv_heads=2, head_dim=128,
                      max_position_embeddings=128),
    vision=SigLIPConfig(image_size=32, patch_size=16, width=32, layers=2, heads=2),
    vq=VQConfig(codebook_size=256, codebook_dim=8, ch=8, ch_mult=(1, 1, 1, 1, 2),
                num_res_blocks=1, z_channels=16, group_norm_groups=4),
    aligner=ProjectorConfig(input_dim=32, n_embed=256, depth=2),
    gen_aligner=ProjectorConfig(input_dim=8, n_embed=256, depth=2),
    image_token_embed=256, image_token_size=256, gen_embed_dim=8,
)


@functools.lru_cache(maxsize=None)
def _qparams():
    return jvlm.init(jax.random.PRNGKey(0), QCFG, dtype=jnp.float32)


@pytest.mark.parametrize("captions", [CAPTIONS[:1], CAPTIONS], ids=["1_caption", "2_captions"])
@pytest.mark.parametrize("mode", ["int4", "int4_a8"])
def test_quantized_plan_equals_jax(mode, captions):
    """`plan` in the int4 forms over the int8 cache: JAX's tokens and
    strings, each pipeline decoding once. Every decode step runs `lm_head`
    and 4 matmuls a layer through K2 (K4 for int4_a8), and the prefill its
    4 a layer when its rows fit the kernel (<= 256)."""
    params = _qparams()
    # under jax.jit, as the JAX pipeline quantizes int4 (tasks/eval.py)
    jparams = jax.jit(functools.partial(jquant.quantize_lm_params_int4,
                                        act_int8=mode == "int4_a8"))(params)
    model = PlanGenModel(QCFG, dtype=torch.float32)
    load_jax_params(model, params, QCFG)
    gen = GenerationConfig(temperature=0.0, max_new_text_tokens=TEXT_BUDGET, quantize=mode)
    tok = ByteFallbackTokenizer(vocab_size=QCFG.llama.vocab_size)
    jax_pipe = JaxPipeline(jparams, QCFG, JaxProcessor(tok, image_tokens=QCFG.image_seq_len,
                                                       gen=gen),
                           compute_dtype=jnp.float32)
    port = PlanGenPipeline(model.eval(), QCFG,
                           PlanGenProcessor(tok, image_tokens=QCFG.image_seq_len, gen=gen))
    assert port._quantized_cache
    decoded = {}
    _recording_text_decode(port, decoded, "port")
    _recording_text_decode(jax_pipe, decoded, "jax")
    prep = port.prepare_plan(captions)
    plain = (im.int4_matmul_w4a8_reference if mode == "int4_a8"
             else im.int4_matmul_w16_reference)
    calls = plain.calls
    got_plan = port.plan_from_prepared(prep)
    calls = plain.calls - calls
    got = decoded["port"]
    assert jax_pipe.plan(captions) == got_plan
    np.testing.assert_array_equal(got, decoded["jax"])
    L = QCFG.llama.num_layers
    B, P, _ = prep["embeds"].shape
    steps = text_decode_steps(got, tok.special.eos_id)
    prefill = 4 * L if B * P <= im.MAX_KERNEL_ROWS else 0
    assert calls == steps * (4 * L + 1) + prefill


# ------------------------------------------- K2 / K4 plans at lm_head's shape

@pytest.mark.parametrize("R", [1, 4, 8])
def test_lm_head_plans_at_janus_pro_1b(R):
    """lm_head (2048 -> 102400, O/2 = 51200) at the text decode's R rows:
    400 column blocks already fill the 132 SMs of an H100, so neither K2
    nor K4 splits the input dim, and both run one n-tile on the tensor
    cores within the shared-memory limit."""
    cfg = PlanGenModelConfig().llama
    I, OH = cfg.hidden_size, cfg.vocab_size // 2
    assert (I, OH) == (2048, 51200)
    for plan in (im.w16_plan(R, I, OH, torch.bfloat16, 132), im.a8_plan(R, I, OH, 132)):
        assert plan.route == "tensor_cores"
        assert plan.grid == (400, 1, 1) and plan.ksplit == 1
        assert plan.row_tiles == 1 and plan.tiles_per_split == -(-I // plan.k_tile)
        assert [list(r) for r in plan.split_ranges(I)] == [list(range(plan.tiles_per_split))]
        assert plan.smem_bytes <= im.SHARED_MEMORY_LIMIT
