"""The port's decode loop and layout-to-image pipeline against the JAX package.

Same weights (JAX `vlm.init`, fp32, through `load_jax_params`), same
prompts. Greedy (temperature 0) and teacher-forced token streams must be
equal token for token: to the JAX loop with the Pallas prefix kernel
(`paged=True`, interpret mode) and with its default segmented
`growing_cache=True`. Sampled runs are compared at the level of
probabilities, since the torch and JAX random streams differ.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import plangen_tpu.ops.pallas_decode_attention as pda
from plangen_tpu.config import GenerationConfig, PlanGenModelConfig
from plangen_tpu.models import vlm as jvlm
from plangen_tpu.ops.sampling import cfg_combine as jcfg_combine
from plangen_tpu.runtime import generate as jgen
from plangen_tpu.runtime.kvcache import init_kv_cache as jinit_kv_cache
from plangen_tpu.tasks.pipeline import PlanGenPipeline as JaxPipeline
from plangen_tpu.tasks.processor import PlanGenProcessor as JaxProcessor
from plangen_tpu.text.tokenizer import ByteFallbackTokenizer
from plangen_tpu_torch.convert import load_jax_params
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.ops.sampling import cfg_combine, sample_categorical
from plangen_tpu_torch.runtime.generate import (
    cache_length, generate_image_tokens, prefill,
)
from plangen_tpu_torch.runtime.kvcache import init_kv_cache
from plangen_tpu_torch.tasks.pipeline import PlanGenPipeline
from plangen_tpu_torch.tasks.processor import PlanGenProcessor

CONFIGS = {"tiny": PlanGenModelConfig.tiny(), "tiny_7b": PlanGenModelConfig.tiny_7b()}
NUM_TOKENS = 6
CFG_WEIGHT = 5.0


@functools.lru_cache(maxsize=None)
def _load(name):
    cfg = CONFIGS[name]
    params = jvlm.init(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    model = PlanGenModel(cfg, dtype=torch.float32)
    load_jax_params(model, params, cfg)
    return cfg, params, model.eval()


@functools.lru_cache(maxsize=None)
def _prompt(name):
    """A left-padded CFG dual batch: embeds [4, 10, H], mask [4, 10 + N]."""
    cfg, params, _ = _load(name)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg.llama.vocab_size, size=(4, 10))
    mask = np.ones((4, 10 + NUM_TOKENS), dtype=np.int32)
    mask[1, :2] = 0
    mask[2, :4] = 0
    mask[3, :1] = 0
    embeds = np.array(jvlm.embed_text(params, jnp.asarray(ids)))  # writable copy
    return embeds, mask


def _jax_tokens(name, gt=None, regen=None, **kw):
    cfg, params, _ = _load(name)
    embeds, mask = _prompt(name)
    out = jgen.generate_image_tokens(
        params, cfg, jnp.asarray(embeds), jnp.asarray(mask),
        rng=jax.random.PRNGKey(0), cfg_weight=jnp.float32(CFG_WEIGHT),
        temperature=jnp.float32(0.0),
        gt_tokens=None if gt is None else jnp.asarray(gt),
        regen_mask=None if regen is None else jnp.asarray(regen),
        num_tokens=NUM_TOKENS, **kw,
    )
    return np.asarray(out.tokens)


def _port_tokens(name, gt=None, regen=None):
    cfg, _, model = _load(name)
    embeds, mask = _prompt(name)
    out = generate_image_tokens(
        model, cfg, torch.from_numpy(embeds), torch.from_numpy(mask),
        generator=None, cfg_weight=CFG_WEIGHT, temperature=0.0,
        gt_tokens=None if gt is None else torch.from_numpy(gt),
        regen_mask=None if regen is None else torch.from_numpy(regen),
        num_tokens=NUM_TOKENS,
    )
    return out.numpy()


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the JAX loop's Pallas prefix kernel in interpret mode (CPU)."""
    monkeypatch.setattr(
        pda, "prefix_decode_attention",
        functools.partial(pda.prefix_decode_attention, interpret=True),
    )


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_greedy_tokens_equal_jax_paged(name, pallas_interpret):
    np.testing.assert_array_equal(_port_tokens(name), _jax_tokens(name, paged=True))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_greedy_tokens_equal_jax_growing_cache(name):
    np.testing.assert_array_equal(_port_tokens(name),
                                  _jax_tokens(name, growing_cache=True))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("forcing", ["full", "partial"])
def test_teacher_forced_tokens_equal_jax(name, forcing):
    cfg = CONFIGS[name]
    rs = np.random.RandomState(1)
    gt = rs.randint(0, cfg.image_token_size, size=(2, NUM_TOKENS)).astype(np.int32)
    if forcing == "full":
        regen = np.zeros((2, NUM_TOKENS), dtype=np.int32)
    else:
        regen = np.array([[1, 0, 1, 1, 0, 0], [0, 0, 1, 0, 1, 1]], dtype=np.int32)
    got = _port_tokens(name, gt, regen)
    np.testing.assert_array_equal(got, _jax_tokens(name, gt, regen, growing_cache=True))
    np.testing.assert_array_equal(got[regen == 0], gt[regen == 0])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step0_sampling_probabilities_equal_jax(name):
    """The step-0 CFG-combined softmax(logits / T) after prefill: the
    distribution the first token is drawn from."""
    cfg, params, model = _load(name)
    embeds, mask = _prompt(name)
    temperature = 1.0  # the main path's default
    L = embeds.shape[1]
    S = cache_length(L, NUM_TOKENS)
    full_mask = np.concatenate([mask, np.zeros((4, S - mask.shape[1]), np.int32)], 1)
    jcache = jinit_kv_cache(cfg.llama, 4, S, dtype=jnp.float32)
    jlast, _ = jgen.prefill(params, cfg, jnp.asarray(embeds), jnp.asarray(full_mask), jcache)
    jlogits = jcfg_combine(jvlm.image_gen_logits(params, jlast), CFG_WEIGHT)
    want = np.asarray(jax.nn.softmax(jlogits / temperature, axis=-1))

    cache = init_kv_cache(cfg.llama, 4, S, dtype=torch.float32)
    with torch.no_grad():
        last = prefill(model, torch.from_numpy(embeds), torch.from_numpy(full_mask), cache)
        logits = cfg_combine(model.image_gen_logits(last), CFG_WEIGHT)
        got = torch.softmax(logits / temperature, dim=-1).numpy()
    # atol 1e-6, plus rtol 1e-5 for the large probabilities: fp32 summation
    # differences in the logits (~1e-7 relative) are multiplied by the CFG
    # weight (5) before the softmax
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def test_per_row_generators_independent_of_batch():
    """A row's draws depend only on its own generator: the same alone as in
    a batch of 3, step after step."""
    rs = np.random.RandomState(2)
    logits = torch.from_numpy(rs.randn(5, 3, 64).astype(np.float32))
    seeds = [7, 8, 9]
    gens = [torch.Generator().manual_seed(s) for s in seeds]
    alone = torch.Generator().manual_seed(seeds[1])
    for step in range(5):
        batch = sample_categorical(logits[step], 1.0, gens)
        single = sample_categorical(logits[step, 1:2], 1.0, [alone])
        assert batch[1].item() == single[0].item(), step


def test_sampling_matches_its_probabilities():
    """Empirical frequencies of the fp32 draw follow softmax(logits / T)."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]])
    probs = torch.softmax(logits / 0.5, dim=-1)[0]
    g = torch.Generator().manual_seed(0)
    draws = torch.cat([sample_categorical(logits, 0.5, g) for _ in range(4000)])
    freq = torch.bincount(draws, minlength=4).float() / len(draws)
    torch.testing.assert_close(freq, probs, atol=0.03, rtol=0)
    assert sample_categorical(logits, 0.0, None).item() == 0  # argmax


# ------------------------------------------------------------ the pipeline

CAPTIONS = ["a cat", "two dogs on the grass"]
GROUNDINGS = [
    "<grounding><ref>cat</ref><box>[100, 100, 500, 500]</box></grounding>",
    "<grounding><ref>dog</ref><box>[0, 0, 480, 500]</box>"
    "<ref>dog</ref><box>[520, 500, 900, 900]</box></grounding>",
]


def _pipelines(**gen_kw):
    cfg, params, model = _load("tiny")
    gen = GenerationConfig(temperature=0.0, **gen_kw)
    tok = ByteFallbackTokenizer(vocab_size=cfg.llama.vocab_size)
    jax_pipe = JaxPipeline(params, cfg, JaxProcessor(tok, image_tokens=cfg.image_seq_len, gen=gen),
                           compute_dtype=jnp.float32)
    port = PlanGenPipeline(model, cfg, PlanGenProcessor(tok, image_tokens=cfg.image_seq_len, gen=gen))
    return jax_pipe, port


@pytest.mark.parametrize("kw", [dict(seed=3), dict(seeds=[5, 6], parallel_size=2)],
                         ids=["seed", "seeds_ps2"])
def test_layout_to_image_equals_jax(kw):
    jax_pipe, port = _pipelines()
    want = jax_pipe.layout_to_image(CAPTIONS, GROUNDINGS, **kw)
    got = port.layout_to_image(CAPTIONS, GROUNDINGS, **kw)
    np.testing.assert_array_equal(got.image_tokens, want.image_tokens)
    assert got.images.dtype == np.float32
    np.testing.assert_allclose(got.images, want.images, atol=1e-4)
    assert got.groundings == list(GROUNDINGS)


def test_layout_to_image_uint8_equals_jax():
    jax_pipe, port = _pipelines(output_uint8=True)
    want = jax_pipe.layout_to_image(CAPTIONS[:1], GROUNDINGS[:1], seed=1)
    got = port.layout_to_image(CAPTIONS[:1], GROUNDINGS[:1], seed=1)
    np.testing.assert_array_equal(got.image_tokens, want.image_tokens)
    assert got.images.dtype == np.uint8
    assert np.abs(got.images.astype(int) - np.asarray(want.images).astype(int)).max() <= 1


def test_sampled_layout_to_image_is_reproducible_per_seed():
    cfg, _, model = _load("tiny")
    tok = ByteFallbackTokenizer(vocab_size=cfg.llama.vocab_size)
    port = PlanGenPipeline(model, cfg, PlanGenProcessor(
        tok, image_tokens=cfg.image_seq_len, gen=GenerationConfig(temperature=1.0)))
    a = port.layout_to_image(CAPTIONS, GROUNDINGS, seeds=[1, 2])
    b = port.layout_to_image(CAPTIONS, GROUNDINGS, seeds=[1, 2])
    np.testing.assert_array_equal(a.image_tokens, b.image_tokens)
    assert a.image_tokens.min() >= 0 and a.image_tokens.max() < cfg.image_token_size


@pytest.mark.parametrize("option", [
    dict(quantize="int2"), dict(kv_a8=True, quantize="int8"),
], ids=["quantize", "kv_a8"])
def test_unported_options_raise(option):
    """The option the port lacks (`kv_a8`) raises; so does a quantize value
    outside the modes (every mode of the JAX package, 'auto' included, is
    ported; `fast_edit` too, tests/test_torch_fast_edit.py; `speculative`
    and `jacobi`, tests/test_torch_speculative.py and test_torch_jacobi.py)."""
    cfg, _, model = _load("tiny")
    tok = ByteFallbackTokenizer(vocab_size=cfg.llama.vocab_size)
    proc = PlanGenProcessor(tok, image_tokens=cfg.image_seq_len)
    with pytest.raises(NotImplementedError):
        PlanGenPipeline(model, cfg, proc, gen_cfg=GenerationConfig(**option))


def _gt_inputs(n=1):
    cfg = CONFIGS["tiny"]
    rs = np.random.RandomState(3)
    size = cfg.vision.image_size
    gt = rs.uniform(-1, 1, size=(n, size, size, 3)).astype(np.float32)
    region = (rs.uniform(size=(n, cfg.image_seq_len)) > 0.5).astype(np.int32)
    return gt, region


@pytest.mark.parametrize("how", ["argument", "config"])
def test_gt_images_ignored_without_teacher_forcing(how):
    """As the JAX pipeline does (`plangen_tpu/tasks/pipeline.py:319-321`):
    without teacher forcing, `gt_images` and `edit_region` are ignored and
    the call returns the tokens of the same call without them. `argument`:
    `teacher_forcing=False` over a config that asks for it; `config`:
    `use_teacher_forcing=False` and no argument."""
    jax_pipe, port = _pipelines(use_teacher_forcing=(how == "argument"))
    gt, region = _gt_inputs(len(CAPTIONS))
    kw = dict(seeds=[5, 6])
    tf = dict(teacher_forcing=False) if how == "argument" else {}
    plain = port.layout_to_image(CAPTIONS, GROUNDINGS, **kw, **tf)
    got = port.layout_to_image(CAPTIONS, GROUNDINGS, gt_images=gt, edit_region=region,
                               **kw, **tf)
    np.testing.assert_array_equal(got.image_tokens, plain.image_tokens)
    np.testing.assert_array_equal(got.images, plain.images)
    want = jax_pipe.layout_to_image(CAPTIONS, GROUNDINGS, gt_images=gt, edit_region=region,
                                    **kw, **tf)
    np.testing.assert_array_equal(got.image_tokens, want.image_tokens)


@pytest.mark.parametrize("method", [
    "layout_to_image", "prepare_layout_to_image", "plan", "prepare_plan",
    "plan_from_prepared", "understand", "prepare_understand", "understand_from_prepared",
    "joint_generate", "edit_image",
])
def test_pipeline_signature_equals_jax(method):
    import inspect

    want = inspect.signature(getattr(JaxPipeline, method)).parameters
    got = inspect.signature(getattr(PlanGenPipeline, method)).parameters
    assert list(got) == list(want)
    assert [p.default for p in got.values()] == [p.default for p in want.values()]


def test_generation_output_fields_equal_jax():
    import dataclasses

    from plangen_tpu.tasks.pipeline import GenerationOutput as JaxOutput
    from plangen_tpu_torch.tasks.pipeline import GenerationOutput

    assert ([f.name for f in dataclasses.fields(GenerationOutput)]
            == [f.name for f in dataclasses.fields(JaxOutput)])
