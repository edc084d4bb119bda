"""The port's quantized serving forms against the JAX package (CPU).

The lane-aligned small config of tests/test_int4.py (hidden 256,
intermediate 512, 2 heads x 128, vocab 1024, 32 px images -> 4 image
tokens, codebook 256): the JAX int4 kernel needs O/2 % 128 == 0. JAX runs
its Pallas kernels in interpret mode, the port its plain versions.

  * the LLaMA stack (prefill + 3 decode steps over the int8 cache) for
    int4, int4_a8, int8 and int8_kv (bf16 weights), fp32 atol 1e-5;
  * `quantize_model_` equals a load of JAX's quantized tree, buffer for
    buffer;
  * the decode loop: temperature-0 and teacher-forced tokens equal JAX's
    for every mode, against both `growing_cache` settings;
  * `PlanGenPipeline(quantize="int4").layout_to_image` gives JAX's tokens
    and pixels; `kv_a8` builds and decodes; the inconsistent settings
    raise;
  * one bf16 prefill + decode step within rtol 2e-2 of JAX bf16.
"""

import copy
import dataclasses
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
from plangen_tpu.models import llama as jllama
from plangen_tpu.models import vlm as jvlm
from plangen_tpu.ops import pallas_int4_matmul as jint4
from plangen_tpu.ops import quant as jquant
from plangen_tpu.runtime import generate as jgen
from plangen_tpu.runtime.kvcache import init_kv_cache as jinit_kv_cache
from plangen_tpu.tasks.pipeline import PlanGenPipeline as JaxPipeline
from plangen_tpu.tasks.processor import PlanGenProcessor as JaxProcessor
from plangen_tpu.text.tokenizer import ByteFallbackTokenizer
from plangen_tpu_torch.convert import load_jax_params, load_jax_quantized_params
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.ops import decode_attention as da
from plangen_tpu_torch.ops import int4_matmul as im
from plangen_tpu_torch.ops.quant import Int4Linear, Int8Linear, quant_form, quantize_model_
from plangen_tpu_torch.runtime.generate import generate_image_tokens
from plangen_tpu_torch.runtime.kvcache import init_kv_cache
from plangen_tpu_torch.tasks.pipeline import PlanGenPipeline
from plangen_tpu_torch.tasks.processor import PlanGenProcessor

CFG = PlanGenModelConfig(
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
MODES = ("int4", "int4_a8", "int8", "int8_kv")
# The int8 KV cache (and int4_a8's per-row int8 activations) round fp32
# values to int8 codes. Where torch and XLA differ by one fp32 ulp upstream
# (summation orders of rms_norm, matmuls, softmax), a code can round the
# other way; one flipped code moves the hidden states by ~1e-3 at these
# scales (scale / 127 times a weight). So the stack is held to 1e-5 when no
# code differs, and to FLIP_ATOL when a few do, each by one step (checked on
# the cache). The int8 math itself is bit-exact (tests/test_torch_quant.py)
# and the token streams equal JAX's below.
FLIP_ATOL = 5e-3
MAX_FLIPPED_CODES = 8
NUM_TOKENS = 6
CFG_WEIGHT = 5.0


@functools.lru_cache(maxsize=None)
def _params():
    return jvlm.init(jax.random.PRNGKey(0), CFG, dtype=jnp.float32)


def _jax_int4(params, act_int8=False):
    """JAX's int4 tree as its pipeline quantizes it (`tasks/eval.py`:
    under jax.jit, the scale a product by the float32 reciprocal of 7),
    which `quantize_model_` follows."""
    return jax.jit(functools.partial(jquant.quantize_lm_params_int4, act_int8=act_int8))(params)


def _jax_quantized(params, mode):
    if mode == "int8":
        return jquant.quantize_lm_params(params)
    if mode in ("int4", "int4_a8"):
        return _jax_int4(params, act_int8=mode == "int4_a8")
    return params  # int8_kv: bf16 weights, int8 cache


@functools.lru_cache(maxsize=None)
def _pair(mode):
    """(JAX params in `mode`, the port model quantized in place to `mode`)."""
    params = _params()
    model = PlanGenModel(CFG, dtype=torch.float32)
    load_jax_params(model, params, CFG)
    quantize_model_(model, mode)
    return _jax_quantized(params, mode), model.eval()


@functools.lru_cache(maxsize=None)
def _prompt():
    """A left-padded CFG dual batch: embeds [4, 10, 256], mask [4, 10 + N]."""
    rs = np.random.RandomState(0)
    ids = rs.randint(0, CFG.llama.vocab_size, size=(4, 10))
    mask = np.ones((4, 10 + NUM_TOKENS), dtype=np.int32)
    mask[1, :2] = 0
    mask[2, :4] = 0
    mask[3, :1] = 0
    embeds = np.array(jvlm.embed_text(_params(), jnp.asarray(ids)))
    return embeds, mask


# -------------------------------------------------------------- the stack


@pytest.fixture
def jax_int4_through_references(monkeypatch):
    """JAX's int4 matmul through its own XLA references
    (`int4_matmul_reference`, `int4_matmul_a8_reference`) at the kernel
    route's row counts. In fp32 the Pallas kernel's two-matmul form is off
    that reference by ~1e-5 (cancellation in y1 - y2), and the int8 KV
    cache turns differences of that size into flipped K/V codes, so a
    hidden-state comparison at 1e-5 holds only against the reference. The
    kernel itself is held by tests/test_torch_quant.py and by the token
    tests below."""
    dense = jint4.int4_matmul

    def through_reference(x, q, layer=None, interpret=None):
        if x.reshape(-1, x.shape[-1]).shape[0] > im.MAX_KERNEL_ROWS:
            return dense(x, q, layer=layer, interpret=interpret)
        ref = jint4.int4_matmul_a8_reference if "a8" in q else jint4.int4_matmul_reference
        return ref(x, q, layer=0 if layer is None else layer)

    monkeypatch.setattr(jint4, "int4_matmul", through_reference)


@pytest.mark.parametrize("mode", MODES)
def test_llama_stack_over_int8_cache_matches_jax(mode, jax_int4_through_references):
    """Prefill (40 rows: the kernel route of the int4 matmul) and 3 decode
    steps, each writing quantized K/V rows; every step's hidden states."""
    jparams, model = _pair(mode)
    embeds, mask = _prompt()
    B, L, _ = embeds.shape
    S = 128
    full = np.concatenate([mask, np.zeros((B, S - mask.shape[1]), np.int32)], 1)
    rs = np.random.RandomState(1)
    steps = rs.randn(3, B, 1, CFG.llama.hidden_size).astype(np.float32)
    lm = jparams["language_model"]
    # jitted, as JAX's prefill and decode run it (its quantize_kv then
    # scales by the float32 reciprocal of 127, as the port's does)
    jforward = jax.jit(lambda p, x, m, pos, c: jllama.forward(p, CFG.llama, x, m,
                                                              positions=pos, kv_cache=c))
    jcache = jinit_kv_cache(CFG.llama, B, S, dtype=jnp.float32, quantized=True)
    jh, jcache = jforward(lm, jnp.asarray(embeds), jnp.asarray(full),
                          jnp.arange(L, dtype=jnp.int32), jcache)
    want = [np.asarray(jh)]
    for i, step in enumerate(steps):
        jh, jcache = jforward(lm, jnp.asarray(step), jnp.asarray(full),
                              jnp.array([L + i], jnp.int32), jcache)
        want.append(np.asarray(jh))

    cache = init_kv_cache(CFG.llama, B, S, dtype=torch.float32, quantized=True)
    tm = torch.from_numpy(full)
    with torch.no_grad():
        got = [model.language_model(torch.from_numpy(embeds), tm,
                                    torch.arange(L, dtype=torch.int32), cache).numpy()]
        for i, step in enumerate(steps):
            got.append(model.language_model(
                torch.from_numpy(step), tm, torch.tensor([L + i], dtype=torch.int32),
                cache).numpy())
    flipped = 0
    for name in ("k", "v"):
        assert cache[name].dtype == torch.int8
        diff = np.abs(cache[name].numpy().astype(int) - np.asarray(jcache[name]).astype(int))
        assert diff.max() <= 1, (name, diff.max())
        flipped += int(diff.sum())
        np.testing.assert_allclose(cache[name + "_scale"].numpy(),
                                   np.asarray(jcache[name + "_scale"]), rtol=1e-5, atol=0)
    assert flipped <= MAX_FLIPPED_CODES, flipped
    valid = full[:, :L].astype(bool)  # pad-position outputs are not compared
    atol = FLIP_ATOL if flipped or mode == "int4_a8" else 1e-5
    np.testing.assert_allclose(got[0][valid], want[0][valid], atol=atol, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


@pytest.mark.parametrize("mode", ["int4", "int4_a8", "int8"])
def test_quantize_model_equals_loaded_jax_tree(mode):
    """The port's in-place quantization and a load of JAX's quantized tree
    (`quantize_lm_params[_int4]`, stacked and fused leaves) give the same
    buffers and parameters, byte for byte."""
    jparams, quantized = _pair(mode)
    loaded = PlanGenModel(CFG, dtype=torch.float32)
    skipped = load_jax_quantized_params(loaded, jparams, CFG)
    assert skipped == []  # every exported key loads, SigLIP and the VQ encoder included
    assert quant_form(loaded) == mode
    a, b = quantized.state_dict(), loaded.state_dict()
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        torch.testing.assert_close(a[name], b[name], rtol=0, atol=0, msg=name)
    kind = Int8Linear if mode == "int8" else Int4Linear
    layer = loaded.language_model.model.layers[0]
    names = ({"q_proj", "k_proj", "v_proj", "o_proj"} if mode == "int8"
             else {"qkv_proj", "o_proj"})
    assert {n for n, m in layer.self_attn.named_children() if isinstance(m, kind)} == names
    assert isinstance(loaded.gen_head.vision_head, kind)
    assert isinstance(loaded.gen_head.output_mlp_projector, torch.nn.Linear)


def test_quantized_loader_refuses_a_model_of_another_form():
    jparams, _ = _pair("int4")
    _, model = _pair("int8")
    with pytest.raises(ValueError, match="int8-quantized"):
        load_jax_quantized_params(copy.deepcopy(model), jparams, CFG)
    with pytest.raises(ValueError, match="not quantized"):
        load_jax_quantized_params(PlanGenModel(CFG, dtype=torch.float32), _params(), CFG)


def test_gqa_fuses_only_k_and_v():
    """Under GQA (kv narrower than q) the int4 form fuses the k|v pair and
    keeps q_proj, as INT4_FUSED_GROUPS falls through in JAX."""
    cfg = dataclasses.replace(CFG, llama=dataclasses.replace(CFG.llama, num_heads=4,
                                                             num_kv_heads=2))
    params = jvlm.init(jax.random.PRNGKey(1), cfg, dtype=jnp.float32)
    model = PlanGenModel(cfg, dtype=torch.float32)
    load_jax_params(model, params, cfg)
    quantize_model_(model, "int4")
    attn = model.language_model.model.layers[0].self_attn
    assert {n for n, _ in attn.named_children()} == {"q_proj", "k_v_proj", "o_proj"}
    loaded = PlanGenModel(cfg, dtype=torch.float32)
    load_jax_quantized_params(loaded, _jax_int4(params), cfg)
    for name, t in model.state_dict().items():
        torch.testing.assert_close(t, loaded.state_dict()[name], rtol=0, atol=0, msg=name)


# ------------------------------------------------------------- the loop


def _jax_tokens(mode, growing, gt=None, regen=None):
    jparams, _ = _pair(mode)
    embeds, mask = _prompt()
    out = jgen.generate_image_tokens(
        jparams, CFG, jnp.asarray(embeds), jnp.asarray(mask),
        rng=jax.random.PRNGKey(0), cfg_weight=jnp.float32(CFG_WEIGHT),
        temperature=jnp.float32(0.0),
        gt_tokens=None if gt is None else jnp.asarray(gt),
        regen_mask=None if regen is None else jnp.asarray(regen),
        num_tokens=NUM_TOKENS, quantized_cache=True, growing_cache=growing,
    )
    return np.asarray(out.tokens)


def _port_tokens(mode, gt=None, regen=None):
    _, model = _pair(mode)
    embeds, mask = _prompt()
    out = generate_image_tokens(
        model, CFG, torch.from_numpy(embeds), torch.from_numpy(mask),
        generator=None, cfg_weight=CFG_WEIGHT, temperature=0.0,
        gt_tokens=None if gt is None else torch.from_numpy(gt),
        regen_mask=None if regen is None else torch.from_numpy(regen),
        num_tokens=NUM_TOKENS, quantized_cache=True,
    )
    return out.numpy()


@functools.lru_cache(maxsize=None)
def _port_greedy(mode):
    """(the port's greedy tokens, its K1-q8 plain calls): one loop for both
    JAX cache forms, so their two cases share its decode."""
    calls = da.prefix_decode_attention_q8_reference.calls
    got = _port_tokens(mode)
    return got, da.prefix_decode_attention_q8_reference.calls - calls


@pytest.mark.parametrize("growing", [True, False], ids=["growing_cache", "fixed_cache"])
@pytest.mark.parametrize("mode", MODES)
def test_greedy_tokens_equal_jax(mode, growing):
    got, calls = _port_greedy(mode)
    # every decode step's attention read the int8 cache through K1-q8
    assert calls == NUM_TOKENS * CFG.llama.num_layers
    np.testing.assert_array_equal(got, _jax_tokens(mode, growing))


@pytest.mark.parametrize("mode", MODES)
def test_teacher_forced_tokens_equal_jax(mode):
    rs = np.random.RandomState(1)
    gt = rs.randint(0, CFG.image_token_size, size=(2, NUM_TOKENS)).astype(np.int32)
    regen = np.array([[1, 0, 1, 1, 0, 0], [0, 0, 1, 0, 1, 1]], dtype=np.int32)
    got = _port_tokens(mode, gt, regen)
    np.testing.assert_array_equal(got, _jax_tokens(mode, True, gt, regen))
    np.testing.assert_array_equal(got[regen == 0], gt[regen == 0])


@pytest.mark.parametrize("mode", ["int4", "int4_a8"])
def test_decode_step_projections_take_the_kernel_route(mode):
    """Each of the N steps runs gen_head.fc2 and 4 int4 matmuls per layer
    (q|k|v, o, gate|up, down) through the K2 (or K4) wrapper; the 40-row
    prefill takes the kernel route too (<= 256 rows)."""
    plain = (im.int4_matmul_w4a8_reference if mode == "int4_a8"
             else im.int4_matmul_w16_reference)
    calls = plain.calls
    _port_tokens(mode)
    per_step = 4 * CFG.llama.num_layers + 1
    assert plain.calls - calls == NUM_TOKENS * per_step + 4 * CFG.llama.num_layers


# ---------------------------------------------------------- the pipeline

CAPTIONS = ["a cat", "two dogs on the grass"]
GROUNDINGS = [
    "<grounding><ref>cat</ref><box>[100, 100, 500, 500]</box></grounding>",
    "<grounding><ref>dog</ref><box>[0, 0, 480, 500]</box>"
    "<ref>dog</ref><box>[520, 500, 900, 900]</box></grounding>",
]


def _dense_model():
    model = PlanGenModel(CFG, dtype=torch.float32)
    load_jax_params(model, _params(), CFG)
    return model.eval()


def _procs(gen):
    tok = ByteFallbackTokenizer(vocab_size=CFG.llama.vocab_size)
    return (JaxProcessor(tok, image_tokens=CFG.image_seq_len, gen=gen),
            PlanGenProcessor(tok, image_tokens=CFG.image_seq_len, gen=gen))


@pytest.mark.parametrize("mode", ["int4", "int8_kv"])
def test_quantized_layout_to_image_equals_jax(mode):
    """The pipeline quantizes its dense model in place at construction (the
    JAX package's eval.build_pipeline quantizes the tree) and decodes over
    the int8 cache: JAX's tokens, pixels within 1e-4."""
    gen = GenerationConfig(temperature=0.0, quantize=mode)
    jproc, proc = _procs(gen)
    jax_pipe = JaxPipeline(_jax_quantized(_params(), mode), CFG, jproc,
                           compute_dtype=jnp.float32)
    port = PlanGenPipeline(_dense_model(), CFG, proc)
    assert quant_form(port.model) == (None if mode == "int8_kv" else mode)
    assert port._quantized_cache
    want = jax_pipe.layout_to_image(CAPTIONS, GROUNDINGS, seed=3)
    got = port.layout_to_image(CAPTIONS, GROUNDINGS, seed=3)
    np.testing.assert_array_equal(got.image_tokens, want.image_tokens)
    np.testing.assert_allclose(got.images, want.images, atol=1e-4)


def test_prequantized_model_engages_its_form():
    """quantize=None on an int4 model: the pipeline serves it as int4 over
    the int8 cache (eval.build_pipeline's pre-quantized artifact rule)."""
    _, proc = _procs(GenerationConfig(temperature=0.0))
    model = quantize_model_(_dense_model(), "int4_a8")
    pipe = PlanGenPipeline(model, CFG, proc)
    assert pipe.gen.quantize == "int4_a8" and pipe._quantized_cache
    out = pipe.layout_to_image(CAPTIONS[:1], GROUNDINGS[:1], seed=1)
    assert out.image_tokens.shape == (1, CFG.image_seq_len)


@pytest.mark.parametrize("option", [
    dict(quantize="auto", speculative=True),
    dict(quantize="int4", kv_a8=True),
], ids=["auto", "kv_a8"])
def test_unported_quantized_options_raise(option):
    """`speculative` with a quantized form raises the JAX config check's
    ValueError, and so does `kv_a8` without a quantized form or with
    `speculative`, before the model is quantized (or, under 'auto', before
    its int4 view is built); 'auto' itself is ported
    (tests/test_torch_auto_route.py). `kv_a8` with a quantized form builds
    and decodes: every image decode step through K1-a8 (its plain version
    here), none through K1-q8."""
    _, proc = _procs(GenerationConfig())
    model = _dense_model()
    refused = [option] if "speculative" in option else [
        dict(kv_a8=True), dict(option, speculative=True)]
    for bad in refused:
        with pytest.raises(ValueError):
            PlanGenPipeline(model, CFG, proc, gen_cfg=GenerationConfig(**bad))
        assert quant_form(model) is None  # refused before quantizing anything
    if option in refused:
        return
    pipe = PlanGenPipeline(model, CFG, proc, gen_cfg=GenerationConfig(temperature=0.0,
                                                                      **option))
    assert quant_form(model) == "int4" and pipe._quantized_cache
    a8, q8 = (da.prefix_decode_attention_a8_reference.calls,
              da.prefix_decode_attention_q8_reference.calls)
    out = pipe.layout_to_image(CAPTIONS[:1], GROUNDINGS[:1], seed=1)
    assert out.image_tokens.shape == (1, CFG.image_seq_len)
    assert (da.prefix_decode_attention_a8_reference.calls - a8,
            da.prefix_decode_attention_q8_reference.calls - q8) == (
        CFG.image_seq_len * CFG.llama.num_layers, 0)


@pytest.mark.parametrize("mode", ["int8", "int4", "int8_kv"])
def test_prequantized_model_with_another_mode_raises(mode):
    _, proc = _procs(GenerationConfig())
    model = quantize_model_(_dense_model(), "int4_a8")
    with pytest.raises(ValueError, match="already int4_a8-quantized"):
        PlanGenPipeline(model, CFG, proc, gen_cfg=GenerationConfig(quantize=mode))


# --------------------------------------------------------------------- bf16


def test_bf16_int4_prefill_and_decode_step_logits():
    """bf16 on both sides with int4 weights and the int8 cache: one prefill
    plus one decode step; the gen-head logits agree within rtol 2e-2 of
    their scale."""
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), _params())
    jparams = _jax_int4(params)
    model = PlanGenModel(CFG, dtype=torch.bfloat16)
    load_jax_params(model, params, CFG)
    quantize_model_(model, "int4")
    embeds, mask = _prompt()
    B, L, hidden = embeds.shape
    S = 128
    full = np.concatenate([mask, np.zeros((B, S - mask.shape[1]), np.int32)], 1)
    step = np.random.RandomState(2).randn(B, 1, hidden).astype(np.float32)
    lm = jparams["language_model"]
    jcache = jinit_kv_cache(CFG.llama, B, S, dtype=jnp.bfloat16, quantized=True)
    _, jcache = jllama.forward(lm, CFG.llama, jnp.asarray(embeds, jnp.bfloat16),
                               jnp.asarray(full), positions=jnp.arange(L, dtype=jnp.int32),
                               kv_cache=jcache)
    jh, _ = jllama.forward(lm, CFG.llama, jnp.asarray(step, jnp.bfloat16), jnp.asarray(full),
                           positions=jnp.array([L], jnp.int32), kv_cache=jcache)
    want = np.asarray(jvlm.image_gen_logits(jparams, jh[:, -1]))

    cache = init_kv_cache(CFG.llama, B, S, dtype=torch.bfloat16, quantized=True)
    tm = torch.from_numpy(full)
    with torch.no_grad():
        model.language_model(torch.from_numpy(embeds).bfloat16(), tm,
                             torch.arange(L, dtype=torch.int32), cache)
        th = model.language_model(torch.from_numpy(step).bfloat16(), tm,
                                  torch.tensor([L], dtype=torch.int32), cache)
        got = model.image_gen_logits(th[:, -1]).float().numpy()
    assert got.dtype == np.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-2 * scale, rtol=2e-2)
