"""`kv_a8` on the CPU: the s8 x s8 decode attention over the int8 KV cache
(K1-a8's plain version) against the JAX package.

  * `_quantize_rows_s8` equals JAX's as the JAX decode runs it (jitted:
    the scale is absmax times the float32 reciprocal of 127) bit for bit,
    codes and scales, ties at .5 included;
  * `dot_product_attention_q8(a8=True)` (the fixed buffer with a bias) and
    `prefix_decode_attention_a8_reference` (the live prefix of the stacked
    cache) against JAX's `dot_product_attention_q8(a8=True)` in fp32, with
    GQA, left pads and q_pos < S - 1, at head_dim 64 and 128;
  * `generate_image_tokens(kv_a8=True, quantized_cache=True)` at
    temperature 0 gives JAX's tokens on `tiny`, against both JAX cache forms;
  * the pipeline with `kv_a8`: `layout_to_image` and teacher-forced
    `edit_image` with `fast_edit`, in `int8` and `int4`, give the JAX
    pipeline's tokens, every image decode step through K1-a8 (its plain
    version here); the text modes are unchanged by the flag; `auto`
    decodes through K1-a8 on both of its routes.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from plangen_tpu.config import GenerationConfig as JaxGenerationConfig
from plangen_tpu.config import (
    LlamaConfig, PlanGenModelConfig, ProjectorConfig, SigLIPConfig, VQConfig,
)
from plangen_tpu.models import vlm as jvlm
from plangen_tpu.ops import attention as jattn
from plangen_tpu.ops import pallas_int4_matmul as jint4
from plangen_tpu.ops import quant as jquant
from plangen_tpu.runtime import generate as jgen
from plangen_tpu.tasks.pipeline import PlanGenPipeline as JaxPipeline
from plangen_tpu.tasks.processor import PlanGenProcessor as JaxProcessor
from plangen_tpu.text.tokenizer import ByteFallbackTokenizer
from plangen_tpu_torch.config import GenerationConfig
from plangen_tpu_torch.config import PlanGenModelConfig as TConfig
from plangen_tpu.convert.torch_to_jax import convert_state_dict
from plangen_tpu_torch.convert import init_params
from plangen_tpu_torch.convert.export import model_state_dict
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.ops import attention as tattn
from plangen_tpu_torch.ops import decode_attention as da
from plangen_tpu_torch.ops import int4_matmul as im
from plangen_tpu_torch.runtime.generate import generate_image_tokens
from plangen_tpu_torch.tasks.pipeline import PlanGenPipeline
from plangen_tpu_torch.tasks.processor import PlanGenProcessor

# ------------------------------------------------------------ the rows


def test_quantize_rows_s8_equals_jax():
    rs = np.random.RandomState(0)
    x = (rs.randn(6, 5, 128) * rs.uniform(0.01, 8, (6, 5, 1))).astype(np.float32)
    # rows whose scale is exactly 1 (absmax 127) with values on .5: round
    # half to even sends 2.5 to 2 and -3.5 to -4
    ties = rs.randint(-126, 126, (5, 128)).astype(np.float32) + 0.5
    ties[:, 0] = 127.0
    x[0] = ties
    x[1, 0] = 0.0  # an all-zero row: scale 1, codes 0
    x[1, 1] = np.float32(1e-30)
    want_q, want_s = (np.asarray(a) for a in jax.jit(jattn._quantize_rows_s8)(jnp.asarray(x)))
    got_q, got_s = tattn._quantize_rows_s8(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    assert (want_q[0, :, 1:] % 2 == 0).all()  # the ties went to even


# -------------------------------------------------------- the attention

L_CACHE, B, S, H, HKV = 2, 3, 256, 4, 2
Q_POS = 200
# The two products are exact integers, so the port and JAX differ only where
# exp and the order of the fp32 softmax sum move a probability across a
# rounding boundary of its int8 code (one code, one step). Read on these
# inputs at seeds 0-11, D 64 and 128: no code differed among ~28,000 nonzero
# ones, and the outputs were within 3.1e-7 relative (the rounding of p_s).
# The bounds leave room for two codes one step apart; a differing code
# moves its row's output by |v8| * p_s <= 127 * p_s.
MAX_DIFFERING_CODES = 2
RTOL_SAME_CODES = 1e-6


def _a8_inputs(D, seed=0, hkv=HKV):
    """q [B, 1, H, D]; the int8 cache [L, B, S, hkv, ...] from JAX's
    quantize_kv; a left-padded mask whose row 2 has no pad."""
    rs = np.random.RandomState(seed)
    q = (rs.randn(B, 1, H, D) * 2).astype(np.float32)
    k = rs.randn(L_CACHE, B, S, hkv, D).astype(np.float32)
    v = rs.randn(L_CACHE, B, S, hkv, D).astype(np.float32)
    parts = [jattn.quantize_kv(jnp.asarray(k[i]), jnp.asarray(v[i])) for i in range(L_CACHE)]
    k8, ks, v8, vs = (np.stack([np.asarray(p[j]) for p in parts]) for j in range(4))
    mask = np.ones((B, S), np.int32)
    mask[0, :5] = 0
    mask[1, :70] = 0
    return q, k8, ks, v8, vs, mask


def _bias(mask):
    return jattn.make_causal_bias(jnp.asarray(mask), jnp.array([Q_POS], jnp.int32),
                                  jnp.arange(S, dtype=jnp.int32))


@jax.jit
def _jax_codes_jitted(q, k8, ks, vs, bias):
    rep = H // HKV
    k8, ks, vs = (jnp.repeat(a, rep, axis=2) for a in (k8, ks, vs))
    q_q8, q_s = jattn._quantize_rows_s8(q)
    logits = jnp.einsum("bqhd,bshd->bhqs", q_q8, k8, preferred_element_type=jnp.int32
                        ).astype(jnp.float32) * q_s.transpose(0, 2, 1, 3)
    logits = logits * ks.transpose(0, 2, 1)[:, :, None, :] * (q.shape[-1] ** -0.5)
    probs = jax.nn.softmax(logits + bias, axis=-1)
    probs = probs * vs.transpose(0, 2, 1)[:, :, None, :]
    return jattn._quantize_rows_s8(probs)[0]


def _jax_codes(q, k8, ks, v8, vs, mask):
    """JAX's dot_product_attention_q8(a8=True) up to its probability codes
    [B, H, S], in its operations, jitted as the JAX decode runs them."""
    codes = _jax_codes_jitted(*(jnp.asarray(a) for a in (q, k8, ks, vs)), _bias(mask))
    return np.asarray(codes)[:, :, 0]


@pytest.mark.parametrize("D", [64, 128])
def test_a8_attention_equals_jax(D):
    q, k8, ks, v8, vs, mask = _a8_inputs(D)
    layer = 1
    want = np.asarray(jax.jit(functools.partial(jattn.dot_product_attention_q8, a8=True))(
        jnp.asarray(q), *(jnp.asarray(a[layer]) for a in (k8, ks, v8, vs)),
        bias=_bias(mask)))  # jitted, as the JAX decode runs it
    t = [torch.from_numpy(a) for a in (q, k8, ks, v8, vs, mask)]
    bias = torch.from_numpy(np.array(_bias(mask)))
    full = tattn.dot_product_attention_q8(t[0], *(a[layer] for a in t[1:5]), bias=bias,
                                          a8=True).numpy()
    live, codes = da.prefix_decode_attention_a8_reference(
        *t, layer, torch.tensor([Q_POS], dtype=torch.int32), return_codes=True)
    live = live.numpy()

    want_codes = _jax_codes(q, k8[layer], ks[layer], v8[layer], vs[layer], mask)
    assert (codes[:, :, Q_POS + 1:] == 0).all()
    diff = np.abs(codes.numpy().astype(int) - want_codes.astype(int))
    # rows (b, h) with the same codes: the output to the rounding of p_s
    same = (diff.sum(-1) == 0)[:, None, :, None]
    p_s = np.abs(want).max() / 127
    for got in (full, live):
        err = np.abs(got - want)
        assert (np.where(same, err, 0) <= RTOL_SAME_CODES * np.abs(want) + 1e-12).all()
        assert err.max() <= 127 * p_s * diff.sum() + 1e-6


def test_a8_wrapper_on_the_cpu_runs_the_plain_version():
    """On CPU tensors the wrapper (MHA, as the kernel takes) runs the
    plain version and fills `codes_out`. A row whose live prefix is all
    pads weighs every live slot alike, the K1 family's rule: its codes are
    one value over [0, q_pos] and 0 past it."""
    q, k8, ks, v8, vs, mask = _a8_inputs(64, hkv=H)
    mask[0, :Q_POS + 1] = 0
    vs[...] = 0.01  # one v_scale, so p * v_scale is one value
    t = [torch.from_numpy(a) for a in (q, k8, ks, v8, vs, mask)]
    q_pos = torch.tensor([Q_POS], dtype=torch.int32)
    calls = da.prefix_decode_attention_a8_reference.calls
    codes = torch.zeros((B, H, S), dtype=torch.int8)
    got = da.prefix_decode_attention_a8(*t, 0, q_pos, codes_out=codes)
    assert da.prefix_decode_attention_a8_reference.calls == calls + 1
    want, want_codes = da.prefix_decode_attention_a8_reference(*t, 0, q_pos,
                                                               return_codes=True)
    assert torch.equal(got, want) and torch.equal(codes, want_codes)
    assert (codes[0, :, :Q_POS + 1] == 127).all() and (codes[:, :, Q_POS + 1:] == 0).all()
    with pytest.raises(ValueError, match="MHA"):  # the kernel's checks hold here too
        da.prefix_decode_attention_a8(*[torch.from_numpy(a) for a in _a8_inputs(64)], 0,
                                      q_pos)


# ------------------------------------------------------------ the loop

TINY = PlanGenModelConfig.tiny()
TTINY = TConfig.tiny()


def _seeded(cfg):
    """A port model at seeded random weights and the same weights as a JAX
    tree, through the JAX package's HF converter (a JAX `init` takes
    seconds to tens of seconds on the CPU)."""
    model = init_params(PlanGenModel(cfg, dtype=torch.float32), torch.Generator().manual_seed(0))
    params = convert_state_dict(model_state_dict(model), cfg, dtype=np.float32)
    return jax.tree_util.tree_map(jnp.asarray, params), model.eval()


@functools.lru_cache(maxsize=None)
def _tiny():
    return _seeded(TTINY)


@functools.lru_cache(maxsize=None)
def _tiny_prompt(n=8):
    """JAX's own kv_a8 test's inputs (tests/test_attn_a8.py): B 2, L 6,
    one pad, n image tokens."""
    params, _ = _tiny()
    ids = jax.random.randint(jax.random.PRNGKey(3), (4, 6), 0, 100)
    embeds = np.asarray(jvlm.embed_text(params, ids), np.float32)
    mask = np.ones((4, 6 + n), dtype=np.int32)
    mask[1, 0] = 0
    return embeds, mask, n


@functools.lru_cache(maxsize=None)
def _port_tiny_tokens():
    _, model = _tiny()
    embeds, mask, n = _tiny_prompt()
    a8, q8 = (da.prefix_decode_attention_a8_reference.calls,
              da.prefix_decode_attention_q8_reference.calls)
    tokens = generate_image_tokens(
        model, TTINY, torch.from_numpy(embeds), torch.from_numpy(mask), None, 5.0, 0.0,
        num_tokens=n, quantized_cache=True, kv_a8=True).numpy()
    return tokens, (da.prefix_decode_attention_a8_reference.calls - a8,
                    da.prefix_decode_attention_q8_reference.calls - q8)


@pytest.mark.parametrize("growing", [False, True], ids=["fixed_cache", "growing_cache"])
def test_greedy_image_tokens_equal_jax(growing):
    params, _ = _tiny()
    embeds, mask, n = _tiny_prompt()
    want = jgen.generate_image_tokens(
        params, TINY, jnp.asarray(embeds), jnp.asarray(mask), rng=jax.random.PRNGKey(0),
        cfg_weight=jnp.float32(5.0), temperature=jnp.float32(0.0), num_tokens=n,
        quantized_cache=True, growing_cache=growing, kv_a8=True).tokens
    got, (a8_calls, q8_calls) = _port_tiny_tokens()
    np.testing.assert_array_equal(got, np.asarray(want))
    # every decode step's attention through K1-a8's plain version, none
    # through K1-q8's
    assert (a8_calls, q8_calls) == (n * TINY.llama.num_layers, 0)


# -------------------------------------------------------- the pipeline

# tests/test_torch_quant_models.py's lane-aligned config: JAX's int4
# kernel needs O/2 % 128 == 0. 32 px images give 4 image tokens.
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
CAPTIONS = ["a cat", "two dogs on the grass"]
GROUNDINGS = [
    "<grounding><ref>cat</ref><box>[100, 100, 500, 500]</box></grounding>",
    "<grounding><ref>dog</ref><box>[0, 0, 480, 500]</box>"
    "<ref>dog</ref><box>[520, 500, 900, 900]</box></grounding>",
]


@functools.lru_cache(maxsize=None)
def _qmodel():
    params, model = _seeded(QCFG)
    return model, params


def _gen(cls, **kw):
    return cls(temperature=0.0, max_new_text_tokens=6, fast_edit=True, **kw)


@functools.lru_cache(maxsize=None)
def _pipelines(mode):
    """(the JAX pipeline over JAX's `mode` tree, the port's pipeline that
    quantizes its own copy in place), both with kv_a8 and `fast_edit`
    (which acts only with teacher forcing) at temperature 0."""
    tok = ByteFallbackTokenizer(vocab_size=QCFG.llama.vocab_size)
    dense, params = _qmodel()
    # as the JAX package's eval.build_pipeline quantizes: int8 eagerly, int4
    # under jax.jit
    jparams = (jquant.quantize_lm_params(params) if mode == "int8"
               else jax.jit(jquant.quantize_lm_params_int4)(params))
    jax_pipe = JaxPipeline(jparams, QCFG, JaxProcessor(
        tok, image_tokens=QCFG.image_seq_len,
        gen=_gen(JaxGenerationConfig, quantize=mode, kv_a8=True)),
        compute_dtype=jnp.float32)
    model = PlanGenModel(QCFG, dtype=torch.float32)
    model.load_state_dict(dense.state_dict())
    port = PlanGenPipeline(model.eval(), QCFG, PlanGenProcessor(
        tok, image_tokens=QCFG.image_seq_len,
        gen=_gen(GenerationConfig, quantize=mode, kv_a8=True)))
    return jax_pipe, port


@pytest.fixture
def jax_int4_through_references(monkeypatch):
    """JAX's int4 matmul through its own XLA reference
    at the kernel route's row counts, as tests/test_torch_quant_models.py
    runs it: the Pallas kernel in interpret mode computes the same function
    at many times the cost."""
    dense = jint4.int4_matmul

    def through_reference(x, q, layer=None, interpret=None):
        if x.reshape(-1, x.shape[-1]).shape[0] > im.MAX_KERNEL_ROWS:
            return dense(x, q, layer=layer, interpret=interpret)
        ref = jint4.int4_matmul_a8_reference if "a8" in q else jint4.int4_matmul_reference
        return ref(x, q, layer=0 if layer is None else layer)

    monkeypatch.setattr(jint4, "int4_matmul", through_reference)


@pytest.mark.parametrize("task", ["layout_to_image", "fast_edit"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_pipeline_tokens_equal_jax(mode, task, jax_int4_through_references):
    """Every image decode step (4 tokens x 2 layers) through K1-a8's plain
    version; in `edit_image` the one chunk of 4 tokens holds a sampled
    position, so `fast_edit` runs it as 4 decode steps."""
    jax_pipe, port = _pipelines(mode)
    a8 = da.prefix_decode_attention_a8_reference.calls
    if task == "layout_to_image":
        want = jax_pipe.layout_to_image(CAPTIONS, GROUNDINGS, seed=3)
        got = port.layout_to_image(CAPTIONS, GROUNDINGS, seed=3)
    else:
        n, size = QCFG.image_seq_len, QCFG.vision.image_size
        images = np.random.RandomState(7).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
        region = np.zeros((2, n), np.int32)
        region[0, 1] = region[1, 3] = 1
        want = jax_pipe.edit_image(CAPTIONS, GROUNDINGS, images, region, seeds=[1, 2])
        got = port.edit_image(CAPTIONS, GROUNDINGS, images, region, seeds=[1, 2])
        np.testing.assert_array_equal(got.edit_mask, want.edit_mask)
    np.testing.assert_array_equal(got.image_tokens, want.image_tokens)
    assert (da.prefix_decode_attention_a8_reference.calls - a8
            == QCFG.image_seq_len * QCFG.llama.num_layers)


def test_text_modes_are_unchanged_by_kv_a8():
    """The text loop takes no kv_a8 (as in JAX): `plan` and `understand` on
    `tiny` in int8 give the same tokens with and without it and never reach
    K1-a8."""
    _, dense = _tiny()
    tok = ByteFallbackTokenizer(vocab_size=TTINY.llama.vocab_size)
    images = np.random.RandomState(5).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    a8 = da.prefix_decode_attention_a8_reference.calls
    runs = []
    for kv_a8 in (True, False):
        model = PlanGenModel(TTINY, dtype=torch.float32)
        model.load_state_dict(dense.state_dict())
        gen = _gen(GenerationConfig, quantize="int8", kv_a8=kv_a8)
        pipe = PlanGenPipeline(model.eval(), TTINY, PlanGenProcessor(
            tok, image_tokens=TTINY.image_seq_len, gen=gen))
        prep = pipe.prepare_plan(CAPTIONS)
        tokens = pipe._text_decode(prep["embeds"], prep["mask"], prep["budget"]).numpy()
        runs.append((tokens, pipe.understand(images).texts))
    assert da.prefix_decode_attention_a8_reference.calls == a8
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]


@pytest.mark.parametrize("n", [1, 2], ids=["int4_view", "dense"])
def test_auto_routes_decode_through_k1_a8(n):
    """`quantize="auto"` with `kv_a8` on `tiny`, its row limit lowered to 2
    CFG rows: one caption takes the int4 view, two the dense model; on both
    routes every image decode step's attention goes through K1-a8 (its
    plain version here), none through K1-q8."""
    _, dense = _tiny()
    model = PlanGenModel(TTINY, dtype=torch.float32)
    model.load_state_dict(dense.state_dict())
    gen = _gen(GenerationConfig, quantize="auto", kv_a8=True, auto_int4_max_rows=2)
    pipe = PlanGenPipeline(model.eval(), TTINY, PlanGenProcessor(
        ByteFallbackTokenizer(vocab_size=TTINY.llama.vocab_size),
        image_tokens=TTINY.image_seq_len, gen=gen))
    assert (pipe._model_for(2 * n) is pipe.model_int4) == (n == 1)
    calls = (da.prefix_decode_attention_a8_reference.calls,
             da.prefix_decode_attention_q8_reference.calls)
    out = pipe.layout_to_image([f"caption {i}" for i in range(n)], [GROUNDINGS[0]] * n,
                               seeds=list(range(n)))
    assert out.image_tokens.shape == (n, TTINY.image_seq_len)
    assert (da.prefix_decode_attention_a8_reference.calls - calls[0],
            da.prefix_decode_attention_q8_reference.calls - calls[1]) == (
        TTINY.image_seq_len * TTINY.llama.num_layers, 0)
