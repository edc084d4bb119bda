"""`quantize="auto"` in the port against the JAX package's (CPU, fp32).

The lane-aligned config of tests/test_torch_quant_models.py (the JAX int4
kernel needs O/2 % 128 == 0; JAX runs it in interpret mode, the port its
plain version):

  * `int4_view` shares every module but the int4 targets with the dense
    model, storage and all, and leaves the dense model dense;
  * its codes are within one grid step of JAX's
    `quantize_lm_params_int4_shared`;
  * the pipeline routes at `auto_int4_max_rows`, on the true matmul rows:
    2 x captions x parallel_size for images, the batch for text;
  * with JAX's own `auto` int4 tree carried into the view
    (`load_jax_quantized_params`), each route is token-exact against the
    JAX `auto` pipeline in `plan` and teacher-forced `layout_to_image`;
  * `auto` on a quantized model raises.
"""

import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plangen_tpu.config import GenerationConfig as JaxGenerationConfig
from plangen_tpu.ops import quant as jquant
from plangen_tpu.tasks.pipeline import PlanGenPipeline as JaxPipeline
from plangen_tpu.tasks.processor import PlanGenProcessor as JaxProcessor
from plangen_tpu.text.tokenizer import ByteFallbackTokenizer as JaxByteTokenizer
from plangen_tpu_torch.config import GenerationConfig, PlanGenConfig
from plangen_tpu_torch.convert import load_jax_params, load_jax_quantized_params
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.ops.quant import Int4Linear, int4_view, quant_form, quantize_model_
from plangen_tpu_torch.tasks.eval import build_pipeline
from plangen_tpu_torch.tasks.pipeline import PlanGenPipeline
from plangen_tpu_torch.tasks.processor import PlanGenProcessor
from plangen_tpu_torch.text.tokenizer import ByteFallbackTokenizer

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_quant_models import CAPTIONS, CFG, GROUNDINGS, _params  # noqa: E402

BUDGET = 4


def _dense_model():
    model = PlanGenModel(CFG, dtype=torch.float32)
    load_jax_params(model, _params(), CFG)
    return model.eval()


@functools.lru_cache(maxsize=None)
def _jax_int4():
    return jquant.quantize_lm_params_int4_shared(_params())


def _gen(max_rows=64):
    return dict(quantize="auto", temperature=0.0, max_new_text_tokens=BUDGET,
                auto_int4_max_rows=max_rows)


def _pipelines(max_rows):
    """(JAX auto pipeline, the port's with JAX's int4 codes in its view)."""
    jgen = JaxGenerationConfig(**_gen(max_rows))
    jpipe = JaxPipeline(_params(), CFG, JaxProcessor(
        JaxByteTokenizer(vocab_size=CFG.llama.vocab_size), image_tokens=CFG.image_seq_len,
        gen=jgen), compute_dtype=jnp.float32, params_int4=_jax_int4())
    gen = GenerationConfig(**_gen(max_rows))
    pipe = PlanGenPipeline(_dense_model(), CFG, PlanGenProcessor(
        ByteFallbackTokenizer(vocab_size=CFG.llama.vocab_size),
        image_tokens=CFG.image_seq_len, gen=gen))
    load_jax_quantized_params(pipe.model_int4, _jax_int4(), CFG)
    return jpipe, pipe


def _int4_paths(model):
    return sorted(n for n, m in model.named_modules() if isinstance(m, Int4Linear))


def test_int4_view_shares_every_untouched_module():
    dense = _dense_model()
    before = {k: v.clone() for k, v in dense.state_dict().items()}
    view = int4_view(dense)
    assert quant_form(dense) is None and quant_form(view) == "int4"
    L = CFG.llama.num_layers
    assert _int4_paths(view) == sorted(
        [f"language_model.model.layers.{i}.{sub}" for i in range(L) for sub in (
            "self_attn.qkv_proj", "self_attn.o_proj", "mlp.gate_up_proj", "mlp.down_proj")]
        + ["language_model.lm_head", "gen_head.vision_head"])
    for name in ("vision_model", "gen_vision_model", "aligner", "gen_aligner", "gen_embed"):
        assert getattr(view, name) is getattr(dense, name)
    assert view.language_model.model.embed_tokens is dense.language_model.model.embed_tokens
    assert view.gen_head.output_mlp_projector is dense.gen_head.output_mlp_projector
    assert view.language_model.model.layers[1].input_layernorm is \
        dense.language_model.model.layers[1].input_layernorm
    dense_ptrs = {p.data_ptr() for p in dense.parameters()}
    assert all(p.data_ptr() in dense_ptrs for p in view.parameters())
    after = dense.state_dict()
    assert sorted(after) == sorted(before)
    assert all(torch.equal(after[k], v) for k, v in before.items())


def _nibbles(a):
    a = np.asarray(a).astype(np.int32)
    return a & 0xF, (a >> 4) & 0xF


def test_codes_within_one_grid_step_of_jax_shared():
    view = int4_view(_dense_model())
    jl = _jax_int4()["language_model"]
    pairs = [(view.language_model.model.layers[i].self_attn.qkv_proj.w_p4,
              jl["layers"]["qkv_proj"]["w_p4"][i]) for i in range(CFG.llama.num_layers)]
    pairs += [(view.language_model.model.layers[0].mlp.down_proj.w_p4,
               jl["layers"]["down_proj"]["w_p4"][0]),
              (view.language_model.lm_head.w_p4, jl["lm_head"]["w_p4"]),
              (view.gen_head.vision_head.w_p4, _jax_int4()["gen_head"]["fc2"]["w"]["w_p4"])]
    for got, want in pairs:
        (glo, ghi), (wlo, whi) = _nibbles(got.numpy()), _nibbles(want)
        diff = np.maximum(np.abs(glo - wlo), np.abs(ghi - whi))
        assert diff.max() <= 1 and (diff != 0).mean() < 0.02


def test_routes_at_the_threshold_on_true_row_counts():
    pipe = PlanGenPipeline(_dense_model(), CFG, PlanGenProcessor(
        ByteFallbackTokenizer(vocab_size=CFG.llama.vocab_size),
        image_tokens=CFG.image_seq_len, gen=GenerationConfig(**_gen())))
    thr = pipe.gen.auto_int4_max_rows
    assert thr == 64 and pipe._quantized_cache
    assert pipe._model_for(thr) is pipe.model_int4
    assert pipe._model_for(thr + 1) is pipe.model
    calls = []
    orig = pipe._model_for
    pipe._model_for = lambda n: calls.append(n) or orig(n)
    pipe.layout_to_image(CAPTIONS, GROUNDINGS, seed=1, parallel_size=2)
    assert calls == [2 * 2 * 2]  # 2 captions x parallel_size 2 x the CFG dual
    pipe.plan(["a", "b", "c"])
    assert calls[-1] == 3  # the text decode's rows: the batch


@pytest.mark.parametrize("route", ["int4", "dense"])
def test_each_route_token_exact_against_jax_auto(route):
    jpipe, pipe = _pipelines(max_rows=1000 if route == "int4" else 0)
    rows = 2 * len(CAPTIONS)
    assert (pipe._model_for(rows) is pipe.model_int4) == (route == "int4")
    assert pipe.plan(CAPTIONS) == jpipe.plan(CAPTIONS)
    # teacher-forced: half the image tokens forced to the VQ codes
    rs = np.random.RandomState(7)
    size = CFG.vision.image_size
    gt = rs.uniform(-1, 1, (len(CAPTIONS), size, size, 3)).astype(np.float32)
    region = np.zeros((len(CAPTIONS), CFG.image_seq_len), dtype=np.int32)
    region[:, ::2] = 1
    got = pipe.layout_to_image(CAPTIONS, GROUNDINGS, gt_images=gt, edit_region=region,
                               seed=5, teacher_forcing=True)
    want = jpipe.layout_to_image(CAPTIONS, GROUNDINGS, gt_images=gt, edit_region=region,
                                 seed=5, teacher_forcing=True)
    np.testing.assert_array_equal(got.image_tokens, want.image_tokens)


def test_auto_on_a_quantized_model_raises():
    proc = PlanGenProcessor(ByteFallbackTokenizer(vocab_size=CFG.llama.vocab_size),
                            image_tokens=CFG.image_seq_len)
    model = quantize_model_(_dense_model(), "int4")
    with pytest.raises(ValueError, match="already int4-quantized"):
        PlanGenPipeline(model, CFG, proc, gen_cfg=GenerationConfig(quantize="auto"))
    cfg = PlanGenConfig(model=CFG)
    cfg = dataclasses.replace(cfg, generation=dataclasses.replace(
        cfg.generation, quantize="auto"))
    with pytest.raises(ValueError, match="already int4-quantized"):
        build_pipeline(cfg, model=model, device="cpu")
    with pytest.raises(ValueError, match="quantize='auto' form"):
        PlanGenPipeline(_dense_model(), CFG, proc, model_int4=int4_view(_dense_model()))
