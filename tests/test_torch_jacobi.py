"""The port's Jacobi text decoder (`runtime/jacobi.py`) against the JAX
package's `jacobi_decode_text` and the port's sequential greedy decoder,
on the CPU.

Same weights (JAX `vlm.init`, fp32, through `load_jax_params`), same
left-padded prompts. The tokens equal JAX's Jacobi and the sequential
loop's, with and without an EOS that fires mid-stream, in the same number
of passes; a capped run keeps its shape; `plan` with `jacobi` equals the
sequential `plan`, in the port and against the JAX pipeline.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from plangen_tpu.config import GenerationConfig as JaxGenerationConfig
from plangen_tpu.config import PlanGenModelConfig
from plangen_tpu.models import vlm as jvlm
from plangen_tpu.runtime.jacobi import jacobi_decode_text as jjacobi
from plangen_tpu.tasks.pipeline import PlanGenPipeline as JaxPipeline
from plangen_tpu.tasks.processor import PlanGenProcessor as JaxProcessor
from plangen_tpu.text.tokenizer import ByteFallbackTokenizer as JaxByteTokenizer
from plangen_tpu_torch.config import GenerationConfig
from plangen_tpu_torch.convert import load_jax_params
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.runtime.generate import greedy_decode_text
from plangen_tpu_torch.runtime.jacobi import jacobi_decode_text, sticky_eos
from plangen_tpu_torch.tasks.pipeline import PlanGenPipeline
from plangen_tpu_torch.tasks.processor import PlanGenProcessor
from plangen_tpu_torch.text.tokenizer import ByteFallbackTokenizer

TINY = PlanGenModelConfig.tiny()
T = 10


@functools.lru_cache(maxsize=None)
def _load():
    params = jvlm.init(jax.random.PRNGKey(0), TINY, dtype=jnp.float32)
    model = PlanGenModel(TINY, dtype=torch.float32)
    load_jax_params(model, params, TINY)
    return params, model.eval()


@functools.lru_cache(maxsize=None)
def _prompt(B=3, L=6):
    params, _ = _load()
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, L), 20, 200))
    embeds = np.array(jvlm.embed_text(params, jnp.asarray(ids)), np.float32)
    mask = np.ones((B, L + T), np.int32)
    mask[0, :2] = 0  # a left-padded row
    return embeds, mask


def _port(fn, eos, **kw):
    embeds, mask = _prompt()
    return fn(_load()[1], TINY, torch.from_numpy(embeds), torch.from_numpy(mask), eos,
              max_new_tokens=T, **kw)


def _jax(eos, **kw):
    embeds, mask = _prompt()
    return jjacobi(_load()[0], TINY, jnp.asarray(embeds), jnp.asarray(mask), jnp.int32(eos),
                   max_new_tokens=T, **kw)


def _eos_mid_stream():
    """A token the sequential decoder emits at step 2 of row 0."""
    return int(_port(greedy_decode_text, -1)[0, 2])


@pytest.mark.parametrize("with_eos", [False, True], ids=["no_eos", "eos"])
def test_equals_jax_and_the_sequential_decoder(with_eos):
    eos = _eos_mid_stream() if with_eos else -1
    seq = _port(greedy_decode_text, eos).numpy()
    got, iters = _port(jacobi_decode_text, eos, return_iters=True)
    want, want_iters = _jax(eos, return_iters=True)
    assert got.dtype == torch.int32 and got.shape == (3, T)
    np.testing.assert_array_equal(got.numpy(), seq)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert iters == int(want_iters) and 1 <= iters <= T
    if with_eos:
        assert (seq[0] == eos).any(), "eos must fire for this test"


@pytest.mark.parametrize("max_iters", [1, 3])
def test_capped_iterations_keep_the_shape_and_equal_jax(max_iters):
    got, iters = _port(jacobi_decode_text, -1, max_iters=max_iters, return_iters=True)
    want = _jax(-1, max_iters=max_iters)
    assert got.shape == (3, T) and iters == max_iters
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sticky_eos():
    toks = torch.tensor([[1, 5, 2, 3], [5, 1, 1, 1], [1, 2, 3, 4]], dtype=torch.int32)
    want = [[1, 5, 5, 5], [5, 5, 5, 5], [1, 2, 3, 4]]
    assert sticky_eos(toks, 5).tolist() == want


def test_bad_mask_raises():
    embeds, mask = _prompt()
    with pytest.raises(ValueError, match="attn_mask"):
        jacobi_decode_text(_load()[1], TINY, torch.from_numpy(embeds),
                           torch.from_numpy(mask[:, :-1]), -1, max_new_tokens=T)


def _pipes(jacobi: bool):
    gen = GenerationConfig(max_new_text_tokens=6, jacobi=jacobi)
    proc = PlanGenProcessor(ByteFallbackTokenizer(vocab_size=TINY.llama.vocab_size),
                            image_tokens=TINY.image_seq_len, gen=gen)
    return PlanGenPipeline(_load()[1], TINY, proc, gen_cfg=gen)


def test_plan_with_jacobi_equals_sequential_and_jax(monkeypatch):
    from plangen_tpu_torch.tasks import pipeline as tpipeline

    captions = ["two cats", "a dog on a red sofa"]
    seq = _pipes(False).plan(captions)
    calls = []
    inner = tpipeline.jacobi_decode_text
    monkeypatch.setattr(tpipeline, "jacobi_decode_text",
                        lambda *a, **k: (calls.append(1), inner(*a, **k))[1])
    jac = _pipes(True).plan(captions)
    assert calls == [1] and jac == seq
    gen = JaxGenerationConfig(max_new_text_tokens=6, jacobi=True)
    jproc = JaxProcessor(JaxByteTokenizer(vocab_size=TINY.llama.vocab_size),
                         image_tokens=TINY.image_seq_len, gen=gen)
    assert JaxPipeline(_load()[0], TINY, jproc, gen_cfg=gen).plan(captions) == jac


def test_understand_and_joint_take_jacobi(monkeypatch):
    from plangen_tpu_torch.tasks import pipeline as tpipeline

    calls = []
    inner = tpipeline.jacobi_decode_text
    monkeypatch.setattr(tpipeline, "jacobi_decode_text",
                        lambda *a, **k: (calls.append(1), inner(*a, **k))[1])
    size = TINY.vision.image_size
    images = np.random.RandomState(2).uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    pipe, seq = _pipes(True), _pipes(False)
    assert pipe.understand(images).texts == seq.understand(images).texts
    out = pipe.joint_generate(["a cat"], seeds=[1])
    assert out.groundings == seq.joint_generate(["a cat"], seeds=[1]).groundings
    assert calls == [1, 1]
    assert dataclasses.replace(pipe.gen).jacobi


@pytest.mark.parametrize("quantize", ["int8", "int4", "auto"])
def test_jacobi_with_a_quantized_form_raises_before_quantizing(quantize):
    from plangen_tpu_torch.ops.quant import quant_form

    model = PlanGenModel(TINY, dtype=torch.float32)
    gen = GenerationConfig(jacobi=True, quantize=quantize)
    proc = PlanGenProcessor(ByteFallbackTokenizer(vocab_size=TINY.llama.vocab_size),
                            image_tokens=TINY.image_seq_len, gen=gen)
    with pytest.raises(ValueError, match="jacobi"):
        PlanGenPipeline(model, TINY, proc, gen_cfg=gen)
    assert quant_form(model) is None
