"""The port's self-speculative image decoder (`runtime/speculative.py`)
against the port's base sampler and the JAX package's decoder, on the CPU.

Same weights (JAX `vlm.init`, fp32, through `load_jax_params`), same
prompt. The two identities of the JAX tests (tests/test_speculative.py):
a full-depth draft reproduces the base sampled stream bit for bit, and
greedy with a 1-layer draft equals base greedy (and the JAX decoder's
greedy tokens). The accept / residual arithmetic is held against the JAX
body's on the same p, q and uniforms, and a chi-square shows that a
round's first token is distributed as p.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from plangen_tpu.config import PlanGenModelConfig
from plangen_tpu.models import llama as jllama
from plangen_tpu.models import vlm as jvlm
from plangen_tpu.runtime.kvcache import init_kv_cache as jinit_kv_cache
from plangen_tpu.runtime.speculative import generate_image_tokens_spec as jspec
from plangen_tpu.text.tokenizer import ByteFallbackTokenizer
from plangen_tpu_torch.config import GenerationConfig
from plangen_tpu_torch.convert import load_jax_params
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.ops.sampling import draw
from plangen_tpu_torch.runtime import speculative as spec
from plangen_tpu_torch.runtime.generate import generate_image_tokens
from plangen_tpu_torch.runtime.kvcache import init_kv_cache
from plangen_tpu_torch.tasks.pipeline import PlanGenPipeline
from plangen_tpu_torch.tasks.processor import PlanGenProcessor

TINY = PlanGenModelConfig.tiny()
N = 16
CFG_WEIGHT = 5.0
G = "<grounding><ref>cat</ref><box>[100,100,600,600]</box></grounding>"


@functools.lru_cache(maxsize=None)
def _load():
    params = jvlm.init(jax.random.PRNGKey(42), TINY, dtype=jnp.float32)
    model = PlanGenModel(TINY, dtype=torch.float32)
    load_jax_params(model, params, TINY)
    return params, model.eval()


@functools.lru_cache(maxsize=None)
def _inputs():
    params, _ = _load()
    ids = np.random.RandomState(3).randint(0, 100, (2, 6))
    emb = np.array(jvlm.embed_text(params, jnp.asarray(ids)), np.float32)
    mask = np.ones((2, 6 + N), np.int32)
    return emb, mask


def _port(fn, *args, **kw):
    emb, mask = _inputs()
    return fn(_load()[1], TINY, torch.from_numpy(emb), torch.from_numpy(mask), *args, **kw)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("seed,d", [(5, 4), (6, 4), (7, 2), (8, 1)])
def test_full_depth_draft_equals_the_base_sampler(seed, d):
    """draft_layers == num_layers: every draft passes, and the tokens are
    the base loop's on the same generator, bit for bit."""
    base = _port(generate_image_tokens, _gen(seed), CFG_WEIGHT, 1.0, num_tokens=N)
    got = _port(spec.generate_image_tokens_spec, _gen(seed), CFG_WEIGHT, 1.0, num_tokens=N,
                draft_layers=TINY.llama.num_layers, draft_len=d)
    torch.testing.assert_close(got.tokens, base, rtol=0, atol=0)
    assert got.rounds == -(-(N - 1) // (d + 1))


def test_greedy_weak_draft_equals_base_greedy_and_jax():
    """A 1-layer draft of the 2-layer model, greedy: the tokens equal the
    port's base greedy loop and the JAX decoder's, whose round count the
    port's matches."""
    params, _ = _load()
    emb, mask = _inputs()
    base = _port(generate_image_tokens, None, CFG_WEIGHT, 0.0, num_tokens=N)
    got = _port(spec.generate_image_tokens_spec, None, CFG_WEIGHT, 0.0, num_tokens=N,
                draft_layers=1, draft_len=3)
    want = jspec(params, TINY, jnp.asarray(emb), jnp.asarray(mask), rng=jax.random.PRNGKey(0),
                 cfg_weight=jnp.float32(CFG_WEIGHT), temperature=jnp.float32(0.0),
                 num_tokens=N, draft_layers=1, draft_len=3)
    torch.testing.assert_close(got.tokens, base, rtol=0, atol=0)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.rounds == int(want.rounds) and 1 <= got.rounds < N - 1


@pytest.mark.parametrize("d", [1, 2, 5])
def test_greedy_equals_base_greedy_for_any_draft_length(d):
    base = _port(generate_image_tokens, None, CFG_WEIGHT, 0.0, num_tokens=N)
    got = _port(spec.generate_image_tokens_spec, None, CFG_WEIGHT, 0.0, num_tokens=N,
                draft_layers=1, draft_len=d)
    torch.testing.assert_close(got.tokens, base, rtol=0, atol=0)


# ------------------------------------------------------- the accept step


def _jax_body(p, q, draft, u, greedy, bonus, resample):
    """The arithmetic of the JAX round's body (plangen_tpu/runtime/
    speculative.py) after the draws, on the same p, q, uniforms and drawn
    tokens: (a, the residual distribution, the candidates)."""
    p, q, draft, u = (jnp.asarray(x) for x in (p, q, draft, u))
    d = draft.shape[0]
    p_at = jax.vmap(lambda pj, t: pj[t])(p[:d], draft)
    q_at = jax.vmap(lambda qj, t: qj[t])(q, draft)
    if_sampled = u * q_at < p_at
    if_greedy = jnp.argmax(p[:d], axis=-1).astype(jnp.int32) == draft
    ok = jnp.where(greedy, if_greedy, if_sampled)
    a = jnp.argmin(jnp.concatenate([ok, jnp.array([False])])).astype(jnp.int32)
    p_a = p[a]
    residual = jnp.maximum(p_a - q[jnp.minimum(a, d - 1)], 0.0)
    residual_sum = residual.sum()
    residual = jnp.where(residual_sum > 0, residual / residual_sum, p_a)
    extra_sampled = jnp.where(a == d, bonus, resample)
    extra = jnp.where(greedy, jnp.argmax(p_a).astype(jnp.int32), extra_sampled)
    cand = jnp.where(jnp.arange(d + 1) < a,
                     jnp.concatenate([draft, jnp.zeros((1,), jnp.int32)]), extra)
    cand = jnp.where(jnp.arange(d + 1) <= a, cand, jnp.concatenate([draft, extra[None]]))
    return int(a), np.array(residual), np.array(cand)


def _round_inputs(seed, d, V, agree):
    """p [d + 1, V] and q [d, V] (q close to p when `agree`, so prefixes of
    every length are accepted), drafts drawn from q, uniforms."""
    rs = np.random.RandomState(seed)
    p_logits = rs.normal(0, 2, (d + 1, V))
    q_logits = p_logits[:d] + rs.normal(0, 0.3 if agree else 3, (d, V))
    p = np.exp(p_logits) / np.exp(p_logits).sum(-1, keepdims=True)
    q = np.exp(q_logits) / np.exp(q_logits).sum(-1, keepdims=True)
    draft = np.array([rs.choice(V, p=row) for row in q], np.int32)
    u = rs.uniform(size=d).astype(np.float32)
    return p.astype(np.float32), q.astype(np.float32), draft, u


@pytest.mark.parametrize("greedy", [False, True], ids=["sampled", "greedy"])
@pytest.mark.parametrize("seed", range(6))
def test_accept_step_equals_the_jax_body(seed, greedy):
    d, V = 4, 12
    p, q, draft, u = _round_inputs(seed, d, V, agree=seed % 2 == 0)
    bonus, resample = np.int32(V - 1), np.int32(V - 2)
    a_j, resid_j, cand_j = _jax_body(p, q, draft, u, greedy, bonus, resample)
    tp, tq, tdraft = torch.from_numpy(p), torch.from_numpy(q), torch.from_numpy(draft).long()
    a = spec.accept_length(tp, tq, tdraft, torch.from_numpy(u), greedy)
    assert int(a) == a_j
    torch.testing.assert_close(spec.residual(tp, tq, a), torch.from_numpy(resid_j),
                               rtol=1e-6, atol=1e-7)
    extra = (tp[a].argmax() if greedy
             else torch.where(a == d, torch.tensor(int(bonus)), torch.tensor(int(resample))))
    np.testing.assert_array_equal(spec.next_tokens(tdraft, a, extra).numpy(), cand_j)


def test_every_prefix_length_is_exercised():
    lengths = {int(spec.accept_length(*(torch.from_numpy(x) for x in (p, q)),
                                      torch.from_numpy(dr).long(), torch.from_numpy(u), False))
               for s in range(40) for p, q, dr, u in [_round_inputs(s, 4, 12, s % 2 == 0)]}
    assert lengths == set(range(5))


def test_residual_of_identical_distributions_is_p():
    p = torch.softmax(torch.randn(3, 8, generator=_gen(0)), -1)
    a = torch.tensor(1)
    torch.testing.assert_close(spec.residual(p, p[:2], a), p[1], rtol=0, atol=0)


def test_first_token_is_distributed_as_p():
    """A round's first token over V = 8, 24,000 rounds on fixed p and q
    (the draft from q, its accept uniform, the residual draw): chi-square
    against p below the 0.001 critical value of 7 degrees of freedom."""
    d, V, trials = 2, 8, 24_000
    rs = np.random.RandomState(0)
    p = torch.softmax(torch.from_numpy(rs.normal(0, 1, (d + 1, V))).float(), -1)
    q = torch.softmax(torch.from_numpy(rs.normal(0, 1.5, (d, V))).float(), -1)
    g_draft, g_acc, g_res = _gen(1), _gen(2), _gen(3)
    counts = np.zeros(V)
    for _ in range(trials):
        draft = torch.stack([draw(q[j:j + 1], g_draft)[0] for j in range(d)])
        a = spec.accept_length(p, q, draft, torch.rand(d, generator=g_acc), False)
        resample = draw(spec.residual(p, q, a)[None], g_res)[0]
        bonus = draw(p[d:d + 1], g_draft)[0]
        extra = torch.where(a == d, bonus, resample)
        counts[int(spec.next_tokens(draft, a, extra)[0])] += 1
    expected = p[0].double().numpy() * trials
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 24.32, (chi2, counts, expected)


# --------------------------------------------------------------- the rest


def test_sampled_weak_draft_is_valid_and_deterministic():
    def run(seed):
        return _port(spec.generate_image_tokens_spec, _gen(seed), CFG_WEIGHT, 1.0,
                     num_tokens=N, draft_layers=1, draft_len=3)

    a, b, c = run(7), run(7), run(8)
    torch.testing.assert_close(a.tokens, b.tokens, rtol=0, atol=0)
    assert a.rounds == b.rounds
    assert a.tokens.shape == (1, N) and a.tokens.dtype == torch.int64
    assert int(a.tokens.min()) >= 0 and int(a.tokens.max()) < TINY.image_token_size
    assert not torch.equal(a.tokens, c.tokens)


def test_streams_are_seeded_from_the_request_generator():
    g = _gen(11)
    acc, res = (spec.stream_generator(g, s) for s in (spec.ACCEPT_STREAM, spec.RESIDUAL_STREAM))
    seeds = {g.initial_seed(), acc.initial_seed(), res.initial_seed()}
    assert len(seeds) == 3
    assert spec.stream_generator(_gen(11), spec.ACCEPT_STREAM).initial_seed() == \
        acc.initial_seed()


@pytest.mark.parametrize("kw,match", [
    (dict(draft_layers=0), "draft_layers"), (dict(draft_layers=3), "draft_layers"),
    (dict(draft_layers=1, draft_len=0), "draft_len"),
])
def test_bad_arguments_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        _port(spec.generate_image_tokens_spec, _gen(0), CFG_WEIGHT, 1.0, num_tokens=N, **kw)


def test_more_than_one_image_raises():
    emb, mask = _inputs()
    model = _load()[1]
    with pytest.raises(ValueError, match="B = 1"):
        spec.generate_image_tokens_spec(
            model, TINY, torch.from_numpy(np.concatenate([emb, emb])),
            torch.from_numpy(np.concatenate([mask, mask])), _gen(0), CFG_WEIGHT, 1.0,
            num_tokens=N)


@pytest.mark.parametrize("limit", [1, 2])
def test_layers_limit_equals_jax(limit):
    """The draft's early exit: a cached Q = 1 step through the first K
    layers, hidden state and the cache rows it writes, against JAX's."""
    params, model = _load()
    rs = np.random.RandomState(4)
    x = rs.normal(size=(2, 1, TINY.llama.hidden_size)).astype(np.float32)
    mask = np.ones((2, 128), np.int32)
    mask[1, :3] = 0
    jcache = jinit_kv_cache(TINY.llama, 2, 128, dtype=jnp.float32)
    jhidden, jcache = jllama.forward(params["language_model"], TINY.llama, jnp.asarray(x),
                                     jnp.asarray(mask), positions=jnp.array([9], jnp.int32),
                                     kv_cache=jcache, layers_limit=limit)
    cache = init_kv_cache(TINY.llama, 2, 128, dtype=torch.float32)
    with torch.no_grad():
        hidden = model.language_model(torch.from_numpy(x), torch.from_numpy(mask),
                                      torch.tensor([9], dtype=torch.int32), cache,
                                      layers_limit=limit)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), rtol=1e-5,
                               atol=1e-6)
    assert not cache["k"][limit:].any()  # layers past K are not written


@pytest.mark.parametrize("limit", [0, 3])
def test_layers_limit_out_of_range_raises(limit):
    model = _load()[1]
    with pytest.raises(ValueError, match="layers_limit"):
        model.language_model(torch.zeros(1, 1, TINY.llama.hidden_size),
                             torch.ones(1, 1, dtype=torch.int32), layers_limit=limit)


# ------------------------------------------------------------ the pipeline


def _pipeline(**gen_kw):
    gen = GenerationConfig(max_new_text_tokens=4, **gen_kw)
    proc = PlanGenProcessor(ByteFallbackTokenizer(vocab_size=TINY.llama.vocab_size),
                            image_tokens=TINY.image_seq_len, gen=gen)
    return PlanGenPipeline(_load()[1], TINY, proc, gen_cfg=gen)


class TestSpeculativeWithPerRowSeeds:
    def test_serving_seeds_route_to_the_request_generator(self):
        """The server passes per-request seeds; the B = 1 speculative call
        draws from that request's generator, reproducibly."""
        pipe = _pipeline(speculative=True, spec_draft_layers=1, spec_draft_len=2)
        out = pipe.layout_to_image(["a"], [G], seeds=[5])
        assert out.image_tokens.shape == (1, TINY.image_seq_len)
        again = pipe.layout_to_image(["a"], [G], seeds=[5])
        np.testing.assert_array_equal(out.image_tokens, again.image_tokens)

    @pytest.mark.parametrize("seeding", ["seeds", "seed"])
    def test_full_depth_pipeline_equals_the_base_pipeline(self, seeding):
        kw = dict(seeds=[5]) if seeding == "seeds" else dict(seed=5)
        base = _pipeline().layout_to_image(["a"], [G], **kw)
        got = _pipeline(speculative=True, spec_draft_layers=TINY.llama.num_layers,
                        spec_draft_len=3).layout_to_image(["a"], [G], **kw)
        np.testing.assert_array_equal(got.image_tokens, base.image_tokens)
        np.testing.assert_array_equal(got.images, base.images)

    def test_two_images_take_the_base_loop(self, monkeypatch):
        from plangen_tpu_torch.tasks import pipeline as tpipeline

        calls = []
        monkeypatch.setattr(tpipeline, "generate_image_tokens_spec",
                            lambda *a, **k: calls.append(1))
        pipe = _pipeline(speculative=True)
        out = pipe.layout_to_image(["a", "b"], [G, G], seeds=[1, 2])
        assert calls == [] and out.image_tokens.shape == (2, TINY.image_seq_len)
        assert dataclasses.replace(pipe.gen).speculative
