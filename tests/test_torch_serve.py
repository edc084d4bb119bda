"""The port's server (`plangen_tpu_torch/serve.py`) on the CPU, `tiny` fp32.

One HTTP server on an ephemeral port in front of the port's pipeline, on
the JAX package's seeded weights (`load_jax_params`); client threads fire
requests. Mirrors tests/test_serve.py where the port holds the same
contract, and holds the answers against the JAX package:

  * `/plan` and `/understand` (with and without a question, with an image
    that must be resized) equal the JAX pipeline's on the same caption or
    pixels;
  * `/edit` with an all-zero region equals the JAX server's tokens;
  * a seeded `/generate` reproduces across batch compositions;
  * buckets, `min_batch`, the 400s, `close`, `warmup` and `parallel_size`.
"""

import base64
import functools
import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from plangen_tpu.config import GenerationConfig as JaxGenerationConfig
from plangen_tpu.models import vlm as jvlm
from plangen_tpu.serve import Batcher as JaxBatcher
from plangen_tpu.tasks.pipeline import PlanGenPipeline as JaxPipeline
from plangen_tpu.tasks.processor import PlanGenProcessor as JaxProcessor
from plangen_tpu.text.tokenizer import ByteFallbackTokenizer as JaxByteTokenizer
from plangen_tpu_torch.config import GenerationConfig, PlanGenModelConfig
from plangen_tpu_torch.convert import load_jax_params
from plangen_tpu_torch.data.preprocess import build_edit_region
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.serve import Batcher, _Request, make_server, warmup
from plangen_tpu_torch.tasks.pipeline import PlanGenPipeline
from plangen_tpu_torch.tasks.processor import PlanGenProcessor
from plangen_tpu_torch.text.tokenizer import ByteFallbackTokenizer
from plangen_tpu_torch.utils.visualize import decode_png, to_uint8

TINY = PlanGenModelConfig.tiny()
G = "<grounding><ref>a cat</ref><box>[100, 100, 600, 600]</box></grounding>"
SIZE = TINY.vision.image_size


@functools.lru_cache(maxsize=None)
def _params():
    return jvlm.init(jax.random.PRNGKey(0), TINY, dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def _jax_pipe():
    proc = JaxProcessor(JaxByteTokenizer(vocab_size=TINY.llama.vocab_size),
                        image_tokens=TINY.image_seq_len,
                        gen=JaxGenerationConfig(max_new_text_tokens=4))
    return JaxPipeline(_params(), TINY, proc)


@functools.lru_cache(maxsize=None)
def _pipe():
    model = PlanGenModel(TINY, dtype=torch.float32)
    load_jax_params(model, _params(), TINY)
    proc = PlanGenProcessor(ByteFallbackTokenizer(vocab_size=TINY.llama.vocab_size),
                            image_tokens=TINY.image_seq_len,
                            gen=GenerationConfig(max_new_text_tokens=4))
    return PlanGenPipeline(model.eval(), TINY, proc)


@pytest.fixture(scope="module")
def server():
    batcher = Batcher(_pipe(), max_batch=4, wait_ms=30.0)
    httpd = make_server(batcher, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", batcher
    httpd.shutdown()
    httpd.server_close()
    batcher.close()


def post(base, path, payload, timeout=300):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _png(img: np.ndarray, mode="RGB") -> str:
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _pattern(h=SIZE, w=SIZE, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


def _model_range(u8):
    return u8.astype(np.float32) / 127.5 - 1.0


def _concurrently(fn, args):
    out = [None] * len(args)

    def call(i):
        out[i] = fn(args[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(args))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return out


class TestServe:
    def test_healthz(self, server):
        base, _ = server
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            body = json.loads(r.read())
        assert body["ok"] is True
        for k in ("requests", "batches", "device_s", "assembly_s", "prep_s", "idle_s"):
            assert k in body["stats"]

    def test_generate_roundtrip(self, server):
        base, _ = server
        code, out = post(base, "/generate", {"caption": "a cat", "grounding": G})
        assert code == 200
        assert len(out["tokens"]) == TINY.image_seq_len
        assert 0 <= min(out["tokens"]) and max(out["tokens"]) < TINY.image_token_size
        png = base64.b64decode(out["image_b64"])
        assert Image.open(io.BytesIO(png)).size == (SIZE, SIZE)
        assert decode_png(png).shape == (SIZE, SIZE, 3)

    def test_plan_equals_jax_pipeline(self, server):
        base, _ = server
        for caption in ("two dogs", "a red fox in the snow"):
            code, out = post(base, "/plan", {"caption": caption})
            assert code == 200
            assert out["grounding"] == _jax_pipe().plan([caption])[0]

    @pytest.mark.parametrize("question", [None, "How many objects are there?"])
    def test_understand_equals_jax_pipeline(self, server, question):
        base, _ = server
        img = _pattern(seed=1)
        payload = {"image_b64": _png(img)}
        if question is not None:
            payload["question"] = question
        code, out = post(base, "/understand", payload)
        assert code == 200
        want = _jax_pipe().understand(_model_range(img)[None], question=question)
        assert out["grounding"] == want.groundings[0]

    def test_understand_resizes_other_sizes(self, server):
        base, _ = server
        for mode in ("RGB", "L", "RGBA"):
            code, out = post(base, "/understand",
                             {"image_b64": _png(_pattern(45, 50, seed=2), mode)})
            assert code == 200 and "grounding" in out

    def test_concurrent_requests_batch_together(self, server):
        base, batcher = server
        before = dict(batcher.stats)
        results = _concurrently(
            lambda i: post(base, "/generate", {"caption": f"scene {i}", "grounding": G}),
            list(range(4)))
        assert all(code == 200 for code, _ in results)
        assert len({tuple(out["tokens"]) for _, out in results}) == 4
        assert batcher.stats["requests"] - before["requests"] == 4
        assert batcher.stats["batches"] - before["batches"] < 4

    def test_unknown_endpoint_and_bad_json(self, server):
        base, _ = server
        code, _ = post(base, "/nope", {})
        assert code == 404
        req = urllib.request.Request(base + "/plan", data=b"{not json", headers={})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400

    def test_missing_field_rejected_at_submit(self, server):
        base, _ = server
        code, out = post(base, "/generate", {"caption": "no grounding"})
        assert code == 400 and "grounding" in out["error"]
        code, out = post(base, "/understand", {"image_b64": "!!notb64!!"})
        assert code == 400 and "image_b64" in out["error"]

    def test_unsupported_png_is_a_400_naming_the_limit(self, server):
        base, _ = server
        code, out = post(base, "/understand", {"image_b64": _png(_pattern(), "P")})
        assert code == 400
        assert "image_b64" in out["error"] and "no palette" in out["error"]

    def test_per_request_seeds_reproduce_across_batching(self, server):
        base, _ = server
        alone = post(base, "/generate", {"caption": "same", "grounding": G, "seed": 1})
        results = _concurrently(
            lambda s: post(base, "/generate", {"caption": "same", "grounding": G, "seed": s}),
            [2, 1, 3])
        assert alone[0] == 200 and all(code == 200 for code, _ in results)
        assert results[1][1]["tokens"] == alone[1]["tokens"]

    def test_edit_all_zero_region_equals_jax_server(self, server):
        base, _ = server
        payload = {"caption": "scene", "grounding": G, "image_b64": _png(_pattern(seed=4)),
                   "edit_region": [0] * TINY.image_seq_len, "seed": 3}
        code, out = post(base, "/edit", dict(payload))
        assert code == 200
        jb = JaxBatcher(_jax_pipe(), max_batch=1, wait_ms=5.0)
        try:
            req = jb.submit("edit", dict(payload))
            assert req.done.wait(timeout=600) and req.error is None, req.error
        finally:
            jb.close()
        assert out["tokens"] == req.result["tokens"]

    def test_edit_with_boxes_equals_the_region(self, server):
        base, _ = server
        img = _png(_pattern(seed=5))
        common = {"caption": "scene", "grounding": G, "image_b64": img, "seed": 3,
                  "neg_grounding": "<ref>clutter</ref><box>[0, 0, 400, 400]</box>"}
        code, out = post(base, "/edit", {**common, "edit_boxes": [[0.0, 0.0, 0.5, 0.5]]})
        assert code == 200 and len(out["tokens"]) == TINY.image_seq_len
        grid = int(round(TINY.image_seq_len ** 0.5))
        region = build_edit_region(np.asarray([[0.0, 0.0, 0.5, 0.5]]), grid=grid)
        code2, out2 = post(base, "/edit", {**common,
                                           "edit_region": [int(x) for x in region]})
        assert code2 == 200 and out2["tokens"] == out["tokens"]

    def test_edit_bad_region_errors(self, server):
        base, _ = server
        img = _png(_pattern())
        code, out = post(base, "/edit", {"grounding": G, "image_b64": img,
                                         "edit_region": [1, 0]})
        assert code == 400 and "edit_region" in out["error"]
        code, out = post(base, "/edit", {"grounding": G, "image_b64": img,
                                         "edit_boxes": [[0.1, 0.2, 0.5]]})
        assert code == 400 and "edit_boxes" in out["error"]
        code, _ = post(base, "/edit", {"grounding": G, "image_b64": img})
        assert code == 400


class TestServeSurface:
    def test_parallel_size_returns_ps_images(self, server):
        base, _ = server
        code, out = post(base, "/generate", {"caption": "a cat", "grounding": G,
                                             "parallel_size": 2, "seed": 7})
        assert code == 200 and out["seed"] == 7
        assert len(out["images_b64"]) == 2 and out["image_b64"] == out["images_b64"][0]
        assert out["images_b64"][0] != out["images_b64"][1]

    def test_parallel_size_rows_match_direct_pipeline(self, server):
        base, batcher = server
        code, out = post(base, "/generate", {"caption": "row check", "grounding": G,
                                             "parallel_size": 2, "seed": 11})
        assert code == 200
        direct = batcher.pipe.layout_to_image(["row check"], [G], seeds=[11],
                                              parallel_size=2)
        for c in range(2):
            np.testing.assert_array_equal(
                decode_png(base64.b64decode(out["images_b64"][c])),
                to_uint8(direct.images[c]))

    def test_joint_returns_a_plan_and_images(self, server):
        base, _ = server
        code, out = post(base, "/joint", {"caption": "two dogs", "seed": 2,
                                          "parallel_size": 2})
        assert code == 200 and len(out["images_b64"]) == 2
        assert out["grounding"] == _jax_pipe().plan(["two dogs"])[0]

    def test_seed_echoed_for_seedless(self, server):
        base, _ = server
        code, out = post(base, "/generate", {"caption": "x", "grounding": G})
        assert code == 200 and 0 <= out["seed"] < 2 ** 31
        code2, out2 = post(base, "/generate", {"caption": "x", "grounding": G,
                                               "seed": out["seed"]})
        assert code2 == 200 and out2["tokens"] == out["tokens"]

    def test_oversized_seed_and_bad_parallel_size_are_400s(self, server):
        base, _ = server
        code, out = post(base, "/generate", {"caption": "x", "grounding": G,
                                             "seed": 2 ** 40})
        assert code == 400 and "seed" in out["error"]
        code, _ = post(base, "/generate", {"caption": "x", "grounding": G,
                                           "parallel_size": 0})
        assert code == 400


# ------------------------------------------------------ the batcher alone


def _batcher(**kw):
    return Batcher(_pipe(), **kw)


def _quiet_batcher(max_batch=8, wait_ms=10.0):
    """A batcher whose worker threads are stopped: the test owns _drain."""
    b = _batcher(max_batch=max_batch, wait_ms=wait_ms)
    b._stop.set()
    b._thread.join(timeout=5)
    b._prep_thread.join(timeout=5)
    assert not b._thread.is_alive() and not b._prep_thread.is_alive()
    b._stop.clear()
    return b


class TestBuckets:
    def test_bucket_floor(self):
        b = _batcher(max_batch=8, wait_ms=5.0, min_batch=4)
        try:
            assert [b._bucket(n) for n in (1, 4, 5, 9)] == [4, 4, 8, 8]
        finally:
            b.close()

    def test_bucket_floor_and_cap_scale_with_parallel_size(self):
        b = _batcher(max_batch=8, wait_ms=5.0, min_batch=8)
        try:
            assert [b._bucket(n, ps=4) for n in (1, 2, 5)] == [2, 2, 2]
            assert b._bucket(1, ps=1) == 8
        finally:
            b.close()

    def test_invalid_min_batch_rejected(self):
        for mb in (5, 0):
            with pytest.raises(ValueError, match="min_batch"):
                _batcher(max_batch=4, wait_ms=5.0, min_batch=mb)

    def test_single_request_pads_to_floor(self):
        b = _batcher(max_batch=4, wait_ms=10.0, min_batch=2)
        try:
            req = b.submit("plan", {"caption": "a cat"})
            assert req.done.wait(timeout=300) and req.error is None
            assert req.result["grounding"] == _jax_pipe().plan(["a cat"])[0]
            assert b.stats["padded_rows"] >= 1
        finally:
            b.close()


class TestShutdownAndValidation:
    def test_close_finalizes_batch_stuck_in_ready_queue(self):
        b = _quiet_batcher(max_batch=2, wait_ms=5.0)
        req = _Request("plan", {"caption": "x"})
        b._ready.put(([req], {"plan": None}))
        b.close()
        assert req.done.is_set() and "shutting down" in req.error

    def test_close_finalizes_queued_and_held_requests(self):
        b = _quiet_batcher(max_batch=2, wait_ms=5.0)
        queued, held = _Request("plan", {"caption": "q"}), _Request("plan", {"caption": "h"})
        b.q.put(queued)
        b._held = held
        b.close()
        for r in (queued, held):
            assert r.done.is_set() and "shutting down" in r.error

    def test_parallel_size_bounded_by_max_batch_and_mode(self):
        b = _quiet_batcher(max_batch=4, wait_ms=5.0)
        try:
            with pytest.raises(ValueError, match="max_batch"):
                b.submit("generate", {"caption": "x", "grounding": "", "parallel_size": 8})
            with pytest.raises(ValueError, match="generate/joint"):
                b.submit("plan", {"caption": "x", "parallel_size": 2})
            with pytest.raises(ValueError, match="JSON object"):
                b.submit("plan", [1, 2, 3])
            for mode in ("generate", "joint", "plan"):
                with pytest.raises(ValueError, match="caption"):
                    b.submit(mode, {"grounding": "<grounding></grounding>"})
            with pytest.raises(ValueError, match="caption"):
                b.submit("generate", {"caption": 7, "grounding": ""})
        finally:
            b.close()

    def test_batch_key_separates_programs(self):
        k = Batcher._batch_key
        assert k(_Request("understand", {"question": "a"})) != k(
            _Request("understand", {"question": "b"}))
        assert k(_Request("generate", {"parallel_size": 2})) != k(
            _Request("generate", {"parallel_size": 1}))
        assert k(_Request("generate", {})) != k(_Request("joint", {}))
        assert k(_Request("generate", {"seed": 1})) == k(_Request("generate", {"seed": 2}))

    def test_drain_holds_mismatched_program_head(self):
        b = _quiet_batcher(max_batch=8, wait_ms=30.0)
        b.q.put(_Request("plan", {"caption": "a"}))
        b.q.put(_Request("plan", {"caption": "b"}))
        b.q.put(_Request("understand", {"question": "q"}))
        assert [r.mode for r in b._drain()] == ["plan", "plan"]
        assert b._held is not None and b._held.mode == "understand"
        assert b._drain()[0].mode == "understand"
        b.close()


class TestBusyDrain:
    def test_busy_device_extends_collection(self):
        import time

        b = _quiet_batcher()
        b._exec_start = time.perf_counter()
        b._ema_dev, b._ema_prep = 1.2, 0.05
        b._exec_busy.set()
        for _ in range(2):
            b.q.put(_Request("plan", {"caption": "early"}))

        def late():
            time.sleep(0.4)
            for _ in range(4):
                b.q.put(_Request("plan", {"caption": "late"}))

        th = threading.Thread(target=late, daemon=True)
        th.start()
        t0 = time.perf_counter()
        batch = b._drain()
        th.join(timeout=5)
        assert len(batch) == 6
        assert time.perf_counter() - t0 < 1.35
        b.close()

    def test_idle_device_keeps_wait_ms_latency(self):
        import time

        b = _quiet_batcher()
        b._ema_dev = 1.2
        b.q.put(_Request("plan", {"caption": "solo"}))
        t0 = time.perf_counter()
        assert len(b._drain()) == 1
        assert time.perf_counter() - t0 < 0.5
        b.close()

    def test_past_deadline_flushes_immediately(self):
        import time

        b = _quiet_batcher()
        b._exec_start = time.perf_counter() - 5.0
        b._ema_dev = 1.0
        b._exec_busy.set()
        b.q.put(_Request("plan", {"caption": "x"}))
        t0 = time.perf_counter()
        assert len(b._drain()) == 1
        assert time.perf_counter() - t0 < 0.5
        b.close()


class TestWarmup:
    def test_warmup_all_modes(self):
        b = _batcher(max_batch=4, wait_ms=10.0)
        try:
            warmup(b, "generate:2,plan:2,understand:1,edit:2,joint:1", timeout=600.0)
            assert b.stats["batches"] >= 5 and b.stats["requests"] == 8
        finally:
            b.close()

    def test_warmup_bad_mode_raises(self):
        b = _quiet_batcher(max_batch=2, wait_ms=10.0)
        try:
            with pytest.raises(ValueError, match="warmup mode"):
                warmup(b, "nosuchmode:2")
        finally:
            b.close()
