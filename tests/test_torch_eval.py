"""The port's evaluation path on the CPU, against the JAX package's.

  * the layout metrics and the FID / KID math equal the JAX copies';
  * the resize of the SigLIP featurizer is within 1e-6 of
    `jax.image.resize(..., "linear", antialias=True)` when shrinking and
    1e-4 when enlarging, and the featurizer's features within 2e-4 of the
    JAX featurizer's on the same weights;
  * `run_validation` at `tiny` width, on the same weights, writes the JAX
    harness's artifact tree for all six task modes over fixtures in the
    real dataset formats (COCO val2017, COCO-200 removal and editing,
    NSR-1K), with equal layout JSONs (every text decode is greedy) and
    equal layout metrics; with `val_image_metrics` at temperature 0 its
    FID / KID keys are the JAX ones and the values within 1e-3; every
    pipeline and featurizer call runs on the worker thread, the artifacts
    on the calling one;
  * `draw_layout`, `save_image_grid` and `load_image_dir` equal the JAX
    ones;
  * `Trainer.fit(validate_fn=...)` calls it at `validation_steps`, and the
    default validator logs `val/` keys from the trainer's own model.
"""

import functools
import importlib.util
import json
import pathlib
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from plangen_tpu.config import PlanGenConfig as JPlanGenConfig
from plangen_tpu.config import PlanGenModelConfig
from plangen_tpu.config import apply_overrides as japply_overrides
from plangen_tpu.models import vlm as jvlm
from plangen_tpu.tasks import image_metrics as jim
from plangen_tpu.tasks import metrics as jmetrics
from plangen_tpu.tasks.eval import run_validation as jrun_validation
from plangen_tpu.utils import visualize as jvis
from plangen_tpu_torch.config import FlowConfig, PlanGenConfig, apply_overrides
from plangen_tpu_torch.config import PlanGenModelConfig as TConfig
from plangen_tpu_torch.convert import load_jax_params
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.tasks import eval as teval
from plangen_tpu_torch.tasks import image_metrics as tim
from plangen_tpu_torch.tasks import metrics as tmetrics
from plangen_tpu_torch.utils import visualize as tvis

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = PlanGenModelConfig.tiny()
TTINY = TConfig.tiny()
# (task, data, batch size, batches): the COCO-200 fixtures hold 2 samples
MODES = [("uni", "coco", 2, 2), ("uni_2stage", "coco", 1, 2), ("mmu", "coco", 2, 2),
         ("plan", "layout", 2, 2), ("rm", "rm_coco", 2, 1), ("edit", "edit_coco", 2, 1)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def _weights():
    params = jvlm.init(jax.random.PRNGKey(0), TINY, dtype=jnp.float32)
    model = PlanGenModel(TTINY, dtype=torch.float32)
    load_jax_params(model, params, TTINY)
    return params, model.eval()


# ------------------------------------------------------------------ metrics


def test_layout_metrics_equal_jax():
    rs = np.random.RandomState(0)
    per_sample = []
    for k in range(20):
        def boxes(n):
            xy = rs.uniform(0, 0.7, (n, 2))
            return np.concatenate([xy, xy + rs.uniform(0.05, 0.3, (n, 2))], 1).tolist()
        pred, gt = boxes(rs.randint(0, 5)), boxes(rs.randint(0, 5))
        if k % 4 == 0 and gt:
            pred = gt[:1] + pred  # an exact match
        assert tmetrics.greedy_match(pred, gt) == jmetrics.greedy_match(pred, gt)
        for thr in (0.3, 0.5):
            got = tmetrics.layout_metrics(pred, gt, thr)
            assert got == jmetrics.layout_metrics(pred, gt, thr)
        per_sample.append(got)
    assert tmetrics.aggregate_layout_metrics(per_sample) == \
        jmetrics.aggregate_layout_metrics(per_sample)
    assert tmetrics.aggregate_layout_metrics([]) == {}


@pytest.mark.parametrize("n,d", [(30, 8), (12, 40), (200, 5)])
def test_fid_kid_math_equals_jax(n, d):
    rs = np.random.RandomState(n + d)
    a = rs.normal(size=(n, d))
    b = rs.normal(0.3, 1.2, size=(n + 3, d))
    for fn in ("feature_stats",):
        for x, y in zip(getattr(tim, fn)(a), getattr(jim, fn)(a)):
            np.testing.assert_array_equal(x, y)
    mu1, s1 = jim.feature_stats(a)
    mu2, s2 = jim.feature_stats(b)
    assert tim.frechet_distance(mu1, s1, mu2, s2) == jim.frechet_distance(mu1, s1, mu2, s2)
    assert tim.kid_poly(a, b, n_subsets=7, subset_size=n // 2, seed=3) == \
        jim.kid_poly(a, b, n_subsets=7, subset_size=n // 2, seed=3)
    assert tim.fid_kid_from_features(a, b, kid_subsets=5, tag="x") == \
        jim.fid_kid_from_features(a, b, kid_subsets=5, tag="x")


# ------------------------------------------------------------------ featurizer


@pytest.mark.parametrize("hw,size,tol", [((64, 48), 32, 1e-6), ((100, 100), 32, 1e-6),
                                         ((37, 53), 17, 1e-6), ((20, 30), 32, 1e-4),
                                         ((200, 300), 384, 1e-4)])
def test_resize_is_jax_linear_antialias(hw, size, tol):
    x = np.random.RandomState(sum(hw)).uniform(-1, 1, (2,) + hw + (3,)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, size, size, 3), "linear",
                                       antialias=True))
    got = tim.resize_linear_antialias(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("kind", ["float_resized", "uint8"])
def test_siglip_featurizer_within_2e4_of_jax(kind):
    params, model = _weights()
    rs = np.random.RandomState(1)
    size = TINY.vision.image_size
    if kind == "uint8":
        images = rs.randint(0, 256, (3, size, size, 3)).astype(np.uint8)
    else:
        images = rs.uniform(-1, 1, (3, 2 * size + 5, size + 3, 3)).astype(np.float32)
    want = jim.SigLIPFeaturizer(params, TINY, batch_size=2)(images)
    got = tim.SigLIPFeaturizer(model, TTINY, batch_size=2)(images)
    assert got.shape == want.shape == (3, TINY.vision.width) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    feat, tag = tim.make_featurizer("siglip", model, TTINY)
    assert tag == "siglip" and isinstance(feat, tim.SigLIPFeaturizer)
    with pytest.raises(ValueError, match="unknown --features"):
        tim.make_featurizer("inception", model, TTINY)


def test_torchscript_featurizer_runs_on_the_card_unless_asked_for_the_cpu(
        tmp_path, monkeypatch):
    """`make_featurizer("torch:<path>")` and `TorchScriptFeaturizer` take
    the card when no device is named, and raise without one; the CPU runs
    when asked, the module seeing [0, 1] NCHW at its size."""

    class Pool(torch.nn.Module):
        def forward(self, x):
            return x.mean(dim=(2, 3), keepdim=True)  # [N, 3, 1, 1]

    path = str(tmp_path / "pool.pt")
    torch.jit.script(Pool()).save(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tim.make_featurizer(f"torch:{path}", None, TTINY, size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tim.TorchScriptFeaturizer(path, size=8)
    feat, tag = tim.make_featurizer(f"torch:{path}", None, TTINY, size=8, device="cpu")
    assert tag == "torchscript" and feat.device.type == "cpu"
    images = np.random.RandomState(3).randint(0, 256, (3, 8, 8, 3)).astype(np.uint8)
    np.testing.assert_allclose(feat(images), images.mean(axis=(1, 2)) / 255.0, rtol=1e-6)


def test_draw_layout_grid_and_image_dir_equal_jax(tmp_path):
    rs = np.random.RandomState(2)
    img = rs.uniform(-1, 1, (40, 48, 3)).astype(np.float32)
    boxes, labels = [[0.1, 0.2, 0.5, 0.6], [0.4, 0.1, 0.9, 0.5]], ["a cat", ""]
    got, want = tvis.draw_layout(img, boxes, labels), jvis.draw_layout(img, boxes, labels)
    np.testing.assert_array_equal(got, want)
    tvis.save_image_grid([got, img, got], str(tmp_path / "t" / "grid.png"), cols=2)
    jvis.save_image_grid([want, img, want], str(tmp_path / "j" / "grid.png"), cols=2)
    np.testing.assert_array_equal(tim.load_image_dir(str(tmp_path / "t")),
                                  jim.load_image_dir(str(tmp_path / "j")))
    for i, shape in enumerate(((40, 48, 3), (30, 20, 3))):
        jvis.save_image(rs.randint(0, 256, shape).astype(np.uint8), str(tmp_path / f"d/{i}.jpg"))
    np.testing.assert_array_equal(tim.load_image_dir(str(tmp_path / "d"), limit=2),
                                  jim.load_image_dir(str(tmp_path / "d"), limit=2))


# ---------------------------------------------------------------- the harness


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """Both harnesses over every mode on the same weights and fixtures;
    returns the output roots and the threads each port call ran on."""
    root = tmp_path_factory.mktemp("eval")
    fields = _chip_smoke().write_eval_fixtures(root / "data")
    over = {**fields, "generation.max_new_text_tokens": 8,
            "generation.use_teacher_forcing": True, "generation.use_neg_box": True}
    jcfg = japply_overrides(JPlanGenConfig(model=TINY, janus_hw=TINY.vision.image_size), over)
    tcfg = apply_overrides(PlanGenConfig(model=TTINY, janus_hw=TTINY.vision.image_size), over)
    params, model = _weights()
    threads = {"run": set(), "save": set()}
    run_batch, save = teval._run_batch, teval._save_batch_artifacts

    def spy_run(*a, **kw):
        threads["run"].add(threading.get_ident())
        return run_batch(*a, **kw)

    def spy_save(*a, **kw):
        threads["save"].add(threading.get_ident())
        return save(*a, **kw)

    results = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(teval, "_run_batch", spy_run)
        mp.setattr(teval, "_save_batch_artifacts", spy_save)
        for task, data, bs, n in MODES:
            jrun_validation(jcfg, task, data, n, str(root / "jax"), bs, params=params)
            results[task] = teval.run_validation(tcfg, task, data, n, str(root / "port"), bs,
                                                 model=model, device="cpu")
    return root, threads, results


def _tree(base):
    return sorted(str(p.relative_to(base)) for p in base.rglob("*"))


@pytest.mark.parametrize("task,data,bs,n", MODES, ids=[m[0] for m in MODES])
def test_run_validation_writes_the_jax_tree(harness, task, data, bs, n):
    root, _, results = harness
    name = f"{data}_{task}_{n}"
    jax_tree, port_tree = _tree(root / "jax" / name), _tree(root / "port" / name)
    assert port_tree == jax_tree
    images = task not in ("plan", "mmu")
    assert ("0/pr_image/0.png" in port_tree) == images
    assert ("0_metrics.json" in port_tree) == (not images)
    for b in range(n):
        got = json.loads((root / "port" / name / "0_batch" / f"{b}_layout.json").read_text())
        want = json.loads((root / "jax" / name / "0_batch" / f"{b}_layout.json").read_text())
        assert got == want
    if not images:
        got = json.loads((root / "port" / name / "0_metrics.json").read_text())
        assert got == json.loads((root / "jax" / name / "0_metrics.json").read_text())
    assert len(results[task]) == n
    for out in results[task]:
        assert set(out) == {"pr_grounding", "pr_image"}
        if images:
            size = TTINY.vision.image_size
            assert out["pr_image"].shape == (bs, size, size, 3)


def test_cuda_work_on_the_worker_and_artifacts_on_the_caller(harness):
    _, threads, _ = harness
    assert threads["run"] and threads["save"] == {threading.get_ident()}
    assert not threads["run"] & threads["save"]


def test_image_metrics_keys_and_values_as_jax(tmp_path):
    fields = _chip_smoke().write_eval_fixtures(tmp_path / "data")
    over = {**fields, "train.val_image_metrics": True, "generation.temperature": 0.0}
    jcfg = japply_overrides(JPlanGenConfig(model=TINY, janus_hw=TINY.vision.image_size), over)
    tcfg = apply_overrides(PlanGenConfig(model=TTINY, janus_hw=TTINY.vision.image_size), over)
    params, model = _weights()
    jrun_validation(jcfg, "uni", "coco", 1, str(tmp_path / "jax"), 4, params=params)
    teval.run_validation(tcfg, "uni", "coco", 1, str(tmp_path / "port"), 4, model=model,
                         device="cpu")
    got = json.loads((tmp_path / "port" / "coco_uni_1" / "0_metrics.json").read_text())
    want = json.loads((tmp_path / "jax" / "coco_uni_1" / "0_metrics.json").read_text())
    assert sorted(got) == sorted(want) == ["fid_siglip", "kid_siglip", "kid_siglip_std",
                                           "n_gt", "n_pr"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6, err_msg=k)


# ------------------------------------------------------------------ trainer


def _train_config(tmp_path, **train):
    return apply_overrides(PlanGenConfig(model=TTINY, janus_hw=32), {
        "train.train_data": (FlowConfig("uni", "toy", 2),),
        "train.output_dir": str(tmp_path / "run"),
        "train.checkpointing_steps": 100,
        "train.num_workers": 0,
        "train.prefetch_depth": 0,
        "generation.max_new_text_tokens": 4,
        **{f"train.{k}": v for k, v in train.items()},
    })


def test_trainer_calls_validate_fn_at_the_cadence(tmp_path):
    from plangen_tpu_torch.train.trainer import Trainer

    trainer = Trainer(_train_config(tmp_path, validation_steps=2), device="cpu")
    calls = []
    trainer.fit(max_steps=4, validate_fn=lambda step, model: calls.append((step, model)))
    assert [s for s, _ in calls] == [2, 4] and all(m is trainer.model for _, m in calls)


def test_trainer_validate_logs_val_keys_from_its_own_model(tmp_path):
    from plangen_tpu_torch.train.trainer import Trainer

    cfg = _train_config(tmp_path, validation_steps=1, val_max_len=1,
                        test_data=FlowConfig("plan", "toy", 2))
    trainer = Trainer(cfg, device="cpu")
    trainer.fit(max_steps=1, validate_fn=trainer.validate)
    assert trainer.model.training  # left in training mode
    lines = [json.loads(x) for x in
             (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    val = [x for x in lines if any(k.startswith("val/") for k in x)]
    assert len(val) == 1 and "val/miou" in val[0] and val[0]["step"] == 1
    assert (tmp_path / "run" / "val" / "toy_plan_1" / "1_batch" / "0_layout.json").exists()
