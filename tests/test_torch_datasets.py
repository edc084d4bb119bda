"""The port's dataset layer against the JAX package's, on fixtures in the
real on-disk formats.

Every dataset class of `plangen_tpu_torch/data/` (LayoutSAM eval and train,
COCO val2017, COCO-200 removal and editing, NSR-1K, the LLM plans, GRiT and
GRiT-7k, the edit specs, OpenImages) gives `Sample`s equal to the JAX
copy's: strings equal, arrays exact (both decode and resize with Pillow).
The transforms are equal, the native C++ resize included (both packages'
bindings over one library the tests build with g++), seeded augmentations
draw the same, and the
registry has the JAX registry's names, each building the same dataset. The
fixtures are built as the JAX package's own tests build them
(tests/test_coco_real.py, test_grit.py, test_layoutsam_real.py,
test_oim_real.py, test_data.py), at small image sizes.
"""

import dataclasses
import json

import numpy as np
import pytest

import plangen_tpu.data.native as jnative
import plangen_tpu_torch.data.native as tnative
from plangen_tpu.config import PlanGenConfig as JPlanGenConfig
from plangen_tpu.config import apply_overrides as japply_overrides
from plangen_tpu.data import registry as jregistry
from plangen_tpu.data import transforms as jtransforms
from plangen_tpu.data.schema import Sample as JSample
from plangen_tpu_torch.config import PlanGenConfig, apply_overrides
from plangen_tpu_torch.data import registry, transforms
from plangen_tpu_torch.data.schema import Sample

from test_coco_real import make_coco_fixture
from test_layoutsam_real import make_eval_fixture, make_raw_train_fixture
from test_oim_real import make_oim_fixture

HW = 32  # janus_hw of the fixtures' configs


def assert_samples_equal(got, want):
    assert [f.name for f in dataclasses.fields(Sample)] == \
        [f.name for f in dataclasses.fields(JSample)]
    for f in dataclasses.fields(JSample):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def _write_json(path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj))
    return str(path)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """One directory with every dataset format; returns the config fields
    that point at them."""
    from PIL import Image

    root = tmp_path_factory.mktemp("datasets")
    make_coco_fixture(root / "coco")
    lse = make_eval_fixture(root / "lse", n=3)
    sam_dir, sam_dump = make_raw_train_fixture(root / "sam", n=2)
    make_oim_fixture(root / "oim")

    c200 = root / "coco200"
    for sub in ("image", "mask", "box", "box_new"):
        (c200 / sub).mkdir(parents=True)
    for i in range(2):
        rs = np.random.RandomState(i)
        Image.fromarray(rs.randint(0, 255, (48, 40, 3), dtype=np.uint8)).save(
            c200 / "image" / f"{i}.png")
        m = np.zeros((30, 30), dtype=np.uint8)
        m[6 + i:14, 5:20 - i] = 255
        Image.fromarray(m).save(c200 / "mask" / f"{i}.png")
        _write_json(c200 / "box" / f"{i}.json",
                    {"obj_bbox": [0.25, 0.25, 0.5 + 0.1 * i, 0.5], "obj_class": "cat"})
        _write_json(c200 / "box_new" / f"{i}.json",
                    {"obj_bbox": [0.5, 0.45, 0.9, 0.9], "obj_class": "dog"})

    nsr = root / "nsr"
    _write_json(nsr / "counting" / "counting.train.json", [
        {"prompt": "two cats", "object_list": [["cat", [0.1, 0.1, 0.2, 0.3]],
                                               ["cat", [0.5, 0.5, 0.2, 0.3]]]}])
    _write_json(nsr / "spatial" / "spatial.val.json", [
        {"prompt": "a left of b", "obj1": ["a", [0.1, 0.1, 0.2, 0.2]],
         "obj2": ["b", [0.6, 0.1, 0.2, 0.2]]}])

    img = root / "grit" / "img0.jpg"
    img.parent.mkdir()
    Image.fromarray(np.random.RandomState(5).randint(0, 255, (100, 200, 3),
                                                     dtype=np.uint8)).save(img)
    grit = _write_json(root / "grit" / "grit.json", {
        "0": {"f_path": str(img), "width": 200, "height": 100,
              "caption": "a red cat sits near a blue dog", "url": "",
              "ref_exps": [[2, 11, 0.1, 0.2, 0.4, 0.7, 0.9],
                           [14, 22, 0.55, 0.1, 0.95, 0.9, 0.8],
                           [0, 5, 0.5, 0.5, 0.52, 0.52, 0.8]]},
        "1": {"f_path": str(img), "width": 200, "height": 100, "caption": "a dog",
              "url": "", "ref_exps": [[2, 5, 0.3, 0.1, 0.9, 0.95, 0.7]]}})
    grit7k = _write_json(root / "grit" / "7k.json", [
        [0, "two cats", 0, {"H": 100, "W": 200}, 0,
         [["cat", [10, 20, 50, 60]], ["cat", [60, 80, 90, 100]]]]])
    edit_img = root / "edit" / "e.png"
    edit_img.parent.mkdir()
    Image.fromarray(np.random.RandomState(6).randint(0, 255, (40, 48, 3),
                                                     dtype=np.uint8)).save(edit_img)
    edit = _write_json(root / "edit" / "edit.json", [{
        "base_caption": "a room",
        "new_grounding_prompt": "<ref>chair</ref><box><h500>,<w500>,<h200>,<w200></box>",
        "edited_grounding_prompt": "<ref>chair</ref><box>500,500,400,400</box>",
        "neg_grounding_prompt": "<ref>clutter</ref><box>500,500,100,100</box>",
        "image_path": str(edit_img)}])
    plan = _write_json(root / "plan" / "plan.json", [
        {"obj_bbox": [[51.2, 102.4, 128.0, 64.0], [300.0, 20.0, 100.0, 400.0]],
         "obj_class": ["lamp", "sofa"]},
        {"obj_bbox": [[float(10 * k), 5.0, 40.0, 40.0] for k in range(12)],
         "obj_class": [f"box {k}" for k in range(12)]}])
    caps = root / "plan" / "caps.jsonl"
    caps.write_text(json.dumps("a living room") + "\n" + json.dumps("twelve boxes") + "\n")

    return {
        "coco_root": str(root / "coco"), "coco_200_path": str(c200),
        "nsr1k_path": str(nsr), "layoutsam_eval_path": lse,
        "layoutsam_path": sam_dir, "layoutsam_image_root": sam_dump,
        "oim_root": str(root / "oim"),
        "oim_class_csv": str(root / "oim" / "class-descriptions-boxable.csv"),
        "oim_caption_dir": str(root / "oim" / "caps"),
        "grit_json": grit, "grit_image_dir": "", "grit7k_json": grit7k,
        "edit_json": edit, "plan_json": plan, "plan_caps_jsonl": str(caps),
        "generation.pad_edit_box": 0.1, "generation.neg_prompt": "blurry",
    }


def _configs(fields, **more):
    over = {**fields, **more}
    return (apply_overrides(PlanGenConfig(janus_hw=HW), over),
            japply_overrides(JPlanGenConfig(janus_hw=HW), over))


# ------------------------------------------------------------------ registry


def test_registry_has_the_jax_names():
    assert sorted(registry.REGISTRY) == sorted(jregistry.REGISTRY)
    with pytest.raises(KeyError, match="unknown dataset"):
        registry.get_dataset(PlanGenConfig(), "layoutsam")


@pytest.mark.parametrize("name", sorted(jregistry.REGISTRY))
@pytest.mark.parametrize("is_test", [True, False], ids=["test", "train"])
def test_every_registry_name_builds_the_jax_dataset(fixtures, name, is_test):
    """Same class name, same length, and the first and last samples equal
    (a GRiT training sample draws its augmentations from a fresh seeded
    stream in both)."""
    cfg, jcfg = _configs(fixtures)
    got = registry.get_dataset(cfg, name, is_test=is_test)
    want = jregistry.get_dataset(jcfg, name, is_test=is_test)
    assert type(got).__name__ == type(want).__name__
    assert len(got) == len(want) > 0
    n = min(len(want), 2)  # the COCO-200 sets say 200 and hold 2 on disk
    for i in sorted({0, n - 1}):
        assert_samples_equal(got[i], want[i])


def test_registry_list_concatenates(fixtures):
    cfg, jcfg = _configs(fixtures)
    got = registry.get_dataset(cfg, ["layout", "hico_7k", "plan"])
    want = jregistry.get_dataset(jcfg, ["layout", "hico_7k", "plan"])
    assert isinstance(got, registry.ConcatDataset) and len(got) == len(want) == 11 + 1 + 2
    for i in range(len(want)):
        assert_samples_equal(got[i], want[i])


def test_missing_files_raise_as_in_jax():
    cfg, jcfg = _configs({})
    for name in ("creati", "sam", "edit_coco", "rm_coco", "layout", "hico", "hico_7k",
                 "edit", "plan"):
        with pytest.raises(FileNotFoundError):
            jregistry.get_dataset(jcfg, name, is_test=True)
        with pytest.raises(FileNotFoundError):
            registry.get_dataset(cfg, name, is_test=True)


# ------------------------------------------------------------------ datasets


@pytest.mark.parametrize("detail", [True, False], ids=["detail", "short"])
def test_layoutsam_eval_samples_equal_jax(fixtures, detail):
    from plangen_tpu.data.layoutsam import LayoutSAMEval as J
    from plangen_tpu_torch.data.layoutsam import LayoutSAMEval as T

    path = fixtures["layoutsam_eval_path"]
    got = T(path, image_hw=HW, limit=2, neg_prompt="x", use_detail_captions=detail,
            textual=False)
    want = J(path, image_hw=HW, limit=2, neg_prompt="x", use_detail_captions=detail,
             textual=False)
    assert len(got) == len(want) == 2
    for i in range(2):
        assert_samples_equal(got[i], want[i])


def test_coco_samples_equal_jax(fixtures):
    from plangen_tpu.data.coco import COCOValDataset as J
    from plangen_tpu_torch.data.coco import COCOValDataset as T

    root = fixtures["coco_root"]
    args = (f"{root}/annotations/instances_val2017.json",
            f"{root}/annotations/captions_val2017.json", f"{root}/val2017")
    got, want = T(*args, image_hw=HW, textual=False), J(*args, image_hw=HW, textual=False)
    assert got.image_ids == want.image_ids
    for i in range(len(want)):
        assert_samples_equal(got[i], want[i])


@pytest.mark.parametrize("textual", [True, False], ids=["textual", "numhw"])
def test_coco200_removal_and_edit_samples_equal_jax(fixtures, textual):
    from plangen_tpu.data import coco as J
    from plangen_tpu_torch.data import coco as T

    root = fixtures["coco_200_path"]
    assert T.RM_NEG_CLASS == J.RM_NEG_CLASS
    for i in range(2):
        assert_samples_equal(T.RmCoco200(root, neg_prompt="n", textual=textual)[i],
                             J.RmCoco200(root, neg_prompt="n", textual=textual)[i])
        assert_samples_equal(
            T.EditCoco200(root, pad_edit_box=0.2, textual=textual)[i],
            J.EditCoco200(root, pad_edit_box=0.2, textual=textual)[i])


def test_grit_training_augmentations_draw_as_jax(fixtures):
    """Seeded flip, caption dropout and IoU crop: the same stream of
    samples, draw after draw, on the calling thread."""
    from plangen_tpu.data.grit import GritSceneGraphDataset as J
    from plangen_tpu_torch.data.grit import GritSceneGraphDataset as T

    kw = dict(image_hw=HW, flip=True, proportion_empty_prompts=0.5,
              use_min_iou_crop=True, seed=3)
    got, want = T(fixtures["grit_json"], **kw), J(fixtures["grit_json"], **kw)
    assert len(got) == len(want) == 2
    prompts = set()
    for k in range(12):
        a, b = got[k % 2], want[k % 2]
        assert_samples_equal(a, b)
        prompts.add(a.prompt)
    assert len(prompts) > 3  # the augmentations did move the layout


def test_oim_samples_equal_jax(fixtures):
    from plangen_tpu.data.oim import OpenImagesDataset as J
    from plangen_tpu_torch.data.oim import OpenImagesDataset as T

    args = (fixtures["oim_root"], fixtures["oim_class_csv"])
    kw = dict(caption_dir=fixtures["oim_caption_dir"], image_hw=HW)
    got, want = T(*args, **kw), J(*args, **kw)
    assert len(got) == len(want) == 2
    for i in range(2):
        assert_samples_equal(got[i], want[i])


# ---------------------------------------------------------------- transforms


@pytest.mark.parametrize("hw,crop", [((100, 200), True), ((150, 60), True),
                                     ((90, 130), False)])
def test_resize_short_side_center_crop_equals_jax(hw, crop):
    rs = np.random.RandomState(sum(hw))
    image = rs.randint(0, 256, hw + (3,), dtype=np.uint8)
    boxes = np.array([[10, 5, 40, 30], [0, 0, hw[1], hw[0]]], dtype=np.float32)
    got = transforms.resize_short_side_center_crop(image, boxes, 48, crop=crop)
    want = jtransforms.resize_short_side_center_crop(image, boxes, 48, crop=crop,
                                                     backend="pil")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # without the library both `auto`s take Pillow, and `native` raises in both
    for mod in (jnative, tnative):
        assert mod._SO_PATH.endswith("native/libplangen_data.so")
    with pytest.raises(RuntimeError, match="native library not built"):
        _with_library(None, lambda: transforms.resize_short_side_center_crop(
            image, boxes, 48, backend="native"))


def _with_library(path, fn):
    """fn() with both packages' bindings pointed at `path` (None: no
    library), then their state restored."""
    saved = [(m, m._SO_PATH, m._LIB, m._TRIED) for m in (jnative, tnative)]
    try:
        for m in (jnative, tnative):
            m._SO_PATH = path or "/nonexistent/libplangen_data.so"
            m._LIB, m._TRIED = None, False
        return fn()
    finally:
        for m, so, lib, tried in saved:
            m._SO_PATH, m._LIB, m._TRIED = so, lib, tried


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """native/plangen_data.cc built with g++ (the Makefile's flags) into a
    temporary directory; skipped only where there is no compiler."""
    import pathlib
    import shutil
    import subprocess

    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build native/plangen_data.cc")
    src = pathlib.Path(__file__).resolve().parent.parent / "native" / "plangen_data.cc"
    out = tmp_path_factory.mktemp("native") / "libplangen_data.so"
    subprocess.run([cxx, "-O3", "-march=native", "-fPIC", "-std=c++17", str(src), "-o",
                    str(out), "-shared", "-lpthread"], check=True, timeout=300)
    return str(out)


@pytest.mark.parametrize("normalize", [True, False])
def test_native_resize_equals_jax(native_lib, normalize):
    rs = np.random.RandomState(5)
    image = rs.randint(0, 256, (37, 53, 3), dtype=np.uint8)
    batch = rs.randint(0, 256, (3, 20, 30, 3), dtype=np.uint8)

    def both(fn_name, *args, **kw):
        return [getattr(m, fn_name)(*args, **kw) for m in (tnative, jnative)]

    def run():
        assert tnative.native_available() and jnative.native_available()
        got, want = both("resize_bilinear_native", image, (24, 31), normalize=normalize)
        np.testing.assert_array_equal(got, want)
        got, want = both("resize_bilinear_batch_native", batch, (9, 14), normalize=normalize)
        np.testing.assert_array_equal(got, want)
        got, want = both("resize_to_model_input", image, 16)
        np.testing.assert_array_equal(got, want)
        return got

    assert _with_library(native_lib, run).shape == (16, 16, 3)


@pytest.mark.parametrize("backend", ["auto", "native"])
def test_native_transform_equals_jax(native_lib, backend):
    rs = np.random.RandomState(6)
    image = rs.randint(0, 256, (70, 110, 3), dtype=np.uint8)
    boxes = np.array([[10, 5, 40, 30]], dtype=np.float32)

    def run():
        got = transforms.resize_short_side_center_crop(image, boxes, 48, backend=backend)
        want = jtransforms.resize_short_side_center_crop(image, boxes, 48, backend=backend)
        pil = transforms.resize_short_side_center_crop(image, boxes, 48, backend="pil")
        return got, want, pil

    got, want, pil = _with_library(native_lib, run)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # the native resize is not Pillow's: `auto` took the library, as JAX's does
    assert not np.array_equal(got[0], pil[0])


def test_auto_takes_the_backend_jax_takes(native_lib):
    image = np.random.RandomState(7).randint(0, 256, (60, 90, 3), dtype=np.uint8)
    boxes = np.zeros((0, 4), np.float32)
    for path in (native_lib, None):
        got, want = _with_library(path, lambda: (
            transforms.resize_short_side_center_crop(image, boxes, 32)[0],
            jtransforms.resize_short_side_center_crop(image, boxes, 32)[0]))
        np.testing.assert_array_equal(got, want)
        assert _with_library(path, tnative.native_available) == (path is not None)


def test_box_transforms_equal_jax():
    rs = np.random.RandomState(0)
    xywh = rs.uniform(-20, 400, (12, 4)).astype(np.float32)
    classes = [f"c{i}" for i in range(12)]
    for fn, args in (("filter_boxes_canvas", (xywh, classes)),
                     ("xywh_to_xyxy_norm", (xywh, 384.0)),
                     ("pad_layout_slots", (xywh / 400, classes))):
        got, want = getattr(transforms, fn)(*args), getattr(jtransforms, fn)(*args)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    image = rs.randint(0, 256, (60, 90, 3), dtype=np.uint8)
    boxes = np.array([[10, 10, 40, 50], [50, 5, 85, 55]], dtype=np.float32)
    for seed in range(6):
        got = transforms.iou_sample_crop(image, boxes, ["a", "b"], np.random.RandomState(seed))
        want = jtransforms.iou_sample_crop(image, boxes, ["a", "b"],
                                           np.random.RandomState(seed))
        assert (got is None) == (want is None)
        if got is not None:
            for a, b in zip(got, want):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        norm = boxes / 90
        for a, b in zip(transforms.random_mirror(image, norm, np.random.RandomState(seed)),
                        jtransforms.random_mirror(image, norm, np.random.RandomState(seed))):
            np.testing.assert_array_equal(a, b)
