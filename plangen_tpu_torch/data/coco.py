"""COCO val2017 loader + the coco_200 edit/removal fixed sets.

A copy of `plangen_tpu/data/coco.py`, which the port cannot import
(`plangen_tpu/data/__init__.py` imports jax); tests/test_torch_datasets.py
holds the two copies' samples equal.

Behavioral re-implementations of:
  * `Dataset_coco` (dataset/coco/data_coco.py:109-201): per-annotation boxes
    -> normalized xyxy, first caption, 384x384 direct resize (aspect
    distorting — the reference does this), dilated annotation masks -> 24x24.
  * `Dataset_edit_coco_edit` (dataset_edit_coco_edit.py:18-68): 200 samples,
    old/new box jsons; target layout = new box; edit region = union(old, new).
  * `Dataset_edit_coco_rm` (dataset_edit_coco_rm.py:18-66): 200 samples,
    target = empty class + zero box; edit region from 24x24 mask png; negative
    grounding = clutter words at the removed box.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from plangen_tpu_torch.data.preprocess import to_model_range
from plangen_tpu_torch.data.schema import Sample
from plangen_tpu_torch.data.transforms import pad_layout_slots
from plangen_tpu_torch.text.grounding import serialize_grounding

RM_NEG_CLASS = (
    "an object, a person, artifacts, disharmonious objects, abrupt objects, "
    "messy background, noisy environment"
)  # reference: dataset_edit_coco_rm.py:50


class _MiniCOCO:
    """Dependency-free reader for the COCO annotation JSON schema
    ({images, annotations, categories}); used when pycocotools is absent.
    Implements exactly the calls COCOValDataset makes, with pycocotools'
    semantics (getAnnIds iscrowd filter, id-keyed loads)."""

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            d = json.load(f)
        self.imgs = {im["id"]: im for im in d.get("images", [])}
        self.anns = {a["id"]: a for a in d.get("annotations", [])}
        self.cats = {c["id"]: c for c in d.get("categories", [])}
        self.img_to_anns: dict = {}
        for a in d.get("annotations", []):
            self.img_to_anns.setdefault(a["image_id"], []).append(a)

    def getImgIds(self):
        return list(self.imgs)

    def loadImgs(self, ids):
        return [self.imgs[i] for i in ids]

    def getAnnIds(self, imgIds, iscrowd=None):
        out = []
        for i in imgIds:
            for a in self.img_to_anns.get(i, []):
                if iscrowd is None or a.get("iscrowd", 0) == iscrowd:
                    out.append(a["id"])
        return out

    def loadAnns(self, ids):
        return [self.anns[i] for i in ids]

    def loadCats(self, ids):
        return [self.cats[i] for i in ids]


def _open_coco(ann_file: str):
    try:
        from pycocotools.coco import COCO

        return COCO(ann_file)
    except ImportError:
        return _MiniCOCO(ann_file)


class COCOValDataset:
    """COCO val2017 boxes + captions (pycocotools when present, else the
    built-in schema reader)."""

    def __init__(
        self,
        ann_file: str,
        caption_file: str,
        image_dir: str,
        image_hw: int = 384,
        neg_prompt: str = "",
        textual: bool = True,
    ):
        self.textual = textual
        self.coco = _open_coco(ann_file)
        self.coco_caption = _open_coco(caption_file)
        self.image_dir = image_dir
        self.image_ids = sorted(self.coco.getImgIds())
        self.hw = image_hw
        self.neg_prompt = neg_prompt

    def __len__(self):
        return len(self.image_ids)

    def __getitem__(self, idx: int) -> Sample:
        from PIL import Image

        img_id = self.image_ids[idx]
        info = self.coco.loadImgs([img_id])[0]
        w, h = info["width"], info["height"]
        anns = self.coco.loadAnns(self.coco.getAnnIds(imgIds=[img_id], iscrowd=None))
        cap_anns = self.coco_caption.loadAnns(
            self.coco_caption.getAnnIds(imgIds=[img_id], iscrowd=None)
        )
        caption = cap_anns[0]["caption"] if cap_anns else ""

        boxes = np.asarray([a["bbox"] for a in anns], dtype=np.float32).reshape(-1, 4)
        boxes[:, 0::2] /= w
        boxes[:, 1::2] /= h
        boxes[:, 2] += boxes[:, 0]
        boxes[:, 3] += boxes[:, 1]
        classes = [
            c["name"]
            for c in self.coco.loadCats([a["category_id"] for a in anns])
        ]

        path = os.path.join(self.image_dir, f"{img_id:012d}.jpg")
        img = Image.open(path).convert("RGB").resize((self.hw, self.hw))
        image = to_model_range(np.asarray(img))

        boxes10, classes10, valid = pad_layout_slots(boxes, classes)
        return Sample(
            image=image,
            base_caption=caption,
            prompt=serialize_grounding(caption, boxes10, classes10, valid,
                                       textual=self.textual),
            gt_grounding=serialize_grounding("", boxes10, classes10, valid,
                                            textual=self.textual),
            neg_base_caption=self.neg_prompt,
            neg_prompt=self.neg_prompt,
            edit_region=np.zeros((576,), dtype=np.int64),
            image_id=f"{img_id:012d}",
            H=h,
            W=w,
        )


def _load_image_ts(path: str, hw: Optional[int] = None) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if hw:
        img = img.resize((hw, hw))
    return to_model_range(np.asarray(img))


class EditCoco200:
    """Layout-guided editing eval set (200 samples from coco_200_path)."""

    def __init__(self, root: str, neg_prompt: str = "", pad_edit_box: float = 0.1,
                 textual: bool = True):
        self.textual = textual
        if not os.path.isdir(root):
            raise FileNotFoundError(f"coco_200 edit data not found at {root}")
        self.root = root
        self.neg_prompt = neg_prompt
        self.pad_edit_box = pad_edit_box

    def __len__(self):
        return 200

    def __getitem__(self, i: int) -> Sample:
        from plangen_tpu_torch.data.preprocess import build_edit_region

        image = _load_image_ts(os.path.join(self.root, "image", f"{i}.png"))
        with open(os.path.join(self.root, "box", f"{i}.json")) as f:
            old = json.load(f)
        with open(os.path.join(self.root, "box_new", f"{i}.json")) as f:
            new = json.load(f)
        old_box = np.asarray(old["obj_bbox"], dtype=np.float32).reshape(1, 4)
        new_box = np.asarray(new["obj_bbox"], dtype=np.float32).reshape(1, 4)
        edit_boxes = np.concatenate([old_box, new_box], axis=0)
        edit_region = build_edit_region(
            edit_boxes, grid=24, pad_edit_box=self.pad_edit_box
        )

        boxes10, classes10, valid = pad_layout_slots(new_box, [new["obj_class"]])
        return Sample(
            image=image,
            base_caption="",
            prompt=serialize_grounding("", boxes10, classes10, valid,
                                       textual=self.textual),
            gt_grounding=serialize_grounding("", boxes10, classes10, valid,
                                            textual=self.textual),
            neg_base_caption=self.neg_prompt,
            neg_prompt=self.neg_prompt,
            edit_region=edit_region,
            image_id=str(i),
        )


class RmCoco200:
    """Object-removal eval set: empty target layout, clutter-word negative
    grounding at the removed box, mask-driven edit region."""

    def __init__(self, root: str, neg_prompt: str = "", textual: bool = True):
        self.textual = textual
        if not os.path.isdir(root):
            raise FileNotFoundError(f"coco_200 rm data not found at {root}")
        self.root = root
        self.neg_prompt = neg_prompt

    def __len__(self):
        return 200

    def __getitem__(self, i: int) -> Sample:
        from PIL import Image

        image = _load_image_ts(os.path.join(self.root, "image", f"{i}.png"))
        with open(os.path.join(self.root, "box", f"{i}.json")) as f:
            old = json.load(f)
        old_box = np.asarray(old["obj_bbox"], dtype=np.float32).reshape(1, 4)

        mask = Image.open(os.path.join(self.root, "mask", f"{i}.png"))
        mask = np.asarray(mask.resize((24, 24)).convert("RGB"))[..., 0] / 255.0
        edit_region = (mask.reshape(-1) > 0.5).astype(np.int64)

        # target: empty layout (zero box, empty class) => caption-only prompt
        zero_box = np.zeros_like(old_box)
        boxes10, classes10, valid = pad_layout_slots(zero_box, [""])
        neg_grounding = serialize_grounding(
            "", old_box, [RM_NEG_CLASS], [True], textual=self.textual
        )
        return Sample(
            image=image,
            base_caption="",
            prompt=serialize_grounding("", boxes10, classes10, valid,
                                       textual=self.textual),
            gt_grounding=serialize_grounding("", boxes10, classes10, valid,
                                            textual=self.textual),
            neg_base_caption=self.neg_prompt,
            neg_prompt=self.neg_prompt,
            neg_gt_grounding=neg_grounding,
            edit_region=edit_region,
            image_id=str(i),
        )
