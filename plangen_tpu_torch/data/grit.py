"""GRiT-20M / HiCo scene-graph datasets + misc small loaders.

A copy of `plangen_tpu/data/grit.py`, which the port cannot import
(`plangen_tpu/data/__init__.py` imports jax); tests/test_torch_datasets.py
holds the two copies' samples equal, seeded augmentations included.

Behavioral re-implementations of:
  * `GritSceneGraphDataset` (code_hico/debug_grit.py:47-573): json dict
    idx -> {f_path, ref_exps, width, height, caption, url}; each ref_exp is
    [phrase_start, phrase_end, x1n, y1n, x2n, y2n, score] with the phrase
    sliced out of the caption; boxes under 5% of a side dropped at parse, at
    most 8 objects; short-side resize + optional mirror; PlanGen drops the
    slot-0 whole-image entry (preprocess_hico, data_hico.py:269-289) so this
    loader emits per-phrase boxes directly.
  * `Dataset_7k` (hico7k/data_7k.py:19-59): GRiT-7k eval json rows
    [_, caption, _, {H, W}, _, [[phrase, box_px], ...]] with boxes normalized
    x by H and y by W exactly as the reference does (note: the reference
    divides x-coords by H and y-coords by W).
  * `Dataset_edit` (edit/dataset_edit.py:18-80): grounding-string-driven edit
    spec jsons with center-format <h>,<w> boxes.
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Tuple

import numpy as np

from plangen_tpu_torch.data.preprocess import build_edit_region, to_model_range
from plangen_tpu_torch.data.schema import Sample
from plangen_tpu_torch.data.transforms import (
    iou_sample_crop,
    pad_layout_slots,
    random_mirror,
    resize_short_side_center_crop,
    xywh_to_xyxy_norm,
)
from plangen_tpu_torch.text.grounding import serialize_grounding


class GritSceneGraphDataset:
    """GRiT-20M grounded-caption training data."""

    def __init__(
        self,
        grit_json: str,
        image_dir: str = "",
        image_hw: int = 384,
        max_objects: int = 8,
        min_side_frac: float = 0.05,
        flip: bool = False,
        neg_prompt: str = "",
        seed: int = 0,
        # caption dropout for CFG training: with this probability the sample's
        # caption becomes "" while the grounded boxes stay
        # (debug_grit.py:51,278 proportion_empty_prompts=0.05)
        proportion_empty_prompts: float = 0.0,
        # SSD-style IoU-constrained square crop instead of the center crop
        # (debug_grit.py:56,445 use_MinIoURandomCrop)
        use_min_iou_crop: bool = False,
        textual: bool = True,
    ):
        self.textual = textual
        if not os.path.exists(grit_json):
            raise FileNotFoundError(f"GRiT json not found at {grit_json}")
        with open(grit_json) as f:
            data = json.load(f)
        self.items = []
        for idx, obj in data.items():
            w, h = obj["width"], obj["height"]
            caption = obj["caption"]
            boxes: List[List[float]] = []
            phrases: List[str] = []
            for exp in obj["ref_exps"]:
                ps, pe, x1n, y1n, x2n, y2n = (
                    int(exp[0]), int(exp[1]), exp[2], exp[3], exp[4], exp[5],
                )
                x1, y1 = int(x1n * w), int(y1n * h)
                x2, y2 = min(int(x2n * w), w), min(int(y2n * h), h)
                if (x2 - x1) < min_side_frac * w or (y2 - y1) < min_side_frac * h:
                    continue
                boxes.append([x1, y1, x2 - x1, y2 - y1])  # xywh px
                phrases.append(caption[ps:pe])
                if len(boxes) >= max_objects:
                    break
            if not boxes:
                continue
            self.items.append(
                {
                    "path": os.path.join(image_dir, obj["f_path"]),
                    "caption": caption,
                    "boxes": np.asarray(boxes, dtype=np.float32),
                    "phrases": phrases,
                }
            )
        self.hw = image_hw
        self.flip = flip
        self.neg_prompt = neg_prompt
        self.proportion_empty_prompts = proportion_empty_prompts
        self.use_min_iou_crop = use_min_iou_crop
        self.seed = seed
        # per-thread RNG streams: BatchLoader(workers>0) calls __getitem__
        # from a pool, and np.random.RandomState is not thread-safe — a
        # shared stream corrupts under concurrency. Each thread gets its own
        # seeded stream (torch DataLoader's per-worker seeding, same
        # reproducibility caveat: draws depend on the sample->thread map).
        import threading

        self._tls = threading.local()

    @property
    def rng(self) -> np.random.RandomState:
        import threading

        r = getattr(self._tls, "rng", None)
        if r is None:
            # main thread keeps the exact seeded stream (single-threaded
            # loading stays run-reproducible); pool threads get derived ones
            if threading.current_thread() is threading.main_thread():
                r = np.random.RandomState(self.seed)
            else:
                r = np.random.RandomState(
                    (self.seed + threading.get_ident()) % (2 ** 31 - 1)
                )
            self._tls.rng = r
        return r

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int) -> Sample:
        from PIL import Image

        it = self.items[i]
        image = np.asarray(Image.open(it["path"]).convert("RGB"))
        phrases = it["phrases"]
        if self.use_min_iou_crop:
            # short-side resize, then an IoU-constrained random square crop
            # replaces the center crop (reference order: resize -> flip ->
            # MinIoU crop, debug_grit.py:400,431,445; flip and crop are both
            # random so applying crop first is distributionally identical)
            img, xywh = resize_short_side_center_crop(
                image, it["boxes"], self.hw, crop=False
            )
            xyxy_px = xywh.copy()
            xyxy_px[:, 2:] += xyxy_px[:, :2]
            cropped = iou_sample_crop(img, xyxy_px, phrases, self.rng)
            if cropped is not None:
                img, kept_xyxy, phrases = cropped
                boxes = (kept_xyxy / self.hw).clip(0, 1)
            else:
                # no valid crop found: fall back to the center crop
                img, xywh = resize_short_side_center_crop(
                    image, it["boxes"], self.hw
                )
                boxes = xywh_to_xyxy_norm(xywh, self.hw).clip(0, 1)
        else:
            img, xywh = resize_short_side_center_crop(image, it["boxes"], self.hw)
            boxes = xywh_to_xyxy_norm(xywh, self.hw).clip(0, 1)
        img_f = to_model_range(img)
        if self.flip:
            img_f, boxes = random_mirror(img_f, boxes, self.rng)
        boxes10, classes10, valid = pad_layout_slots(boxes, phrases)
        caption = it["caption"]
        if (
            self.proportion_empty_prompts > 0
            and self.rng.rand() < self.proportion_empty_prompts
        ):
            caption = ""  # CFG caption dropout (debug_grit.py:278)
        return Sample(
            image=img_f,
            base_caption=caption,
            prompt=serialize_grounding(caption, boxes10, classes10, valid,
                                       textual=self.textual),
            gt_grounding=serialize_grounding("", boxes10, classes10, valid,
                                            textual=self.textual),
            neg_base_caption=self.neg_prompt,
            neg_prompt=self.neg_prompt,
            edit_region=np.zeros((576,), dtype=np.int64),
            image_id=str(i),
        )


class Grit7kDataset:
    """GRiT-7k layout eval set (text + boxes, no images needed)."""

    def __init__(self, json_path: str, neg_prompt: str = "", textual: bool = True):
        self.textual = textual
        if not os.path.exists(json_path):
            raise FileNotFoundError(f"7k json not found at {json_path}")
        with open(json_path) as f:
            self.datas = json.load(f)
        self.neg_prompt = neg_prompt

    def __len__(self):
        return len(self.datas)

    def __getitem__(self, i: int) -> Sample:
        row = self.datas[i]
        caption = row[1]
        h, w = row[3]["H"], row[3]["W"]
        boxes = []
        classes = []
        for phrase, box in row[5]:
            b = np.asarray(box, dtype=np.float32)
            # reference normalization: x coords / H, y coords / W
            # (data_7k.py:48-50) — replicated verbatim for parity
            b[0::2] /= h
            b[1::2] /= w
            boxes.append(b)
            classes.append(phrase)
        boxes10, classes10, valid = pad_layout_slots(np.asarray(boxes), classes)
        return Sample(
            image=None,
            base_caption=caption,
            prompt=serialize_grounding(caption, boxes10, classes10, valid,
                                       textual=self.textual),
            gt_grounding=serialize_grounding("", boxes10, classes10, valid,
                                            textual=self.textual),
            neg_base_caption=self.neg_prompt,
            neg_prompt=self.neg_prompt,
            edit_region=np.zeros((576,), dtype=np.int64),
        )


_CENTER_BOX_RE = re.compile(r"<ref>(.*?)</ref><box>(.*?)</box>")
_HW_TOKEN_RE = re.compile(r"<[hw](\d+)>")


def _parse_center_grounding(text: str) -> Tuple[List[str], np.ndarray]:
    """Parse center-format groundings: <box><h cy>,<w cx>,... or ints.

    Reference `Dataset_edit.get_obj_from_grounding` + funcs.convert_coordinates
    (funcs.py:71-83): <h/w> tokens become ints, box holds (cx, cy, h, w)
    center format scaled 0-1000.
    """
    classes, boxes = [], []
    for desc, body in _CENTER_BOX_RE.findall(text):
        body = _HW_TOKEN_RE.sub(lambda m: m.group(1), body)
        try:
            cx, cy, bh, bw = (int(v) for v in body.split(","))
        except ValueError:
            continue
        x1, y1 = cx - bw / 2, cy - bh / 2
        x2, y2 = cx + bw / 2, cy + bh / 2
        classes.append(desc)
        boxes.append([x1, y1, x2, y2])
    arr = np.asarray(boxes, dtype=np.float32).reshape(-1, 4).clip(0, 1000) / 1000.0
    return classes, arr


class EditSpecDataset:
    """Grounding-string-driven editing specs (edit.json variant)."""

    def __init__(self, json_path: str, neg_prompt: str = "", pad_edit_box: float = 0.0,
                 textual: bool = True):
        self.textual = textual
        if not os.path.exists(json_path):
            raise FileNotFoundError(f"edit json not found at {json_path}")
        with open(json_path) as f:
            self.datas = json.load(f)
        self.neg_prompt = neg_prompt
        self.pad_edit_box = pad_edit_box

    def __len__(self):
        return len(self.datas)

    def __getitem__(self, i: int) -> Sample:
        from PIL import Image

        d = self.datas[i]
        classes, boxes = _parse_center_grounding(d.get("new_grounding_prompt", ""))
        _, edit_boxes = _parse_center_grounding(d.get("edited_grounding_prompt", ""))
        neg_classes, neg_boxes = _parse_center_grounding(
            d.get("neg_grounding_prompt", "")
        )
        image = to_model_range(
            np.asarray(Image.open(d["image_path"]).convert("RGB"))
        )
        boxes10, classes10, valid = pad_layout_slots(boxes, classes)
        caption = d.get("base_caption", "")
        neg_grounding = (
            serialize_grounding("", neg_boxes, neg_classes,
                                [True] * len(neg_classes), textual=self.textual)
            if len(neg_classes)
            else ""
        )
        return Sample(
            image=image,
            base_caption=caption,
            prompt=serialize_grounding(caption, boxes10, classes10, valid,
                                       textual=self.textual),
            gt_grounding=serialize_grounding("", boxes10, classes10, valid,
                                            textual=self.textual),
            neg_base_caption=self.neg_prompt,
            neg_prompt=self.neg_prompt,
            neg_gt_grounding=neg_grounding,
            edit_region=build_edit_region(
                edit_boxes, grid=24, pad_edit_box=self.pad_edit_box
            ),
            image_id=str(i),
        )
