"""LayoutSAM / LayoutSAM-eval ("creati") loaders.

A copy of `plangen_tpu/data/layoutsam.py`, which the port cannot import
(`plangen_tpu/data/__init__.py` imports jax); tests/test_torch_datasets.py
holds the two copies' samples equal.

Behavioral re-implementation of the reference's `BboxDataset_sam`
(dataset/sam/sam_traindata.py:21-137) + `convert_creati_to_hico`
(data_hico.py:185-215): stringified box/caption lists parsed with
literal_eval, boxes normalized by original W/H, eval images bilinear-resized
square, train images short-side-resize-crop to 384 with canvas box filtering.
Requires a local HF-datasets copy (zero-egress environment: path-gated).
"""

from __future__ import annotations

import ast
import os
from typing import Optional

import numpy as np

from plangen_tpu_torch.data.preprocess import to_model_range
from plangen_tpu_torch.data.schema import Sample
from plangen_tpu_torch.data.transforms import (
    filter_boxes_canvas,
    pad_layout_slots,
    resize_short_side_center_crop,
    xywh_to_xyxy_norm,
)
from plangen_tpu_torch.text.grounding import serialize_grounding


def _normalize_xyxy(boxes, w, h):
    b = np.asarray(boxes, dtype=np.float32).reshape(-1, 4)
    b[:, 0::2] = np.round(b[:, 0::2] / w, 3)
    b[:, 1::2] = np.round(b[:, 1::2] / h, 3)
    # clip like grit.py/layoutgpt.py: an annotation past the image edge
    # would serialize to an out-of-vocab <h100+>/<w100+> token in numhw
    # mode (byte-fallback-encoded into many ids — silent label divergence)
    return b.clip(0.0, 1.0)


def _parse_list(v):
    return ast.literal_eval(v) if isinstance(v, str) else v


def _captions(item, detail: bool):
    """Caption columns of the real HF datasets are 'region_captions' /
    'detail_region_captions' (reference testset branch reads exactly these,
    sam_traindata.py:89-99); '*_caption_list' names are tolerated because
    the reference's own __getitem__ re-emits them under those keys."""
    names = (
        ("detail_region_captions", "detail_region_caption_list")
        if detail
        else ("region_captions", "region_caption_list")
    )
    for k in names:
        if k in item and item[k] is not None:
            return _parse_list(item[k])
    raise KeyError(f"none of {names} present; columns: {sorted(item)}")


class LayoutSAMEval:
    """LayoutSAM-eval test split ('creati'; '1k' = first 1000 samples).

    Reference: data_hico.py:119-123 + sam_traindata.py testset branch.
    """

    def __init__(
        self,
        path: str,
        image_hw: int = 384,
        limit: Optional[int] = None,
        neg_prompt: str = "",
        use_detail_captions: bool = True,
        textual: bool = True,
    ):
        self.textual = textual
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"LayoutSAM-eval not found at {path}; download "
                "HuiZhang0812/LayoutSAM-eval and point layoutsam_eval_path at it"
            )
        from datasets import load_dataset

        self.ds = load_dataset(path)["test"]
        self.hw = image_hw
        self.limit = limit
        self.neg_prompt = neg_prompt
        self.use_detail = use_detail_captions

    def __len__(self):
        n = len(self.ds)
        return min(n, self.limit) if self.limit else n

    def __getitem__(self, idx: int) -> Sample:
        item = self.ds[idx]
        w, h = int(item["width"]), int(item["height"])
        boxes = _normalize_xyxy(_parse_list(item["bbox_list"]), w, h)
        caps = _captions(item, detail=self.use_detail)
        if any(c is None for c in caps):
            # null detail captions fall back to the short ones
            # (sam_traindata.py:124-125)
            caps = _captions(item, detail=False)

        image = item["image"]
        pil = image.convert("RGB").resize((self.hw, self.hw))
        img = to_model_range(np.asarray(pil))

        boxes10, classes10, valid = pad_layout_slots(boxes, caps)
        caption = item["global_caption"]
        prompt = serialize_grounding(caption, boxes10, classes10, valid,
                                     textual=self.textual)
        gt_grounding = serialize_grounding("", boxes10, classes10, valid,
                                          textual=self.textual)
        return Sample(
            image=img,
            base_caption=caption,
            prompt=prompt,
            gt_grounding=gt_grounding,
            neg_base_caption=self.neg_prompt,
            neg_prompt=self.neg_prompt,
            edit_region=np.zeros((576,), dtype=np.int64),
            image_id=str(item.get("file_name", idx)),
            boxes=[tuple(b) for b in boxes10[valid > 0]],
            classes=[c for c, v in zip(classes10, valid) if v],
            H=h,
            W=w,
        )


class LayoutSAMTrain:
    """LayoutSAM train split: resize-crop to 384 + canvas box filter.

    Reference: sam_traindata.py train branch (:101-120). The raw HF
    LayoutSAM train rows carry `image_path` + a nested `metadata` dict
    ({bbox_info: [{bbox, description, detail_description}], global_caption,
    image_info: {height, width, file_name}}) with images in a separate SAM
    dump — the reference flattens them in `update_item`
    (sam_traindata.py:41-72); flat rows with an `image` column are also
    accepted (pre-flattened local copies).
    """

    def __init__(
        self,
        path: str,
        image_hw: int = 384,
        neg_prompt: str = "",
        image_root: str = "",
        textual: bool = True,
    ):
        self.textual = textual
        if not os.path.exists(path):
            raise FileNotFoundError(f"LayoutSAM not found at {path}")
        from datasets import load_dataset

        self.ds = load_dataset(path)["train"]
        self.hw = image_hw
        self.neg_prompt = neg_prompt
        self.image_root = image_root

    def __len__(self):
        return len(self.ds)

    def _flatten_raw(self, item) -> dict:
        """update_item semantics (sam_traindata.py:41-72): pull the flat
        columns out of `metadata` and load the image from the SAM dump
        ('xx/<dirname>/<file>' -> root/int(dirname)/file)."""
        from PIL import Image

        meta = item["metadata"]
        info = meta["image_info"]
        bbox_info = meta["bbox_info"]
        dirname, filename = item["image_path"][3:].split("/")
        image = Image.open(
            os.path.join(self.image_root, str(int(dirname)), filename)
        ).convert("RGB")
        return {
            "image": image,
            "height": info["height"],
            "width": info["width"],
            "global_caption": meta["global_caption"],
            "bbox_list": [b["bbox"] for b in bbox_info],
            "region_captions": [b["description"] for b in bbox_info],
            "detail_region_captions": [
                b["detail_description"] for b in bbox_info
            ],
        }

    def __getitem__(self, idx: int) -> Sample:
        item = self.ds[idx]
        if "metadata" in item:
            item = self._flatten_raw(item)
        image = np.asarray(item["image"].convert("RGB"))
        w, h = int(item["width"]), int(item["height"])
        boxes = _normalize_xyxy(_parse_list(item["bbox_list"]), w, h) * [w, h, w, h]
        caps = _captions(item, detail=True)
        if any(c is None for c in caps):
            caps = _captions(item, detail=False)
        # xyxy -> xywh pixel, resize-crop, filter, back to normalized xyxy
        xywh = boxes.copy()
        xywh[:, 2] -= xywh[:, 0]
        xywh[:, 3] -= xywh[:, 1]
        img, xywh = resize_short_side_center_crop(image, xywh, self.hw)
        xywh, caps = filter_boxes_canvas(xywh, caps, canvas=self.hw)
        boxes = xywh_to_xyxy_norm(xywh, self.hw)

        boxes10, classes10, valid = pad_layout_slots(boxes, caps)
        caption = item["global_caption"]
        return Sample(
            image=to_model_range(img),
            base_caption=caption,
            prompt=serialize_grounding(caption, boxes10, classes10, valid,
                                       textual=self.textual),
            gt_grounding=serialize_grounding("", boxes10, classes10, valid,
                                            textual=self.textual),
            neg_base_caption=self.neg_prompt,
            neg_prompt=self.neg_prompt,
            edit_region=np.zeros((576,), dtype=np.int64),
            image_id=str(idx),
            H=h,
            W=w,
        )
