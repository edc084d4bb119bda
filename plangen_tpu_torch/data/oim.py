"""OpenImages bbox loader.

A copy of `plangen_tpu/data/oim.py`, which the port cannot import
(`plangen_tpu/data/__init__.py` imports jax); tests/test_torch_datasets.py
holds the two copies' samples equal.

Behavioral re-implementation of `Dataset_oim` (dataset/oim/data_oim.py:38-157):
CSV bbox annotations grouped by ImageID, class names via the
class-descriptions-boxable table, top-10 boxes by area, short-side resize +
center crop + canvas filter, captions from pre-generated per-image jsonl
(MiniCPM captions in the reference; '' when missing).
"""

from __future__ import annotations

import json
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


class OpenImagesDataset:
    def __init__(
        self,
        data_root: str,
        class_csv: str,
        split: str = "train",
        caption_dir: Optional[str] = None,
        image_hw: int = 384,
        neg_prompt: str = "",
        textual: bool = True,
    ):
        self.textual = textual
        import pandas as pd

        ann_names = {
            "train": "oidv6-train-annotations-bbox.csv",
            "validation": "validation-annotations-bbox.csv",
            "test": "test-annotations-bbox.csv",
        }
        ann_path = os.path.join(data_root, "anno", ann_names[split])
        if not os.path.exists(ann_path):
            raise FileNotFoundError(f"OpenImages annotations not found at {ann_path}")
        self.df = pd.read_csv(ann_path)
        # the official class-descriptions-boxable.csv has NO header row
        # ("/m/011k07,Tortoise" is row 1) — pandas' default header=0 would
        # eat the first class mapping, silently dropping every image that
        # contains it via the unknown-label skip below. The REFERENCE has
        # exactly that defect (data_oim.py:63 default read_csv); it's
        # silent data loss, so we deliberately do not replicate it
        names = pd.read_csv(class_csv, header=None, names=["id", "name"])
        self.class_map = names.set_index("id")["name"].to_dict()
        self.image_ids = self.df["ImageID"].unique()
        # per-image row indices once: a boolean mask over the full
        # annotations frame (~14M rows for oidv6 train) per __getitem__
        # would gate training throughput on a pandas scan
        self._rows_by_image = self.df.groupby("ImageID").indices
        self.data_root = data_root
        self.split = split
        self.caption_dir = caption_dir
        self.hw = image_hw
        self.neg_prompt = neg_prompt

    def __len__(self):
        return len(self.image_ids)

    def __getitem__(self, i: int) -> Sample:
        from PIL import Image

        # bounded ITERATIVE skip of unknown-label samples (the reference
        # skips bad samples too, data_oim.py:93-96) — a recursive
        # self[(i+1) % len] dies with RecursionError when many consecutive
        # samples have labels missing from class_csv (e.g. a mismatched
        # OpenImages version), and an exhausted scan must say WHY
        for attempt in range(len(self.image_ids)):
            image_id = self.image_ids[(i + attempt) % len(self.image_ids)]
            rows = self.df.iloc[self._rows_by_image[image_id]]
            try:
                classes = [self.class_map[t].lower() for t in rows["LabelName"]]
            except KeyError:
                continue  # unknown label: try the next image
            break
        else:
            raise ValueError(
                "every OpenImages sample has labels missing from "
                "class-descriptions-boxable.csv — wrong class_csv version?"
            )
        boxes = np.stack(
            [rows["XMin"], rows["YMin"], rows["XMax"], rows["YMax"]], axis=-1
        ).astype(np.float32)

        areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        order = np.argsort(-areas)
        boxes = boxes[order][:10]
        classes = [classes[j] for j in order[:10]]

        path = os.path.join(self.data_root, self.split, f"{image_id}.jpg")
        pil = Image.open(path).convert("RGB")
        w, h = pil.size
        xywh = boxes * [w, h, w, h]
        xywh[:, 2] -= xywh[:, 0]
        xywh[:, 3] -= xywh[:, 1]
        img, xywh = resize_short_side_center_crop(np.asarray(pil), xywh, self.hw)
        xywh, classes = filter_boxes_canvas(xywh, classes, canvas=self.hw)
        boxes = xywh_to_xyxy_norm(xywh, self.hw)

        caption = ""
        if self.caption_dir:
            cap_path = os.path.join(self.caption_dir, f"{image_id}.jsonl")
            if os.path.exists(cap_path):
                with open(cap_path) as f:
                    line = f.readline().strip()
                    if line:
                        caption = json.loads(line)

        boxes10, classes10, valid = pad_layout_slots(boxes, classes)
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
            image_id=str(image_id),
            H=h,
            W=w,
        )
