"""Layout-planning datasets (text -> layout, no images).

A copy of `plangen_tpu/data/layoutgpt.py`, which the port cannot import
(`plangen_tpu/data/__init__.py` imports jax); tests/test_torch_datasets.py
holds the two copies' samples equal.

Behavioral re-implementations of:
  * `Dataset_layout` (dataset/layoutgpt/data_layoutgpt.py:22-85): LayoutGPT
    NSR-1K counting + spatial jsons; boxes come as (x1, y1, w, h) normalized
    — converted to xyxy by adding w/h; spatial split oversampled 10x.
  * `Dataset_plan` (dataset/plan/data_plan.py:18-60): pre-generated LLM plans
    (plan1k_{model}_out.json) with 512-canvas xywh boxes + 1k_cap.jsonl
    captions; top-10 objects.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from plangen_tpu_torch.data.schema import Sample
from plangen_tpu_torch.data.transforms import pad_layout_slots
from plangen_tpu_torch.text.grounding import serialize_grounding


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _make_sample(caption: str, boxes_xyxy, classes, neg_prompt: str,
                 textual: bool = True) -> Sample:
    boxes10, classes10, valid = pad_layout_slots(
        np.clip(np.asarray(boxes_xyxy, dtype=np.float32).reshape(-1, 4), 0, 1),
        classes,
    )
    return Sample(
        image=None,
        base_caption=caption,
        prompt=serialize_grounding(caption, boxes10, classes10, valid,
                                   textual=textual),
        gt_grounding=serialize_grounding("", boxes10, classes10, valid,
                                         textual=textual),
        neg_base_caption=neg_prompt,
        neg_prompt=neg_prompt,
        edit_region=np.zeros((576,), dtype=np.int64),
    )


class NSR1KLayoutDataset:
    """LayoutGPT NSR-1K counting + spatial layouts (train data for 'plan')."""

    def __init__(self, root: str, neg_prompt: str = "", spatial_oversample: int = 10,
                 textual: bool = True):
        self.textual = textual
        if not os.path.isdir(root):
            raise FileNotFoundError(f"NSR-1K data not found at {root}")
        counting = []
        for split in ["counting.train.json", "counting.val.json"]:
            p = os.path.join(root, "counting", split)
            if os.path.exists(p):
                counting += _load_json(p)
        spatial = []
        for split in ["spatial.train.json", "spatial.val.json"]:
            p = os.path.join(root, "spatial", split)
            if os.path.exists(p):
                spatial += _load_json(p)
        self.items: List[dict] = []
        for d in counting:
            clas = [t[0] for t in d["object_list"]]
            boxes = np.asarray([t[1] for t in d["object_list"]], dtype=np.float32)
            self.items.append(
                {"caption": d["prompt"], "boxes": self._cvt(boxes), "classes": clas}
            )
        for d in spatial:
            pair = [d["obj1"], d["obj2"]]
            clas = [t[0] for t in pair]
            boxes = np.asarray([t[1] for t in pair], dtype=np.float32)
            item = {"caption": d["prompt"], "boxes": self._cvt(boxes), "classes": clas}
            self.items.extend([item] * spatial_oversample)
        self.neg_prompt = neg_prompt

    @staticmethod
    def _cvt(boxes: np.ndarray) -> np.ndarray:
        """(x1, y1, w, h) -> (x1, y1, x2, y2) (reference convert_box,
        data_layoutgpt.py:60-78 — despite naming cx/cy it adds w/h)."""
        out = boxes.copy().reshape(-1, 4)
        out[:, 2] = boxes[:, 0] + boxes[:, 2]
        out[:, 3] = boxes[:, 1] + boxes[:, 3]
        return out

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int) -> Sample:
        it = self.items[i]
        return _make_sample(it["caption"], it["boxes"], it["classes"],
                            self.neg_prompt, textual=self.textual)


class PlanEvalDataset:
    """Pre-generated LLM layout plans for scoring (Dataset_plan)."""

    def __init__(self, plan_json: str, caps_jsonl: str, neg_prompt: str = "",
                 textual: bool = True):
        self.textual = textual
        if not os.path.exists(plan_json):
            raise FileNotFoundError(f"plan json not found at {plan_json}")
        self.datas = _load_json(plan_json)
        with open(caps_jsonl) as f:
            self.caps = [json.loads(line) for line in f if line.strip()]
        self.neg_prompt = neg_prompt

    def __len__(self):
        return len(self.datas)

    def __getitem__(self, i: int) -> Sample:
        d = self.datas[i]
        boxes = np.asarray(d["obj_bbox"], dtype=np.float32).reshape(-1, 4) / 512.0
        boxes[:, 2:] += boxes[:, :2]
        classes = d["obj_class"]
        if len(boxes) > 10:
            boxes, classes = boxes[:10], classes[:10]
        return _make_sample(self.caps[i], boxes, classes, self.neg_prompt,
                            textual=self.textual)
