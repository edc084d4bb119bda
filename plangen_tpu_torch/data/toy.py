"""Toy smoke dataset: N copies of one synthetic image + fixed layout prompt.

A copy of `plangen_tpu/data/toy.py`, which the port cannot import:
`plangen_tpu/data/__init__.py` imports `preprocess.py`, which imports jax.
tests/test_torch_data.py holds the two copies' batches equal.


Equivalent of the reference's `Dataset_toy` (dataset/data_toy.py:18-41 — 100
copies of a meme image with a fixed prompt) without needing an image file:
a deterministic procedurally-drawn image (colored rectangles matching the
layout boxes) so generation/eval smoke tests have consistent content.
"""

from __future__ import annotations

import numpy as np

from plangen_tpu_torch.data.schema import Sample
from plangen_tpu_torch.text.grounding import serialize_grounding


class ToyDataset:
    def __init__(self, size: int = 100, image_hw: int = 384, neg_prompt: str = "",
                 textual: bool = True):
        self.size = size
        self.hw = image_hw
        self.neg_prompt = neg_prompt
        self.textual = textual
        self.boxes = [(0.1, 0.15, 0.45, 0.8), (0.55, 0.3, 0.9, 0.75)]
        self.classes = ["a red rectangle", "a blue rectangle"]
        self.caption = "two colored rectangles on a white background"
        self._image = self._draw()

    def _draw(self) -> np.ndarray:
        img = np.ones((self.hw, self.hw, 3), dtype=np.float32)
        colors = [(1.0, 0.1, 0.1), (0.1, 0.2, 1.0)]
        for (x1, y1, x2, y2), c in zip(self.boxes, colors):
            xs, ys = int(x1 * self.hw), int(y1 * self.hw)
            xe, ye = int(x2 * self.hw), int(y2 * self.hw)
            img[ys:ye, xs:xe] = c
        return img * 2.0 - 1.0  # [-1, 1]

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int) -> Sample:
        prompt = serialize_grounding(
            self.caption, self.boxes, self.classes, textual=self.textual
        )
        gt_grounding = serialize_grounding(
            "", self.boxes, self.classes, textual=self.textual
        )
        return Sample(
            image=self._image.copy(),
            base_caption=self.caption,
            prompt=prompt,
            gt_grounding=gt_grounding,
            neg_base_caption=self.neg_prompt,
            neg_prompt=self.neg_prompt,
            edit_region=np.zeros((576,), dtype=np.int64),
            image_id=str(idx),
            boxes=list(self.boxes),
            classes=list(self.classes),
        )
