"""Canonical sample schema.

A copy of `plangen_tpu/data/schema.py`, which the port cannot import:
`plangen_tpu/data/__init__.py` imports `preprocess.py`, which imports jax.
tests/test_torch_data.py holds the two copies' batches equal.


Every dataset source normalizes into this shape, mirroring the reference's
universal `Hico_dataset` adapter output (data_hico.py:291-376): image in
[-1, 1], caption, grounding strings (positive + negative), edit region mask.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class Sample:
    image: Optional[np.ndarray] = None  # [H, W, 3] float32 in [-1, 1] (NHWC)
    base_caption: str = ""
    prompt: str = ""  # caption + grounding (serialized with caption prefix)
    gt_grounding: str = ""  # grounding serialized with empty caption
    neg_base_caption: str = ""
    neg_prompt: str = ""
    neg_gt_grounding: str = ""
    edit_region: Optional[np.ndarray] = None  # [576] int, 1 = regenerate
    image_id: str = ""
    boxes: List[Tuple[float, float, float, float]] = field(default_factory=list)
    classes: List[str] = field(default_factory=list)
    H: int = 0
    W: int = 0
    edited_image: Optional[np.ndarray] = None  # edit GT, when available
