"""Layout evaluation metrics.

A copy of `plangen_tpu/tasks/metrics.py` (numpy only);
tests/test_torch_eval.py holds the two equal.

The reference computes quality metrics (FID, spatial accuracy) OUTSIDE the
repo — validation() only dumps artifacts (SURVEY §4). Here the layout-side
metrics are built in so `eval` runs report numbers directly:

  * pairwise box IoU + greedy matching between predicted and GT layouts
  * layout mIoU (matched IoU mean), precision/recall at an IoU threshold
  * counting accuracy (predicted object count vs GT)

Image-quality metrics (FID/KID over SigLIP features) live in
`tasks/image_metrics.py` (train.val_image_metrics / `cli metrics`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

Box = Sequence[float]


def box_iou(a: Box, b: Box) -> float:
    x1 = max(a[0], b[0])
    y1 = max(a[1], b[1])
    x2 = min(a[2], b[2])
    y2 = min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    area_a = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
    area_b = max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0


def greedy_match(
    pred: Sequence[Box], gt: Sequence[Box]
) -> List[Tuple[int, int, float]]:
    """Greedy highest-IoU matching; returns (pred_idx, gt_idx, iou) triples."""
    pairs = sorted(
        (
            (box_iou(p, g), pi, gi)
            for pi, p in enumerate(pred)
            for gi, g in enumerate(gt)
        ),
        key=lambda t: -t[0],
    )
    used_p: set = set()
    used_g: set = set()
    out = []
    for iou, pi, gi in pairs:
        if pi in used_p or gi in used_g or iou <= 0:
            continue
        used_p.add(pi)
        used_g.add(gi)
        out.append((pi, gi, iou))
    return out


def layout_metrics(
    pred_boxes: Sequence[Box],
    gt_boxes: Sequence[Box],
    iou_threshold: float = 0.5,
) -> Dict[str, float]:
    """mIoU over matches + precision/recall at the threshold + count accuracy."""
    matches = greedy_match(pred_boxes, gt_boxes)
    ious = [m[2] for m in matches]
    tp = sum(1 for i in ious if i >= iou_threshold)
    n_pred, n_gt = len(pred_boxes), len(gt_boxes)
    return {
        "miou": float(np.mean(ious)) if ious else 0.0,
        "precision": tp / n_pred if n_pred else 0.0,
        "recall": tp / n_gt if n_gt else 0.0,
        "count_match": float(n_pred == n_gt),
        "n_pred": float(n_pred),
        "n_gt": float(n_gt),
    }


def aggregate_layout_metrics(per_sample: List[Dict[str, float]]) -> Dict[str, float]:
    if not per_sample:
        return {}
    keys = per_sample[0].keys()
    return {k: float(np.mean([s[k] for s in per_sample])) for k in keys}
