"""Box-aware image transforms (host numpy + PIL).

A copy of `plangen_tpu/data/transforms.py`, which the port cannot import
(`plangen_tpu/data/__init__.py` imports jax). Its native resize is the
port's own binding (`data/native.py`) of the same C++ library, so
`backend="auto"` takes the native resize exactly when
`native/libplangen_data.so` is built, as the JAX module does.
tests/test_torch_datasets.py holds the two copies equal.

Behavioral re-implementations of the reference's shared dataset helpers:
  * short-side resize + center crop with box adjustment
    (dataset/coco/data_coco.py:24-71 resize_and_crop)
  * 384-canvas box filtering: clip to the canvas, drop boxes with
    area < 200 px^2 or origin beyond 380 (data_coco.py:74-106 filter_box)
  * random mirror / IoU-constrained sample crop for training augmentation
    (code_hico/dataset/augmentations.py SSD-style transforms)
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def resize_short_side_center_crop(
    image: np.ndarray,  # [H, W, 3] float or uint8
    boxes_xywh: np.ndarray,  # [N, 4] pixel coords (x1, y1, w, h)
    target: int = 384,
    crop: bool = True,
    backend: str = "auto",  # auto (native when built) | native | pil
) -> Tuple[np.ndarray, np.ndarray]:
    """Bilinear short-side resize to `target`, center crop, adjust boxes.

    With `crop=False` only the short-side resize is applied (the reference
    crops separately when use_MinIoURandomCrop is on, debug_grit.py:445-456);
    boxes stay in pixel coords of the resized image.

    `backend="auto"` uses the native C++ resize (native/plangen_data.cc,
    half-pixel-center bilinear — the cv2/torch convention the REFERENCE's
    dataset-side resize uses, funcs.py:523-528) when the library is built,
    falling back to PIL. The eval-side Janus preprocessor
    (data/preprocess.py janus_image_preprocess) stays bicubic PIL for
    processor parity — this function is the TRAIN loaders' resize.
    """
    h, w = image.shape[:2]
    if w < h:
        scale = target / w
        new_w, new_h = target, int(h * scale)
    else:
        scale = target / h
        new_h, new_w = target, int(w * scale)
    left = (new_w - target) // 2 if crop else 0
    top = (new_h - target) // 2 if crop else 0

    src = image.astype(np.uint8) if image.dtype != np.uint8 else image
    if backend == "auto":
        from plangen_tpu_torch.data.native import native_available

        backend = "native" if native_available() else "pil"
    if backend == "native":
        from plangen_tpu_torch.data.native import resize_bilinear_native

        full = resize_bilinear_native(src, (new_h, new_w), normalize=False)
        full = np.clip(np.round(full), 0, 255).astype(np.uint8)
        out = full[top:top + target, left:left + target] if crop else full
    else:
        from PIL import Image

        pil = Image.fromarray(src).resize((new_w, new_h), Image.BILINEAR)
        if crop:
            pil = pil.crop((left, top, left + target, top + target))
        out = np.asarray(pil)

    boxes = np.asarray(boxes_xywh, dtype=np.float32).reshape(-1, 4).copy()
    boxes[:, 0] = boxes[:, 0] * scale - left
    boxes[:, 1] = boxes[:, 1] * scale - top
    boxes[:, 2] *= scale
    boxes[:, 3] *= scale
    return out, boxes


def filter_boxes_canvas(
    boxes_xywh: np.ndarray,
    classes: Sequence[str],
    canvas: int = 384,
    min_area: float = 200.0,
    max_origin: float = 380.0,
) -> Tuple[np.ndarray, List[str]]:
    """Clip boxes to the canvas; drop tiny or out-of-frame boxes."""
    kept_boxes: List[List[float]] = []
    kept_classes: List[str] = []
    for i, (x, y, w, h) in enumerate(np.asarray(boxes_xywh).reshape(-1, 4)):
        x2, y2 = x + w, y + h
        x, y = max(0.0, x), max(0.0, y)
        if x > max_origin or y > max_origin:
            continue
        x2, y2 = min(float(canvas), x2), min(float(canvas), y2)
        w, h = x2 - x, y2 - y
        if w * h < min_area:
            continue
        kept_boxes.append([x, y, w, h])
        kept_classes.append(classes[i])
    return np.asarray(kept_boxes, dtype=np.float32).reshape(-1, 4), kept_classes


def xywh_to_xyxy_norm(boxes_xywh: np.ndarray, scale: float) -> np.ndarray:
    b = np.asarray(boxes_xywh, dtype=np.float32).reshape(-1, 4) / scale
    out = b.copy()
    out[:, 2] = b[:, 0] + b[:, 2]
    out[:, 3] = b[:, 1] + b[:, 3]
    return out


def pad_layout_slots(
    boxes_xyxy: np.ndarray,
    classes: Sequence[str],
    slots: int = 10,
) -> Tuple[np.ndarray, List[str], np.ndarray]:
    """Truncate/pad to the 10-slot canonical layout with a validity mask
    (reference convert_*_to_hico, data_hico.py:185-267)."""
    boxes = np.asarray(boxes_xyxy, dtype=np.float32).reshape(-1, 4)[:slots]
    classes = list(classes)[:slots]
    n = len(boxes)
    pad = slots - n
    boxes = np.concatenate([boxes, np.zeros((pad, 4), dtype=np.float32)], axis=0)
    classes = classes + [""] * pad
    valid = np.array([1] * n + [0] * pad, dtype=np.int32)
    # invalidate zero boxes / empty classes (data_hico.py:314-318)
    for i in range(slots):
        if boxes[i].sum() == 0 or classes[i] == "":
            valid[i] = 0
    return boxes, classes, valid


def random_mirror(
    image: np.ndarray, boxes_xyxy_norm: np.ndarray, rng: np.random.RandomState
) -> Tuple[np.ndarray, np.ndarray]:
    """Horizontal flip with box reflection (augmentations.py RandomMirror)."""
    if rng.rand() < 0.5:
        image = image[:, ::-1].copy()
        b = boxes_xyxy_norm.copy()
        b[:, 0], b[:, 2] = 1.0 - boxes_xyxy_norm[:, 2], 1.0 - boxes_xyxy_norm[:, 0]
        return image, b
    return image, boxes_xyxy_norm


def _jaccard(boxes: np.ndarray, rect: np.ndarray) -> np.ndarray:
    """IoU of each box [N, 4] with one rect [4] (pixel xyxy)."""
    x1 = np.maximum(boxes[:, 0], rect[0])
    y1 = np.maximum(boxes[:, 1], rect[1])
    x2 = np.minimum(boxes[:, 2], rect[2])
    y2 = np.minimum(boxes[:, 3], rect[3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    area_r = (rect[2] - rect[0]) * (rect[3] - rect[1])
    union = area_b + area_r - inter
    return np.where(union > 0, inter / union, 0.0)


IOU_CROP_MODES = ((0.1, None), (0.3, None), (0.7, None), (0.9, None), (None, None))


def iou_sample_crop(
    image: np.ndarray,  # [H, W, 3]
    boxes_xyxy: np.ndarray,  # [N, 4] pixel coords
    labels: Sequence[str],
    rng: np.random.RandomState,
    max_trials: int = 50,
) -> Optional[Tuple[np.ndarray, np.ndarray, List[str]]]:
    """SSD-style IoU-constrained square crop keeping boxes whose centers lie
    inside the crop (augmentations.py RandomSampleCrop/CenterSampleCrop:
    square patch with side = min(H, W), min-jaccard modes .1/.3/.7/.9 or
    unconstrained, boxes clipped and shifted to the crop frame).

    Returns (cropped image, adjusted boxes, kept labels) or None when no
    valid crop is found within max_trials (caller keeps the original).
    """
    h, w = image.shape[:2]
    boxes = np.asarray(boxes_xyxy, dtype=np.float32).reshape(-1, 4)
    if len(boxes) == 0:
        return None
    side = min(h, w)
    min_iou, max_iou = IOU_CROP_MODES[rng.randint(len(IOU_CROP_MODES))]
    lo = -np.inf if min_iou is None else min_iou
    hi = np.inf if max_iou is None else max_iou
    for _ in range(max_trials):
        left = rng.uniform(0, w - side)
        top = rng.uniform(0, h - side)
        rect = np.array(
            [int(left), int(top), int(left + side), int(top + side)], dtype=np.float32
        )
        overlap = _jaccard(boxes, rect)
        if overlap.min() < lo and hi < overlap.max():
            continue
        centers = (boxes[:, :2] + boxes[:, 2:]) / 2.0
        keep = (
            (rect[0] < centers[:, 0])
            & (rect[1] < centers[:, 1])
            & (rect[2] > centers[:, 0])
            & (rect[3] > centers[:, 1])
        )
        if not keep.any():
            continue
        out_img = image[int(rect[1]) : int(rect[3]), int(rect[0]) : int(rect[2])]
        kept = boxes[keep].copy()
        kept[:, :2] = np.maximum(kept[:, :2], rect[:2]) - rect[:2]
        kept[:, 2:] = np.minimum(kept[:, 2:], rect[2:]) - rect[:2]
        kept_labels = [l for l, k in zip(labels, keep) if k]
        return out_img, kept, kept_labels
    return None
