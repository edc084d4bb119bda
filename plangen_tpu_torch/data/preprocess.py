"""Image preprocessing on the host, in numpy and CPU torch.

Port of `plangen_tpu/data/preprocess.py`: the [-1, 1] model range and back,
CLIP normalization, the vanilla Janus image processor and the rasterized
edit region. The JAX module resizes with Pillow (`janus_image_preprocess`)
or `jax.image.resize`; the port resizes with `resize_bicubic`, torch's
antialiased bicubic (Pillow's filter, a = -0.5, its support widened when
shrinking) in fp32 on the CPU, rounded to uint8 once: within one level of
Pillow's `BICUBIC`, which rounds after each of its two passes
(tests/test_torch_preprocess.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def resize_bicubic(image_u8: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[H, W, C] uint8 -> [size[0], size[1], C] uint8, antialiased bicubic."""
    h, w = size
    if image_u8.shape[:2] == (h, w):
        return image_u8
    x = torch.from_numpy(np.array(image_u8, dtype=np.float32)).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(h, w), mode="bicubic", align_corners=False,
                      antialias=True)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


def to_model_range(image_u8: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1] (Normalize(0.5, 0.5) semantics)."""
    return image_u8.astype(np.float32) / 127.5 - 1.0


def from_model_range(image: np.ndarray) -> np.ndarray:
    """float [-1, 1] -> uint8 [0, 255]."""
    x = np.clip((np.asarray(image, dtype=np.float32) + 1.0) * 127.5, 0, 255)
    return x.astype(np.uint8)


def clip_normalize(image_u8: np.ndarray) -> np.ndarray:
    """uint8 -> CLIP-normalized float32 (the vanilla Janus processor)."""
    x = image_u8.astype(np.float32) / 255.0
    return (x - CLIP_MEAN) / CLIP_STD


def janus_image_preprocess(image_u8: np.ndarray, image_size: int = 384) -> np.ndarray:
    """The vanilla Janus image processor: the long side resized to
    `image_size` (bicubic, antialiased), padded to a square of the CLIP
    mean color, then CLIP-normalized."""
    h, w = image_u8.shape[:2]
    scale = image_size / max(w, h)
    new_w, new_h = max(int(w * scale), 1), max(int(h * scale), 1)
    resized = resize_bicubic(image_u8, (new_h, new_w))
    canvas = np.empty((image_size, image_size, 3), dtype=np.uint8)
    canvas[:] = [int(255 * m) for m in CLIP_MEAN]
    top, left = (image_size - new_h) // 2, (image_size - new_w) // 2
    canvas[top:top + new_h, left:left + new_w] = resized
    return clip_normalize(canvas)


def build_edit_region(
    edit_boxes: np.ndarray,  # [N, 4] normalized x1, y1, x2, y2
    grid: int = 24,
    pad_edit_box: float = 0.0,
) -> np.ndarray:
    """Rasterize edit boxes onto the token grid -> [grid * grid] int64 {0, 1},
    1 = regenerate. Boxes are dilated by `pad_edit_box` of their size, then
    clamped to [0, 1]; cells are marked by integer truncation of grid *
    coord."""
    region = np.zeros((grid, grid), dtype=np.int64)
    boxes = np.asarray(edit_boxes, dtype=np.float32).reshape(-1, 4).copy()
    if pad_edit_box != 0 and len(boxes):
        dx = boxes[:, 2] - boxes[:, 0]
        dy = boxes[:, 3] - boxes[:, 1]
        boxes[:, 0] -= dx * pad_edit_box
        boxes[:, 1] -= dy * pad_edit_box
        boxes[:, 2] += dx * pad_edit_box
        boxes[:, 3] += dy * pad_edit_box
    boxes = boxes.clip(0, 1)
    for box in boxes:
        x1, y1, x2, y2 = (int(grid * v) for v in box)
        region[y1:y2, x1:x2] = 1
    return region.reshape(-1)
