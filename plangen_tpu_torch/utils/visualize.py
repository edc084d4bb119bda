"""Pixels out: the uint8 contract, a PNG codec on zlib and numpy, and the
evaluation artifacts.

Port of `plangen_tpu/utils/visualize.py` (`to_uint8`, `save_image`,
`draw_layout`, `save_image_grid`) and of the server's PNG encode and decode
(`plangen_tpu/serve.py`). `encode_png` writes 8-bit gray or RGB, each row
with the Sub filter. `decode_png` reads non-interlaced 8-bit gray, gray +
alpha, RGB and RGBA with all five row filters, and returns RGB (gray
replicated, alpha dropped, as Pillow's `convert("RGB")` does); any other
PNG (palette, 16-bit, interlaced) raises `ValueError` naming the limit.
The server needs no Pillow. `save_image` writes `.png` files with
`encode_png` and any other format (the evaluation's `.jpg` names) with
Pillow, as the JAX module does; `draw_layout` and `save_image_grid` draw
and tile with Pillow like the JAX ones.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels, for 8-bit samples
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
PNG_LIMIT = ("8-bit gray, gray+alpha, RGB or RGBA, non-interlaced "
             "(no palette, 16-bit or interlaced PNGs)")


def to_uint8(image: np.ndarray) -> np.ndarray:
    """Float [-1, 1] -> uint8 pixels (identity on uint8 input): the one
    pixel-contract conversion of saved images and served PNGs."""
    if image.dtype != np.uint8:
        image = np.clip((image + 1.0) * 127.5, 0, 255).astype(np.uint8)
    return image


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """[H, W, 3] or [H, W] uint8 (or float in [-1, 1]) -> PNG bytes."""
    image = np.ascontiguousarray(to_uint8(np.asarray(image)))
    if image.ndim == 2:
        color, bpp = 0, 1
    elif image.ndim == 3 and image.shape[2] == 3:
        color, bpp = 2, 3
    else:
        raise ValueError(f"encode_png takes [H, W] or [H, W, 3], got {image.shape}")
    h, w = image.shape[:2]
    rows = image.reshape(h, w * bpp)
    sub = rows.copy()
    sub[:, bpp:] -= rows[:, :-bpp]  # Sub filter, modulo 256
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    if len(data) != h * (stride + 1):
        raise ValueError(f"PNG image data holds {len(data)} bytes, "
                         f"expected {h * (stride + 1)}")
    rows = np.frombuffer(data, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum along each channel
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64) % 256
                   ).astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: each byte depends on the last
            buf = bytearray(line.tobytes())
            (_average_row if kind == 3 else _paeth_row)(buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] uint8 RGB (module docstring for the formats)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n] or b"\0\0\0\0")
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} is truncated or fails its CRC")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"PNG of bit depth {depth}, color type {color}, interlace "
                         f"{interlace}: this decoder reads {PNG_LIMIT}")
    bpp = _CHANNELS[color]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    pixels = pixels.reshape(h, w, bpp)
    if bpp <= 2:  # gray (+ alpha)
        return np.repeat(pixels[..., :1], 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def save_image(image: np.ndarray, path: str) -> None:
    """Write one image: a `.png` name through `encode_png`, any other
    format Pillow knows by its extension."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.lower().endswith(".png"):
        with open(path, "wb") as f:
            f.write(encode_png(image))
        return
    from PIL import Image

    Image.fromarray(to_uint8(np.asarray(image))).save(path)


_COLORS = [
    (230, 60, 60),
    (60, 140, 230),
    (70, 190, 80),
    (240, 170, 40),
    (170, 80, 220),
    (30, 200, 200),
    (240, 110, 180),
    (150, 150, 60),
    (100, 100, 240),
    (200, 120, 80),
]


def draw_layout(
    image: np.ndarray,  # [H, W, 3] uint8 or float [-1, 1]
    boxes: Sequence[Sequence[float]],  # normalized xyxy
    labels: Optional[Sequence[str]] = None,
) -> np.ndarray:
    """Return a copy with box overlays + labels (uint8)."""
    from PIL import Image, ImageDraw

    image = to_uint8(np.asarray(image))
    pil = Image.fromarray(image)
    draw = ImageDraw.Draw(pil)
    h, w = image.shape[:2]
    for i, box in enumerate(boxes):
        x1, y1, x2, y2 = box[0] * w, box[1] * h, box[2] * w, box[3] * h
        color = _COLORS[i % len(_COLORS)]
        draw.rectangle([x1, y1, x2, y2], outline=color, width=2)
        if labels is not None and i < len(labels) and labels[i]:
            text = labels[i][:40]
            ty = max(0, y1 - 12)
            draw.rectangle([x1, ty, x1 + 6 * len(text), ty + 12], fill=color)
            draw.text((x1 + 1, ty), text, fill=(255, 255, 255))
    return np.asarray(pil)


def save_image_grid(
    images: Sequence[np.ndarray], path: str, cols: Optional[int] = None
) -> None:
    """Tile images row-major (one row of all of them by default) and save."""
    imgs = [to_uint8(np.asarray(im)) for im in images]
    n = len(imgs)
    cols = cols or n
    rows = -(-n // cols)
    h, w = imgs[0].shape[:2]
    grid = np.full((rows * h, cols * w, 3), 255, dtype=np.uint8)
    for i, im in enumerate(imgs):
        r, c = divmod(i, cols)
        grid[r * h : (r + 1) * h, c * w : (c + 1) * w] = im
    save_image(grid, path)
