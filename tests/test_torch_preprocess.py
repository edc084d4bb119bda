"""The port's host image code against Pillow and the JAX package.

  * `utils/visualize.py`: `encode_png` read back by Pillow; `decode_png`
    equal to Pillow's `convert("RGB")` on 8-bit gray, gray + alpha, RGB and
    RGBA files, and on rows written with each of the five filter types;
    the formats it does not read raise naming the limit; `to_uint8` and
    `save_image` as the JAX package's;
  * `data/preprocess.py`: `resize_bicubic` within one uint8 level of
    Pillow's `BICUBIC`, up and down; `build_edit_region`, the model range,
    CLIP normalization equal to the JAX package's, and
    `janus_image_preprocess` within one uint8 level of it.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from plangen_tpu.data import preprocess as jpre
from plangen_tpu.utils.visualize import to_uint8 as jto_uint8
from plangen_tpu_torch.data import preprocess as tpre
from plangen_tpu_torch.utils.visualize import (
    PNG_SIGNATURE, decode_png, encode_png, save_image, to_uint8,
)


def _photo(h=52, w=61, seed=0):
    """A smooth seeded RGB image (a noise image upsampled), so that every
    row filter has something to predict."""
    base = np.random.RandomState(seed).randint(0, 256, (7, 9, 3)).astype(np.uint8)
    return np.asarray(Image.fromarray(base).resize((w, h), Image.BILINEAR))


def _pil_png(img, mode, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, format="PNG", **kw)
    return buf.getvalue()


# ------------------------------------------------------------------ the PNG codec


@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
def test_encode_png_reads_back_in_pillow(gray):
    img = _photo()
    if gray:
        img = img[..., 0]
    got = np.asarray(Image.open(io.BytesIO(encode_png(img))))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
@pytest.mark.parametrize("optimize", [False, True])
def test_decode_png_equals_pillow(mode, optimize):
    data = _pil_png(_photo(), mode, optimize=optimize)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = decode_png(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _filtered_png(img: np.ndarray, kinds) -> bytes:
    """An RGB PNG whose row y is written with filter kinds[y % len(kinds)],
    by the PNG specification's filter definitions (a plain loop)."""
    h, w, _ = img.shape
    rows = img.reshape(h, w * 3).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        kind = kinds[y % len(kinds)]
        prev = rows[y - 1] if y else np.zeros(w * 3, np.int64)
        out = []
        for i in range(w * 3):
            a = rows[y, i - 3] if i >= 3 else 0
            b = prev[i]
            c = prev[i - 3] if i >= 3 else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out.append((rows[y, i] - pred) % 256)
        raw += bytes([kind]) + bytes(out)
    return _png(struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0), zlib.compress(bytes(raw)))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _png(ihdr: bytes, idat: bytes) -> bytes:
    return PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat) + _chunk(b"IEND", b"")


@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "all"])
def test_decode_png_reads_every_filter_type(kinds):
    img = _photo(13, 11, seed=2)
    data = _filtered_png(img, kinds)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    np.testing.assert_array_equal(decode_png(data), img)


def test_decode_png_refuses_what_it_does_not_read():
    img = _photo(8, 8)
    palette = _pil_png(img, "P")
    sixteen = _png(struct.pack(">IIBBBBB", 8, 8, 16, 2, 0, 0, 0), zlib.compress(b"\0" * 8))
    interlaced = _png(struct.pack(">IIBBBBB", 8, 8, 8, 2, 0, 0, 1), zlib.compress(b"\0" * 8))
    for data in (palette, sixteen, interlaced):
        with pytest.raises(ValueError, match="non-interlaced"):
            decode_png(data)
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + bytes(20))
    good = bytearray(encode_png(img))
    good[40] ^= 0xFF  # a byte inside IDAT
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(good))


def test_to_uint8_and_save_image_as_jax(tmp_path):
    x = np.random.RandomState(1).uniform(-1.2, 1.2, (9, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(to_uint8(x), jto_uint8(x))
    u8 = to_uint8(x)
    assert to_uint8(u8) is u8
    save_image(x, str(tmp_path / "sub" / "a.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "sub" / "a.png")),
                                  jto_uint8(x))
    # other formats through Pillow, byte for byte the JAX module's file
    from plangen_tpu.utils.visualize import save_image as jsave_image

    save_image(x, str(tmp_path / "a.jpg"))
    jsave_image(x, str(tmp_path / "jax" / "a.jpg"))
    assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "jax" / "a.jpg").read_bytes()


# ---------------------------------------------------------------- preprocessing


@pytest.mark.parametrize("size", [(32, 32), (384, 384), (20, 45), (130, 97)])
def test_resize_bicubic_within_one_level_of_pillow(size):
    img = _photo(60, 75, seed=3)
    want = np.asarray(Image.fromarray(img).resize((size[1], size[0]), Image.BICUBIC))
    got = tpre.resize_bicubic(img, size)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_build_edit_region_equals_jax():
    rs = np.random.RandomState(4)
    for n, pad, grid in [(0, 0.0, 24), (1, 0.0, 24), (3, 0.1, 24), (5, 0.25, 8)]:
        boxes = rs.uniform(-0.1, 1.1, (n, 4)).astype(np.float32)
        boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2])
        np.testing.assert_array_equal(
            tpre.build_edit_region(boxes, grid=grid, pad_edit_box=pad),
            jpre.build_edit_region(boxes, grid=grid, pad_edit_box=pad))


def test_model_range_and_clip_normalize_equal_jax():
    u8 = np.random.RandomState(5).randint(0, 256, (6, 5, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tpre.to_model_range(u8), jpre.to_model_range(u8))
    x = jpre.to_model_range(u8)
    np.testing.assert_array_equal(tpre.from_model_range(x), jpre.from_model_range(x))
    np.testing.assert_array_equal(tpre.clip_normalize(u8), jpre.clip_normalize(u8))


@pytest.mark.parametrize("hw", [(50, 80), (90, 40), (64, 64)])
def test_janus_image_preprocess_within_one_level_of_jax(hw):
    img = _photo(*hw, seed=6)
    got = tpre.janus_image_preprocess(img, image_size=48)
    want = jpre.janus_image_preprocess(img, image_size=48)
    assert got.shape == want.shape == (48, 48, 3) and got.dtype == np.float32
    # one uint8 level after CLIP normalization: 1 / 255 / std
    assert np.abs(got - want).max() <= 1.0 / 255 / tpre.CLIP_STD.min() + 1e-6
