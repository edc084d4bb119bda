"""ctypes bindings for the native data-path library (native/plangen_data.cc).

A copy of `plangen_tpu/data/native.py` (the port imports nothing of the JAX
package; `plangen_tpu/data/__init__.py` imports jax). The library is C++ at
the root of the repository and belongs to neither package: both load the
same `native/libplangen_data.so`, built by `make -C native`.
tests/test_torch_datasets.py holds the two bindings equal over a library
the test builds.

Host-side native component (C++): fused multithreaded bilinear resize +
[-1, 1] normalization for the training data loader. Gracefully falls back
to PIL when the .so is absent (`native_available()` is False).

Convention: half-pixel-center bilinear (torch/cv2 align_corners=False), NOT
PIL's antialiased filter — this is the throughput path; the PIL path remains
for reference-parity eval preprocessing.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SO_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "libplangen_data.so",
)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_SO_PATH):
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
        lib.plangen_resize_bilinear.restype = ctypes.c_int
        lib.plangen_resize_bilinear.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.plangen_resize_bilinear_batch.restype = ctypes.c_int
        lib.plangen_resize_bilinear_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def native_available() -> bool:
    return _load() is not None


def resize_bilinear_native(
    image_u8: np.ndarray,  # [H, W, C] uint8
    out_hw: tuple,
    normalize: bool = True,
    threads: int = 4,
) -> np.ndarray:
    """Native fused resize(+normalize). Raises RuntimeError if lib missing."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library not built: {_SO_PATH} (make -C native)")
    src = np.ascontiguousarray(image_u8, dtype=np.uint8)
    h, w, c = src.shape
    dh, dw = out_hw
    dst = np.empty((dh, dw, c), dtype=np.float32)
    rc = lib.plangen_resize_bilinear(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, c,
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dh, dw, int(normalize), threads,
    )
    if rc != 0:
        raise RuntimeError(f"plangen_resize_bilinear failed rc={rc}")
    return dst


def resize_bilinear_batch_native(
    images_u8: np.ndarray,  # [N, H, W, C] uint8 (same size)
    out_hw: tuple,
    normalize: bool = True,
    threads: int = 8,
) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library not built: {_SO_PATH} (make -C native)")
    src = np.ascontiguousarray(images_u8, dtype=np.uint8)
    n, h, w, c = src.shape
    dh, dw = out_hw
    dst = np.empty((n, dh, dw, c), dtype=np.float32)
    rc = lib.plangen_resize_bilinear_batch(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, h, w, c,
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dh, dw, int(normalize), threads,
    )
    if rc != 0:
        raise RuntimeError(f"plangen_resize_bilinear_batch failed rc={rc}")
    return dst


def resize_to_model_input(image_u8: np.ndarray, hw: int, threads: int = 4) -> np.ndarray:
    """Resize to (hw, hw) float32 [-1, 1]: native when built, PIL fallback."""
    if native_available():
        return resize_bilinear_native(image_u8, (hw, hw), normalize=True, threads=threads)
    from PIL import Image

    pil = Image.fromarray(image_u8).resize((hw, hw), Image.BILINEAR)
    return np.asarray(pil).astype(np.float32) / 127.5 - 1.0
