"""A small reader and writer of the safetensors format, in torch alone.

A file is an 8-byte little-endian header length, a JSON header naming each
tensor's dtype, shape and `data_offsets` (begin, end) into the byte buffer
that follows, and that buffer. The reader maps the file and makes each
tensor with `torch.frombuffer` over the map (no copy while the offsets are
aligned to the element size); the writer lays the tensors out in order, the
header padded with spaces to a multiple of 8 bytes. Dtypes: F32, F16, BF16,
I64, I32, I8, U8 and BOOL; any other raises. An optional `__metadata__`
entry of the header holds strings. tests/test_torch_loading.py holds both
against the `safetensors` package.
"""

from __future__ import annotations

import json
import math
import mmap
import struct
from typing import Dict, Mapping, Optional

import torch

DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {dtype: name for name, dtype in DTYPES.items()}
_MAX_HEADER = 100 * 2**20


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a safetensors file, in the header's order."""
    with open(path, "rb") as f:
        # ACCESS_COPY: a writable (copy-on-write) map, which frombuffer needs
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    if len(buf) < 8:
        raise ValueError(f"{path}: not a safetensors file ({len(buf)} bytes)")
    (n,) = struct.unpack("<Q", buf[:8])
    if n > min(_MAX_HEADER, len(buf) - 8):
        raise ValueError(f"{path}: header length {n} exceeds the file")
    header = json.loads(bytes(buf[8:8 + n]))
    header.pop("__metadata__", None)
    base, size = 8 + n, len(buf) - 8 - n
    out = {}
    for name, info in header.items():
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}; "
                             f"this reader takes {sorted(DTYPES)}")
        dtype = DTYPES[info["dtype"]]
        shape = [int(d) for d in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        count = math.prod(shape)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if not 0 <= begin <= end <= size or end - begin != count * itemsize:
            raise ValueError(f"{path}: tensor {name!r} has offsets {begin, end} "
                             f"for {count} x {itemsize} bytes in a {size}-byte buffer")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        elif (base + begin) % itemsize:  # unaligned: copy the bytes out
            out[name] = torch.frombuffer(bytearray(buf[base + begin:base + end]),
                                         dtype=dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                         offset=base + begin).reshape(shape)
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write `tensors` (any device; copied to the CPU) as a safetensors file."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs, offset = [], 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}; "
                             f"this writer takes {sorted(DTYPES)}")
        data = t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8)
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + data.numel()]}
        blobs.append(data)
        offset += data.numel()
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for data in blobs:
            f.write(data.numpy().tobytes())
