"""Build the CUDA sources under `csrc/` into shared libraries and load them.

Each `csrc/<name>.cu` is compiled by `nvcc` into
`plangen_tpu_torch/_build/<name>-<hash>.so` (a plain C interface, loaded
with `ctypes`) the first time a CUDA tensor reaches its wrapper. The hash
covers the sources and the flags, so an edited source builds anew and an
unchanged one is reused. nvcc's output (`-Xptxas -v`: registers, shared
memory, spills) is kept beside the library as `<name>-<hash>.log`.

Nothing here runs at import: the CPU tests import every module on machines
without nvcc, so building happens only when a kernel is first launched.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Sequence

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-lineinfo",
)


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source; the message carries its output."""


@dataclass(frozen=True)
class BuiltLibrary:
    lib: ctypes.CDLL
    path: pathlib.Path
    log: str  # nvcc's output from the build that made `path`
    build_seconds: float  # 0.0 when an earlier build was reused


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA toolkit is needed to build the kernels"
        )
    return found


def source_files(name: str) -> list:
    """The .cu file of kernel `name` plus every shared header in csrc/."""
    cu = CSRC_DIR / f"{name}.cu"
    if not cu.is_file():
        raise KernelBuildError(f"no CUDA source {cu}")
    return [cu] + sorted(CSRC_DIR.glob("*.cuh"))


def build_key(name: str) -> str:
    h = hashlib.sha256()
    for path in source_files(name):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def compile_library(name: str) -> tuple:
    """Compile csrc/<name>.cu unless the same sources were built before.

    Returns (library path, nvcc log, seconds spent compiling). The library
    is written under a temporary name and renamed into place, so processes
    that build at the same time never load a half-written file."""
    key = build_key(name)
    so = BUILD_DIR / f"{name}-{key}.so"
    log = BUILD_DIR / f"{name}-{key}.log"
    if so.is_file():
        return so, log.read_text() if log.is_file() else "", 0.0
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{name}-{key}.{os.getpid()}.tmp.so"
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    output = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}) building {name}:\n"
            f"{' '.join(cmd)}\n{output}"
        )
    log.write_text(output)
    os.replace(tmp, so)
    return so, output, seconds


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> BuiltLibrary:
    """Build (if needed) and load the kernel library `name`, once a process."""
    path, log, seconds = compile_library(name)
    return BuiltLibrary(ctypes.CDLL(str(path)), path, log, seconds)


def load_libraries(names: Sequence[str]) -> Dict[str, BuiltLibrary]:
    """Build and load several kernel libraries, one nvcc per source, all
    started together (each build waits on its own subprocess)."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(load_library, names)))
