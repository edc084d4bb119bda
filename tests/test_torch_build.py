"""Building the CUDA sources (plangen_tpu_torch/kernels/build.py) without a
card: the content key, the rename-into-place, the reuse of an earlier build
and the errors, driven through a stand-in `nvcc` script. The real nvcc runs
on the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import os
import stat

import pytest
import torch

from plangen_tpu_torch.kernels import build
from plangen_tpu_torch.ops import decode_attention as da

FAKE_NVCC = """#!/bin/sh
# stand-in for nvcc: record the call, print ptxas-like lines, write -o's file
echo "$@" >> "{calls}"
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo "ptxas info    : Used 40 registers, used 1 barriers, 528 bytes smem" >&2
echo "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" >&2
exit {rc}
"""


def _fake_cuda_home(tmp_path, rc=0, write_output=True):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    script = FAKE_NVCC.format(calls=tmp_path / "calls.txt", rc=rc)
    if write_output:
        script = script.replace("exit", ': > "$out"\nexit')
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(script)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return tmp_path / "cuda"


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    out = tmp_path / "_build"
    monkeypatch.setattr(build, "BUILD_DIR", out)
    return out


def test_build_key_covers_sources_and_flags(monkeypatch):
    key = build.build_key(da.KERNEL_NAME)
    assert key == build.build_key(da.KERNEL_NAME)
    assert len(key) == 16
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-DX",))
    assert build.build_key(da.KERNEL_NAME) != key


def test_sources_target_sm90a():
    cu = build.CSRC_DIR / f"{da.KERNEL_NAME}.cu"
    assert cu in build.source_files(da.KERNEL_NAME)
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert 'extern "C" int plangen_prefix_decode_attention' in cu.read_text()


def test_compile_writes_library_and_log_then_reuses_them(tmp_path, monkeypatch, build_dir):
    monkeypatch.setenv("CUDA_HOME", str(_fake_cuda_home(tmp_path)))
    so, log, _ = build.compile_library(da.KERNEL_NAME)
    assert so.parent == build_dir and so.is_file()
    assert so.name == f"{da.KERNEL_NAME}-{build.build_key(da.KERNEL_NAME)}.so"
    assert "registers" in log and (build_dir / so.name.replace(".so", ".log")).is_file()
    assert not list(build_dir.glob("*.tmp.so"))
    calls = (tmp_path / "calls.txt").read_text().splitlines()
    assert len(calls) == 1 and "-gencode arch=compute_90a,code=sm_90a" in calls[0]
    so2, log2, seconds = build.compile_library(da.KERNEL_NAME)  # reused
    assert (so2, log2, seconds) == (so, log, 0.0)
    assert len((tmp_path / "calls.txt").read_text().splitlines()) == 1


def test_compile_failure_raises_with_nvcc_output(tmp_path, monkeypatch, build_dir):
    monkeypatch.setenv("CUDA_HOME", str(_fake_cuda_home(tmp_path, rc=2, write_output=False)))
    with pytest.raises(build.KernelBuildError, match="registers"):
        build.compile_library(da.KERNEL_NAME)
    assert not list(build_dir.glob("*.so"))


def test_missing_nvcc_raises(tmp_path, monkeypatch, build_dir):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nowhere"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.compile_library(da.KERNEL_NAME)


def test_wrapper_refuses_devices_without_a_kernel():
    """Only CPU tensors take the plain version; a device with no kernel
    raises rather than falling back."""
    L, B, S, H, D = 1, 1, 128, 1, 64
    kw = dict(device="meta")
    q = torch.empty(B, 1, H, D, **kw)
    k = torch.empty(L, B, S, H, D, **kw)
    mask = torch.empty(B, S, dtype=torch.int32, **kw)
    launches = da.prefix_decode_attention.launches
    with pytest.raises(ValueError, match="no prefix decode attention"):
        da.prefix_decode_attention(q, k, k, mask, 0, 3)
    assert da.prefix_decode_attention.launches == launches
