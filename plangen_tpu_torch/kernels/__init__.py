"""Build and load the hand-written CUDA kernels under `csrc/` (see build.py)."""

from plangen_tpu_torch.kernels.build import (
    BuiltLibrary,
    KernelBuildError,
    load_libraries,
    load_library,
)

__all__ = ["BuiltLibrary", "KernelBuildError", "load_libraries", "load_library"]
