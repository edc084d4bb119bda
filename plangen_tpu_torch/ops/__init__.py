"""Attention, sampling and the prefix decode-attention kernel wrapper."""

import functools

import torch


@functools.lru_cache(maxsize=None)
def _reciprocal(c: float) -> float:
    """fl(1 / c) in float32, held exactly by a Python float."""
    return (torch.tensor(1.0, dtype=torch.float32) / torch.tensor(c, dtype=torch.float32)).item()


def scale_of(absmax: torch.Tensor, c: float, jitted: bool) -> torch.Tensor:
    """absmax / c (c = 127 or 7, the top code of a quantizer), rounded as
    the JAX package rounds it where it quantizes: under `jax.jit` XLA turns
    a division by a constant into a product by the float32 reciprocal
    fl(1 / c) (`jitted`), eagerly JAX divides. Either way the operand is
    float32, so the CPU and the card give the same bits (PyTorch on CUDA
    would turn a division by a Python number into a product)."""
    if jitted:
        return absmax * _reciprocal(c)
    return absmax / torch.full_like(absmax, c)


def require_local(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise TypeError if any argument of a kernel wrapper is a DTensor:
    the kernels take the rank's local tensors (the TP styles hand them over
    with `use_local_output`), and a DTensor reaches neither the kernel nor
    its plain version."""
    from torch.distributed.tensor import DTensor

    for t in tensors:
        if isinstance(t, DTensor):
            raise TypeError(f"{kernel} takes local tensors, got a DTensor "
                            f"{tuple(t.shape)} {t.placements}: pass t.to_local()")
