"""Attention, sampling and the prefix decode-attention kernel wrapper."""

import torch


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
