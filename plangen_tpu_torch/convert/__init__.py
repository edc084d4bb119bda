"""Weights into and out of the port: from the JAX parameter tree, a local
checkout (`loading.py`) or the port's artifact (`params.py`), or seeded
random; back out as the reference's state dict (`export.py`)."""

from plangen_tpu_torch.convert.from_jax import (
    init_params, load_jax_params, load_jax_quantized_params,
)

__all__ = ["init_params", "load_jax_params", "load_jax_quantized_params"]
