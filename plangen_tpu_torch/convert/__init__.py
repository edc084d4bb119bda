"""Weights into the port: from the JAX parameter tree, or seeded random."""

from plangen_tpu_torch.convert.from_jax import (
    init_params, load_jax_params, load_jax_quantized_params,
)

__all__ = ["init_params", "load_jax_params", "load_jax_quantized_params"]
