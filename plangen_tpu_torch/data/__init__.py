"""Host-side training data: copies of the JAX package's jax-free data modules
(`schema`, `toy`, `collate`, `loader`) and a registry that knows `toy`."""
