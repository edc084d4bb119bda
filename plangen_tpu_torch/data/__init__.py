"""Host-side data: copies of the JAX package's jax-free data modules
(`schema`, `toy`, `collate`, `loader`, `transforms` and the dataset loaders
`coco`, `grit`, `layoutgpt`, `layoutsam`, `oim`), the binding of the
native resize (`native`), the port's own `preprocess`, and the registry
with every name of the JAX one."""
