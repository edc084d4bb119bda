"""KV cache, prefill, the decode loops and their CUDA graphs, and the
opt-in decoders (`speculative`, `jacobi`)."""
