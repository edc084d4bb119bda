"""KV cache, prefill and the image-token decode loop."""
