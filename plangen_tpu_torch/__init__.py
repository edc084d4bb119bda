"""plangen_tpu_torch — the PyTorch + CUDA port of plangen_tpu for NVIDIA Hopper.

The JAX package `plangen_tpu` is the reference: every module here is held
against its counterpart there on the same weights and inputs
(tests/test_torch_*.py). This package imports `torch` and never `jax`, and
nothing of `plangen_tpu` either: it keeps its own copies of the host modules
it needs (`config.py`, `text/`, `data/`'s jax-free modules with the
native resize binding, and `convert/export.py` for weights), which
tests/test_torch_copies.py holds equal to the originals. Only the tests
import both packages.

Layout mirrors the JAX package:

  * `ops/`      — attention, sampling, and the wrappers of the hand-written
                  kernels: decode attention (`decode_attention.py`), the
                  int4 matmuls (`int4_matmul.py`), flash attention forward
                  and backward for training (`flash_attention.py`).
  * `models/`   — `nn.Module`s named like HF `MultiModalityCausalLM`
                  (LLaMA backbone, gen_head / aligners, SigLIP, VQ).
  * `runtime/`  — fixed-buffer KV cache, prefill, the image and text decode
                  loops and their CUDA graphs, `fast_edit`, and the opt-in
                  decoders (self-speculative images, Jacobi text).
  * `tasks/`    — the pipeline's task modes, its host-side processor and
                  the evaluation harness.
  * `train/`    — losses, the multi-task train step, AdamW, checkpoints and
                  the `Trainer`; `data/` — the training data it reads.
  * `convert/`  — weights from the JAX parameter tree, local checkouts and
                  the port's own artifact (`params.py`), seeded random
                  init; the exporter back to the reference's torch format.
  * `config.py`, `text/` — the configuration dataclasses and the host-side
                  text layer (grounding strings, chat template, batching,
                  tokenizers).
  * `csrc/`     — CUDA sources (sm_90a); `kernels/` builds and loads them.
"""

__version__ = "0.1.0"
