"""One decode step captured in a CUDA graph and replayed.

The port's counterpart of the JAX package's one-program decode
(`plangen_tpu/runtime/generate.py`: prefill + a `lax.scan` over the image
steps, or a `lax.while_loop` over the text steps, in one jitted program). An
eager step enqueues some 1,100-2,600 kernels from Python (the most in the
int4 forms), and the host, not the card, then sets the pace. A
step that reads and writes only static buffers in place can be captured once
and replayed: one graph launch a step.

  1. `eager_step(step)` runs `step()` once eagerly on a side stream, the
     capture stream: a real step, which also builds and loads each kernel
     library (`kernels/build.py` runs nvcc at a kernel's first launch), sets
     each kernel's shared-memory attribute and gives cuBLAS its workspace on
     that stream, none of which may happen under capture;
  2. `StepGraph(step, generators)` captures `step()` on the same stream into
     a `torch.cuda.CUDAGraph`, with every generator the step draws from
     registered with the graph, so each replay draws the numbers the next
     eager step would draw. A loop that may end after its first step (the
     text decode at EOS) reads its flag between the two and captures
     nothing if it ends there;
  3. `replay()` launches the graph on the current stream.

Nothing falls back to eager: an operation that cannot be captured (a host
read of a device value, a synchronisation) makes the capture raise. The
capture's error mode is `thread_local`: that check holds on the capturing
thread, and another thread may wait on an event of its own meanwhile (the
server's assembler waits for a batch's pixels while the device-owner
thread captures the next batch's step).

The kernel wrappers count their launches in Python, which runs at capture
and not at replay. The capture's counts are taken back, and each replay adds
them again, so the counts still say how many times each kernel ran.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Dict, Sequence, Tuple

import torch

from plangen_tpu_torch.ops import decode_attention as da
from plangen_tpu_torch.ops import int4_matmul as im

# (wrapper, counter) of every kernel a decode step may launch
COUNTERS = tuple((fn, name)
                 for fn in (da.prefix_decode_attention, da.prefix_decode_attention_q8,
                            da.prefix_decode_attention_a8, im.int4_matmul_w16,
                            im.int4_matmul_w4a8)
                 for name in ("launches", "tc_launches") if hasattr(fn, name))


def _counts() -> Dict[Tuple[Callable, str], int]:
    return {(fn, name): getattr(fn, name) for fn, name in COUNTERS}


@functools.lru_cache(maxsize=None)
def capture_stream(device_index: int) -> torch.cuda.Stream:
    """One side stream per card for every capture: cuBLAS keeps a workspace
    for each stream it has run on."""
    return torch.cuda.Stream(device=device_index)


def eager_step(step: Callable[[], None]) -> None:
    """`step()` once, eagerly, on the capture stream, ordered after the
    current stream's work and before its later work: what `StepGraph` needs
    to have run before it captures the same step."""
    main = torch.cuda.current_stream()
    side = capture_stream(main.device.index)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        step()
    main.wait_stream(side)


class StepGraph:
    """`step()`, run once by `eager_step`, captured in a CUDA graph that
    `replay()` launches (module docstring). `capture_ms` is the host time of
    the capture and the graph's instantiation; `launches` the kernel
    launches one replay adds to the wrappers' counts."""

    def __init__(self, step: Callable[[], None],
                 generators: Sequence[torch.Generator] = ()):
        main = torch.cuda.current_stream()
        side = capture_stream(main.device.index)
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # raw_cuda_graph() stays readable
        for g in generators:
            graph.register_generator_state(g)
        with torch.cuda.stream(side):
            before = _counts()
            t0 = time.perf_counter()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                step()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is void; the step's own error says why
                raise
            finally:
                after = _counts()
                for (fn, name), count in before.items():
                    setattr(fn, name, count)
            graph.capture_end()
            graph.instantiate()
            self.capture_ms = (time.perf_counter() - t0) * 1e3
        main.wait_stream(side)
        self.graph = graph
        self.launches = {key: after[key] - count for key, count in before.items()
                         if after[key] != count}

    def replay(self) -> None:
        self.graph.replay()
        for (fn, name), count in self.launches.items():
            setattr(fn, name, getattr(fn, name) + count)
