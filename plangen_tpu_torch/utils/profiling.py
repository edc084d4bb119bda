"""Profiling and tracing hooks.

Port of `plangen_tpu/utils/profiling.py`: `trace()` wraps a region in a
`torch.profiler` session (CPU activity, and CUDA activity when the card is
there) and writes its Chrome trace into a directory (viewable in Perfetto
or `chrome://tracing`), `annotate()` names a sub-region on the profiler's
timeline and, on the card, as an NVTX range, and `StepTimer` tracks
host-side step latency percentiles, with the JAX package's `summary()` keys
and percentile rule.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional

import torch


def _activities() -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region and write its Chrome trace to
    `<log_dir>/trace_<pid>_<ns>.json` on exit (the directory is made).
    Yields the profiler, whose `key_averages()` the caller may read."""
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named sub-region on the profiler's timeline
    (`torch.profiler.record_function`), and an NVTX range on the card."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Host-side step latency tracker with percentile summary."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        ts = sorted(self._times)

        def pct(p):
            return ts[min(len(ts) - 1, int(p * len(ts)))]

        return {
            "steps": len(ts),
            "mean_s": sum(ts) / len(ts),
            "p50_s": pct(0.5),
            "p90_s": pct(0.9),
            "max_s": ts[-1],
        }
