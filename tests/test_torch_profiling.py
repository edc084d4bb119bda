"""`plangen_tpu_torch/utils/profiling.py` against the JAX package's
`plangen_tpu/utils/profiling.py`, on the CPU: `StepTimer` on one patched
clock, and `trace` / `annotate` writing a Chrome trace that names the
annotated region."""

import json
import time

import pytest
import torch

from plangen_tpu_torch.utils import profiling as tprof


def _clock(ticks):
    it = iter(ticks)
    return lambda: next(it)


@pytest.mark.parametrize("warmup,n", [(1, 12), (0, 3), (2, 2)], ids=["w1x12", "w0x3", "w2x2"])
def test_step_timer_summary_matches_jax(monkeypatch, warmup, n):
    """The same step durations (uneven, so every percentile picks its own
    step) give JAX's summary: the same keys, values and warmup rule (an
    empty summary when the warmup takes every step)."""
    from plangen_tpu.utils import profiling as jprof

    durations = [0.5 + 0.37 * ((7 * i) % 11) for i in range(n)]
    ticks = []
    t = 100.0
    for d in durations:
        ticks += [t, t + d]
        t += d + 1.0
    summaries = []
    for mod in (jprof, tprof):
        monkeypatch.setattr(time, "perf_counter", _clock(ticks))
        timer = mod.StepTimer(warmup=warmup)
        for _ in durations:
            with timer:
                pass
        summaries.append(timer.summary())
    assert summaries[1] == summaries[0]
    if n > warmup:
        assert sorted(summaries[1]) == ["max_s", "mean_s", "p50_s", "p90_s", "steps"]
    else:
        assert summaries[1] == {}


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    """On the CPU `trace` profiles the region and writes one Chrome trace
    into the directory it makes; a region under `annotate` appears in it
    by name, and the profiler's `key_averages()` see the traced op."""
    log_dir = tmp_path / "trace"
    with tprof.trace(str(log_dir)) as prof:
        with tprof.annotate("plangen_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(log_dir.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "plangen_region" for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
