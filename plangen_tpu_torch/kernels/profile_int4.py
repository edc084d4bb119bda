"""Device time of K2 (bf16) and K4 (W4A8), both on the tensor cores, by
split count and n-tiles, main kernel and second pass apart, at the
Janus-Pro-1B decode shapes. Needs an NVIDIA card:

    python -m plangen_tpu_torch.kernels.profile_int4 [--kernels K2,K4]
        [--targets 0,1,2,4] [--row-tiles 0,2,4]

For each kernel, each shape, each target of blocks per SM (the split-K plan
aims at `target` x SMs blocks, `ops/int4_matmul.py::split_k`; 0: the plan's
own, `tc_blocks_per_sm`) and each count
of 8-row n-tiles a warp (0: the plan's own, `tc_row_tiles`; others are tried
only where they cover fewer rows than R) it prints the plan,
the mean device time per call over weights rotating through more than the
L2 cache (CUDA events, the host enqueuing ahead), and one profiler pass's
device time of the main kernel and of the second pass.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from plangen_tpu_torch.ops import int4_matmul as im

# (name, R, I, O): chip_smoke.py phase 5's cases
SHAPES = (("qkv_proj", 8, 2048, 6144), ("o_proj", 8, 2048, 2048),
          ("gate_up_proj", 8, 2048, 11264), ("down_proj", 8, 5632, 2048),
          ("gen_head.fc2", 8, 2048, 16384), ("gate_up_proj", 64, 2048, 11264),
          ("gate_up_proj", 256, 2048, 11264))
L2_BYTES = 50 * 2**20


def device_ms(fn, iters: int) -> float:
    """Mean device ms per call: the card spins while the host enqueues."""
    fn(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s: the host enqueues ahead of the card
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_us(fn) -> dict:
    """{kernel name: device µs} of one call, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(0)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        t = getattr(e, "cuda_time_total", 0) if t is None else t
        if t > 0:
            key = "main" if "tc_kernel" in e.key else "reduce" if "reduce" in e.key else e.key
            out[key] = out.get(key, 0.0) + t
    return out


PLANS = {"K2": lambda R, I, OH, n_sm: im.w16_plan(R, I, OH, torch.bfloat16, n_sm),
         "K4": lambda R, I, OH, n_sm: im.a8_plan(R, I, OH, n_sm)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default="K2,K4", help="K2, K4 or both")
    ap.add_argument("--targets", default="0", help="blocks per SM the split aims at (0: the plan's)")
    ap.add_argument("--row-tiles", default="0", help="8-row n-tiles a warp (0: the plan's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda:0")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(4321)
    rows = []
    for name, R, I, O in SHAPES:
        OH = O // 2
        n_w = max(2, -(-2 * L2_BYTES // (I * OH)))
        ws = [(torch.randint(-128, 128, (I, OH), generator=gen, device=dev, dtype=torch.int8),
               torch.rand((1, OH), generator=gen, device=dev) * 0.02,
               torch.rand((1, OH), generator=gen, device=dev) * 0.02 / 16) for _ in range(n_w)]
        x = torch.randn((R, I), generator=gen, device=dev).to(torch.bfloat16)
        x8, xs = im.quantize_activations_int8(x)
        calls = {"K2": lambda i: im.int4_matmul_w16(x, *ws[i % n_w]),
                 "K4": lambda i: im.int4_matmul_w4a8(x8, xs, *ws[i % n_w], torch.bfloat16)}
        tiles = [int(t) for t in args.row_tiles.split(",")]
        tiles = [t for t in tiles if t == 0 or 8 * t < R]
        own = im.tc_row_tiles, im.tc_blocks_per_sm
        for kernel in args.kernels.split(","):
            for nt, target in ((nt, int(t)) for nt in tiles for t in args.targets.split(",")):
                im.tc_row_tiles = own[0] if nt == 0 else (lambda rows, nt=nt: nt)
                im.tc_blocks_per_sm = own[1] if target == 0 else (lambda nt, t=target: t)
                plan = PLANS[kernel](R, I, OH, n_sm)
                ms = device_ms(calls[kernel], min(64, 4 * n_w))
                parts = kernel_us(calls[kernel])
                row = dict(kernel=kernel, name=name, R=R, I=I, O=O, target=target,
                           row_tiles=plan.row_tiles, grid=plan.grid, ksplit=plan.ksplit,
                           us=round(ms * 1e3, 2), main_us=round(parts.get("main", 0.0), 2),
                           reduce_us=round(parts.get("reduce", 0.0), 2))
                rows.append(row)
                print(json.dumps(row), flush=True)
        im.tc_row_tiles, im.tc_blocks_per_sm = own
        del ws
    print(json.dumps({"rows": rows}))


if __name__ == "__main__":
    main()
