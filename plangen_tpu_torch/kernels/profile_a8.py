"""Device time of K1-a8 by split count, at the Janus-Pro-1B image decode
shapes. Needs an NVIDIA card:

    python -m plangen_tpu_torch.kernels.profile_a8 [--splits 1,2,4,8]
        [--q-pos 0,128,256,390,677,1023]

The kernel takes any split plan of whole 128-slot chunks; the wrapper
launches `split_plan(S, A8_MAX_SPLITS)`. For each q_pos this launches it
with the plan of at most each count of splits over one seeded int8 cache
(L 24, B 8, S 1024, H 16, D 128: the image call of 4 requests with CFG),
checks each plan's probability codes against the plain version's (at most
one step apart, on at most a thousandth of the nonzero codes: the sum over
the splits is taken in another order), and prints the mean device time per
launch in turns (the counts in order, then reversed), the layers rotating
through more than the L2 cache, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from plangen_tpu_torch.ops import decode_attention as da
from plangen_tpu_torch.ops.attention import quantize_kv

SHAPE = dict(L=24, B=8, S=1024, H=16, D=128)
MAX_CODE_SHARE = 1e-3


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


def a8_cache(dev, seed: int = 0):
    """q (bf16 [B, 1, H, D]), the int8 cache and its scales, a mask with a
    few left pads."""
    L, B, S, H, D = (SHAPE[k] for k in "LBSHD")
    g = torch.Generator(device=dev).manual_seed(seed)
    parts = [quantize_kv(torch.randn((B, S, H, D), generator=g, device=dev),
                         torch.randn((B, S, H, D), generator=g, device=dev))
             for _ in range(L)]
    cache = tuple(torch.stack([p[i] for p in parts]) for i in range(4))
    mask = torch.ones((B, S), dtype=torch.int32, device=dev)
    for row in range(B):
        mask[row, :5 * row] = 0
    q = torch.randn((B, 1, H, D), generator=g, device=dev).to(torch.bfloat16)
    return q, cache, mask


def launcher(q, cache, mask, max_splits: int):
    """fn(layer, q_pos, codes=None) launching K1-a8 with the plan of at most
    `max_splits` splits."""
    L, B, S, H, D = cache[0].shape
    plan = da.split_plan(S, max_splits)
    kernel = da._kernel_fn_a8()
    stream = torch.cuda.current_stream().cuda_stream

    def run(layer, q_pos, codes=None):
        out = torch.empty_like(q)
        err = kernel(q.data_ptr(), *(t.data_ptr() for t in cache), mask.data_ptr(),
                     q_pos.data_ptr(), out.data_ptr(),
                     None if codes is None else codes.data_ptr(), B, S, H, D, layer,
                     D ** -0.5, da._DTYPE_CODES[q.dtype], *plan, stream)
        if err != 0:
            raise RuntimeError(f"K1-a8 with plan {plan}: cudaError {err}")
        return out

    return run, plan


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--splits", default="1,2,4,8")
    ap.add_argument("--q-pos", default="0,128,256,390,677,1023")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_a8 needs an NVIDIA card")
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip().splitlines()[0]
    q, cache, mask = a8_cache(dev)
    L = cache[0].shape[0]
    counts = [int(c) for c in args.splits.split(",")]
    runs = {c: launcher(q, cache, mask, c) for c in counts}
    for qp in (int(p) for p in args.q_pos.split(",")):
        q_pos = torch.tensor([qp], dtype=torch.int32, device=dev)
        _, want = da.prefix_decode_attention_a8_reference(q, *cache, mask, L - 1, q_pos,
                                                          return_codes=True)
        for c, (run, plan) in runs.items():
            codes = torch.empty_like(want)
            run(L - 1, q_pos, codes)
            diff = (codes.long() - want.long()).abs()
            nonzero = int((want != 0).sum())
            if int(diff.max()) > 1 or int(diff.sum()) > MAX_CODE_SHARE * max(nonzero, 1):
                raise SystemExit(f"plan {plan} at q_pos {qp}: {int(diff.sum())} of {nonzero} "
                                 "codes apart from the plain version's")
        us = {c: [] for c in counts}
        for order in (counts, counts[::-1]):
            for c in order:
                run = runs[c][0]
                us[c].append(1e3 * device_ms(lambda i, run=run: run(i % L, q_pos), 2 * L))
        print(json.dumps({"card": card, "q_pos": qp, **{
            f"at_most_{c}_splits": {"plan": list(runs[c][1]), "us": sum(v) / 2, "turns": v}
            for c, v in us.items()}}), flush=True)


if __name__ == "__main__":
    main()
