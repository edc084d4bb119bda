#!/usr/bin/env python3
"""Run plangen_tpu_torch's layout-to-image path once on one NVIDIA card.

    python3 chip_smoke.py

Phases; each passes or raises, and the script exits non-zero on any failure:

  1. header: torch / CUDA versions, the card's name and power limit, TF32 off;
  2. build: compile the prefix decode-attention kernel from csrc/ (nvcc)
     and print its registers and spills;
  3. kernel vs its plain PyTorch version at Janus-Pro-1B decode shapes
     (L=24, B=8, S=1024, H=16, D=128), bf16 and fp32, left-padded rows,
     with CUDA-event timings taken in turns (plain, kernel, kernel, plain);
  4. the slice: `PlanGenPipeline.layout_to_image` at Janus-Pro-1B width
     (seeded random bf16 weights, byte-fallback tokenizer) on 4 requests
     and then on 1, checking shapes, ranges, and that every decode-attention
     call of each run went through the kernel (576 x 24 launches, no plain
     calls); before that, the kernel is checked on the cache the prefill
     wrote, and one cached decode step against the uncached forward.

The last two lines are a JSON object describing the kernel and
`{"ok": true, "device": {...}}`. Without a CUDA device the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

PEAK_HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
KERNEL_SHAPE = dict(L=24, B=8, S=1024, H=16, D=128)
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}
LEFT_PADS = (0, 5, 37, 100, 0, 64, 120, 3)  # per row; all < 127 so no row is
# fully masked at the smallest q_pos tested
CAPTIONS = [
    "a red fox sitting in the snow",
    "two teddy bears on a wooden bench in a park",
    "a bowl of oranges next to a blue teapot on a kitchen table",
    "a lighthouse on a cliff at sunset",
]
GROUNDINGS = [
    "<grounding><ref>fox</ref><box>[200, 300, 700, 900]</box></grounding>",
    "<grounding><ref>teddy bear</ref><box>[100, 250, 450, 800]</box>"
    "<ref>teddy bear</ref><box>[500, 260, 880, 790]</box></grounding>",
    "<grounding><ref>bowl</ref><box>[80, 500, 420, 820]</box>"
    "<ref>teapot</ref><box>[520, 380, 860, 840]</box>"
    "<ref>table</ref><box>[0, 600, 1000, 1000]</box></grounding>",
    "<grounding><ref>lighthouse</ref><box>[380, 120, 600, 760]</box>"
    "<ref>cliff</ref><box>[0, 620, 1000, 1000]</box></grounding>",
]
SEEDS = [11, 22, 33, 44]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed nothing")
    return out[0]


def phase_header(torch) -> str:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    card = nvidia_smi_line()
    log(card)
    log(f"[1] device 0: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build() -> None:
    from plangen_tpu_torch.kernels import load_library

    t0 = time.perf_counter()
    built = load_library("prefix_decode_attention")
    log(f"[2] built {built.path.name} in {built.build_seconds:.2f} s of nvcc "
        f"({time.perf_counter() - t0:.2f} s with loading)")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[2]   {line.strip()}")


def time_ms(torch, fn, iters: int) -> float:
    """Mean ms per call over `iters` calls between two CUDA events."""
    fn(0)  # warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def left_padded_mask(torch, B: int, S: int, live: int, device):
    mask = torch.zeros((B, S), dtype=torch.int32, device=device)
    for r in range(B):
        mask[r, LEFT_PADS[r % len(LEFT_PADS)]:live] = 1
    return mask


def phase_kernel_vs_plain(torch, prompt_len: int, dev, shape=KERNEL_SHAPE) -> dict:
    """K1 against its plain version at the decode shapes of Janus-Pro-1B."""
    from plangen_tpu_torch.ops.decode_attention import (
        prefix_decode_attention, prefix_decode_attention_reference,
    )

    L, B, S, H, D = (shape[k] for k in "LBSHD")
    gen = torch.Generator(device=dev).manual_seed(1234)
    mask = left_padded_mask(torch, B, S, min(prompt_len + 576, S), dev)
    q_positions = [prompt_len, 127, 128, prompt_len + 287, S - 1]
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        k = torch.randn((L, B, S, H, D), generator=gen, device=dev).to(dtype)
        v = torch.randn((L, B, S, H, D), generator=gen, device=dev).to(dtype)
        q = torch.randn((B, 1, H, D), generator=gen, device=dev).to(dtype)
        for qp in q_positions:
            q_pos = torch.tensor([qp], dtype=torch.int32, device=dev)
            err = 0.0
            for layer in (0, L // 2, L - 1):
                got = prefix_decode_attention(q, k, v, mask, layer, q_pos)
                want = prefix_decode_attention_reference(q, k, v, mask, layer, q_pos)
                check(bool(torch.isfinite(got).all()), f"non-finite K1 output {name} q_pos={qp}")
                err = max(err, (got.float() - want.float()).abs().max().item())
            check(err <= TOLERANCE[name],
                  f"K1 vs plain {name} q_pos={qp}: max abs err {err:.3e} > {TOLERANCE[name]}")

            # layers in turn, so each launch reads cache the L2 has not kept
            def kernel(i):
                prefix_decode_attention(q, k, v, mask, i % L, q_pos)

            def plain(i):
                prefix_decode_attention_reference(q, k, v, mask, i % L, q_pos)

            iters = 2 * L
            p1 = time_ms(torch, plain, iters)
            k1 = time_ms(torch, kernel, iters)
            k2 = time_ms(torch, kernel, iters)
            p2 = time_ms(torch, plain, iters)
            k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
            nbytes = 2 * B * (qp + 1) * H * D * k.element_size()
            gbps = nbytes / (k_ms * 1e-3) / 1e9
            rows.append(dict(dtype=name, q_pos=qp, err=err, ms=k_ms, plain_ms=p_ms))
            log(f"[3] {name:8s} q_pos={qp:5d} max_abs_err={err:.3e} "
                f"kernel {k_ms * 1e3:8.2f} us ({k1 * 1e3:.2f}/{k2 * 1e3:.2f}) "
                f"plain {p_ms * 1e3:9.2f} us ({p1 * 1e3:.2f}/{p2 * 1e3:.2f}) "
                f"kernel {gbps:7.1f} GB/s = "
                f"{100 * gbps * 1e9 / PEAK_HBM_BYTES_PER_S:.1f}% of 3.35 TB/s")
        del k, v, q
    headline = next(r for r in rows
                    if r["dtype"] == "bfloat16" and r["q_pos"] == prompt_len + 287)
    return dict(max_abs_err=max(r["err"] for r in rows),
                ms=headline["ms"], plain_ms=headline["plain_ms"])


def build_pipeline(torch, dev, output_uint8: bool, model=None, cfg=None):
    from plangen_tpu.config import GenerationConfig, PlanGenModelConfig
    from plangen_tpu.text.tokenizer import ByteFallbackTokenizer
    from plangen_tpu_torch.convert import init_params
    from plangen_tpu_torch.models.vlm import PlanGenModel
    from plangen_tpu_torch.tasks.pipeline import PlanGenPipeline
    from plangen_tpu_torch.tasks.processor import PlanGenProcessor

    cfg = cfg or PlanGenModelConfig()  # default: Janus-Pro-1B widths
    gen = GenerationConfig(cfg_weight=5.0, temperature=1.0, output_uint8=output_uint8)
    tok = ByteFallbackTokenizer(vocab_size=cfg.llama.vocab_size)
    proc = PlanGenProcessor(tok, image_tokens=cfg.image_seq_len, gen=gen)
    if model is None:
        model = PlanGenModel(cfg, dtype=torch.bfloat16, device=dev)
        init_params(model, torch.Generator(device=dev).manual_seed(0))
        model.eval()
    return PlanGenPipeline(model, cfg, proc), cfg


def check_prefill_cache_and_decode_step(torch, pipe, cfg, step_tol=None) -> None:
    """K1 on the cache the slice's prefill wrote, and one cached decode step
    (through K1) against the uncached forward (plain attention): the
    gen-head logits' relative error must be within `step_tol` when given."""
    import torch.nn.functional as F

    from plangen_tpu_torch.ops.decode_attention import (
        prefix_decode_attention, prefix_decode_attention_reference,
    )
    from plangen_tpu_torch.ops.sampling import cfg_combine
    from plangen_tpu_torch.runtime.generate import cache_length, prefill
    from plangen_tpu_torch.runtime.kvcache import init_kv_cache

    model = pipe.model
    lm = model.language_model
    with torch.inference_mode():
        prep = pipe.prepare_layout_to_image(CAPTIONS, GROUNDINGS, seeds=SEEDS)
        B2, L0, _ = prep.embeds.shape
        S = cache_length(L0, cfg.image_seq_len)
        mask = F.pad(prep.cfg_mask, (0, S - prep.cfg_mask.shape[1])).contiguous()
        cache = init_kv_cache(cfg.llama, B2, S, dtype=prep.embeds.dtype,
                              device=prep.embeds.device)
        last_hidden = prefill(model, prep.embeds, mask, cache)
        q = torch.randn((B2, 1, cfg.llama.num_heads, cfg.llama.head_dim),
                        generator=torch.Generator(device=mask.device).manual_seed(7),
                        device=mask.device).to(prep.embeds.dtype)
        err = 0.0
        for qp in (L0 - 1, L0 + 287):
            q_pos = torch.tensor([qp], dtype=torch.int32, device=mask.device)
            for layer in (0, cfg.llama.num_layers - 1):
                got = prefix_decode_attention(q, cache["k"], cache["v"], mask, layer, q_pos)
                want = prefix_decode_attention_reference(
                    q, cache["k"], cache["v"], mask, layer, q_pos)
                err = max(err, (got.float() - want.float()).abs().max().item())
        dtype = str(prep.embeds.dtype).split(".")[-1]
        log(f"[4] {dtype}: K1 on the prefill cache (2B={B2}, L={L0}, S={S}): "
            f"max abs err {err:.3e}")
        check(err <= TOLERANCE[dtype], f"K1 on the {dtype} prefill cache: err {err:.3e}")

        token = cfg_combine(model.image_gen_logits(last_hidden), 5.0).argmax(-1)
        step_embeds = model.gen_img_embeds(token.repeat_interleave(2)[:, None])
        step_embeds = step_embeds.to(prep.embeds.dtype)
        pos = torch.tensor([L0], dtype=torch.int32, device=mask.device)
        cached = lm(step_embeds, mask, pos, cache)[:, -1]
        full = lm(torch.cat([prep.embeds, step_embeds], dim=1), mask[:, :L0 + 1])[:, -1]
        a = model.image_gen_logits(cached)
        b = model.image_gen_logits(full)
        rel = ((a - b).norm() / b.norm()).item()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        log(f"[4] {dtype}: cached decode step (K1) vs uncached forward: gen-head "
            f"logits rel err {rel:.3e}, argmax agreement {agree:.3f}"
            + ("" if step_tol is None else f" (limit {step_tol})"))
        check(step_tol is None or rel <= step_tol,
              f"{dtype} cached vs uncached decode step: rel err {rel:.3e}")


def run_slice(torch, pipe, cfg, captions, groundings, seeds):
    from plangen_tpu_torch.ops.decode_attention import (
        prefix_decode_attention, prefix_decode_attention_reference,
    )

    n = len(captions)
    sync = torch.cuda.synchronize if pipe.device.type == "cuda" else (lambda: None)
    sync()
    prefix_decode_attention.launches = 0
    prefix_decode_attention_reference.calls = 0
    t0 = time.perf_counter()
    out = pipe.layout_to_image(captions, groundings, seeds=seeds)
    sync()
    seconds = time.perf_counter() - t0
    launches = prefix_decode_attention.launches
    plain_calls = prefix_decode_attention_reference.calls

    expected = cfg.image_seq_len * cfg.llama.num_layers
    check(launches == expected, f"{launches} K1 launches, expected {expected}")
    check(plain_calls == 0, f"the plain version ran {plain_calls} times on the main path")
    toks = out.image_tokens
    check(toks.shape == (n, cfg.image_seq_len), f"tokens shape {toks.shape}")
    check(int(toks.min()) >= 0 and int(toks.max()) < cfg.image_token_size,
          f"tokens out of range [{toks.min()}, {toks.max()}]")
    size = cfg.vision.image_size
    imgs = out.images
    check(imgs.shape == (n, size, size, 3), f"images shape {imgs.shape}")
    if pipe.gen.output_uint8:
        check(str(imgs.dtype) == "uint8", f"images dtype {imgs.dtype}")
    else:
        import numpy as np

        check(bool(np.isfinite(imgs).all()), "non-finite pixels")
    log(f"[4] {n} request(s): {seconds:.2f} s/call, "
        f"{n * cfg.image_seq_len / seconds:.1f} image tokens/s, "
        f"K1 launches {launches} (= {cfg.image_seq_len} x {cfg.llama.num_layers}), "
        f"plain calls {plain_calls}, tokens {toks.shape} in [{toks.min()}, {toks.max()}], "
        f"images {imgs.shape} {imgs.dtype} in [{imgs.min()}, {imgs.max()}]")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: this script "
                           "runs only on an NVIDIA card")
    import plangen_tpu_torch  # noqa: F401  (fails outside a checkout)

    phase_header(torch)
    phase_build()

    dev = torch.device("cuda:0")
    pipe, cfg = build_pipeline(torch, dev, output_uint8=False)
    ids, mask = pipe.proc.uni_batch(CAPTIONS, GROUNDINGS)
    prompt_len = pipe.proc.cfg_batch(ids, mask)[0].shape[1]
    k1 = phase_kernel_vs_plain(torch, prompt_len, dev)

    n_params = sum(p.numel() for p in pipe.model.parameters())
    log(f"[4] PlanGenModel at Janus-Pro-1B width: {n_params / 1e9:.3f} B params, "
        f"bf16, {cfg.llama.num_layers} x {cfg.llama.hidden_size}, "
        f"prompt length {prompt_len}")
    # the decode path against the uncached forward: exact enough to hold to a
    # limit in fp32 (a float copy of the weights); reported in bf16
    pipe32, _ = build_pipeline(torch, dev, output_uint8=False,
                               model=copy.deepcopy(pipe.model).float())
    check_prefill_cache_and_decode_step(torch, pipe32, cfg, step_tol=1e-3)
    del pipe32
    torch.cuda.empty_cache()
    check_prefill_cache_and_decode_step(torch, pipe, cfg)

    torch.cuda.reset_peak_memory_stats()
    launches = run_slice(torch, pipe, cfg, CAPTIONS, GROUNDINGS, SEEDS)
    pipe_u8, _ = build_pipeline(torch, dev, output_uint8=True, model=pipe.model)
    launches += run_slice(torch, pipe_u8, cfg, CAPTIONS[:1], GROUNDINGS[:1], SEEDS[:1])
    log(f"[4] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    log(json.dumps({"kernels": [{
        "name": "prefix_decode_attention",
        "route": "cuda",
        "source": "plangen_tpu_torch/csrc/prefix_decode_attention.cu",
        "replaces": "plangen_tpu/ops/pallas_decode_attention.py:31",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
