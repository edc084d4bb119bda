#!/usr/bin/env python3
"""Run plangen_tpu_torch's layout-to-image and training paths once on one
NVIDIA card.

    python3 chip_smoke.py

Phases; each passes or raises, and the script exits non-zero on any failure:

  1. header: torch / CUDA versions, the card's name and power limit, TF32 off;
  2. build: compile every kernel source in csrc/ (one nvcc each, started
     together) and print nvcc seconds, registers and spills; then the SASS
     (`cuobjdump`) must show HGMMA in the bf16 K3 forward and HMMA in the
     bf16 K3 dK/dV and dQ kernels (the tensor cores);
  3. K1 vs its plain PyTorch version at Janus-Pro-1B decode shapes
     (L=24, B=8, S=1024, H=16, D=128), bf16 and fp32, left-padded rows,
     with device times (the host enqueues ahead) taken in turns (plain,
     kernel, kernel, plain); in bf16 also the one-call counterpart
     (`scaled_dot_product_attention` of the query over the layer's live
     prefix with the pad mask), between the two kernel turns;
  4. the bf16 slice: `PlanGenPipeline.layout_to_image` at Janus-Pro-1B width
     (seeded random bf16 weights, byte-fallback tokenizer) on 4 requests
     and then on 1, checking shapes, ranges, and that every decode-attention
     call of each run went through K1 (576 x 24 launches, no plain calls);
     before that, K1 is checked on the cache the prefill wrote, and one
     cached decode step against the uncached forward;
  5. K2 (W4A16) and K4 (W4A8) int4 matmuls vs their plain versions at the
     1B decode shapes (R = 8; fused qkv, o, fused gate|up, down, gen_head
     fc2) and R = 256 at gate|up, timed in turns;
  6. K1-q8 (decode attention over the int8 cache) vs its plain version at
     the phase-3 shapes;
  7. the quantized slice: the same seeded model quantized in place to
     `int4`, K1-q8 checked on the int8 cache its prefill wrote, then
     `layout_to_image` on the 4 requests; a fresh seeded model quantized to
     `int4_a8` on 1 request. Every decode-step projection goes through K2
     (or K4), every decode attention through K1-q8, no plain version runs;
  8. K3 (flash attention, forward and backward) vs its plain version at the
     training shapes: causal left-padded [3, 736, 16, 128], causal
     [3, 1024, 16, 128], non-causal [3, 576, 16, 64], bf16 (tensor cores)
     and fp32 (CUDA cores), every row and every gradient; in bf16 also
     against `scaled_dot_product_attention` (the default backend, named from
     one profiler pass) on the rows that have an allowed key; device times
     of kernel, plain and SDPA taken in turns;
  9. the training slice: the `Trainer` at Janus-Pro-1B width (seeded random
     fp32 masters, bf16 compute, stage3, the recipe's uni 3 / mmu 3 / plan 2
     flows on the `toy` data, use_flash_attention) takes 7 steps of its own
     loop (the body of `Trainer.fit`, without the final save of ~24 GB of
     state); step-0 losses and gradient norm held against the plain
     attention path; every step's K3 calls counted (24 SigLIP + 3 x 24 LLaMA
     layers, forward and backward, all on the tensor-core route, no plain
     call); the VQ left bit-for-bit
     unchanged, every trainable tensor changed, the loss falling; s/step,
     tokens/s, peak memory and the model-FLOPs share printed; then one more
     step under `torch.profiler`: device busy time against the step's
     wall time, and device time by kernel group.

The last two lines are a JSON object describing the kernels (each with its
launches on the main path, error, time, plain time, the one-call
counterpart's time or null, and `bound_ms`: the least time the card could
take, from `roofline_ms`) and `{"ok": true, "device": {...}}`. Without a
CUDA device the script exits non-zero before printing any result.
"""

from __future__ import annotations

import copy
import json
import pathlib
import re
import subprocess
import sys
import time

PEAK_HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
KERNEL_SHAPE = dict(L=24, B=8, S=1024, H=16, D=128)
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}
KERNEL_SOURCES = ("prefix_decode_attention", "int4_matmul", "flash_attention")
# (name, I, O) of the int4 matmuls of a Janus-Pro-1B decode step
INT4_SHAPES = (("qkv_proj", 2048, 6144), ("o_proj", 2048, 2048),
               ("gate_up_proj", 2048, 11264), ("down_proj", 5632, 2048),
               ("gen_head.fc2", 2048, 16384))
INT4_TOLERANCE = 2e-2  # K2 in bf16 (rtol and atol): it sums in another order
L2_BYTES = 50 * 2**20  # H100 L2: weights rotate through more than this
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
# K3 at the training shapes: (label, B, S, H, D, causal, left pads per row)
FLASH_CASES = (
    ("uni LLaMA", 3, 736, 16, 128, True, (5, 37, 100)),
    ("mmu LLaMA", 3, 1024, 16, 128, True, (0, 0, 0)),
    ("SigLIP", 3, 576, 16, 64, False, (0, 0, 0)),
)
FLASH_TOLERANCE = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 2e-2)}  # (out, grads)
TRAIN_STEPS = 7  # step 0 and 6 more: step 6's loss is the loss after 6 updates
TRAIN_REL_TOL = 2e-2  # step 0, K3 vs the plain attention path
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 data sheet
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 data sheet
# SASS instruction each bf16 K3 kernel must contain: the tensor cores
TENSOR_CORE_SASS = {"flash_fwd_tc_kernel": "HGMMA", "flash_bwd_dkdv_tc_kernel": "HMMA",
                    "flash_bwd_dq_tc_kernel": "HMMA"}


class SmokeFailure(RuntimeError):
    pass


def roofline_ms(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time (ms) the card could take for work of `flops`
    operations over `nbytes` of memory traffic (each input read once, each
    output written once): the larger of the two times at the peak rates."""
    return max(flops / peak_flops, nbytes / PEAK_HBM_BYTES_PER_S) * 1e3


def bound_by(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> str:
    return "operations" if flops / peak_flops > nbytes / PEAK_HBM_BYTES_PER_S else "bytes"


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
    from plangen_tpu_torch.kernels import load_libraries

    t0 = time.perf_counter()
    built = load_libraries(KERNEL_SOURCES)
    log(f"[2] built {len(built)} kernel libraries in {time.perf_counter() - t0:.2f} s "
        "(nvcc runs in parallel, loading included)")
    for lib in built.values():
        log(f"[2] {lib.path.name}: {lib.build_seconds:.2f} s of nvcc")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[2]   {line.strip()}")
    check_tensor_core_sass(built["flash_attention"].path)


def sass_counts(path: pathlib.Path, instructions) -> dict:
    """{kernel function (mangled): {instruction: count}} from cuobjdump."""
    from plangen_tpu_torch.kernels.build import find_nvcc

    cuobjdump = pathlib.Path(find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = dict.fromkeys(instructions, 0)
        elif name is not None:
            for ins in instructions:
                counts[name][ins] += bool(re.search(rf"\b{ins}\b", line))
    return counts


def check_tensor_core_sass(path: pathlib.Path) -> None:
    """Every instantiation (head dim 64 / 128, causal or not) of the bf16 K3
    kernels holds its tensor-core instruction in the built library."""
    counts = sass_counts(path, ("HGMMA", "HMMA"))
    for kernel, ins in TENSOR_CORE_SASS.items():
        found = {n: c for n, c in counts.items() if kernel in n}
        check(len(found) == 4, f"SASS: {len(found)} instantiations of {kernel}, expected 4")
        for name, c in sorted(found.items()):
            m = re.search(r"ILi(\d+)ELb([01])E", name)
            what = f"D={m.group(1)} causal={m.group(2)}" if m else name
            log(f"[2] SASS {kernel} {what}: HGMMA {c['HGMMA']}, HMMA {c['HMMA']}")
            check(c[ins] > 0, f"SASS: no {ins} in {kernel} ({what})")


def time_ms(torch, fn, iters: int, host_ahead: bool = False) -> float:
    """Mean ms per call over `iters` calls between two CUDA events.

    With `host_ahead` the card first spins (`torch.cuda._sleep`) for about
    three times as long as the host took to enqueue the calls, so the calls
    run back to back and the events time the device alone, not the Python
    of each call (a slow or busy host still finishes enqueuing in time)."""
    fn(0)  # warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if host_ahead:
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
        enqueue_s = time.perf_counter() - t0
        torch.cuda._sleep(int(6e9 * enqueue_s) + 2_000_000)  # ~2 GHz SM clock
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


def decode_bound(B: int, live: int, H: int, D: int, kv_bytes_per_row: int) -> tuple:
    """(operations, bytes) of one decode-attention call: the query against
    `live` cache slots (2 D multiply-adds per slot and head: q.k and p.v),
    reading the live K and V rows (`kv_bytes_per_row` per slot and head),
    the bf16 query and mask once and writing the bf16 output once."""
    return 4 * D * B * H * live, B * H * live * kv_bytes_per_row + 4 * B * H * D + 4 * B * live


def phase_kernel_vs_plain(torch, prompt_len: int, dev, shape=KERNEL_SHAPE) -> dict:
    """K1 against its plain version at the decode shapes of Janus-Pro-1B;
    in bf16 also SDPA of the query over the layer's live prefix."""
    import torch.nn.functional as F

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

            # the one-call counterpart: SDPA of the query over the live
            # prefix [0, q_pos] of the layer, with the pad mask
            allowed = (mask[:, None, None, :qp + 1] > 0)

            def library(i):
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k[i % L, :, :qp + 1].transpose(1, 2),
                    v[i % L, :, :qp + 1].transpose(1, 2), attn_mask=allowed).transpose(1, 2)

            iters = 2 * L
            p1 = time_ms(torch, plain, iters, host_ahead=True)
            k1 = time_ms(torch, kernel, iters, host_ahead=True)
            lib_ms = lib_err = None
            if dtype == torch.bfloat16:
                lib_err = max((library(layer).float() - prefix_decode_attention(
                    q, k, v, mask, layer, q_pos).float()).abs().max().item()
                    for layer in (0, L // 2, L - 1))
                check(lib_err <= TOLERANCE[name], f"SDPA vs K1 q_pos={qp}: {lib_err:.3e}")
                lib_ms = (time_ms(torch, library, iters, host_ahead=True)
                          + time_ms(torch, library, iters, host_ahead=True)) / 2
            k2 = time_ms(torch, kernel, iters, host_ahead=True)
            p2 = time_ms(torch, plain, iters, host_ahead=True)
            k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
            nbytes = 2 * B * (qp + 1) * H * D * k.element_size()
            gbps = nbytes / (k_ms * 1e-3) / 1e9
            ops, traffic = decode_bound(B, qp + 1, H, D, 2 * D * k.element_size())
            bound = roofline_ms(ops, traffic)
            rows.append(dict(dtype=name, q_pos=qp, err=err, ms=k_ms, plain_ms=p_ms,
                             library_ms=lib_ms, bound_ms=bound,
                             bound_by=bound_by(ops, traffic)))
            log(f"[3] {name:8s} q_pos={qp:5d} max_abs_err={err:.3e} "
                f"kernel {k_ms * 1e3:8.2f} us ({k1 * 1e3:.2f}/{k2 * 1e3:.2f}) "
                f"plain {p_ms * 1e3:9.2f} us ({p1 * 1e3:.2f}/{p2 * 1e3:.2f}) "
                f"kernel {gbps:7.1f} GB/s = "
                f"{100 * gbps * 1e9 / PEAK_HBM_BYTES_PER_S:.1f}% of 3.35 TB/s; bound "
                f"{bound * 1e3:.2f} us ({bound_by(ops, traffic)}) = {100 * bound / k_ms:.1f}% "
                "of the kernel's time"
                + ("" if lib_ms is None else
                   f"; SDPA {lib_ms * 1e3:.2f} us (max abs diff to K1 {lib_err:.3e})"))
        del k, v, q
    headline = next(r for r in rows
                    if r["dtype"] == "bfloat16" and r["q_pos"] == prompt_len + 287)
    return dict(max_abs_err=max(r["err"] for r in rows),
                **{key: headline[key] for key in
                   ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})


def build_pipeline(torch, dev, output_uint8: bool, model=None, cfg=None,
                   quantize=None):
    from plangen_tpu_torch.config import GenerationConfig, PlanGenModelConfig
    from plangen_tpu_torch.text.tokenizer import ByteFallbackTokenizer
    from plangen_tpu_torch.convert import init_params
    from plangen_tpu_torch.models.vlm import PlanGenModel
    from plangen_tpu_torch.tasks.pipeline import PlanGenPipeline
    from plangen_tpu_torch.tasks.processor import PlanGenProcessor

    cfg = cfg or PlanGenModelConfig()  # default: Janus-Pro-1B widths
    gen = GenerationConfig(cfg_weight=5.0, temperature=1.0, output_uint8=output_uint8,
                           quantize=quantize)
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


def kernel_counters():
    """{kernel name: (wrapper, its plain version)} of every kernel."""
    from plangen_tpu_torch.ops import decode_attention as da
    from plangen_tpu_torch.ops import flash_attention as fa
    from plangen_tpu_torch.ops import int4_matmul as im

    return {
        "prefix_decode_attention": (da.prefix_decode_attention,
                                    da.prefix_decode_attention_reference),
        "prefix_decode_attention_q8": (da.prefix_decode_attention_q8,
                                       da.prefix_decode_attention_q8_reference),
        "int4_matmul_w16": (im.int4_matmul_w16, im.int4_matmul_w16_reference),
        "int4_matmul_a8": (im.int4_matmul_w4a8, im.int4_matmul_w4a8_reference),
        "flash_attention_fwd": (fa.flash_attention_fwd, fa.flash_attention_reference),
        "flash_attention_bwd": (fa.flash_attention_bwd, fa.flash_attention_reference),
    }


def reset_counters(counters) -> None:
    for wrapper, plain in counters.values():
        wrapper.launches = 0
        if hasattr(wrapper, "routes"):
            wrapper.routes = dict.fromkeys(wrapper.routes, 0)
        plain.calls = 0


def expected_launches(cfg, quantize, n_rows: int, prompt_len: int) -> dict:
    """Kernel launches of one `layout_to_image` call, from the code: each of
    the 576 steps runs gen_head (fc2 quantized) and one decoder step whose
    24 layers each make 1 decode attention and 4 quantized matmuls (q|k|v,
    o, gate|up, down); the prefill's matmuls take the kernel only at
    <= 256 rows (2B x prompt), else the dense route."""
    from plangen_tpu_torch.ops.int4_matmul import MAX_KERNEL_ROWS

    N, L = cfg.image_seq_len, cfg.llama.num_layers
    want = dict.fromkeys(kernel_counters(), 0)
    if quantize is None:
        want["prefix_decode_attention"] = N * L
        return want
    want["prefix_decode_attention_q8"] = N * L
    matmul = "int4_matmul_a8" if quantize == "int4_a8" else "int4_matmul_w16"
    prefill = 4 * L if n_rows * prompt_len <= MAX_KERNEL_ROWS else 0
    want[matmul] = N * (4 * L + 1) + prefill
    return want


def run_slice(torch, pipe, cfg, captions, groundings, seeds):
    """One `layout_to_image` call with every kernel's counts set to 0 just
    before it and read just after; returns the launches by kernel."""
    counters = kernel_counters()
    n = len(captions)
    ids, mask = pipe.proc.uni_batch(list(captions), list(groundings))
    prompt_len = pipe.proc.cfg_batch(ids, mask)[0].shape[1]
    sync = torch.cuda.synchronize if pipe.device.type == "cuda" else (lambda: None)
    sync()
    reset_counters(counters)
    t0 = time.perf_counter()
    out = pipe.layout_to_image(captions, groundings, seeds=seeds)
    sync()
    seconds = time.perf_counter() - t0
    launches = {k: w.launches for k, (w, _) in counters.items()}
    plain_calls = sum(p.calls for _, p in counters.values())

    mode = pipe.gen.quantize or "bf16"
    want = expected_launches(cfg, pipe.gen.quantize, 2 * n, prompt_len)
    for name, count in launches.items():
        log(f"[{4 if mode == 'bf16' else 7}] {mode}: {name} launches {count} "
            f"(expected from the code: {want[name]})")
    check(launches == want, f"{mode}: launches {launches}, expected {want}")
    check(plain_calls == 0, f"the plain versions ran {plain_calls} times on the main path")
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
    log(f"[{4 if mode == 'bf16' else 7}] {mode}, {n} request(s): {seconds:.3f} s/call, "
        f"{n * cfg.image_seq_len / seconds:.1f} image tokens/s, plain calls {plain_calls}, "
        f"tokens {toks.shape} in [{toks.min()}, {toks.max()}], "
        f"images {imgs.shape} {imgs.dtype} in [{imgs.min()}, {imgs.max()}]")
    return launches


def rotating(make, nbytes: int):
    """Enough copies of an input to rotate through more than the L2 cache."""
    return [make() for _ in range(max(2, -(-2 * L2_BYTES // nbytes)))]


def timed_pair(torch, kernel, plain, iters: int):
    """(kernel ms, plain ms, the four readings), in turns plain, kernel,
    kernel, plain; device time (host_ahead)."""
    p1 = time_ms(torch, plain, iters, host_ahead=True)
    k1 = time_ms(torch, kernel, iters, host_ahead=True)
    k2 = time_ms(torch, kernel, iters, host_ahead=True)
    p2 = time_ms(torch, plain, iters, host_ahead=True)
    return (k1 + k2) / 2, (p1 + p2) / 2, (p1, k1, k2, p2)


def phase_int4_vs_plain(torch, dev) -> dict:
    """K2 and K4 against their plain versions at the 1B decode shapes."""
    from plangen_tpu_torch.ops import int4_matmul as im

    gen = torch.Generator(device=dev).manual_seed(4321)
    rows = []
    cases = [(name, 8, I, O) for name, I, O in INT4_SHAPES] + [("gate_up_proj", 256, 2048, 11264)]
    for name, R, I, O in cases:
        OH = O // 2

        def weight():
            return {"w_p4": torch.randint(-128, 128, (I, OH), generator=gen, device=dev,
                                          dtype=torch.int8),
                    "s_lo": torch.rand((1, OH), generator=gen, device=dev) * 0.02,
                    "s_hi16": torch.rand((1, OH), generator=gen, device=dev) * 0.02 / 16}

        ws = rotating(weight, I * OH)
        x = torch.randn((R, I), generator=gen, device=dev).to(torch.bfloat16)
        x8, xs = im.quantize_activations_int8(x)
        args = lambda i: (ws[i % len(ws)]["w_p4"], ws[i % len(ws)]["s_lo"], ws[i % len(ws)]["s_hi16"])
        err16 = err8 = 0.0
        for i in range(min(3, len(ws))):
            got = im.int4_matmul_w16(x, *args(i))
            want = im.int4_matmul_w16_reference(x, *args(i))
            check(got.shape == (R, O) and got.dtype == torch.bfloat16, f"K2 output {got.shape}")
            check(bool(torch.isfinite(got).all()), f"non-finite K2 output at {name}")
            torch.testing.assert_close(got.float(), want.float(), rtol=INT4_TOLERANCE,
                                       atol=INT4_TOLERANCE)
            err16 = max(err16, (got.float() - want.float()).abs().max().item())
            got8 = im.int4_matmul_w4a8(x8, xs, *args(i), torch.bfloat16)
            want8 = im.int4_matmul_w4a8_reference(x8, xs, *args(i), torch.bfloat16)
            err8 = max(err8, (got8.float() - want8.float()).abs().max().item())
        check(err8 == 0.0, f"K4 at {name} R={R} differs from its plain version: {err8:.3e}")

        iters = min(64, 4 * len(ws))
        k16, p16, r16 = timed_pair(torch, lambda i: im.int4_matmul_w16(x, *args(i)),
                                   lambda i: im.int4_matmul_w16_reference(x, *args(i)), iters)
        k8, p8, r8 = timed_pair(torch, lambda i: im.int4_matmul_w4a8(x8, xs, *args(i), torch.bfloat16),
                                lambda i: im.int4_matmul_w4a8_reference(x8, xs, *args(i), torch.bfloat16),
                                iters)
        # bytes: packed weights, both scale rows, the activations (bf16, or
        # int8 plus a scale per row for K4), the bf16 output
        weights = I * OH + 2 * OH * 4 + 2 * R * O
        work = {"K2": (2 * R * I * O, weights + 2 * R * I, PEAK_BF16_FLOPS),
                "K4": (2 * R * I * O, weights + R * I + 4 * R, PEAK_INT8_OPS)}
        for tag, k_ms, p_ms, r, err in (("K2", k16, p16, r16, err16), ("K4", k8, p8, r8, err8)):
            gbps = I * OH / (k_ms * 1e-3) / 1e9
            bound = roofline_ms(*work[tag])
            rows.append(dict(kernel=tag, name=name, R=R, err=err, ms=k_ms, plain_ms=p_ms,
                             bound_ms=bound, bound_by=bound_by(*work[tag])))
            log(f"[5] {tag} {name:13s} R={R:3d} I={I} O={O}: max_abs_err={err:.3e} "
                f"kernel {k_ms * 1e3:8.2f} us ({r[1] * 1e3:.2f}/{r[2] * 1e3:.2f}) "
                f"plain {p_ms * 1e3:9.2f} us ({r[0] * 1e3:.2f}/{r[3] * 1e3:.2f}) "
                f"weights {gbps:7.1f} GB/s = {100 * gbps * 1e9 / PEAK_HBM_BYTES_PER_S:.1f}% "
                f"of 3.35 TB/s; bound {bound * 1e3:.2f} us ({bound_by(*work[tag])})")
        del ws
    out = {}
    for tag in ("K2", "K4"):
        mine = [r for r in rows if r["kernel"] == tag and r["R"] == 8]
        # no one PyTorch call computes a matmul over the packed int4 format
        out[tag] = dict(max_abs_err=max(r["err"] for r in rows if r["kernel"] == tag),
                        ms=sum(r["ms"] for r in mine) / len(mine),
                        plain_ms=sum(r["plain_ms"] for r in mine) / len(mine),
                        bound_ms=sum(r["bound_ms"] for r in mine) / len(mine),
                        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in mine)
                        else "operations",
                        library_ms=None)
    return out


def q8_cache(torch, shape, dev, gen):
    """Random rows quantized into an int8 cache (codes and fp32 scales)."""
    from plangen_tpu_torch.ops.attention import quantize_kv

    L, B, S, H, D = (shape[k] for k in "LBSHD")
    cache = {}
    for layer in range(L):
        k = torch.randn((B, S, H, D), generator=gen, device=dev)
        v = torch.randn((B, S, H, D), generator=gen, device=dev)
        parts = quantize_kv(k, v)
        for name, part in zip(("k", "k_scale", "v", "v_scale"), parts):
            if name not in cache:
                cache[name] = torch.empty((L,) + tuple(part.shape), dtype=part.dtype, device=dev)
            cache[name][layer] = part
    return cache


def phase_k1_q8_vs_plain(torch, prompt_len: int, dev, shape=KERNEL_SHAPE) -> dict:
    """K1-q8 against its plain version at the decode shapes of Janus-Pro-1B."""
    from plangen_tpu_torch.ops.decode_attention import (
        prefix_decode_attention, prefix_decode_attention_q8,
        prefix_decode_attention_q8_reference,
    )

    L, B, S, H, D = (shape[k] for k in "LBSHD")
    gen = torch.Generator(device=dev).manual_seed(5678)
    mask = left_padded_mask(torch, B, S, min(prompt_len + 576, S), dev)
    cache = q8_cache(torch, shape, dev, gen)
    c = (cache["k"], cache["k_scale"], cache["v"], cache["v_scale"])
    q = torch.randn((B, 1, H, D), generator=gen, device=dev).to(torch.bfloat16)
    # the bf16 cache K1 reads, for its device time at the same shapes
    kv16 = [torch.randn((L, B, S, H, D), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2)]
    rows = []
    for qp in [prompt_len, 127, 128, prompt_len + 287, S - 1]:
        q_pos = torch.tensor([qp], dtype=torch.int32, device=dev)
        err = 0.0
        for layer in (0, L // 2, L - 1):
            got = prefix_decode_attention_q8(q, *c, mask, layer, q_pos)
            want = prefix_decode_attention_q8_reference(q, *c, mask, layer, q_pos)
            check(bool(torch.isfinite(got).all()), f"non-finite K1-q8 output q_pos={qp}")
            err = max(err, (got.float() - want.float()).abs().max().item())
        check(err <= TOLERANCE["bfloat16"], f"K1-q8 vs plain q_pos={qp}: max abs err {err:.3e}")
        k_ms, p_ms, r = timed_pair(
            torch, lambda i: prefix_decode_attention_q8(q, *c, mask, i % L, q_pos),
            lambda i: prefix_decode_attention_q8_reference(q, *c, mask, i % L, q_pos), 2 * L)
        k1_ms = time_ms(torch, lambda i: prefix_decode_attention(q, *kv16, mask, i % L, q_pos),
                        2 * L, host_ahead=True)
        gbps = B * (qp + 1) * H * (2 * D + 8) / (k_ms * 1e-3) / 1e9
        ops, traffic = decode_bound(B, qp + 1, H, D, 2 * D + 8)  # int8 rows + 2 fp32 scales
        rows.append(dict(q_pos=qp, err=err, ms=k_ms, plain_ms=p_ms,
                         bound_ms=roofline_ms(ops, traffic), bound_by=bound_by(ops, traffic)))
        log(f"[6] int8 cache q_pos={qp:5d} max_abs_err={err:.3e} "
            f"kernel {k_ms * 1e3:8.2f} us ({r[1] * 1e3:.2f}/{r[2] * 1e3:.2f}) "
            f"plain {p_ms * 1e3:9.2f} us ({r[0] * 1e3:.2f}/{r[3] * 1e3:.2f}) "
            f"kernel {gbps:7.1f} GB/s = {100 * gbps * 1e9 / PEAK_HBM_BYTES_PER_S:.1f}% of 3.35 TB/s; "
            f"K1 on a bf16 cache {k1_ms * 1e3:.2f} us; bound "
            f"{roofline_ms(ops, traffic) * 1e3:.2f} us ({bound_by(ops, traffic)})")
    del cache, c, kv16
    headline = next(r for r in rows if r["q_pos"] == prompt_len + 287)
    # no one PyTorch call reads the int8 cache with its scales
    return dict(max_abs_err=max(r["err"] for r in rows), library_ms=None,
                **{key: headline[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")})


def check_q8_prefill_cache(torch, pipe, cfg) -> float:
    """K1-q8 on the int8 cache the quantized slice's prefill wrote."""
    import torch.nn.functional as F

    from plangen_tpu_torch.ops.decode_attention import (
        prefix_decode_attention_q8, prefix_decode_attention_q8_reference,
    )
    from plangen_tpu_torch.runtime.generate import cache_length, prefill
    from plangen_tpu_torch.runtime.kvcache import init_kv_cache

    with torch.inference_mode():
        prep = pipe.prepare_layout_to_image(CAPTIONS, GROUNDINGS, seeds=SEEDS)
        B2, L0, _ = prep.embeds.shape
        S = cache_length(L0, cfg.image_seq_len)
        mask = F.pad(prep.cfg_mask, (0, S - prep.cfg_mask.shape[1])).contiguous()
        cache = init_kv_cache(cfg.llama, B2, S, dtype=prep.embeds.dtype,
                              device=prep.embeds.device, quantized=True)
        prefill(pipe.model, prep.embeds, mask, cache)
        c = (cache["k"], cache["k_scale"], cache["v"], cache["v_scale"])
        q = torch.randn((B2, 1, cfg.llama.num_heads, cfg.llama.head_dim),
                        generator=torch.Generator(device=mask.device).manual_seed(7),
                        device=mask.device).to(prep.embeds.dtype)
        err = 0.0
        for qp in (L0 - 1, L0 + 287):
            q_pos = torch.tensor([qp], dtype=torch.int32, device=mask.device)
            for layer in (0, cfg.llama.num_layers - 1):
                got = prefix_decode_attention_q8(q, *c, mask, layer, q_pos)
                want = prefix_decode_attention_q8_reference(q, *c, mask, layer, q_pos)
                err = max(err, (got.float() - want.float()).abs().max().item())
    log(f"[7] K1-q8 on the int8 prefill cache (2B={B2}, L={L0}, S={S}): max abs err {err:.3e}")
    check(err <= TOLERANCE["bfloat16"], f"K1-q8 on the prefill cache: err {err:.3e}")
    return err


def quantized_pipeline(torch, dev, quantize, model=None):
    """A pipeline whose model (the given one, or a fresh seeded one) is
    quantized in place at construction; prints the quantization time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe, cfg = build_pipeline(torch, dev, output_uint8=False, model=model, quantize=quantize)
    torch.cuda.synchronize()
    nbytes = sum(b.numel() * b.element_size() for b in pipe.model.buffers())
    log(f"[7] {quantize}: model quantized in place in {time.perf_counter() - t0:.2f} s; "
        f"buffers {nbytes / 2**30:.3f} GiB, parameters "
        f"{sum(p.numel() * p.element_size() for p in pipe.model.parameters()) / 2**30:.3f} GiB")
    return pipe, cfg


def _within(got, want, tol: float) -> bool:
    return bool(((got.float() - want.float()).abs() <= tol + tol * want.float().abs()).all())


def flash_work(torch, mask, H: int, D: int, causal: bool) -> dict:
    """Operations and bytes of one K3 call at these inputs: 4 D (forward)
    and 10 D (backward) per (query, key) pair the masks allow, a row with no
    allowed key counting all S keys (it averages V over them); each input
    read once, each output written once (forward: q, k, v, mask in; out,
    lse out; backward: q, k, v, out, dout, mask, lse in; dq, dk, dv out)."""
    B, S = mask.shape
    real = mask > 0
    keys = real.int().cumsum(1) if causal else real.sum(1, keepdim=True).expand(B, S)
    pairs = H * int(torch.where(keys > 0, keys, S).sum())
    tensor = B * S * H * D * 2  # one bf16 [B, S, H, D] tensor
    small = B * S * 4 + B * H * S * 4  # the int32 mask and the fp32 lse
    return {"fwd": (4 * D * pairs, 4 * tensor + small), "bwd": (10 * D * pairs, 8 * tensor + small)}


def rows_with_key(mask, causal: bool):
    """[B, S] bool: the query rows that have an allowed key."""
    real = mask > 0
    return real.cumsum(1) > 0 if causal else real.any(1, keepdim=True).expand_as(real)


def sdpa_inputs(torch, q, k, v, mask, causal: bool):
    """The [B, H, S, D] views and keyword arguments of the one-call
    counterpart of K3: `is_causal` with no pads, a boolean causal and pad
    mask [B, 1, S, S] with them, no mask for full attention over real keys."""
    views = [t.transpose(1, 2) for t in (q, k, v)]
    real = mask > 0
    if bool(real.all()):
        return views, ({"is_causal": True} if causal else {})
    allowed = real[:, None, None, :]
    if causal:
        S = mask.shape[1]
        allowed = allowed & torch.ones((S, S), dtype=torch.bool, device=mask.device).tril()
    return views, {"attn_mask": allowed}


def cuda_kernel_names(torch, fn, top: int = 3) -> str:
    """The CUDA kernels one call of `fn` ran, by device time (one profiler
    pass); names cut to 80 characters."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    timed = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        t = getattr(e, "cuda_time_total", 0) if t is None else t
        if t > 0 and getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type):
            timed.append((t, e.key))
    if not timed:
        return "not measured (the profiler showed no device time)"
    return "; ".join(f"{name[:80]} {t:.1f} us" for t, name in sorted(timed, reverse=True)[:top])


def phase_flash_vs_plain(torch, dev) -> dict:
    """K3 forward and backward against the plain version (autograd through
    the bias path) at the training shapes; every row is compared, those with
    no allowed key included. In bf16 also against SDPA (the rows with a key)
    and device times of kernel, plain and SDPA, taken in turns."""
    import torch.nn.functional as F

    from plangen_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(99)
    stats = {key: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                       bound_parts={}) for key in ("fwd", "bwd")}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tol_out, tol_grad = FLASH_TOLERANCE[name]
        for label, B, S, H, D, causal, pads in FLASH_CASES:
            q, k, v, dout = (torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype)
                             for _ in range(4))
            mask = torch.ones((B, S), dtype=torch.int32, device=dev)
            for r, pad in enumerate(pads):
                mask[r, :pad] = 0
            mine = [t.clone().requires_grad_() for t in (q, k, v)]
            plain = [t.clone().requires_grad_() for t in (q, k, v)]
            out = fa.flash_attention(*mine, mask, causal=causal)
            out.backward(dout)
            want = fa.flash_attention_reference(*plain, mask, causal=causal)
            want.backward(dout)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), f"K3 {label} {name}: non-finite output")
            err_f = (out.float() - want.float()).abs().max().item()
            check(_within(out, want, tol_out), f"K3 {label} {name}: output err {err_f:.3e}")
            err_b = 0.0
            for g, a, b in zip("qkv", mine, plain):
                check(bool(torch.isfinite(a.grad).all()), f"K3 {label} {name}: non-finite d{g}")
                err_b = max(err_b, (a.grad.float() - b.grad.float()).abs().max().item())
                check(_within(a.grad, b.grad, tol_grad),
                      f"K3 {label} {name}: d{g} err {err_b:.3e}")
            stats["fwd"]["max_abs_err"] = max(stats["fwd"]["max_abs_err"], err_f)
            stats["bwd"]["max_abs_err"] = max(stats["bwd"]["max_abs_err"], err_b)
            line = (f"[8] K3 {label} [{B}, {S}, {H}, {D}] {'causal' if causal else 'full'} "
                    f"pads {pads} {name}: out max_abs_err {err_f:.3e}, dq/dk/dv {err_b:.3e}")
            if dtype == torch.bfloat16:
                line += "; " + flash_against_library(torch, F, fa, q, k, v, dout, mask, causal,
                                                     label, stats)
            log(line)
    for key, what in (("fwd", "forward"), ("bwd", f"backward ({fa.BACKWARD_KERNELS_PER_CALL} "
                                                  "kernels a call: Delta, dK/dV, dQ)")):
        st = stats[key]
        log(f"[8] K3 bf16 {what}, the three shapes summed (one layer of uni, mmu and SigLIP): "
            f"kernel {st['ms'] * 1e3:.2f} us, plain {st['plain_ms'] * 1e3:.2f} us, SDPA "
            f"{st['library_ms'] * 1e3:.2f} us, bound {st['bound_ms'] * 1e3:.2f} us = "
            f"{100 * st['bound_ms'] / st['ms']:.1f}% of the kernel's time")
        parts = st.pop("bound_parts")
        st["bound_by"] = max(parts.items(), key=lambda kv: kv[1][0])[1][1]
    return stats


def flash_against_library(torch, F, fa, q, k, v, dout, mask, causal, label, stats) -> str:
    """One bf16 K3 shape against SDPA (values on the rows with a key; the
    backend it ran), then device times of kernel, plain and SDPA, forward and
    backward, in turns; adds them and the bound to `stats`."""
    B, S, H, D = q.shape
    scale = D ** -0.5
    # values: SDPA leaves rows with no allowed key NaN or 0, so those rows
    # get no output gradient here and are not compared
    keep = rows_with_key(mask, causal)[:, :, None, None]
    g = dout * keep
    lib_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    views, kw = sdpa_inputs(torch, *lib_leaves, mask, causal)
    lib_out = F.scaled_dot_product_attention(*views, **kw).transpose(1, 2)
    lib_out.backward(g)
    k3_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    k3_out = fa.flash_attention(*k3_leaves, mask, causal=causal)
    k3_out.backward(g)
    torch.cuda.synchronize()
    tol_out, tol_grad = FLASH_TOLERANCE["bfloat16"]
    check(_within(k3_out[keep.expand_as(k3_out)], lib_out[keep.expand_as(lib_out)], tol_out),
          f"K3 {label}: SDPA and the kernel differ on rows with a key")
    diffs, nonfinite = [], 0
    for n, a, b in zip("qkv", k3_leaves, lib_leaves):
        ok = torch.isfinite(b.grad)
        nonfinite += int((~ok).sum())
        check(_within(a.grad[ok], b.grad[ok], tol_grad), f"K3 {label}: SDPA d{n} differs")
        diffs.append((a.grad[ok].float() - b.grad[ok].float()).abs().max().item())
    out_diff = (k3_out - lib_out)[keep.expand_as(k3_out)].abs().max().item()
    lib_note = (f"SDPA vs kernel: out {out_diff:.3e}, dq/dk/dv {max(diffs):.3e} ({nonfinite} "
                "non-finite SDPA gradient entries not compared)")

    o, lse = fa.flash_attention_fwd(q, k, v, mask, causal, scale)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref_out = fa.flash_attention_reference(*ref_leaves, mask, causal, scale)
    views_t, kw_t = sdpa_inputs(torch, q, k, v, mask, causal)
    lib_ref_out = F.scaled_dot_product_attention(*views, **kw)
    dout_t = dout.transpose(1, 2)
    backend = cuda_kernel_names(torch, lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*views, **kw), lib_leaves, dout_t))
    calls = {
        "fwd": (lambda i: fa.flash_attention_fwd(q, k, v, mask, causal, scale),
                lambda i: fa.flash_attention_reference(q, k, v, mask, causal, scale),
                lambda i: F.scaled_dot_product_attention(*views_t, **kw_t), 20),
        "bwd": (lambda i: fa.flash_attention_bwd(q, k, v, mask, o, dout, lse, causal, scale),
                lambda i: torch.autograd.grad(ref_out, ref_leaves, dout, retain_graph=True),
                lambda i: torch.autograd.grad(lib_ref_out, lib_leaves, dout_t,
                                              retain_graph=True), 10),
    }
    work = flash_work(torch, mask, H, D, causal)
    line = lib_note
    for key, (kernel, plain, library, iters) in calls.items():
        p1 = time_ms(torch, plain, iters, host_ahead=True)
        k1 = time_ms(torch, kernel, iters, host_ahead=True)
        l1 = time_ms(torch, library, iters, host_ahead=True)
        l2 = time_ms(torch, library, iters, host_ahead=True)
        k2 = time_ms(torch, kernel, iters, host_ahead=True)
        p2 = time_ms(torch, plain, iters, host_ahead=True)
        k_ms, p_ms, l_ms = (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2
        flops, nbytes = work[key]
        bound = roofline_ms(flops, nbytes)
        st = stats[key]
        st["ms"] += k_ms
        st["plain_ms"] += p_ms
        st["library_ms"] += l_ms
        st["bound_ms"] += bound
        st["bound_parts"][label] = (bound, bound_by(flops, nbytes))
        line += (f"; {key} kernel {k_ms * 1e3:.2f} us ({k1 * 1e3:.2f}/{k2 * 1e3:.2f}) "
                 f"= {flops / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s, plain {p_ms * 1e3:.2f} us "
                 f"({p1 * 1e3:.2f}/{p2 * 1e3:.2f}), SDPA {l_ms * 1e3:.2f} us "
                 f"({l1 * 1e3:.2f}/{l2 * 1e3:.2f}), bound {bound * 1e3:.2f} us "
                 f"({bound_by(flops, nbytes)}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    return line + f"; SDPA's kernels (forward and backward): {backend}"


def train_flops(model, cfg, batches) -> tuple:
    """Model FLOPs of one train step over the trained path, as 3 x the
    forward's (the backward is 2 x): 2 x parameters x positions for every
    matmul (LLaMA layers on every position; lm_head on the text positions;
    gen_head, gen_aligner on the image positions; SigLIP and the aligner on
    the patches) plus attention (causal 2 S^2 H D a row and layer, SigLIP
    4 N^2 width). The frozen VQ encoder's forward is left out."""
    def n(mod):
        return sum(p.numel() for p in mod.parameters())

    lm, vis, N = cfg.llama, cfg.vision, cfg.image_seq_len
    uni, mmu, plan = batches[0], batches[1], batches[2]
    B_uni, B_mmu = uni["input_ids"].shape[0], mmu["input_ids"].shape[0]
    positions = sum(b["attn_mask"].numel() for b in batches.values())
    text = uni["input_ids"].numel() + mmu["input_ids"].numel() + plan["input_ids"].numel()
    parts = {
        "LLaMA layers": 2 * n(model.language_model.model.layers) * positions,
        "lm_head": 2 * n(model.language_model.lm_head) * text,
        "gen_head": 2 * n(model.gen_head) * B_uni * (N + 1),
        "gen_aligner": 2 * n(model.gen_aligner) * B_uni * N,
        "SigLIP + aligner": 2 * (n(model.vision_model) + n(model.aligner)) * B_mmu * vis.num_patches,
        "LLaMA attention": sum(2 * b["attn_mask"].shape[0] * b["attn_mask"].shape[1] ** 2
                               * lm.num_heads * lm.head_dim * lm.num_layers
                               for b in batches.values()),
        "SigLIP attention": 4 * B_mmu * vis.num_patches ** 2 * vis.width * vis.layers,
    }
    total = 3 * sum(parts.values())
    return total, ", ".join(f"{k} {3 * v / 1e12:.2f}" for k, v in parts.items())


def phase_training(torch, dev) -> dict:
    """The Trainer at Janus-Pro-1B width, K3 on every attention."""
    import dataclasses
    import math
    import shutil
    import statistics
    import tempfile

    from plangen_tpu_torch.config import FlowConfig, PlanGenConfig, apply_overrides
    from plangen_tpu_torch.data.loader import infinite
    from plangen_tpu_torch.ops import flash_attention as fa
    from plangen_tpu_torch.train.step import make_loss_fn
    from plangen_tpu_torch.train.trainer import Trainer

    out_dir = tempfile.mkdtemp(prefix="plangen_train_")
    try:
        cfg = apply_overrides(PlanGenConfig(), {
            "train.tuning_mode": "stage3",
            "train.train_data": (FlowConfig("uni", "toy", 3), FlowConfig("mmu", "toy", 3),
                                 FlowConfig("plan", "toy", 2)),
            "train.use_flash_attention": True,
            "train.output_dir": out_dir,
            "train.num_workers": 0,
            "train.prefetch_depth": 0,
        })
        t0 = time.perf_counter()
        trainer = Trainer(cfg, device=dev)
        trainer.logger.close()
        model, mask = trainer.model, trainer.mask
        n_train = sum(p.numel() for n, p in model.named_parameters() if mask[n])
        log(f"[9] Trainer built in {time.perf_counter() - t0:.2f} s: "
            f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B fp32 parameters, "
            f"{n_train / 1e9:.3f} B trainable (stage3), AdamW moments allocated")
        loader = infinite(trainer.build_dataloader())
        batches = trainer.device_batches(next(loader))
        shapes = {f: tuple(b["attn_mask"].shape) for f, b in batches.items()}
        positions = sum(b["attn_mask"].numel() for b in batches.values())
        real = sum(int(b["attn_mask"].sum()) for b in batches.values())
        log(f"[9] batch: attn_mask shapes {shapes}: {positions} positions, {real} real tokens")

        # step 0 from the same weights and batch: K3 against the plain path
        pad_id = trainer.tokenizer.special.pad_id
        ref = {}
        for flash in (True, False):
            tcfg = dataclasses.replace(cfg.train, use_flash_attention=flash)
            loss_fn = make_loss_fn(cfg.model, tcfg, pad_id, trainer.flows, trainable_mask=mask)
            model.zero_grad(set_to_none=True)
            loss, ld = loss_fn(model, batches)
            loss.backward()
            gnorm = math.sqrt(sum(float(torch.sum(p.grad * p.grad))
                                  for p in model.parameters() if p.grad is not None))
            ref[flash] = ({"loss": loss.item(), **{k: v.item() for k, v in ld.items()}}, gnorm)
            del loss, ld
            model.zero_grad(set_to_none=True)
        (lf, gf), (lp, gp) = ref[True], ref[False]
        log(f"[9] step 0 losses, K3: {json.dumps(lf)}; plain: {json.dumps(lp)} "
            f"(ln {cfg.model.image_token_size} = {math.log(cfg.model.image_token_size):.2f}, "
            f"ln {cfg.model.llama.vocab_size} = {math.log(cfg.model.llama.vocab_size):.2f})")
        log(f"[9] step 0 gradient global norm (trainable): K3 {gf:.6e}, plain {gp:.6e}")
        for k in lf:
            check(abs(lf[k] - lp[k]) <= TRAIN_REL_TOL * abs(lp[k]),
                  f"step 0 {k}: K3 {lf[k]} vs plain {lp[k]}")
        check(abs(gf - gp) <= TRAIN_REL_TOL * gp, f"step 0 gradient norm: K3 {gf} vs plain {gp}")

        vq = {n: p.detach().clone() for n, p in model.gen_vision_model.named_parameters()}
        before = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()
                  if mask[n]}
        n_calls = cfg.model.vision.layers + len(trainer.flows) * cfg.model.llama.num_layers
        counters = kernel_counters()
        torch.cuda.reset_peak_memory_stats()  # the training run's own peak
        reset_counters(counters)
        losses, seconds = [], []
        wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd)
        for step in range(TRAIN_STEPS):
            counts = [w.launches for w in wrappers]
            tc_counts = [w.routes["tensor_cores"] for w in wrappers]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.state, metrics = trainer.step_fn(trainer.state,
                                                     trainer.device_batches(next(loader)))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            metrics = {k: float(v) for k, v in metrics.items()}
            losses.append(metrics["loss"])
            calls = tuple(w.launches - c for w, c in zip(wrappers, counts))
            tc_calls = tuple(w.routes["tensor_cores"] - c for w, c in zip(wrappers, tc_counts))
            log(f"[9] step {step}: {seconds[-1]:.3f} s, K3 forward/backward calls {calls}, "
                f"on the tensor cores {tc_calls}, {json.dumps(metrics)}")
            check(all(math.isfinite(v) for v in metrics.values()), f"step {step}: non-finite loss")
            check(calls == (n_calls, n_calls) and tc_calls == calls,
                  f"step {step}: K3 calls {calls} ({tc_calls} on the tensor cores), "
                  f"expected {n_calls} each, all on the tensor cores")
        launches = {k: w.launches for k, (w, _) in counters.items()}
        plain_calls = fa.flash_attention_reference.calls
        check(plain_calls == 0, f"the plain attention ran {plain_calls} times in training")
        check(trainer.state.step == TRAIN_STEPS, f"train state step {trainer.state.step}")
        check(losses[-1] < losses[0], f"loss did not fall: {losses[0]} -> {losses[-1]}")
        for n, p in model.gen_vision_model.named_parameters():
            check(torch.equal(p, vq[n]), f"frozen gen_vision_model.{n} changed")
        unchanged = [n for n, p in model.named_parameters()
                     if mask[n] and torch.equal(p.detach().cpu(), before[n])]
        check(not unchanged, f"trainable tensors unchanged: {unchanged[:5]}")
        log(f"[9] K3 calls a step {n_calls} forward and {n_calls} backward, all on the tensor "
            f"cores (each backward call launches {fa.BACKWARD_KERNELS_PER_CALL} kernels), "
            f"plain calls 0; gen_vision_model "
            f"bit-for-bit unchanged; all {len(before)} trainable tensors changed; loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f} after {TRAIN_STEPS - 1} updates")

        s_step = statistics.median(seconds[1:])
        flops, parts = train_flops(model, cfg.model, batches)
        peak = torch.cuda.max_memory_allocated()
        log(f"[9] {s_step:.4f} s/step (median of steps 1-{TRAIN_STEPS - 1}; step 0 "
            f"{seconds[0]:.3f} s), {positions / s_step:.1f} positions/s, "
            f"{real / s_step:.1f} real tokens/s, peak device memory {peak / 2**30:.2f} GiB")
        log(f"[9] model FLOPs a step {flops / 1e12:.2f} T ({parts}), "
            f"{flops / s_step / 1e12:.1f} TFLOP/s = {flops / s_step / PEAK_BF16_FLOPS:.3%} "
            f"of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16")
        profile_step(torch, trainer, loader)
        del trainer, model, before, vq
        return launches
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


# device-time groups of a training step, by kernel name (first match wins)
KERNEL_GROUPS = (("K3 forward", ("flash_fwd",)), ("K3 backward", ("flash_bwd",)),
                 ("matmuls (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")),
                 ("softmax / log-softmax", ("softmax",)), ("other", ("",)))


def profile_step(torch, trainer, loader) -> None:
    """One more training step under `torch.profiler`: the device's busy time
    (the sum of its kernels) against the step's wall time under the
    profiler, and the device time by kernel group, largest kernels named."""
    from torch.profiler import ProfilerActivity, profile

    batches = trainer.device_batches(next(loader))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.state, _ = trainer.step_fn(trainer.state, batches)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        t = getattr(e, "cuda_time_total", 0) if t is None else t
        if t > 0 and "CUDA" in str(getattr(e, "device_type", "")):
            kernels.append((t, e.count, e.key))
    if not kernels:
        log("[9] profile: not measured (the profiler showed no device time)")
        return
    busy = sum(t for t, _, _ in kernels)
    groups = dict.fromkeys((g for g, _ in KERNEL_GROUPS), 0.0)
    for t, _, name in kernels:
        low = name.lower()
        groups[next(g for g, keys in KERNEL_GROUPS if any(k in low for k in keys))] += t
    log(f"[9] profile of one step: wall {wall_us / 1e3:.1f} ms under the profiler, device "
        f"busy {busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%, idle "
        f"{100 * (1 - busy / wall_us):.1f}%), {sum(c for _, c, _ in kernels)} kernel launches; "
        + ", ".join(f"{g} {t / 1e3:.1f} ms" for g, t in groups.items()))
    log("[9] largest kernels: " + "; ".join(
        f"{name[:70]} {t / 1e3:.2f} ms x{c}" for t, c, name in sorted(kernels, reverse=True)[:8]))


def device_line(torch) -> dict:
    """The last line: the run drives cuda:0 only, so it used one card,
    whatever `torch.cuda.device_count()` says the machine shows."""
    return {"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": 1,
    }}


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
    bf16 = run_slice(torch, pipe, cfg, CAPTIONS, GROUNDINGS, SEEDS)
    pipe_u8, _ = build_pipeline(torch, dev, output_uint8=True, model=pipe.model)
    bf16_1 = run_slice(torch, pipe_u8, cfg, CAPTIONS[:1], GROUNDINGS[:1], SEEDS[:1])
    log(f"[4] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    launches = {k: bf16[k] + bf16_1[k] for k in bf16}
    del pipe_u8

    int4 = phase_int4_vs_plain(torch, dev)
    k1q8 = phase_k1_q8_vs_plain(torch, prompt_len, dev)

    # the same seeded model, quantized in place (the bf16 phases are done)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    qpipe, _ = quantized_pipeline(torch, dev, "int4", model=pipe.model)
    del pipe
    k1q8["max_abs_err"] = max(k1q8["max_abs_err"], check_q8_prefill_cache(torch, qpipe, cfg))
    q4 = run_slice(torch, qpipe, cfg, CAPTIONS, GROUNDINGS, SEEDS)
    log(f"[7] int4: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del qpipe
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    apipe, _ = quantized_pipeline(torch, dev, "int4_a8")
    a8 = run_slice(torch, apipe, cfg, CAPTIONS[:1], GROUNDINGS[:1], SEEDS[:1])
    log(f"[7] int4_a8: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in launches:
        launches[name] += q4[name] + a8[name]
    del apipe
    torch.cuda.empty_cache()

    flash = phase_flash_vs_plain(torch, dev)
    torch.cuda.empty_cache()
    trained = phase_training(torch, dev)
    for name in launches:
        launches[name] += trained[name]

    kernels = [
        ("prefix_decode_attention", "prefix_decode_attention.cu",
         "plangen_tpu/ops/pallas_decode_attention.py:31", k1),
        ("prefix_decode_attention_q8", "prefix_decode_attention.cu",
         "plangen_tpu/ops/pallas_decode_attention.py:31", k1q8),
        ("int4_matmul_w16", "int4_matmul.cu",
         "plangen_tpu/ops/pallas_int4_matmul.py:101", int4["K2"]),
        ("int4_matmul_a8", "int4_matmul.cu",
         "plangen_tpu/ops/pallas_int4_matmul.py:112", int4["K4"]),
        ("flash_attention_fwd", "flash_attention.cu",
         "plangen_tpu/ops/pallas_attention.py:36", flash["fwd"]),
        ("flash_attention_bwd", "flash_attention.cu",
         "plangen_tpu/ops/pallas_attention.py:249", flash["bwd"]),
    ]
    log(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"plangen_tpu_torch/csrc/{source}",
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": stats["max_abs_err"],
        "ms": stats["ms"],
        "plain_ms": stats["plain_ms"],
        "bound_ms": stats["bound_ms"],
        "bound_by": stats["bound_by"],
        "library_ms": stats["library_ms"],
    } for name, source, replaces, stats in kernels]}))
    log(json.dumps(device_line(torch)))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
