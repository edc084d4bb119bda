#!/usr/bin/env python3
"""Run plangen_tpu_torch's layout-to-image (bf16, every quantized form and
`kv_a8`), text, editing, training, serving and evaluation paths, the
opt-in decoders, the weight artifacts and the parallel path (on a world-1
mesh) once on one NVIDIA card.

    python3 chip_smoke.py

Phases; each passes or raises, and the script exits non-zero on any failure:

  1. header: torch / CUDA versions, the card's name and power limit, TF32 off;
  2. build: compile every kernel source in csrc/ (one nvcc each, started
     together) and print nvcc seconds, registers and spills; then the SASS
     (`cuobjdump`) must show HGMMA (`wgmma`, the tensor cores) in the bf16
     K3 forward, dK/dV and dQ kernels, HMMA (`mma.sync` bf16) in each of the
     four instances (8-row n-tiles per warp 1, 2, 4, 8) of the bf16 K2
     kernel, and IMMA (`mma.sync` s8) in each of the eight instances (the
     same n-tiles x fp32 or bf16 output) of the K4 kernel;
  3. K1 vs its plain PyTorch version at Janus-Pro-1B decode shapes
     (L=24, B=8, S=1024, H=16, D=128), bf16 and fp32, left-padded rows,
     at q_pos 390, 127, 128, 677 and 1023: its split plan and grid (blocks
     live at that q_pos, per SM), two calls bitwise equal, device times
     (the host enqueues ahead) taken in turns (plain, kernel, kernel,
     plain); in bf16 also the one-call counterpart
     (`scaled_dot_product_attention` of the query over the layer's live
     prefix with the pad mask), between the two kernel turns, and the
     kernel's share of the bound and of SDPA's time; then the same at the
     plan cache (4 rows of the stage-1 prompt, S = its length + 512 rounded
     to 128, q_pos = the prompt length: the first text decode step);
  4. the bf16 slice: `PlanGenPipeline.layout_to_image` at Janus-Pro-1B width
     (seeded random bf16 weights, byte-fallback tokenizer) on 4 requests
     and then on 1, checking shapes, ranges, and that every decode-attention
     call of each run went through K1 (576 x 24 launches, no plain calls);
     the image loop runs as the pipeline runs it on the card: step 0
     eagerly, then a CUDA graph of one step replayed 575 times;
     before that, K1 is checked on the cache the prefill wrote, and one
     cached decode step against the uncached forward;
  4b. the bf16 text paths and editing on the same model: `plan` on the 4
     captions (512 steps); the early exit (row 0 of the plan prompt alone,
     then with the token it first emits near column 40 as EOS: the prefix,
     then EOS, and the loop stops at that column); `joint_generate`
     on 1 caption; `understand` on 2 seeded noise images; `edit_image` on
     the 4 images phase 4 decoded with a box regenerated (every token
     outside it equal to the VQ code of its image). Each call's text tokens
     are in the vocabulary, its K1 launches are 24 x the steps its tokens
     imply (plus 576 x 24 for an image), no plain call, no K3. The text
     loop runs as the pipeline runs it on the card: step 0 eagerly, then a
     CUDA graph of one step replayed until every row has emitted EOS;
  4d. the text loop's CUDA graph against its eager loop (`eager=True`) on
     the same model: `plan` on the 4 captions in turns eager, graph, graph,
     then one profiled graph call (`understand` and `joint_generate`, eager
     against graph, are left out to keep the smoke within its time limit;
     4b runs them on the graph). Every call checked as in 4b, its tokens bitwise equal
     to the first turn's; per call s/call, host ms a step (the flag read
     included), capture + instantiate ms and peak memory; in every graph
     call the captured step's kernel nodes (24 K1) and the device ms a step
     by CUDA events over replays 100-131; in the profiled call 4c's traces:
     kernels a step on the device, the device-busy share and the largest
     kernels;
  4c. the image loop's CUDA graph against its eager loop (`eager=True`) in
     `layout_to_image` on the phase-4 model, 4 requests (1 request is left
     out for time; phase 4 runs it on the graph), in turns eager, graph,
     graph, then one more graph call: every call's
     tokens bitwise equal to the first's and its launches the code's; per
     call s/call, host ms a step, capture + instantiate ms and peak memory;
     in the last call the captured step's kernel nodes by name (read
     through libcuda), replays 100-131 timed by CUDA events (the graph's
     ms a step, and the device's time between replays), then traces of `torch.profiler` over 2 + 32 + 2 replays,
     the middle 32 set apart by 0.5 s idle gaps (up to three, until one shows
     every kernel of the path at its launches a step; the profiler loses a
     few records at a trace's end); both counts must be 24 K1, or 24
     K1-q8 and 97 K2 or K4 in the int4 forms, as `expected_launches` says;
     and the device-busy share: that window's kernel time a step over the
     events' ms a step;
  5. K2 (W4A16) and K4 (W4A8) int4 matmuls vs their plain versions at the
     1B decode shapes (R = 8; fused qkv, o, fused gate|up, down, gen_head
     fc2), R = 64 (batch 32 with CFG) and R = 256 at gate|up, `lm_head`
     (2048 -> 102400) at the plan's R = 4, timed in
     turns. Every bf16 K2 call and every K4 call must take the tensor-core
     route (`tc_launches` rises by one), two calls must be bitwise equal, K4
     bit-equal to its plain version; beside each K2 row the time of cuBLAS
     on the weight dequantized to bf16 once (`x @ w_bf16`, 4x the bytes),
     beside K4 at R = 64 and 256 that of `torch._int_mm` on the weight
     unpacked once to int8 [I, O] (2x the bytes): points of comparison, not
     the same functions;
  6. K1-q8 (decode attention over the int8 cache) vs its plain version at
     the phase-3 shapes;
  7. the quantized slice: the same seeded model quantized in place to
     `int4`, K1-q8 checked on the int8 cache its prefill wrote, then
     `layout_to_image` on the 4 requests; a fresh seeded model quantized to
     `int4_a8` on 1 request. Every decode-step projection goes through K2
     (or K4), every K2 and K4 launch on the tensor-core route, every decode
     attention through K1-q8, no plain version runs; then `plan` in each
     form (int4 on the 4 captions, int4_a8 on 1): K1-q8 at every step,
     K2 / K4 at every projection and `lm_head`, all on the tensor cores,
     launches as the code implies (7b); then, for int4, 4d's comparison of
     `plan`, eager then graph (7d: the captured step holds 24 K1-q8 and 97
     K2 kernel nodes), and 4c's on 4 requests in the same turns (7c);
     int4_a8's eager calls are left out to keep the smoke within its time
     limit;
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

  10. serving at Janus-Pro-1B width: the seeded model written as an HF
     checkout (2 `pytorch_model-0000{1,2}-of-00002.bin` shards, and the first
     shard again as safetensors through the port's writer, read back
     bitwise equal), `tasks/eval.py::build_pipeline` from it (every weight
     bitwise equal to the seeded model's), `serve.Batcher` and the HTTP
     server in-process on 127.0.0.1:0; from client threads: 4 `/generate`
     in one batch (a cold and a warm burst), `/plan` (equal to `pipe.plan`
     on the same caption), 4 `/plan`, `/understand` on a 384 px PNG and one
     to resize, `/joint`, `/edit` with `edit_boxes` (the tokens outside the
     box equal the image's VQ codes), and seed 7 in two batches of 4 with
     other companions (bitwise equal; against the same request alone, in
     bucket 1, reported); p50 latency, requests/s and peak memory per
     mode, the batcher's stats, K1 the only kernel of the bf16 serving run;
     then `quantize="auto"` through `build_pipeline`: at 32 captions (64
     rows) K2 and K1-q8 as `expected_launches` says and no dense LM matmul,
     at 33 (66 rows) no K2; the peak with both trees; and both routes
     timed at B = 4, 32, 48 (a warm call, then a timed one).

  11. the evaluation path at Janus-Pro-1B width on the phase-4 model (run
     after 4c): `tasks/eval.py::run_validation` over small datasets written
     in the real formats (COCO val2017: the two annotation JSONs and 4 JPEGs
     of unequal sizes; the COCO-200 removal and edit sets, 2 samples each;
     NSR-1K, 4 records) for `uni` on COCO (batch 4, FID / KID over SigLIP
     features), `uni_2stage` (1) and `mmu` (2) on COCO, `plan` on NSR-1K
     (4), `rm` and `edit` on COCO-200 (2 each, `fast_edit` and teacher
     forcing as scripts/run_infer.sh sets them): each call's file tree is
     the JAX harness's, its layout JSONs parse, its metrics JSON has the
     JAX keys, its K1 launches are 24 x the decode steps its tokens imply
     (16 a mixed chunk under `fast_edit`), no plain call; then the `rm` and
     `edit` batch through `edit_image` with and without `fast_edit`: bf16
     (forced tokens equal the VQ codes; s/call of each, frozen chunks,
     tokens that differ; one frozen chunk's forward timed on the host and,
     profiled, on the device) and an fp32 copy of the model (bitwise
     equal); the
     SigLIP featurizer's s on 4 images; peak memory. Run it alone from the
     checkout's root with `python3 -c "import torch, chip_smoke as cs;
     cs.phase_build(); p, c = cs.build_pipeline(torch, torch.device('cuda:0'),
     False); cs.phase_eval(torch, p, c)"`.

  12. the training options (run after phase 9, its trainer freed), on the
     recipe's flows over the `toy` data with K3 in every attention, each
     run's kernel counts from 0: 12a step 0's forward + backward at
     Janus-Pro-1B width without remat, with `full` and with `dots` (losses
     and gradient norm within 2e-2 of none, K3's forward twice a call under
     remat, backward once, peak memory of each); 12b LoRA (`lora_tokens`,
     r 256, alpha 128, fp32 masters) 3 steps (every base weight
     bit-for-bit unchanged, every adapter and embedding tensor moved; K3's
     backward skips the frozen SigLIP), then `merge_lora` held in fp32
     (step-0 logits within 1e-3) and a bf16 `plan` of the 4 captions
     merged against adapters through the captured text step (equal tokens,
     or the first differing step reported and its tokens checked for a
     near-tie at the logit level); 12c Adafactor + bf16 masters +
     accumulation 2 + fused CE + `dots`, 4 micro-steps (no parameter moves
     between updates; the VQ frozen); 12d `janus_pro_7b()` width, stage3,
     Adafactor + bf16 masters + `full` + fused CE, 3 steps (finite losses,
     K3 counted, peak under the card's memory) beside a printed reckoning
     of AdamW with fp32 masters at that width; s/step, positions/s, peak
     and the model-FLOPs share of each. Run it alone from the checkout's
     root with `python3 -c "import torch, chip_smoke as cs;
     cs.phase_header(torch); cs.phase_build();
     cs.phase_train_options(torch, torch.device('cuda:0'))"`.

  13. the opt-in decoders at Janus-Pro-1B width on the phase-4 model (run
     after phase 11): `layout_to_image` x1 with `speculative` (bf16, draft
     8 layers, 4 tokens a round) against the graph base loop: s/call,
     rounds, tokens a round, a round's device ms (CUDA events) and host ms
     (the n read included), capture ms; K1 launches 4 x 8 a round and no
     plain call; the graph's rounds bitwise equal to the eager round loop's
     over the first 32 tokens; on an fp32 copy a full-depth draft bitwise
     equal to the graph base loop at temperature 1 in ceil(575 / 5) rounds,
     and greedy with the 8-layer draft equal to base greedy; then `plan` x4
     with `jacobi` (bf16, budget 512) against the graph text loop: s/call,
     the decoder's passes (its `return_iters`), a pass's device and host ms
     (the whole call timed by CUDA events and the host clock over its
     passes), no kernel of the table launched,
     the column where each row first parts from the graph loop (reported:
     the two round differently); at budget 64 in fp32 equal to it.

  14. the weight artifacts (run after phase 10, from its `.bin` checkout):
     `cli convert` plain and `--quantize int4` (the weights read, quantized
     and stored in fp32, as a user runs it), `build_pipeline` (bf16) from
     each `params_path` (every tensor bitwise equal to the `janus_path`
     model's, or to its int4 form quantized in place by convert's rule
     (JAX's eager division; the pipeline's own quantization follows JAX's
     jitted reciprocal): the checkout holds bf16 values and quantization
     runs in fp32 from either), load s and size on disk; the int4
     artifact's `plan` x4 and that in-place int4 pipeline's launch K2 and
     K1-q8 alike, with equal tokens; `cli export` (fp32 safetensors) read back through
     `load_params`, bitwise equal to the model's fp32 state dict. Run 13
     and 14 alone from the root with `python3 -c "import pathlib, tempfile,
     torch, chip_smoke as cs; cs.phase_header(torch); cs.phase_build();
     dev = torch.device('cuda:0'); p, c = cs.build_pipeline(torch, dev,
     False); cs.phase_decoders(torch, p, c); d =
     pathlib.Path(tempfile.mkdtemp()); cs.write_checkpoint(torch, p.model,
     d); del p; cs.phase_artifacts(torch, dev, d)"`.
  16. `kv_a8` (run after phase 7): K1-a8, the s8 x s8 decode attention over
     the int8 cache (split over slots, one cluster per (row, head)),
     against its plain version on phase 6's cache and mask at q_pos 0,
     127, 128 (a tile edge), 256 (a split edge), 677 and 1023, bf16 and
     fp32 queries, then with one row's live prefix all pads, then on a
     cache of S 2048 (four 128-slot tiles a split) at q_pos 1500: max abs err, the probability
     codes that differ from the plain version's (at most
     A8_MAX_CODE_SHARE of the nonzero ones, one step each; a row within
     A8_RTOL, plus the largest v_scale for each code that differs), two
     calls bitwise equal, the split plan and the live blocks, device times
     in turns with the earlier one-block design
     (`csrc/prefix_decode_attention_a8_one_block.cu`, built in phase 2,
     launched by no path of the port) beside K1-q8's and the plain
     version's, and each design's share of the bound (K1-q8's bytes);
     then a fresh seeded model quantized to `int8`:
     `layout_to_image` x4 with and without `kv_a8` in turns int8, kv_a8,
     kv_a8, int8 on the graph (13,824 K1-a8 launches a kv_a8 call, no K1-q8,
     no plain call; tokens equal to the mode's first call; s/call, peak),
     and the kv_a8 loop's first A8_EAGER_STEPS steps eagerly against the
     graph, bitwise. Alone from the root: `python3 -c "import torch,
     chip_smoke as cs; cs.phase_header(torch); cs.phase_build(); dev =
     torch.device('cuda:0'); cs.phase_k1_a8_vs_plain(torch, 390, dev);
     cs.phase_kv_a8(torch, dev)"`.
  15. parallelism (`parallel/mesh.py`; run after phase 12, before 10):
     (a) `init_distributed` opens a world-1 NCCL group on cuda:0 and
     `create_mesh` a 1 x 1 mesh; (d) the phase-4 model (a fresh seeded
     build) split by `shard_params(tp_axis="model")` over the world-1
     axis: `layout_to_image` x4 on the graph path in turns unsharded, TP,
     TP, unsharded (tokens bitwise equal, K1 576 x 24 a call), the TP loop
     for 16 steps eager against the graph, `plan` x4 TP against unsharded
     (groundings and tokens bitwise equal); (e) two ranks on the one card
     over gloo with CUDA tensors (NCCL refuses two ranks on one device):
     the seeded model in fp32, TP 2, 32 eager steps, the ranks' tokens
     equal to each other and to the unsharded fp32 model's; (b) the
     phase-9 Trainer at 1B width cut to PARALLEL_TRAIN_LAYERS (4 LLaMA
     layers, 4 SigLIP blocks) plain, then with `fsdp=True` on the 1 x 1
     mesh at JAX's default `fsdp_min_size` (the parameters' placements by
     kind and dim against the rule and PARALLEL_PLACED), 3 steps each
     from the same seed (K3 16 forward and 16 backward a step, no plain
     call; s/step, peak) and a fourth under the profiler (device
     busy, kernels by group), then the losses and every parameter against
     plain; (c) the FSDP run's checkpoint (gathered, written by the lead)
     restored into a plain Trainer, every parameter bitwise; (f) the
     quantized forms under TP over the world-1 axis (after d): `int8`,
     `int4`, `int4_a8` and `auto`, `layout_to_image` x4 on the graph of
     the TP model quantized on its shards against the unsharded quantized
     model (tokens bitwise equal, launches the code's on both, s/call),
     the quantized model split by `shard_params` holding the same bytes;
     `int8` also with `kv_a8` on both models (K1-a8 at the rank's heads,
     tokens bitwise equal);
     and (after c) a LoRA step (`lora_tokens`, r 256) with the model split
     over the world-1 "model" axis, and 3 Adafactor steps under FSDP, each
     bitwise equal to plain (losses and every parameter), then the FSDP
     and the plain Trainer's `validate` over one toy `plan` batch (files
     and `val/` metrics equal); (g) (after e) K2 and K4 at each TP-2 local
     shape of Janus-Pro-1B against their plain versions, timed, then two
     ranks over gloo on the one card at TP 2 with the phase-4 model
     quantized to `int4` and `int4_a8` on their shards, bf16 activations
     (K2's tensor-core route): route a's bytes equal route b's, the ranks'
     tokens and logits equal, K2 / K4 at every projection of every step,
     the logits of 32 teacher-forced steps within `TP2_LOGIT_TOL` of
     the unsharded model's, and a row split's product within `ROW_TOL` of
     the unsplit layer's, a planted fault beyond `ROW_PLANTED_MIN`
     (`row_witness`); (h) (last) FSDP x TP: four ranks on the one card
     over gloo, mesh data 2 x model 2, `fsdp=True`, the phase-9 Trainer
     (stage3, AdamW, fp32 masters, bf16 compute) at Janus-Pro-1B width cut
     to FSDP_TP_LAYERS, under gradient_checkpointing, 2 steps: every
     parameter gathered right after `shard_params` bitwise equal to the
     seeded weights on every rank, placed as the rule says at JAX's default
     `fsdp_min_size` (FSDP_TP_PLACED), 8 heads a rank, K3's launches the
     code's count each step (no plain call), against one plain Trainer's
     same steps on the global batch the losses within FSDP_TP_LOSS_RTOL,
     AdamW's first moment after step 1 (linear in the gradient) within
     FSDP_TP_MU_RTOL at the median tensor, every parameter within FSDP_TP_PARAM_TOL lr x steps
     (a bound on the steps). Run it alone from the root with `python3 -c "import
     torch, chip_smoke as cs; cs.phase_header(torch); cs.phase_build();
     cs.phase_parallel(torch, torch.device('cuda:0'))"`, (h) alone with
     `cs.phase_fsdp_tp(torch, torch.device('cuda:0'))` after the build.

The last two lines are a JSON object describing the kernels (each with its
launches on the main path, error, time, plain time, the one-call
counterpart's time or null, and `bound_ms`: the least time the card could
take, from `roofline_ms`; K2's and K4's times are the means over the R = 8
shapes, with their times by row count beside them in `ms_by_rows`) and
`{"ok": true, "device": {...}}`. Without a
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
KERNEL_SOURCES = ("prefix_decode_attention", "prefix_decode_attention_a8", "int4_matmul",
                  "flash_attention", "prefix_decode_attention_a8_one_block")
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
# {library: {kernel: (SASS instruction it must contain, instances)}}: the
# bf16 K3 kernels (head dim 64 / 128 x causal or not) on `wgmma`, the bf16
# K2 kernel (1, 2, 4, 8 n-tiles a warp) on `mma.sync` bf16, the K4 kernel
# (the same n-tiles x fp32 / bf16 output) on `mma.sync` s8
TENSOR_CORE_SASS = {
    "flash_attention": {"flash_fwd_tc_kernel": ("HGMMA", 4),
                        "flash_bwd_dkdv_tc_kernel": ("HGMMA", 4),
                        "flash_bwd_dq_tc_kernel": ("HGMMA", 4)},
    "int4_matmul": {"int4_w16_tc_kernel": ("HMMA", 4), "int4_a8_tc_kernel": ("IMMA", 8)},
}
SASS_INSTRUCTIONS = ("HGMMA", "HMMA", "IMMA")
# K2's and K4's row counts in phase 5: 4 is lm_head (2048 -> 102400) at the
# text decode's 4 plan rows; 8 the image loop's decode shapes; 64 and 256
# gate|up at larger batches
INT4_ROWS = (4, 8, 64, 256)
N_SMS = 132  # H100 SXM
# phases 4c, 7c and 4d's plan: one eager turn (two before phase 10 was added,
# which kept the smoke within its time)
GRAPH_TURNS = ("eager", "graph", "graph")


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
    for name in TENSOR_CORE_SASS:
        check_tensor_core_sass(built[name].path, TENSOR_CORE_SASS[name])


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


def check_tensor_core_sass(path: pathlib.Path, kernels: dict) -> None:
    """Every instantiation of each tensor-core kernel (`kernels`:
    {name: (instruction, instances)}) holds its instruction in the built
    library."""
    counts = sass_counts(path, SASS_INSTRUCTIONS)
    for kernel, (ins, instances) in kernels.items():
        found = {n: c for n, c in counts.items() if kernel in n}
        check(len(found) == instances,
              f"SASS: {len(found)} instantiations of {kernel}, expected {instances}")
        for name, c in sorted(found.items()):
            m = re.search(r"ILi(\d+)ELb([01])E", name)
            n_tiles = re.search(r"ILi(\d+)E(f|13__nv_bfloat16)?E", name)
            what = (f"D={m.group(1)} causal={m.group(2)}" if m else
                    f"n-tiles={n_tiles.group(1)}" + {None: "", "f": " fp32 out"}.get(
                        n_tiles.group(2), " bf16 out") if n_tiles else name)
            log(f"[2] SASS {kernel} {what}: "
                + ", ".join(f"{i} {c[i]}" for i in SASS_INSTRUCTIONS))
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


def phase_kernel_vs_plain(torch, prompt_len: int, dev, shape=KERNEL_SHAPE,
                          q_positions=None, mask=None) -> dict:
    """K1 against its plain version at the decode shapes of Janus-Pro-1B;
    in bf16 also SDPA of the query over the layer's live prefix. By default
    the image loop's cache, left-padded rows, at five q_pos; else the given
    pad `mask` at `q_positions`. The headline is the first q_pos."""
    import torch.nn.functional as F

    from plangen_tpu_torch.ops.decode_attention import (
        prefix_decode_attention, prefix_decode_attention_reference, split_plan,
    )

    L, B, S, H, D = (shape[k] for k in "LBSHD")
    n_split, slots = split_plan(S)
    log(f"[3] K1 split plan at S={S}: {n_split} splits of {slots} slots per (row, head), "
        f"one cluster of {n_split} blocks each; grid ({n_split}, {B * H}) = "
        f"{n_split * B * H} blocks = {n_split * B * H / N_SMS:.2f} per SM")
    gen = torch.Generator(device=dev).manual_seed(1234)
    if mask is None:
        mask = left_padded_mask(torch, B, S, min(prompt_len + 576, S), dev)
        q_positions = [prompt_len + 287, prompt_len, 127, 128, S - 1]
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
            again = [prefix_decode_attention(q, k, v, mask, L - 1, q_pos) for _ in range(2)]
            check(torch.equal(*again), f"K1 {name} q_pos={qp}: two calls differ")
            live_blocks = (min(qp, S - 1) // slots + 1) * B * H

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
            log(f"[3] {name:8s} q_pos={qp:5d} max_abs_err={err:.3e} bitwise equal twice, "
                f"{live_blocks} live blocks = {live_blocks / N_SMS:.2f} per SM; "
                f"kernel {k_ms * 1e3:8.2f} us ({k1 * 1e3:.2f}/{k2 * 1e3:.2f}) "
                f"plain {p_ms * 1e3:9.2f} us ({p1 * 1e3:.2f}/{p2 * 1e3:.2f}) "
                f"kernel {gbps:7.1f} GB/s = "
                f"{100 * gbps * 1e9 / PEAK_HBM_BYTES_PER_S:.1f}% of 3.35 TB/s; bound "
                f"{bound * 1e3:.2f} us ({bound_by(ops, traffic)}) = {100 * bound / k_ms:.1f}% "
                "of the kernel's time"
                + ("" if lib_ms is None else
                   f"; SDPA {lib_ms * 1e3:.2f} us (max abs diff to K1 {lib_err:.3e}), "
                   f"K1 takes {k_ms / lib_ms:.2f}x SDPA's time"))
        del k, v, q
    headline = next(r for r in rows
                    if r["dtype"] == "bfloat16" and r["q_pos"] == q_positions[0])
    return dict(max_abs_err=max(r["err"] for r in rows),
                **{key: headline[key] for key in
                   ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})


def build_pipeline(torch, dev, output_uint8: bool, model=None, cfg=None,
                   quantize=None, kv_a8: bool = False):
    from plangen_tpu_torch.config import GenerationConfig, PlanGenModelConfig
    from plangen_tpu_torch.text.tokenizer import ByteFallbackTokenizer
    from plangen_tpu_torch.convert import init_params
    from plangen_tpu_torch.models.vlm import PlanGenModel
    from plangen_tpu_torch.tasks.pipeline import PlanGenPipeline
    from plangen_tpu_torch.tasks.processor import PlanGenProcessor

    cfg = cfg or PlanGenModelConfig()  # default: Janus-Pro-1B widths
    gen = GenerationConfig(cfg_weight=5.0, temperature=1.0, output_uint8=output_uint8,
                           quantize=quantize, kv_a8=kv_a8)
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
        "prefix_decode_attention_a8": (da.prefix_decode_attention_a8,
                                       da.prefix_decode_attention_a8_reference),
        "int4_matmul_w16": (im.int4_matmul_w16, im.int4_matmul_w16_reference),
        "int4_matmul_a8": (im.int4_matmul_w4a8, im.int4_matmul_w4a8_reference),
        "flash_attention_fwd": (fa.flash_attention_fwd, fa.flash_attention_reference),
        "flash_attention_bwd": (fa.flash_attention_bwd, fa.flash_attention_reference),
    }


def reset_counters(counters) -> None:
    for wrapper, plain in counters.values():
        wrapper.launches = 0
        if hasattr(wrapper, "tc_launches"):
            wrapper.tc_launches = 0
        if hasattr(wrapper, "routes"):
            wrapper.routes = dict.fromkeys(wrapper.routes, 0)
        plain.calls = 0


def expected_launches(cfg, quantize, n_rows: int, prompt_len: int, steps=None,
                      kv_a8: bool = False) -> dict:
    """Kernel launches of one decode loop, from the code: each of its
    `steps` (the image loop's 576 by default; a text decode's from its
    tokens) runs the head (gen_head with fc2 quantized, or lm_head) and one
    decoder step whose 24 layers each make 1 decode attention (K1-a8 with
    `kv_a8`) and 4 quantized matmuls (q|k|v, o, gate|up, down); the
    prefill's matmuls take the kernel only at <= 256 rows (rows x prompt),
    else the dense route."""
    from plangen_tpu_torch.ops.int4_matmul import MAX_KERNEL_ROWS

    N = cfg.image_seq_len if steps is None else steps
    L = cfg.llama.num_layers
    want = dict.fromkeys(kernel_counters(), 0)
    if quantize is None:
        want["prefix_decode_attention"] = N * L
        return want
    want["prefix_decode_attention_a8" if kv_a8 else "prefix_decode_attention_q8"] = N * L
    matmul = "int4_matmul_a8" if quantize == "int4_a8" else "int4_matmul_w16"
    prefill = 4 * L if n_rows * prompt_len <= MAX_KERNEL_ROWS else 0
    want[matmul] = N * (4 * L + 1) + prefill
    return want


def counted(torch, device, fn):
    """fn() with every kernel's counts set to 0 just before it and read just
    after: (its result, seconds, launches by kernel, plain calls, launches
    on the tensor cores by int4 kernel)."""
    counters = kernel_counters()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    reset_counters(counters)
    t0 = time.perf_counter()
    out = fn()
    sync()
    seconds = time.perf_counter() - t0
    launches = {k: w.launches for k, (w, _) in counters.items()}
    plain_calls = sum(p.calls for _, p in counters.values())
    tc = {name: counters[name][0].tc_launches for name in ("int4_matmul_w16", "int4_matmul_a8")}
    return out, seconds, launches, plain_calls, tc


def check_launches(tag: str, what: str, launches: dict, want: dict, plain_calls: int,
                   tc: dict) -> None:
    """The launches are the code's, no plain version ran, and every int4
    launch took the tensor cores."""
    for name, count in launches.items():
        log(f"[{tag}] {what}: {name} launches {count} (expected from the code: {want[name]})")
    check(launches == want, f"{what}: launches {launches}, expected {want}")
    check(plain_calls == 0, f"{what}: the plain versions ran {plain_calls} times")
    for name, on_tc in tc.items():
        if launches[name]:
            log(f"[{tag}] {what}: {name} launches on the tensor cores {on_tc} of "
                f"{launches[name]}")
            check(on_tc == launches[name],
                  f"{what}: {launches[name] - on_tc} {name} launches off the tensor cores")


def run_slice(torch, pipe, cfg, captions, groundings, seeds):
    """One `layout_to_image` call with every kernel's counts set to 0 just
    before it and read just after; returns (launches by kernel, output)."""
    n = len(captions)
    ids, mask = pipe.proc.uni_batch(list(captions), list(groundings))
    prompt_len = pipe.proc.cfg_batch(ids, mask)[0].shape[1]
    out, seconds, launches, plain_calls, tc = counted(
        torch, pipe.device, lambda: pipe.layout_to_image(captions, groundings, seeds=seeds))
    mode = pipe.gen.quantize or "bf16"
    tag = "4" if mode == "bf16" else "7"
    check_launches(tag, mode, launches,
                   expected_launches(cfg, pipe.gen.quantize, 2 * n, prompt_len),
                   plain_calls, tc)
    check_image_output(cfg, out, n, pipe.gen.output_uint8)
    toks, imgs = out.image_tokens, out.images
    log(f"[{tag}] {mode}, {n} request(s): {seconds:.3f} s/call, "
        f"{n * cfg.image_seq_len / seconds:.1f} image tokens/s, plain calls {plain_calls}, "
        f"tokens {toks.shape} in [{toks.min()}, {toks.max()}], "
        f"images {imgs.shape} {imgs.dtype} in [{imgs.min()}, {imgs.max()}]")
    return launches, out


def check_image_output(cfg, out, n: int, uint8: bool = False) -> None:
    import numpy as np

    toks = out.image_tokens
    check(toks.shape == (n, cfg.image_seq_len) and toks.dtype == np.int32,
          f"tokens {toks.dtype} {toks.shape}")
    check(int(toks.min()) >= 0 and int(toks.max()) < cfg.image_token_size,
          f"tokens out of range [{toks.min()}, {toks.max()}]")
    size = cfg.vision.image_size
    imgs = out.images
    check(imgs.shape == (n, size, size, 3), f"images shape {imgs.shape}")
    if uint8:
        check(str(imgs.dtype) == "uint8", f"images dtype {imgs.dtype}")
    else:
        check(bool(np.isfinite(imgs).all()), "non-finite pixels")


class TextTokens:
    """Records the token rows of every text decode a pipeline runs, by
    wrapping the instance's `_text_decode` while the `with` block lasts."""

    def __init__(self, pipe):
        self.pipe, self.runs = pipe, []

    def __enter__(self):
        inner = self.pipe._text_decode

        def record(*args, **kw):
            tokens = inner(*args, **kw)
            self.runs.append(tokens)
            return tokens

        self.pipe._text_decode = record
        return self.runs

    def __exit__(self, *exc):
        del self.pipe._text_decode


def text_call(torch, pipe, cfg, tag: str, what: str, fn, n_rows: int, prompt_len: int,
              image_launches=None):
    """One call of a text entry point, counted: its text decode's tokens
    (in the vocabulary, EOS after each row's first EOS, int32 [rows,
    budget]) and the launches of the steps they imply, plus
    `image_launches(output)` for a call that also generates an image.
    Returns (the call's output, its tokens, its launches, its seconds)."""
    import numpy as np

    from plangen_tpu_torch.runtime.generate import text_decode_steps

    eos = pipe.proc.tok.special.eos_id
    budget = pipe.gen.max_new_text_tokens
    with TextTokens(pipe) as runs:
        out, seconds, launches, plain_calls, tc = counted(torch, pipe.device, fn)
    check(len(runs) == 1, f"{what}: {len(runs)} text decodes")
    tokens = runs[0].cpu().numpy()
    check(tokens.shape == (n_rows, budget) and tokens.dtype == np.int32,
          f"{what}: text tokens {tokens.dtype} {tokens.shape}")
    check(int(tokens.min()) >= 0 and int(tokens.max()) < cfg.llama.vocab_size,
          f"{what}: text tokens out of range [{tokens.min()}, {tokens.max()}]")
    for row in tokens:
        hit = np.flatnonzero(row == eos)
        check(not len(hit) or bool((row[hit[0]:] == eos).all()), f"{what}: tokens after EOS")
    steps = text_decode_steps(tokens, eos)
    want = expected_launches(cfg, pipe.gen.quantize, n_rows, prompt_len, steps)
    if image_launches is not None:
        add_launches(want, image_launches(out))
    check_launches(tag, what, launches, want, plain_calls, tc)
    log(f"[{tag}] {what}: {seconds:.3f} s/call, {steps} text decode steps of {budget} "
        f"({n_rows} rows, prompt {prompt_len}), {n_rows * steps / seconds:.1f} text tokens/s"
        + ("" if image_launches else f", {1e3 * seconds / steps:.2f} ms/step with the prefill"))
    return out, tokens, launches, seconds


def joint_image_launches(pipe, cfg, caption):
    """The launches of `joint_generate`'s image stage, from its output's
    groundings: for `text_call`'s `image_launches`."""
    def image_launches(out):
        ids, mask = pipe.proc.uni_batch(caption, out.groundings)
        return expected_launches(cfg, pipe.gen.quantize, 2,
                                 pipe.proc.cfg_batch(ids, mask)[0].shape[1])
    return image_launches


def add_launches(total: dict, *more) -> dict:
    for launches in more:
        for name, count in launches.items():
            total[name] += count
    return total


def clip_noise(n: int, size: int, seed: int):
    """Seeded uniform noise images [n, size, size, 3], CLIP-normalized."""
    import numpy as np

    u = np.random.RandomState(seed).uniform(size=(n, size, size, 3))
    mean = np.array([0.48145466, 0.4578275, 0.40821073])
    std = np.array([0.26862954, 0.26130258, 0.27577711])
    return ((u - mean) / std).astype(np.float32)


def phase_text_paths(torch, pipe, cfg, images) -> dict:
    """[4b] The bf16 text paths at Janus-Pro-1B width on the phase-4 model:
    `plan` on the 4 captions; the early exit (row 0 of the plan prompt
    alone, then again with one of its tokens as EOS); `joint_generate` on 1 caption; `understand` on 2 noise images;
    `edit_image` on the 4 images phase 4 decoded, a box regenerated. Every
    decode attention through K1, no plain call. Returns the launches."""
    import numpy as np

    from plangen_tpu_torch.runtime.generate import greedy_decode_text, text_decode_steps
    from plangen_tpu_torch.text.grounding import truncate_grounding

    proc, model, dev = pipe.proc, pipe.model, pipe.device
    budget = pipe.gen.max_new_text_tokens
    total = dict.fromkeys(kernel_counters(), 0)

    plan_len = proc.stage1_batch(CAPTIONS, budget)[0].shape[1]
    plans, tokens, launches, _ = text_call(torch, pipe, cfg, "4b", "bf16 plan", lambda: pipe.plan(
        CAPTIONS), len(CAPTIONS), plan_len)
    check(all(g.startswith("<grounding>") and g.endswith("</grounding>") for g in plans),
          f"plan strings {plans}")
    log(f"[4b] bf16 plan: groundings {[g[:60] for g in plans]}")
    add_launches(total, launches)

    # the early exit: row 0 alone (a batch of 4 and one of 1 may round
    # differently in bf16), then with the token it emits first at about
    # column 40 as EOS: the prefix up to it, then EOS, and no step past it
    exit_budget, L = 64, cfg.llama.num_layers
    ids, mask = proc.stage1_batch(CAPTIONS, exit_budget)
    embeds0 = model.embed_text(torch.from_numpy(ids[:1].astype(np.int64)).to(dev))
    mask0 = torch.from_numpy(mask[:1]).to(dev)
    eos = proc.tok.special.eos_id

    def decode(eos_id):
        return counted(torch, dev, lambda: greedy_decode_text(
            model, cfg, embeds0, mask0, eos_id, max_new_tokens=exit_budget))

    first_run, _, launches_a, plain_a, _ = decode(eos)
    check(launches_a["prefix_decode_attention"]
          == L * text_decode_steps(first_run.cpu(), eos), "early exit: the first run's launches")
    row = first_run[0].cpu().numpy()
    new = [c for c in range(exit_budget) if int(np.flatnonzero(row == row[c])[0]) == c]
    col = min((c for c in new if c >= 8), key=lambda c: abs(c - 40), default=None)
    check(col is not None, f"row 0 emits no new token after column 8: {row.tolist()}")
    stop = int(row[col])
    again, _, launches_b, plain_b, _ = decode(stop)
    got = again[0].cpu().numpy()
    steps = text_decode_steps(again.cpu(), stop)
    want_steps = col + 1
    check(bool((got[:col] == row[:col]).all()) and bool((got[col:] == stop).all()),
          f"early exit: {got.tolist()} against {row.tolist()} cut at column {col}")
    check(steps == want_steps and launches_b["prefix_decode_attention"] == L * steps
          and plain_a == plain_b == 0,
          f"early exit: {launches_b['prefix_decode_attention']} K1 launches, expected "
          f"{L} x {want_steps}")
    log(f"[4b] early exit: row 0 alone, token {stop} first at column {col} as EOS: the first "
        f"run's prefix then EOS; {steps} steps run, "
        f"{launches_b['prefix_decode_attention']} K1 launches, against {exit_budget} steps "
        f"without it")
    add_launches(total, launches_a, launches_b)

    # joint_generate: the plan, then the image on the planned grounding
    caption = CAPTIONS[:1]
    plan_len = proc.stage1_batch(caption, budget)[0].shape[1]
    joint, joint_tokens, launches, _ = text_call(
        torch, pipe, cfg, "4b", "bf16 joint_generate",
        lambda: pipe.joint_generate(caption, seeds=SEEDS[:1]), 1, plan_len,
        image_launches=joint_image_launches(pipe, cfg, caption))
    check(joint.groundings == [truncate_grounding(t) for t in proc.decode_until_eos(
        joint_tokens)], f"joint_generate groundings {joint.groundings}")
    check_image_output(cfg, joint, 1)
    add_launches(total, launches)

    # understand: 2 seeded noise images
    noise = clip_noise(2, cfg.vision.image_size, seed=5)
    mmu_len = proc.mmu_batch(2, decode_budget=budget).input_ids.shape[1]
    understood, _, launches, _ = text_call(torch, pipe, cfg, "4b", "bf16 understand",
                                           lambda: pipe.understand(noise), 2, mmu_len)
    check(len(understood.texts) == 2 and understood.groundings == understood.texts
          and all(isinstance(t, str) for t in understood.texts),
          f"understand texts {understood.texts}")
    add_launches(total, launches)

    # edit_image: the phase-4 images, a box of the 24 x 24 token grid
    # regenerated; every token outside it is the VQ code of its image
    n, grid = images.shape[0], pipe.grid
    box = np.zeros((grid, grid), dtype=np.int32)
    box[6:18, 4:16] = 1
    region = np.broadcast_to(box.reshape(1, -1), (n, grid * grid)).copy()
    with torch.inference_mode():
        vq = model.gen_vision_model
        codes = vq.encode_to_indices(torch.from_numpy(images).to(
            device=dev, dtype=next(vq.parameters()).dtype)).cpu().numpy()
    ids, mask = proc.uni_batch(CAPTIONS, GROUNDINGS)
    edit_len = proc.cfg_batch(ids, mask)[0].shape[1]
    edited, seconds, launches, plain_calls, tc = counted(torch, dev, lambda: pipe.edit_image(
        CAPTIONS, GROUNDINGS, images, region, seeds=SEEDS))
    check_launches("4b", "bf16 edit_image", launches,
                   expected_launches(cfg, None, 2 * n, edit_len), plain_calls, tc)
    check_image_output(cfg, edited, n)
    check(edited.edit_mask is not None and bool((edited.edit_mask == region).all()),
          "edit_image: edit_mask is not the region")
    keep = region == 0
    check(bool((edited.image_tokens[keep] == codes[keep]).all()),
          f"edit_image: {(edited.image_tokens[keep] != codes[keep]).sum()} forced tokens "
          "differ from the VQ codes")
    changed = int((edited.image_tokens[~keep] != codes[~keep]).sum())
    log(f"[4b] bf16 edit_image, {n} images: {seconds:.3f} s/call, {int(keep.sum())} tokens "
        f"forced to the VQ codes, all equal; {int((~keep).sum())} regenerated, {changed} "
        "of them differ from the codes")
    return add_launches(total, launches)


def quantized_plan(torch, pipe, cfg, captions) -> dict:
    """[7b] `plan` in the pipeline's quantized form: every decode attention
    through K1-q8, every int4 matmul (`lm_head` included) through K2 or K4
    on the tensor cores, no plain call. Returns the launches."""
    mode = pipe.gen.quantize
    plan_len = pipe.proc.stage1_batch(list(captions), pipe.gen.max_new_text_tokens)[0].shape[1]
    plans, _, launches, _ = text_call(torch, pipe, cfg, "7b", f"{mode} plan",
                                      lambda: pipe.plan(captions), len(captions), plan_len)
    check(len(plans) == len(captions), f"{mode} plan: {plans}")
    return launches


class DecodeLoop:
    """While the `with` block lasts, the pipeline's image loop (with `text`,
    its text loop) runs eagerly (`eager=True`) or through its CUDA graph,
    and every decode step (eager) or replay (graph) of that loop leaves its
    host clock (start, end) in `stamps`; the graph's capture ms go to
    `capture_ms`. The other loop's replays (`joint_generate`'s image stage
    under `text`) are not recorded.

    With `measure`, the graph's kernel nodes by name go to `nodes`, and
    events recorded before and after each of replays 100-131 time the
    window (`window_ms`) and the device's time between one replay's end and
    the next one's start (`between_ms`: where the text loop's host reads its
    flag and launches the next replay). With `profile` as well, up to
    PROFILED_WINDOWS traces of `torch.profiler` follow, each over
    GRAPH_PAD + GRAPH_WINDOW + GRAPH_PAD replays with the device idle for
    GAP_S before and after the middle GRAPH_WINDOW, until `accept` holds for
    the kernels of the middle ones. `profiles` keeps those kernels of each
    trace (None when the gaps did not split it in three), `accepted` says
    whether the last was accepted."""

    def __init__(self, torch, text: bool = False, eager: bool = False, measure: bool = False,
                 profile: bool = False, accept=None):
        self.torch, self.text, self.eager, self.accept = torch, text, eager, accept
        self.measure, self.profiled = measure or profile, profile
        self.stamps, self.capture_ms, self.replays, self.profiles = [], [], 0, []
        self.window_ms, self.nodes, self.accepted, self.active = None, None, False, False
        self.starts, self.ends, self.between_ms = [], [], None

    def __enter__(self):
        import functools

        from plangen_tpu_torch.runtime import cuda_graph, generate
        from plangen_tpu_torch.tasks import pipeline

        loop, step_name = (("greedy_decode_text", "text_decode_step") if self.text
                           else ("generate_image_tokens", "image_decode_step"))
        self.saved = [(pipeline, loop, getattr(pipeline, loop)),
                      (generate, step_name, getattr(generate, step_name)),
                      (cuda_graph.StepGraph, "replay", cuda_graph.StepGraph.replay)]
        run = functools.partial(getattr(generate, loop), eager=self.eager)
        step, replay = getattr(generate, step_name), cuda_graph.StepGraph.replay

        def active_loop(*args, **kw):
            self.active = True
            try:
                return run(*args, **kw)
            finally:
                self.active = False

        def timed_step(*args, **kw):
            t0 = time.perf_counter()
            step(*args, **kw)
            if self.eager:
                self.stamps.append((t0, time.perf_counter()))

        def timed_replay(graph):
            if not self.active:
                return replay(graph)
            if self.replays == 0:
                self.capture_ms.append(graph.capture_ms)
                if self.measure:
                    self.nodes = graph_kernel_nodes(graph.graph.raw_cuda_graph())
            if self.measure:
                self.before(self.replays)
            t0 = time.perf_counter()
            replay(graph)
            self.stamps.append((t0, time.perf_counter()))
            self.replays += 1
            if self.measure:
                self.after(self.replays)

        setattr(pipeline, loop, active_loop)
        setattr(generate, step_name, timed_step)
        cuda_graph.StepGraph.replay = timed_replay
        return self

    def trace(self, i: int):
        """(trace k, replay i's place in it) for replays from 132 on."""
        k, j = divmod(i - 100 - GRAPH_WINDOW, GRAPH_WINDOW + 2 * GRAPH_PAD)
        return ((k, j) if self.profiled and i >= 100 + GRAPH_WINDOW and k < PROFILED_WINDOWS
                else (None, None))

    def event(self):
        event = self.torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def before(self, i: int) -> None:
        torch = self.torch
        k, j = self.trace(i)
        if 100 <= i < 100 + GRAPH_WINDOW:
            self.starts.append(self.event())
        elif k is None or self.accepted:
            return
        elif j == 0:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self.profile = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.profile.__enter__()
        elif j in (GRAPH_PAD, GRAPH_PAD + GRAPH_WINDOW):
            torch.cuda.synchronize()
            time.sleep(GAP_S)  # the device idles between the pads and the window

    def after(self, i: int) -> None:
        torch = self.torch
        k, j = self.trace(i - 1)  # of the replay just run
        if 100 < i <= 100 + GRAPH_WINDOW:
            self.ends.append(self.event())
        if i == 100 + GRAPH_WINDOW:
            torch.cuda.synchronize()
            self.window_ms = self.starts[0].elapsed_time(self.ends[-1])
            self.between_ms = sum(e.elapsed_time(s) for e, s in zip(self.ends, self.starts[1:]))
        elif k is not None and j == GRAPH_WINDOW + 2 * GRAPH_PAD - 1 and not self.accepted:
            torch.cuda.synchronize()
            self.profile.__exit__(None, None, None)
            parts = split_at_gaps(device_kernels(self.profile), GAP_S * 1e6 / 2)
            self.profiles.append(parts[1] if len(parts) == 3 else None)
            self.accepted = len(parts) == 3 and self.accept(parts[1])

    def __exit__(self, *exc):
        for owner, name, value in self.saved:
            setattr(owner, name, value)

    def host_ms_per_step(self) -> float:
        return (self.stamps[-1][1] - self.stamps[0][0]) * 1e3 / len(self.stamps)


# kernels of the path counted in the graph and on the device: (wrapper whose
# launches a step they are, a piece of the kernel's name)
GRAPH_KERNELS = (("prefix_decode_attention", "split_kv_decode_kernel"),
                 ("prefix_decode_attention_q8", "split_kv_decode_kernel"),
                 ("prefix_decode_attention_a8", "a8_split_kernel"),
                 ("int4_matmul_w16", "int4_w16_tc_kernel"),
                 ("int4_matmul_a8", "int4_a8_tc_kernel"))
GRAPH_WINDOW = 32  # replays a window
# The profiler loses kernel records of a trace, ~16 of 51,000 at its end
# in one run on the H100 (one of them a K2), 0-3 in others; it never adds
# one. So each trace pads the counted window with GRAPH_PAD replays on
# either side, set apart by GAP_S of device idle, and counts the middle; a
# trace that still shows a kernel of the path short is followed by
# another, up to PROFILED_WINDOWS. Under the profiler a slow host can leave
# the device idle for tens of ms between replays: GAP_S stays far above.
GRAPH_PAD = 2
GAP_S = 0.5
PROFILED_WINDOWS = 3


def graph_kernel_nodes(raw_graph: int) -> dict:
    """{kernel name (mangled): nodes} of a captured CUDA graph, read through
    libcuda (`cuGraphGetNodes`, the kernel nodes' functions and names)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    graph, n = ctypes.c_void_p(raw_graph), ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    counts = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType failed")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func at byte 0, kern (CUkernel) at byte 56
        params = (ctypes.c_uint64 * 16)()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params) == 0,
              "cuGraphKernelNodeGetParams failed")
        name = ctypes.c_char_p()
        err = (cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params[0])) if params[0]
               else cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params[7])))
        check(err == 0 and name.value is not None, f"no name for a kernel node (error {err})")
        key = name.value.decode()
        counts[key] = counts.get(key, 0) + 1
    return counts


def device_kernels(prof) -> list:
    """(start us, end us, name) of every device kernel the profiler
    recorded, by start."""
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if "CUDA" in str(getattr(e, "device_type", ""))
                  and e.time_range.end > e.time_range.start)


def split_at_gaps(kernels: list, gap_us: float) -> list:
    """`kernels` (by start) cut where the device idled more than `gap_us`."""
    parts, end = [], None
    for k in kernels:
        if end is None or k[0] - end > gap_us:
            parts.append([])
            end = k[1]
        parts[-1].append(k)
        end = max(end, k[1])
    return parts


def profiled_kernels(prof) -> list:
    """(device us, calls, name) of every device kernel the profiler saw."""
    kernels = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        t = getattr(e, "cuda_time_total", 0) if t is None else t
        if t > 0 and "CUDA" in str(getattr(e, "device_type", "")):
            kernels.append((t, e.count, e.key))
    return kernels


def path_per_step(cfg, quantize, n_rows: int, prompt_len: int):
    """(launches a decode step by kernel, from `expected_launches`; the
    kernels of the path with their name pieces, from GRAPH_KERNELS)."""
    one, two = (expected_launches(cfg, quantize, n_rows, prompt_len, steps) for steps in (1, 2))
    per_step = {k: two[k] - one[k] for k in two}
    return per_step, [(name, piece) for name, piece in GRAPH_KERNELS if per_step[name]]


def on_device(kernels, path) -> dict:
    """Kernels a step of each kernel of the path in a profiled window."""
    return {name: sum(piece in k for _, _, k in kernels) / GRAPH_WINDOW for name, piece in path}


def check_graph_nodes(tag: str, label: str, loop, per_step: dict, path) -> int:
    """The captured step's kernel nodes of each kernel of the path equal its
    launches a step; returns the graph's kernel nodes."""
    nodes = {name: sum(c for k, c in loop.nodes.items() if piece in k) for name, piece in path}
    total = sum(loop.nodes.values())
    log(f"[{tag}] {label}, the captured step: {total} kernel nodes; of the path's kernels "
        + ", ".join(f"{k} {v} (expected {per_step[k]})" for k, v in nodes.items()))
    check(all(v == per_step[k] for k, v in nodes.items()),
          f"{label}: kernel nodes of the captured step {nodes}, expected {per_step}")
    return total


def report_profile(tag: str, label: str, loop, per_step: dict, path) -> dict:
    """The profiled traces of `loop`: kernels a step on the device by kernel
    of the path, then over the accepted window the device-busy share of the
    events' ms a step and the largest kernels a step. Returns the numbers."""
    for w, kernels in enumerate(loop.profiles):
        log(f"[{tag}] {label}, profiled trace {w + 1}: " + (
            "the device's idle gaps did not set the window apart" if kernels is None else
            f"{GRAPH_WINDOW} replays between two idle gaps, "
            f"{len(kernels) / GRAPH_WINDOW:.5f} kernels a step on the device; by kernel "
            + ", ".join(f"{k} {v:g} (expected {per_step[k]})"
                        for k, v in on_device(kernels, path).items())))
    check(loop.accepted, f"{label}: in none of {len(loop.profiles)} profiled traces "
          "did every kernel of the path show its launches a step")
    graph_ms = loop.window_ms / GRAPH_WINDOW
    kernels = loop.profiles[-1]
    # the kernels' device time a step (profiled) over the step's device time
    # (CUDA events, no profiler, whose host cost may idle the device)
    busy = sum(e - s for s, e, _ in kernels) / 1e3 / GRAPH_WINDOW
    span_ms = (max(e for _, e, _ in kernels) - kernels[0][0]) / 1e3
    launched = len(kernels) / GRAPH_WINDOW
    between = loop.between_ms / (GRAPH_WINDOW - 1)
    log(f"[{tag}] {label}: {graph_ms:.3f} ms a step on the device "
        f"(CUDA events over replays 100-{100 + GRAPH_WINDOW - 1}), of it {busy:.3f} ms of "
        f"kernels (the accepted window; {100 * busy / graph_ms:.1f}% busy, idle "
        f"{100 * (1 - busy / graph_ms):.1f}%, of which {between:.3f} ms a step between "
        f"replays; under the profiler {span_ms / GRAPH_WINDOW:.3f} "
        f"ms a step), {launched:.5f} kernels a step (the graph has "
        f"{sum(loop.nodes.values())} kernel nodes; a replay also fills each generator's seed "
        "and offset), every kernel of the path at its launches a step")
    by_name = {}
    for s_us, e_us, name in kernels:
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + e_us - s_us, c + 1)
    log(f"[{tag}] largest kernels a step: " + "; ".join(
        f"{name[:60]} {t / GRAPH_WINDOW:.1f} us x{c / GRAPH_WINDOW:g}"
        for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]))
    return dict(graph_ms_per_step=graph_ms, device_busy_share=busy / graph_ms,
                between_replays_ms=between, kernels_per_step=launched,
                profiled_windows=len(loop.profiles))


def phase_graph_vs_eager(torch, pipe, cfg, tag: str, n: int, turns) -> dict:
    """The image loop's CUDA graph against its eager loop (`eager=True`) in
    `layout_to_image` on the first `n` requests, in `turns` ("eager" or
    "graph"), then one more graph call with a window of replays timed by
    events and profiled windows (`DecodeLoop`). Every call's tokens equal the
    first's, bit for bit, and its launches the code's; per call s/call, host
    ms a step, capture ms and peak memory; over the accepted profiled window
    the device-busy share and the kernels a step by name, each kernel of the
    path at its launches a step from `expected_launches`. Returns the
    numbers."""
    mode = pipe.gen.quantize or "bf16"
    captions, groundings, seeds = CAPTIONS[:n], GROUNDINGS[:n], SEEDS[:n]
    ids, mask = pipe.proc.uni_batch(captions, groundings)
    prompt_len = pipe.proc.cfg_batch(ids, mask)[0].shape[1]
    want = expected_launches(cfg, pipe.gen.quantize, 2 * n, prompt_len)
    per_step, path = path_per_step(cfg, pipe.gen.quantize, 2 * n, prompt_len)

    def exact(kernels) -> bool:
        return all(v == per_step[k] for k, v in on_device(kernels, path).items())

    first, rows = None, []
    for i, kind in enumerate(list(turns) + ["graph (profiled)"]):
        loop = DecodeLoop(torch, eager=kind == "eager", profile="profiled" in kind,
                          accept=exact)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with loop:
            out, seconds, launches, plain_calls, tc = counted(
                torch, pipe.device,
                lambda: pipe.layout_to_image(captions, groundings, seeds=seeds))
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_launches(tag, f"{mode} x{n} turn {i + 1} ({kind})", launches, want,
                       plain_calls, tc)
        check_image_output(cfg, out, n)
        if first is None:
            first = out.image_tokens
        same = bool((out.image_tokens == first).all())
        check(same, f"{mode} x{n} turn {i + 1} ({kind}): tokens differ from turn 1's in "
              f"{int((out.image_tokens != first).sum())} places")
        steps = len(loop.stamps)
        check(steps == (cfg.image_seq_len if kind == "eager" else cfg.image_seq_len - 1),
              f"{mode} x{n} turn {i + 1} ({kind}): {steps} timed steps")
        row = dict(kind=kind, s_per_call=seconds, host_ms_per_step=loop.host_ms_per_step(),
                   capture_ms=loop.capture_ms[0] if loop.capture_ms else None,
                   peak_gib=peak)
        rows.append(row)
        log(f"[{tag}] {mode}, {n} request(s), turn {i + 1} ({kind}): {seconds:.3f} s/call, "
            f"{n * cfg.image_seq_len / seconds:.1f} image tokens/s, host "
            f"{row['host_ms_per_step']:.3f} ms a step over {steps} "
            + ("steps" if kind == "eager" else
               f"replays, capture + instantiate {row['capture_ms']:.2f} ms")
            + f", peak device memory {peak:.2f} GiB, tokens bitwise equal to turn 1's")
    prof_row = rows.pop()
    label = f"{mode}, {n} request(s)"
    nodes = check_graph_nodes(tag, label, loop, per_step, path)
    summary = dict(mode=mode, requests=n, turns=rows,
                   **report_profile(tag, f"{label}, graph", loop, per_step, path),
                   graph_kernel_nodes=nodes, profiled_call_s=prof_row["s_per_call"])
    log(f"[{tag}] " + json.dumps(summary))
    return summary


def phase_text_graph_vs_eager(torch, pipe, cfg, tag: str, what: str, fn, n_rows: int,
                              prompt_len: int, turns, image_launches=None) -> dict:
    """The text loop's CUDA graph against its eager loop (`eager=True`) in
    one text entry point `fn` on `n_rows` rows, in `turns` ("eager", "graph"
    or "graph (profiled)"), each call counted and checked by `text_call`: its
    tokens bitwise equal to the first turn's, its launches those of the
    steps they imply. Per call s/call, host ms a step, capture ms and peak
    memory; in each graph call the captured step's kernel nodes (24 K1 or
    K1-q8, and 97 K2 or K4 in the int4 forms) and the device ms a step by
    CUDA events over replays 100-131, each with the host's flag read after
    it; in a profiled call the device-busy share and the kernels a step by
    name. Returns the numbers."""
    from plangen_tpu_torch.runtime.generate import text_decode_steps

    mode = pipe.gen.quantize or "bf16"
    eos = pipe.proc.tok.special.eos_id
    per_step, path = path_per_step(cfg, pipe.gen.quantize, n_rows, prompt_len)

    def exact(kernels) -> bool:
        return all(v == per_step[k] for k, v in on_device(kernels, path).items())

    first, rows = None, []
    for i, kind in enumerate(turns):
        label = f"{mode} {what} turn {i + 1} ({kind})"
        graph = kind != "eager"
        loop = DecodeLoop(torch, text=True, eager=not graph, measure=graph,
                          profile="profiled" in kind, accept=exact)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with loop:
            _, tokens, _, seconds = text_call(torch, pipe, cfg, tag, label, fn, n_rows,
                                              prompt_len, image_launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if first is None:
            first = tokens
        check(bool((tokens == first).all()), f"{label}: tokens differ from turn 1's in "
              f"{int((tokens != first).sum())} places")
        steps = text_decode_steps(tokens, eos)
        check(len(loop.stamps) == (steps - 1 if graph else steps),
              f"{label}: {len(loop.stamps)} timed steps of {steps}")
        row = dict(kind=kind, s_per_call=seconds, steps=steps,
                   host_ms_per_step=loop.host_ms_per_step(),
                   capture_ms=loop.capture_ms[0] if loop.capture_ms else None, peak_gib=peak)
        if graph:
            row.update(graph_kernel_nodes=check_graph_nodes(tag, label, loop, per_step, path),
                       events_ms_per_step=loop.window_ms / GRAPH_WINDOW,
                       between_replays_ms=loop.between_ms / (GRAPH_WINDOW - 1))
        if "profiled" in kind:
            row.update(report_profile(tag, label, loop, per_step, path))
        rows.append(row)
        log(f"[{tag}] {label}: {seconds:.3f} s/call, host {row['host_ms_per_step']:.3f} ms a "
            f"step over {len(loop.stamps)} " + ("steps" if not graph else
            f"replays, capture + instantiate {row['capture_ms']:.2f} ms, "
            f"{row['events_ms_per_step']:.3f} ms a step on the device (CUDA events), "
            f"{row['between_replays_ms']:.3f} ms of it between replays")
            + f", peak device memory {peak:.2f} GiB, tokens bitwise equal to turn 1's")
    summary = dict(mode=mode, call=what, rows=n_rows, prompt=prompt_len, turns=rows)
    log(f"[{tag}] " + json.dumps(summary))
    return summary


def phase_text_graphs(torch, pipe, cfg, tag: str, captions, more: bool = False) -> list:
    """[4d], [7d] The text loop's CUDA graph against its eager loop
    (`phase_text_graph_vs_eager`): `plan` on `captions`; with `more` in
    turns GRAPH_TURNS then one profiled graph call, without it eager then
    graph. (`understand` and `joint_generate`, eager against graph, are
    left out to keep the smoke within its time limit: phase 4b runs both
    on the graph, and the card tests hold the text graph against eager.)
    Returns the summaries."""
    proc, budget = pipe.proc, pipe.gen.max_new_text_tokens
    captions = list(captions)
    plan_len = proc.stage1_batch(captions, budget)[0].shape[1]
    turns = GRAPH_TURNS + ("graph (profiled)",) if more else ("eager", "graph")
    return [phase_text_graph_vs_eager(torch, pipe, cfg, tag, f"plan x{len(captions)}",
                                      lambda: pipe.plan(captions), len(captions), plan_len,
                                      turns)]


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


def unpacked_int8(torch, im, q):
    """The packed weight unpacked once to int8 [I, O] (lo then hi nibbles),
    column-major as `torch._int_mm` takes its second operand."""
    lo, hi = im._unpack(q["w_p4"])
    return torch.cat([lo, hi], dim=-1).to(torch.int8).t().contiguous().t()


def int4_case(torch, dev, gen, name: str, R: int, I: int, O: int, tag: str = "5") -> list:
    """K2 and K4 at one shape against their plain versions (every call on
    the tensor cores, two calls bitwise equal, K4 bit-equal to plain),
    timed in turns, with cuBLAS on bf16 weights beside K2 and
    `torch._int_mm` on int8 weights beside K4 (yardsticks of other
    functions): one row of numbers for each kernel."""
    from plangen_tpu_torch.ops import int4_matmul as im

    rows = []
    k2, k4 = im.int4_matmul_w16, im.int4_matmul_w4a8
    OH = O // 2
    plan = im.w16_plan(R, I, OH, torch.bfloat16, N_SMS)
    plan8 = im.a8_plan(R, I, OH, N_SMS)

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
        tc_before = k2.tc_launches
        got = k2(x, *args(i))
        check(k2.tc_launches == tc_before + 1, f"K2 at {name} R={R} left the tensor cores")
        want = im.int4_matmul_w16_reference(x, *args(i))
        check(got.shape == (R, O) and got.dtype == torch.bfloat16, f"K2 output {got.shape}")
        check(bool(torch.isfinite(got).all()), f"non-finite K2 output at {name}")
        torch.testing.assert_close(got.float(), want.float(), rtol=INT4_TOLERANCE,
                                   atol=INT4_TOLERANCE)
        err16 = max(err16, (got.float() - want.float()).abs().max().item())
        check(torch.equal(got, k2(x, *args(i))), f"K2 at {name} R={R}: two calls differ")
        tc_before = k4.tc_launches
        got8 = k4(x8, xs, *args(i), torch.bfloat16)
        check(k4.tc_launches == tc_before + 1, f"K4 at {name} R={R} left the tensor cores")
        want8 = im.int4_matmul_w4a8_reference(x8, xs, *args(i), torch.bfloat16)
        check(got8.shape == (R, O) and got8.dtype == torch.bfloat16, f"K4 output {got8.shape}")
        err8 = max(err8, (got8.float() - want8.float()).abs().max().item())
        check(torch.equal(got8, k4(x8, xs, *args(i), torch.bfloat16)),
              f"K4 at {name} R={R}: two calls differ")
    check(err8 == 0.0, f"K4 at {name} R={R} differs from its plain version: {err8:.3e}")

    iters = min(64, 4 * len(ws))
    before = {k: (k.launches, k.tc_launches) for k in (k2, k4)}
    k16, p16, r16 = timed_pair(torch, lambda i: k2(x, *args(i)),
                               lambda i: im.int4_matmul_w16_reference(x, *args(i)), iters)
    # the yardstick: cuBLAS on the weight dequantized to bf16 once
    dense = rotating(lambda: im.dequantize_weight_int4(ws[0], dtype=torch.bfloat16),
                     2 * I * O)
    cublas = [time_ms(torch, lambda i: x @ dense[i % len(dense)], iters, host_ahead=True)
              for _ in range(2)]
    del dense
    k8, p8, r8 = timed_pair(
        torch, lambda i: k4(x8, xs, *args(i), torch.bfloat16),
        lambda i: im.int4_matmul_w4a8_reference(x8, xs, *args(i), torch.bfloat16), iters)
    for k, kname in ((k2, "K2"), (k4, "K4")):
        check(k.tc_launches - before[k][1] == k.launches - before[k][0],
              f"{kname} at {name} R={R}: timed calls left the tensor cores")
    # K4's yardstick: torch._int_mm (cuBLASLt int8, needs R > 16) on the
    # weight unpacked to int8 once
    int_mm = None
    if R > 16:
        dense8 = rotating(lambda: unpacked_int8(torch, im, ws[0]), I * O)
        int_mm = [time_ms(torch, lambda i: torch._int_mm(x8, dense8[i % len(dense8)]), iters,
                          host_ahead=True) for _ in range(2)]
        del dense8
    timed = [("K2", k16, p16, r16, err16, plan, cublas), ("K4", k8, p8, r8, err8, plan8, int_mm)]
    # bytes: packed weights, both scale rows, the activations (bf16, or
    # int8 plus a scale per row for K4), the bf16 output
    weights = I * OH + 2 * OH * 4 + 2 * R * O
    work = {"K2": (2 * R * I * O, weights + 2 * R * I, PEAK_BF16_FLOPS),
            "K4": (2 * R * I * O, weights + R * I + 4 * R, PEAK_INT8_OPS)}
    for kname, k_ms, p_ms, r, err, pl, yard in timed:
        gbps = I * OH / (k_ms * 1e-3) / 1e9
        bound = roofline_ms(*work[kname])
        yard_ms = None if yard is None else sum(yard) / 2
        rows.append(dict(kernel=kname, name=name, R=R, I=I, O=O, err=err, ms=k_ms,
                         plain_ms=p_ms, bound_ms=bound, bound_by=bound_by(*work[kname]),
                         yard_ms=yard_ms))
        what = ("bf16 weights, 4x the bytes (cuBLAS x @ w_bf16" if kname == "K2" else
                "int8 weights, 2x the bytes (torch._int_mm")
        extra = (f"; {pl.route}, grid {pl.grid}, {pl.row_tiles} n-tiles a warp, "
                 f"{pl.smem_bytes} B shared, bitwise equal twice")
        if yard_ms is not None:
            extra += (f"; {what}, another function) {yard_ms * 1e3:.2f} us "
                      f"({yard[0] * 1e3:.2f}/{yard[1] * 1e3:.2f}), {kname} takes "
                      f"{k_ms / yard_ms:.2f}x its time")
        log(f"[{tag}] {kname} {name:13s} R={R:3d} I={I} O={O}: max_abs_err={err:.3e} "
            f"kernel {k_ms * 1e3:8.2f} us ({r[1] * 1e3:.2f}/{r[2] * 1e3:.2f}) "
            f"plain {p_ms * 1e3:9.2f} us ({r[0] * 1e3:.2f}/{r[3] * 1e3:.2f}) "
            f"weights {gbps:7.1f} GB/s = {100 * gbps * 1e9 / PEAK_HBM_BYTES_PER_S:.1f}% "
            f"of 3.35 TB/s; bound {bound * 1e3:.2f} us ({bound_by(*work[kname])}) = "
            f"{100 * bound / k_ms:.1f}% of the kernel's time" + extra)
    del ws
    return rows


def phase_int4_vs_plain(torch, dev) -> dict:
    """K2 and K4 against their plain versions at the 1B decode shapes
    (`int4_case`)."""
    gen = torch.Generator(device=dev).manual_seed(4321)
    cases = ([(name, 8, I, O) for name, I, O in INT4_SHAPES]
             + [("gate_up_proj", R, 2048, 11264) for R in INT4_ROWS[2:]]
             + [("lm_head", 4, 2048, 102400)])
    rows = []
    for name, R, I, O in cases:
        rows += int4_case(torch, dev, gen, name, R, I, O)
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
        by_rows = {R: [r for r in rows if r["kernel"] == tag and r["R"] == R] for R in INT4_ROWS}
        mean = {R: {key: sum(r[key] for r in rs) / len(rs) for key in ("ms", "bound_ms")}
                for R, rs in by_rows.items()}
        out[tag]["ms_by_rows"] = {str(R): m["ms"] for R, m in mean.items()}
        out[tag]["bound_ms_by_rows"] = {str(R): m["bound_ms"] for R, m in mean.items()}
        yard = "bf16 weights by cuBLAS" if tag == "K2" else "int8 weights by torch._int_mm"
        log(f"[5] {tag} (mean over the shapes at each R): " + "; ".join(
            f"R = {R} {m['ms'] * 1e3:.2f} us, bound {m['bound_ms'] * 1e3:.2f} us = "
            f"{100 * m['bound_ms'] / m['ms']:.1f}%"
            + ("" if by_rows[R][0]["yard_ms"] is None else
               f", {yard} {sum(r['yard_ms'] for r in by_rows[R]) / len(by_rows[R]) * 1e3:.2f} us")
            for R, m in mean.items()))
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


# K1-a8 against its plain version: the two take the same integer products
# and the same fp32 logits; a probability code may land one step apart where
# expf and the order of the fp32 softmax sum move p across a rounding
# boundary. At most this share of the nonzero codes may differ, each by one
# step; a (row, head) whose codes agree is within A8_RTOL of the plain
# output (the rounding of p_s and of the output dtype), one whose codes
# differ within A8_RTOL plus, for each differing code, the largest v_scale
# (|v8| * p_s <= 127 * p_s <= max v_scale).
A8_MAX_CODE_SHARE = 1e-3
A8_RTOL = {"bfloat16": 2.0 ** -7, "float32": 1e-6}
A8_EAGER_STEPS = 64  # [16] graph against eager: the first 64 image steps


def a8_compare(torch, got, want, codes, want_codes, v_scale, dtype: str) -> dict:
    """K1-a8's output and probability codes against the plain version's."""
    diff = (codes.long() - want_codes.long()).abs()
    flips = diff.sum(-1)[:, None, :, None].float()  # [B, 1, H, 1]
    err = (got.float() - want.float()).abs()
    bound = A8_RTOL[dtype] * want.float().abs() + flips * v_scale.max()
    return dict(err=err.max().item(), codes=int(diff.sum()), step=int(diff.max()),
                nonzero=int((want_codes != 0).sum()), within=bool((err <= bound).all()))


A8_LONG_SHAPE = dict(L=4, B=8, S=2048, H=16, D=128)  # [16] 512-slot splits: four tiles each
A8_LONG_Q_POS = 1500
A8_ONE_BLOCK = "prefix_decode_attention_a8_one_block"  # the earlier design, timed beside


def a8_one_block(torch):
    """K1-a8's earlier design (`csrc/prefix_decode_attention_a8_one_block.cu`:
    one block per (row, head)), which no path of the port launches: a
    function (q, k8, ks, v8, vs, mask, layer, q_pos) -> out on the card."""
    import ctypes

    from plangen_tpu_torch.kernels import load_library
    from plangen_tpu_torch.ops.decode_attention import _DTYPE_CODES

    fn = getattr(load_library(A8_ONE_BLOCK).lib, f"plangen_{A8_ONE_BLOCK}")
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(q, k8, ks, v8, vs, mask, layer, q_pos):
        L, B, S, H, D = k8.shape
        out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
        err = fn(q.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(), vs.data_ptr(),
                 mask.data_ptr(), q_pos.data_ptr(), out.data_ptr(), None, B, S, H, D, layer,
                 D ** -0.5, _DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"[16] the one-block K1-a8 launch failed: cudaError {err}")
        return out

    return run


def a8_case(torch, c, mask, qp: int, dtype, gen, one_block, what: str) -> dict:
    """[16] K1-a8 against its plain version at one q_pos on the cache `c`
    (three layers, codes through `codes_out`, two calls bitwise equal);
    in bf16 its device time in turns with the one-block design (one block,
    split, split, one block), the plain version's, K1-q8's and the bound."""
    from plangen_tpu_torch.ops.decode_attention import (
        A8_MAX_SPLITS, prefix_decode_attention_a8, prefix_decode_attention_a8_reference,
        prefix_decode_attention_q8, split_plan,
    )

    L, B, S, H, D = c[0].shape
    name = str(dtype).split(".")[-1]
    q = torch.randn((B, 1, H, D), generator=gen, device=c[0].device).to(dtype)
    q_pos = torch.tensor([qp], dtype=torch.int32, device=q.device)
    res = []
    for layer in (0, L // 2, L - 1):
        codes = torch.empty((B, H, S), dtype=torch.int8, device=q.device)
        got = prefix_decode_attention_a8(q, *c, mask, layer, q_pos, codes_out=codes)
        want, want_codes = prefix_decode_attention_a8_reference(
            q, *c, mask, layer, q_pos, return_codes=True)
        check(bool(torch.isfinite(got).all()), f"[16] non-finite K1-a8 output {what}")
        check(bool((codes[:, :, qp + 1:] == 0).all()), f"[16] K1-a8 {what}: codes past q_pos")
        res.append(a8_compare(torch, got, want, codes, want_codes, c[3][layer], name))
        again = prefix_decode_attention_a8(q, *c, mask, layer, q_pos)
        check(torch.equal(again, got), f"[16] K1-a8 {name} {what}: two calls differ")
    err = max(r["err"] for r in res)
    n_codes, nonzero = sum(r["codes"] for r in res), sum(r["nonzero"] for r in res)
    check(all(r["within"] for r in res) and max(r["step"] for r in res) <= 1
          and n_codes <= A8_MAX_CODE_SHARE * nonzero,
          f"[16] K1-a8 vs plain {name} {what}: max abs err {err:.3e}, {n_codes} of "
          f"{nonzero} codes differ ({res})")
    n_split, slots = split_plan(S, A8_MAX_SPLITS)
    live = min(qp, S - 1) // slots + 1
    row = dict(dtype=name, q_pos=qp, S=S, what=what, err=err, codes=n_codes, nonzero=nonzero,
               n_split=n_split, split_slots=slots, live_blocks=B * H * live)
    line = (f"[16] K1-a8 {name:8s} {what} (S {S}, q_pos {qp}): max_abs_err={err:.3e}, "
            f"{n_codes} of {nonzero} nonzero p codes differ from the plain version's "
            f"(3 layers), bitwise equal twice; split plan {n_split} x {slots} slots, "
            f"{B * H * live} of {B * H * n_split} blocks live ({B * H * live / N_SMS:.2f} per SM)")
    if dtype == torch.bfloat16:
        k_ms, o_ms, r = timed_pair(
            torch, lambda i: prefix_decode_attention_a8(q, *c, mask, i % L, q_pos),
            lambda i: one_block(q, *c, mask, i % L, q_pos), 2 * L)
        p_ms = time_ms(torch, lambda i: prefix_decode_attention_a8_reference(
            q, *c, mask, i % L, q_pos), 2 * L, host_ahead=True)
        q8_ms = time_ms(torch, lambda i: prefix_decode_attention_q8(
            q, *c, mask, i % L, q_pos), 2 * L, host_ahead=True)
        ops, traffic = decode_bound(B, qp + 1, H, D, 2 * D + 8)  # as K1-q8
        bound = roofline_ms(ops, traffic, PEAK_INT8_OPS)
        row.update(ms=k_ms, one_block_ms=o_ms, plain_ms=p_ms, q8_ms=q8_ms, bound_ms=bound,
                   bound_by=bound_by(ops, traffic, PEAK_INT8_OPS))
        line += (f"; split {k_ms * 1e3:.2f} us ({r[1] * 1e3:.2f}/{r[2] * 1e3:.2f}) = "
                 f"{100 * bound / k_ms:.1f}% of bound, one block {o_ms * 1e3:.2f} us "
                 f"({r[0] * 1e3:.2f}/{r[3] * 1e3:.2f}) = {100 * bound / o_ms:.1f}%, in turns; "
                 f"plain {p_ms * 1e3:.2f} us, K1-q8 {q8_ms * 1e3:.2f} us; bound "
                 f"{bound * 1e3:.2f} us ({row['bound_by']})")
    log(line)
    return row


def phase_k1_a8_vs_plain(torch, prompt_len: int, dev, shape=KERNEL_SHAPE) -> dict:
    """[16] K1-a8 against its plain version at the decode shapes of
    Janus-Pro-1B on phase 6's cache and mask, bf16 and fp32 queries, at
    q_pos 0, 127, 128 (a tile edge), 256 (a split edge), 677 and S - 1, then a live prefix of
    pads only in one row, and a cache of A8_LONG_SHAPE (S 2048: splits of
    four 128-slot tiles); in bf16 device times in turns with the one-block
    design, beside K1-q8's and the plain version's."""
    L, B, S, H, D = (shape[k] for k in "LBSHD")
    gen = torch.Generator(device=dev).manual_seed(5678)
    mask = left_padded_mask(torch, B, S, min(prompt_len + 576, S), dev)
    cache = q8_cache(torch, shape, dev, gen)
    c = (cache["k"], cache["k_scale"], cache["v"], cache["v_scale"])
    from plangen_tpu_torch.ops.decode_attention import A8_MAX_SPLITS

    one_block = a8_one_block(torch)
    log(f"[16] K1-a8: one cluster of up to {A8_MAX_SPLITS} blocks of 128 threads per (row, "
        "head), split over slots, mbarrier exchanges; the one-block design timed beside it")
    rows = []
    headline_q = prompt_len + 287
    for dtype in (torch.bfloat16, torch.float32):
        for qp in [0, 127, 128, 256, headline_q, S - 1]:
            rows.append(a8_case(torch, c, mask, qp, dtype, gen, one_block, "1B cache"))
    pads = mask.clone()
    pads[1, :headline_q + 1] = 0  # row 1: every live slot a pad
    rows.append(a8_case(torch, c, pads, headline_q, torch.bfloat16, gen, one_block,
                        "row 1 all pads"))
    del cache, c
    torch.cuda.empty_cache()
    L2, B2, S2, H2, D2 = (A8_LONG_SHAPE[k] for k in "LBSHD")
    cache = q8_cache(torch, A8_LONG_SHAPE, dev, gen)
    c = (cache["k"], cache["k_scale"], cache["v"], cache["v_scale"])
    long_mask = left_padded_mask(torch, B2, S2, S2, dev)
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(a8_case(torch, c, long_mask, A8_LONG_Q_POS, dtype, gen, one_block,
                            "long cache"))
    del cache, c
    torch.cuda.empty_cache()
    headline = next(r for r in rows if r["dtype"] == "bfloat16" and r["q_pos"] == headline_q
                    and r["what"] == "1B cache")
    log("[16] " + json.dumps(dict(k1_a8=rows)))
    # no one PyTorch call takes int8 K/V with per-slot scales and int8
    # probabilities
    return dict(max_abs_err=max(r["err"] for r in rows), library_ms=None,
                **{key: headline[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")})


def phase_kv_a8(torch, dev) -> tuple:
    """[16] `kv_a8` at Janus-Pro-1B width: a fresh seeded model quantized to
    `int8`, `layout_to_image` x4 with and without `kv_a8` on it in turns
    int8, kv_a8, kv_a8, int8 (each call's launches the code's, no plain
    call, tokens equal to its mode's first call; s/call, peak), then the
    kv_a8 image loop's first A8_EAGER_STEPS steps eagerly against the graph,
    bitwise. Returns (the launches of the kv_a8 calls, the numbers)."""
    from plangen_tpu_torch.runtime.generate import generate_image_tokens

    a8pipe, cfg = build_pipeline(torch, dev, False, quantize="int8", kv_a8=True)
    # the same int8 model: a quantized model engages its own form
    q8pipe, _ = build_pipeline(torch, dev, False, model=a8pipe.model)
    check(q8pipe.gen.quantize == "int8" and not q8pipe.gen.kv_a8 and a8pipe.gen.kv_a8,
          f"[16] {q8pipe.gen} {a8pipe.gen}")
    ids, mask = a8pipe.proc.uni_batch(CAPTIONS, GROUNDINGS)
    prompt_len = a8pipe.proc.cfg_batch(ids, mask)[0].shape[1]
    n = len(CAPTIONS)
    launches = dict.fromkeys(kernel_counters(), 0)
    first, rows = {}, []
    for i, (mode, p) in enumerate((("int8", q8pipe), ("kv_a8", a8pipe), ("kv_a8", a8pipe),
                                   ("int8", q8pipe))):
        want = quantized_launches(cfg, "int8", 2 * n, prompt_len, kv_a8=mode == "kv_a8")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out, seconds, got, plain_calls, tc = counted(
            torch, dev, lambda: p.layout_to_image(CAPTIONS, GROUNDINGS, seeds=SEEDS))
        check_launches("16", f"{mode} x4 turn {i + 1}", got, want, plain_calls, tc)
        check_image_output(cfg, out, n)
        if mode == "kv_a8":
            add_launches(launches, got)
        ref = first.setdefault(mode, out.image_tokens)
        check(bool((out.image_tokens == ref).all()),
              f"[16] {mode} x4 turn {i + 1}: tokens differ from its first call's")
        rows.append(dict(mode=mode, s_per_call=seconds,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30))
        log(f"[16] {mode} x4 turn {i + 1} (graph): {seconds:.3f} s/call, "
            f"{n * cfg.image_seq_len / seconds:.1f} image tokens/s, peak "
            f"{rows[-1]['peak_gib']:.2f} GiB; tokens equal to the mode's first call")
    apart = int((first["kv_a8"] != first["int8"]).sum())
    log(f"[16] kv_a8 against int8 on the same weights and seeds: {apart} of "
        f"{first['int8'].size} tokens differ (another function: s8 queries and "
        "probabilities)")
    steps = min(A8_EAGER_STEPS, cfg.image_seq_len)
    loops = {}
    for eager in (True, False):
        prep = a8pipe.prepare_layout_to_image(CAPTIONS, GROUNDINGS, seeds=SEEDS)
        tokens, seconds, got, plain_calls, tc = counted(torch, dev, lambda: generate_image_tokens(
            a8pipe.model, cfg, prep.embeds, prep.cfg_mask[:, :prompt_len + steps].contiguous(),
            prep.generator, a8pipe.gen.cfg_weight, a8pipe.gen.temperature, num_tokens=steps,
            quantized_cache=True, eager=eager, kv_a8=True))
        what = "eager" if eager else "graph"
        # int8's matmuls are plain torch: K1-a8 alone, at every decode step
        want = dict(dict.fromkeys(got, 0),
                    prefix_decode_attention_a8=steps * cfg.llama.num_layers)
        check_launches("16", f"kv_a8 loop {what}, {steps} steps", got, want, plain_calls, tc)
        loops[what] = (tokens.cpu(), seconds)
        log(f"[16] kv_a8 loop {what}, {steps} steps: {seconds:.3f} s "
            f"({1e3 * seconds / steps:.2f} ms a step with prefill)")
    check(torch.equal(loops["graph"][0], loops["eager"][0]),
          f"[16] kv_a8 graph against eager: "
          f"{int((loops['graph'][0] != loops['eager'][0]).sum())} tokens differ")
    log(f"[16] kv_a8 loop: the graph's {steps} x {n} tokens bitwise equal to the eager loop's")
    summary = dict(calls=rows, tokens_apart=apart,
                   eager_s=loops["eager"][1], graph_s=loops["graph"][1], steps=steps)
    log("[16] " + json.dumps(summary))
    del a8pipe, q8pipe
    torch.cuda.empty_cache()
    return launches, summary


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
                                                  "kernels a call: dQ with Delta, dK/dV)")):
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


def profile_step(torch, trainer, loader, tag: str = "9") -> None:
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
    kernels = profiled_kernels(prof)
    if not kernels:
        log(f"[{tag}] profile: not measured (the profiler showed no device time)")
        return
    busy = sum(t for t, _, _ in kernels)
    groups = dict.fromkeys((g for g, _ in KERNEL_GROUPS), 0.0)
    for t, _, name in kernels:
        low = name.lower()
        groups[next(g for g, keys in KERNEL_GROUPS if any(k in low for k in keys))] += t
    log(f"[{tag}] profile of one step: wall {wall_us / 1e3:.1f} ms under the profiler, device "
        f"busy {busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%, idle "
        f"{100 * (1 - busy / wall_us):.1f}%), {sum(c for _, c, _ in kernels)} kernel launches; "
        + ", ".join(f"{g} {t / 1e3:.1f} ms" for g, t in groups.items()))
    log(f"[{tag}] largest kernels: " + "; ".join(
        f"{name[:70]} {t / 1e3:.2f} ms x{c}" for t, c, name in sorted(kernels, reverse=True)[:8]))


# ------------------------------------------------ [12] the training options


TRAIN_OPTION_FLOWS = (("uni", 3), ("mmu", 3), ("plan", 2))  # the recipe's flows
LORA_STEPS = 3
MERGE_TOL = 1e-3  # fp32 logits, merged weights against the adapters (phase 4's fp32 limit)
ACCUM_MICRO_STEPS = 4  # = 2 updates at gradient_accumulation_steps 2
STEPS_7B = 3


def options_trainer(torch, dev, overrides: dict, model_cfg=None):
    """A `Trainer` on the recipe's flows over the toy data, K3 on every
    attention, stage3 unless `overrides` (train.* keys) says otherwise:
    (trainer, its batch iterator, build seconds)."""
    import tempfile

    from plangen_tpu_torch.config import FlowConfig, PlanGenConfig, apply_overrides
    from plangen_tpu_torch.data.loader import infinite
    from plangen_tpu_torch.train.trainer import Trainer

    base = PlanGenConfig() if model_cfg is None else PlanGenConfig(model=model_cfg)
    cfg = apply_overrides(base, {
        "train.tuning_mode": "stage3",
        "train.train_data": tuple(FlowConfig(t, "toy", b) for t, b in TRAIN_OPTION_FLOWS),
        "train.use_flash_attention": True,
        "train.output_dir": tempfile.mkdtemp(prefix="plangen_options_"),
        "train.num_workers": 0,
        "train.prefetch_depth": 0,
        **{f"train.{k}": v for k, v in overrides.items()},
    })
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=dev)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    trainer.logger.close()
    return trainer, infinite(trainer.build_dataloader()), built


def drop_trainer(torch, trainer) -> None:
    import shutil

    shutil.rmtree(trainer.cfg.train.output_dir, ignore_errors=True)
    trainer.state = trainer.model = trainer.step_fn = None
    torch.cuda.empty_cache()


def k3_counts() -> tuple:
    from plangen_tpu_torch.ops import flash_attention as fa

    return (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches,
            fa.flash_attention_fwd.routes["tensor_cores"],
            fa.flash_attention_bwd.routes["tensor_cores"], fa.flash_attention_reference.calls)


def check_k3(tag: str, what: str, before: tuple, calls: tuple, remat: bool) -> None:
    """K3's calls since `before`, `calls` = (attentions, attentions that
    need a gradient): the forward once per attention (twice under remat:
    the recompute runs it again), the backward once per attention that
    needs one, all on the tensor cores, no plain call."""
    fwd, bwd, fwd_tc, bwd_tc, plain = (a - b for a, b in zip(k3_counts(), before))
    want = (calls[0] * (2 if remat else 1), calls[1])
    log(f"[{tag}] {what}: K3 forward/backward calls ({fwd}, {bwd}), on the tensor cores "
        f"({fwd_tc}, {bwd_tc}), plain {plain}; expected {want}")
    check((fwd, bwd) == want and (fwd_tc, bwd_tc) == want and plain == 0,
          f"{what}: K3 calls ({fwd}, {bwd}) ({fwd_tc}, {bwd_tc} on the tensor cores, "
          f"{plain} plain), expected {want} all on the tensor cores")


def n_attention_calls(trainer) -> tuple:
    """(K3 calls a step, those with a backward): SigLIP's 24 and each flow's
    LLaMA layers; with the vision tower and the aligner frozen (the LoRA
    modes) no gradient reaches SigLIP, and its attention has no backward."""
    cfg = trainer.cfg.model
    llama = len(trainer.flows) * cfg.llama.num_layers
    into_siglip = any(trainer.mask[n] for n in trainer.mask
                      if n.startswith(("vision_model", "aligner")))
    return cfg.vision.layers + llama, llama + (cfg.vision.layers if into_siglip else 0)


def timed_step(torch, tag: str, what: str, trainer, loader, remat: bool):
    """One call of the trainer's step, its K3 calls checked: (metrics,
    seconds, its batches)."""
    import math

    batches = trainer.device_batches(next(loader))
    before = k3_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.state, metrics = trainer.step_fn(trainer.state, batches)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    metrics = {k: float(v) for k, v in metrics.items()}
    log(f"[{tag}] {what}: {seconds:.3f} s, {json.dumps(metrics)}")
    check(all(math.isfinite(v) for v in metrics.values()), f"{what}: non-finite loss")
    check_k3(tag, what, before, n_attention_calls(trainer), remat)
    return metrics, seconds, batches


def report_rate(tag: str, trainer, batches, seconds: list, peak: int, label: str) -> None:
    """s/step (the median after step 0), positions/s, the peak and the
    model-FLOPs share, as phase 9 prints them."""
    import statistics

    s_step = statistics.median(seconds[1:]) if len(seconds) > 1 else seconds[0]
    positions = sum(b["attn_mask"].numel() for b in batches.values())
    flops, parts = train_flops(trainer.model, trainer.cfg.model, batches)
    log(f"[{tag}] {label}: {s_step:.4f} s/step (median of steps 1-{len(seconds) - 1}; step 0 "
        f"{seconds[0]:.3f} s), {positions / s_step:.1f} positions/s, peak device memory "
        f"{peak / 2**30:.2f} GiB; model FLOPs a step {flops / 1e12:.2f} T ({parts}), "
        f"{flops / s_step / 1e12:.1f} TFLOP/s = {flops / s_step / PEAK_BF16_FLOPS:.3%} of "
        f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16")


def phase_remat(torch, dev) -> dict:
    """[12a] Step 0's loss and gradient at Janus-Pro-1B width without remat,
    with remat `full` and with `dots`, on the same weights and batch."""
    import dataclasses
    import math

    from plangen_tpu_torch.train.step import make_loss_fn

    trainer, loader, built = options_trainer(torch, dev, {})
    model, mask, cfg = trainer.model, trainer.mask, trainer.cfg
    batches = trainer.device_batches(next(loader))
    n_calls = n_attention_calls(trainer)
    reset_counters(kernel_counters())
    pad_id = trainer.tokenizer.special.pad_id
    ref = None
    for policy in (None, "full", "dots"):
        tcfg = dataclasses.replace(cfg.train, gradient_checkpointing=policy is not None,
                                   remat_policy=policy or "full")
        loss_fn = make_loss_fn(cfg.model, tcfg, pad_id, trainer.flows, trainable_mask=mask)
        what = f"remat {policy or 'off'}"
        seconds = []
        for turn in range(2):  # the first turn warms up and gives the peak
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            if turn == 0:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                static = torch.cuda.memory_allocated()
            before = k3_counts()
            t0 = time.perf_counter()
            loss, ld = loss_fn(model, batches)
            loss.backward()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            if turn == 0:
                peak = torch.cuda.max_memory_allocated()
            check_k3("12a", what, before, n_calls, policy is not None)
        gnorm = math.sqrt(sum(float(torch.sum(p.grad.float() ** 2))
                              for p in model.parameters() if p.grad is not None))
        losses = {"loss": loss.item(), **{k: v.item() for k, v in ld.items()}}
        log(f"[12a] {what}: forward + backward {seconds[1]:.3f} s (first turn "
            f"{seconds[0]:.3f} s), peak device memory {peak / 2**30:.2f} GiB "
            f"({(peak - static) / 2**30:.2f} GiB above the {static / 2**30:.2f} GiB of "
            f"weights and optimizer state), gradient global norm {gnorm:.6e}, "
            f"{json.dumps(losses)}")
        if ref is None:
            ref = (losses, gnorm)
        else:
            for k, v in losses.items():
                check(abs(v - ref[0][k]) <= TRAIN_REL_TOL * abs(ref[0][k]),
                      f"{what} {k}: {v} vs {ref[0][k]} without remat")
            check(abs(gnorm - ref[1]) <= TRAIN_REL_TOL * ref[1],
                  f"{what}: gradient norm {gnorm} vs {ref[1]} without remat")
        del loss, ld
        model.zero_grad(set_to_none=True)
    log(f"[12a] Trainer built in {built:.2f} s; remat full and dots within "
        f"{TRAIN_REL_TOL} of no remat; K3's forward twice a call under remat")
    drop_trainer(torch, trainer)
    return launch_counts()


def prompt_logits(torch, model, ids, mask):
    """The LM logits (fp32) at the last position of an uncached forward."""
    dev = next(model.parameters()).device
    with torch.no_grad():
        embeds = model.embed_text(torch.from_numpy(ids.astype("int64")).to(dev))
        hidden = model.language_model(embeds, torch.from_numpy(mask).to(dev))
        return model.language_model.logits(hidden[:, -1]).float()


def logit_divergence(torch, pipes, captions, a, b) -> None:
    """The first step where the two pipelines' greedy tokens differ: each
    model's fp32 logits at that step (the prompt and the common prefix,
    uncached, in bf16 as the pipelines run) for the rows that differ,
    reported, and the two tokens near-tied: a swap of the argmax needs the
    gap between them within twice the models' largest logit difference
    (plus bf16 noise: the uncached forward rounds apart from the decode)."""
    import numpy as np

    diff = np.argwhere(a != b)
    col = int(diff[:, 1].min())
    rows = sorted({int(r) for r, c in diff if c == col})
    proc, dev = pipes[0].proc, pipes[0].device
    ids, mask = proc.stage1_batch(captions, pipes[0].gen.max_new_text_tokens)
    seq = np.concatenate([ids, a[:, :col]], axis=1).astype(np.int64)
    seq_mask = np.concatenate([mask[:, :ids.shape[1]], np.ones((len(ids), col), np.int32)],
                              axis=1)
    la, lb = (prompt_logits(torch, pipe.model, seq, seq_mask).cpu().numpy() for pipe in pipes)
    for r in rows:
        ta, tb = int(a[r, col]), int(b[r, col])
        d = float(np.abs(la[r] - lb[r]).max())
        scale = float(np.abs(la[r]).max())
        rel = float(np.linalg.norm(la[r] - lb[r]) / np.linalg.norm(la[r]))
        gaps = (float(la[r, ta] - la[r, tb]), float(lb[r, tb] - lb[r, ta]))
        log(f"[12b] row {r} first differs at step {col} of {a.shape[1]}: adapters {ta}, merged "
            f"{tb}; their logit gaps {gaps[0]:.4f} (adapters) and {gaps[1]:.4f} (merged); the "
            f"bf16 models' logits there: rel err {rel:.3e}, largest difference {d:.4f} of "
            f"{scale:.2f}")
        check(max(abs(g) for g in gaps) <= 2 * d + TRAIN_REL_TOL * scale,
              f"row {r}: the tokens {ta} and {tb} are not near-tied ({gaps}, {d})")


def phase_lora(torch, dev) -> dict:
    """[12b] LoRA (`lora_tokens`, r 256, alpha 128, fp32 masters), 3 steps;
    then `merge_lora` and a bf16 greedy `plan` of the 4 captions on the
    merged model against the adapters, through the captured text step.
    Returns the plan calls' launches."""
    import numpy as np

    from plangen_tpu_torch.train.lora import merge_lora

    trainer, loader, built = options_trainer(
        torch, dev, {"tuning_mode": "lora", "lora_rank": 256, "lora_alpha": 128})
    model, mask = trainer.model, trainer.mask
    check(trainer.tuning_mode == "lora_tokens", f"effective mode {trainer.tuning_mode}")
    trainable = [n for n in mask if mask[n]]
    check(all(".lora." in n or n.endswith("embed_tokens.weight") for n in trainable),
          "trainable outside the adapters and the token embeddings")
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not mask[n]}
    start = {n: p.detach().clone() for n, p in model.named_parameters() if mask[n]}
    n_adapter = sum(p.numel() for n, p in model.named_parameters() if ".lora." in n)
    log(f"[12b] Trainer built in {built:.2f} s: {len(trainable)} trainable tensors, "
        f"{n_adapter / 1e6:.1f} M adapter parameters + the token embeddings")
    torch.cuda.reset_peak_memory_stats()
    reset_counters(kernel_counters())
    seconds = []
    for step in range(LORA_STEPS):
        _, s, batches = timed_step(torch, "12b", f"LoRA step {step}", trainer, loader, False)
        seconds.append(s)
    peak = torch.cuda.max_memory_allocated()
    total = launch_counts()
    moved = [n for n, p in model.named_parameters()
             if not mask[n] and not torch.equal(p, frozen[n])]
    check(not moved, f"base weights changed: {moved[:5]}")
    still = [n for n in trainable if torch.equal(model.get_parameter(n), start[n])]
    check(not still, f"trainable tensors unchanged: {still[:5]}")
    log(f"[12b] after {LORA_STEPS} steps all {len(frozen)} base weights bit-for-bit unchanged, "
        f"all {len(trainable)} adapter and embedding tensors changed")
    report_rate("12b", trainer, batches, seconds, peak, "LoRA")
    del frozen, start

    cfg = trainer.cfg.model
    trainer.state = None
    lora_pipe, _ = build_pipeline(torch, dev, False, model=copy.deepcopy(model).to(
        torch.bfloat16).eval(), cfg=cfg)
    # merge_lora in fp32 at the logit level: the step-0 logits of the plan
    # prompts, adapters against merged weights (fp32 rounding apart)
    ids, mask = lora_pipe.proc.stage1_batch(CAPTIONS, lora_pipe.gen.max_new_text_tokens)
    prompt = (ids, np.ascontiguousarray(mask[:, :ids.shape[1]]))
    model.eval()
    adapters = prompt_logits(torch, model, *prompt)
    merge_lora(model)
    check(not any(".lora." in n for n, _ in model.named_parameters()), "adapters left")
    merged = prompt_logits(torch, model, *prompt)
    rel = ((merged - adapters).norm() / adapters.norm()).item()
    log(f"[12b] merge_lora in fp32: step-0 logits of the 4 plan prompts, merged against the "
        f"adapters: rel err {rel:.3e} (limit {MERGE_TOL}), argmax agreement "
        f"{(merged.argmax(-1) == adapters.argmax(-1)).float().mean().item():.3f}")
    check(rel <= MERGE_TOL, f"merged against adapters: rel err {rel}")
    merged_pipe, _ = build_pipeline(torch, dev, False, model=model.to(torch.bfloat16).eval(),
                                    cfg=cfg)
    drop_trainer(torch, trainer)
    plan_len = lora_pipe.proc.stage1_batch(CAPTIONS, lora_pipe.gen.max_new_text_tokens)[0].shape[1]
    tokens = []
    for label, pipe in (("adapters", lora_pipe), ("merged", merged_pipe)):
        _, toks, launches, _ = text_call(torch, pipe, cfg, "12b", f"bf16 plan, {label}",
                                         lambda p=pipe: p.plan(CAPTIONS), len(CAPTIONS),
                                         plan_len)
        add_launches(total, launches)
        tokens.append(toks)
    if (tokens[0] == tokens[1]).all():
        log("[12b] the merged model's plan tokens equal the adapters' on all 4 captions")
    else:
        logit_divergence(torch, (lora_pipe, merged_pipe), CAPTIONS, *tokens)
    del lora_pipe, merged_pipe, model
    torch.cuda.empty_cache()
    return total


def phase_adafactor(torch, dev) -> dict:
    """[12c] Adafactor + bf16 masters + accumulation 2 + fused CE + remat
    `dots` at Janus-Pro-1B width, stage3: 4 micro-steps = 2 updates."""
    overrides = {"master_dtype": "bfloat16", "optim.optimizer": "adafactor",
                 "optim.gradient_accumulation_steps": 2, "fused_lm_ce": True,
                 "gradient_checkpointing": True, "remat_policy": "dots"}
    trainer, loader, built = options_trainer(torch, dev, overrides)
    model, mask = trainer.model, trainer.mask
    check(all(p.dtype == torch.bfloat16 for p in model.parameters()), "masters not bf16")
    log(f"[12c] Trainer built in {built:.2f} s: bf16 masters, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B parameters")
    torch.cuda.reset_peak_memory_stats()
    reset_counters(kernel_counters())
    seconds = []
    for step in range(ACCUM_MICRO_STEPS):
        snap = {n: p.detach().clone() for n, p in model.named_parameters()}
        _, s, batches = timed_step(torch, "12c", f"micro-step {step}", trainer, loader, True)
        seconds.append(s)
        changed = [n for n, p in model.named_parameters() if not torch.equal(p, snap[n])]
        elements = sum(int((p != snap[n]).sum()) for n, p in model.named_parameters())
        update = (step + 1) % 2 == 0
        log(f"[12c] micro-step {step} ({'an update' if update else 'accumulation only'}): "
            f"{len(changed)} tensors changed, {elements} elements "
            f"({elements / sum(p.numel() for p in model.parameters()):.2%})")
        check(bool(changed) == update, f"micro-step {step}: {len(changed)} tensors changed")
        check(not [n for n in changed if not mask[n]], "a frozen tensor changed")
        del snap
    check(trainer.state.opt.count == ACCUM_MICRO_STEPS // 2, "updates")
    peak = torch.cuda.max_memory_allocated()
    log("[12c] gen_vision_model bit-for-bit unchanged (frozen, checked every micro-step)")
    report_rate("12c", trainer, batches, seconds, peak, "Adafactor + bf16 + accumulation")
    launches = launch_counts()
    drop_trainer(torch, trainer)
    return launches


def phase_7b(torch, dev) -> dict:
    """[12d] Janus-Pro-7B width, stage3: Adafactor + bf16 masters + remat
    `full` + fused CE, `STEPS_7B` steps."""
    from plangen_tpu_torch.config import PlanGenModelConfig

    overrides = {"master_dtype": "bfloat16", "optim.optimizer": "adafactor",
                 "fused_lm_ce": True, "gradient_checkpointing": True, "remat_policy": "full"}
    torch.cuda.reset_peak_memory_stats()
    trainer, loader, built = options_trainer(torch, dev, overrides,
                                             PlanGenModelConfig.janus_pro_7b())
    model, mask = trainer.model, trainer.mask
    total = sum(p.numel() for p in model.parameters())
    trained = sum(p.numel() for n, p in model.named_parameters() if mask[n])
    lm = trainer.cfg.model.llama
    log(f"[12d] Janus-Pro-7B width ({lm.num_layers} x {lm.hidden_size}, MLP "
        f"{lm.intermediate_size}): Trainer built in {built:.2f} s, {total / 1e9:.3f} B bf16 "
        f"parameters, {trained / 1e9:.3f} B trainable (stage3), "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    adamw = 4 * total + 4 * trained + 8 * trained + 2 * total
    log(f"[12d] AdamW with fp32 masters at this width (not run): masters 4 B x {total / 1e9:.3f} B"
        f" + gradients 4 B x {trained / 1e9:.3f} B + moments 8 B x {trained / 1e9:.3f} B + the "
        f"bf16 compute copy 2 B x {total / 1e9:.3f} B = {adamw / 1e9:.1f} GB before activations, "
        f"over the card's {torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB")
    torch.cuda.reset_peak_memory_stats()
    reset_counters(kernel_counters())
    seconds = []
    for step in range(STEPS_7B):
        _, s, batches = timed_step(torch, "12d", f"7B step {step}", trainer, loader, True)
        seconds.append(s)
    peak = torch.cuda.max_memory_allocated()
    check(peak < torch.cuda.get_device_properties(0).total_memory, "peak above the card")
    report_rate("12d", trainer, batches, seconds, peak, "7B stage3")
    launches = launch_counts()
    drop_trainer(torch, trainer)
    return launches


def launch_counts() -> dict:
    return {k: w.launches for k, (w, _) in kernel_counters().items()}


def phase_train_options(torch, dev) -> dict:
    """[12] The training options on the card (module docstring); returns
    the launches of their runs, each counted from 0."""
    launches = dict.fromkeys(kernel_counters(), 0)
    log(f"[12] {nvidia_smi_line()}")
    for run in (phase_remat, phase_lora, phase_adafactor, phase_7b):
        add_launches(launches, run(torch, dev))
        torch.cuda.empty_cache()
    log(f"[12] {nvidia_smi_line()}")
    return launches


# ----------------------------------------------------------- [15] parallel


PARALLEL_STEPS = 3  # checked trainer steps of (b), each run, before a profiled one
# (b, c): the phase-9 Trainer at Janus-Pro-1B width cut in depth to 4 LLaMA
# layers and 4 SigLIP blocks: at 24 + 24 the two runs and the checkpoint's
# write and restore took ~150 s, which brought the smoke near its time
# limit; cut, ~33 s
PARALLEL_TRAIN_LAYERS = (4, 4)
FSDP_MIN_SIZE = 2 ** 20  # JAX's default `train.fsdp_min_size`, which (b) and (h) keep
# (b) the FSDP Trainer's parameters by kind and dim at FSDP_MIN_SIZE on the
# 1 x 1 mesh: the JAX leaves of 2^20 elements or more FSDP-sharded along
# the port dim of their largest dim (every dim divides 1), the rest whole
PARALLEL_PLACED = {"fsdp 0": 22, "fsdp 1": 51, "replicated": 375}
# (b) the FSDP run's s/step and peak when FSDP2 sharded every parameter along
# dim 0 (the code before `fsdp_min_size`), measured by this phase in turns
# with the rule's code in one run
EVERY_PARAM_SHARDED_15B = ("0.2701-0.3369 s/step, peak 16.86 GiB on NVIDIA H100 80GB HBM3, "
                           "700.00 W")
TP2_STEPS = 32  # the 2-rank decode of (e)
TP2_TIMEOUT_S = 240.0
TP_EAGER_STEPS = 16  # (d): eager against graph under TP; an eager step is host-bound
TP_QUANT_MODES = ("int8", "int4", "int4_a8", "auto")  # (f)
TP2_QUANT_MODES = ("int4", "int4_a8")  # (g)
# (g) the TP-2 local shapes of K2 and K4 at Janus-Pro-1B: (name, R, I, O of
# the rank): the image loop's 8 rows, lm_head at the plan's 4
TP2_LOCAL_SHAPES = (("qkv_proj", 8, 2048, 3072), ("o_proj", 8, 1024, 2048),
                    ("gate_up_proj", 8, 2048, 5632), ("down_proj", 8, 2816, 2048),
                    ("lm_head", 4, 2048, 51200), ("gen_head.fc2", 8, 2048, 8192))
# (g) the TP-2 bf16 logits against the unsharded model's, relative to their
# largest magnitude over 32 steps: each rank rounds its partial sums to
# bf16 (8 bits, 0.4 %) before the all-reduce, over 24 layers. int4_a8's
# limit is wider: its per-row int8 activations turn those rounding
# differences into flipped codes (a code a 1-ulp change flips moves its
# product by 1/127 of the row's scale), which the next layers and the int8
# cache carry on; K4 itself is exact. On the H100 its TP gap read 7.82 %,
# and the unsharded model with 1 % of its prompt embeddings one bf16 ulp
# away 7.35 % (`phase_tp2_quantized(witness=True)`): rounding alone gives a
# gap that size. A row absmax left unreduced read 8.47 % end to end, which
# no logit limit tells from rounding; `row_witness` catches it
TP2_LOGIT_TOL = {"int4": 5e-2, "int4_a8": 1e-1}
# (g) the row-split witness (`row_witness`): layer 0's down_proj on fp32 rows,
# split over the two ranks against the layer quantized whole, relative to the
# product's largest magnitude: the split path within ROW_TOL (fp32 sums in
# another order), int4_a8 with its row absmax taken on the rank's columns
# alone (the group MAX left out) beyond ROW_PLANTED_MIN (~8e-3 on the CPU)
ROW_TOL = 1e-5
ROW_PLANTED_MIN = 1e-3
# (h) FSDP x TP: four ranks on the one card over gloo, mesh data 2 x model 2,
# the phase-9 Trainer at Janus-Pro-1B width cut in depth to FSDP_TP_LAYERS
# (LLaMA layers, SigLIP blocks) under gradient_checkpointing, as the 7B
# recipe trains (each FSDP2 unit's recompute must run on the bf16 casts of
# the TP-split parameters FSDP2 ignores); each rank's flows take the
# recipe's batch, the plain Trainer twice that (the global batch)
FSDP_TP_MESH = {"data": 2, "model": 2}
FSDP_TP_LAYERS = (2, 2)
FSDP_TP_STEPS = 2
FSDP_TP_TIMEOUT_S = 300.0
# (h) the parameters by kind and dim at FSDP_MIN_SIZE: 30 TP-split (21
# column, 8 row, the vocab-split embedding), 26 FSDP-sharded, the rest whole
FSDP_TP_PLACED = {"fsdp 0": 3, "fsdp 1": 23, "replicated": 350, "tp": 30}
# (h) the ranks' losses against the plain Trainer's, relative: bf16 compute,
# each data shard's rows and each TP partial sum rounded to bf16 (8 bits,
# 0.4 %) apart from the plain run's, a few roundings deep at this depth
FSDP_TP_LOSS_RTOL = 1e-2
# (h) the parameters after the steps against the plain Trainer's, in units of
# lr x steps: Adam moves a parameter by at most ~lr a step (at step 2
# |m / sqrt(v)| <= 1.0013 with the bias corrections, by Cauchy-Schwarz), so
# a gradient whose sign a rounding flips parts the runs by up to 2 lr a step;
# 1 % over that for that slack and the weight decay. This bounds the steps
# only: Adam's update does not change with the gradient's scale, so no limit
# on the parameters sees a gradient left unsummed over "data" (about half
# the sum); FSDP_TP_MU_RTOL does
FSDP_TP_PARAM_TOL = 2.02
# (h) AdamW's first moment after step 1 (a tenth of the clipped gradient)
# against the plain Trainer's, each trainable tensor's gap in L2 norm
# relative to the plain one's, their median: bf16 compute on each data
# shard's rows and each TP partial sum rounds apart from the plain run, a
# few tensors far apart (the image-generation aligner's biases 0.27, the
# whole model as one vector 0.148, on the H100), the median tensor 1.2e-2;
# with the TP-split gradients left unsummed over "data" (planted) it read
# 0.40, the clip's norm carrying the fault into every tensor
FSDP_TP_MU_RTOL = 5e-2


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def trainer_steps(torch, tag: str, what: str, trainer, loader, steps: int, first: int = 0):
    """`steps` of the trainer's own step on its batches (logged from step
    `first`), K3 counted each step (forward and backward =
    `n_attention_calls`, the forward twice under gradient_checkpointing,
    all on the tensor cores in bf16 compute, no plain call): (losses,
    seconds, peak GiB, launches)."""
    import math

    from plangen_tpu_torch.train import trainer as trainer_module

    n_calls = n_attention_calls(trainer)
    if trainer.cfg.train.gradient_checkpointing:  # the recompute runs the forward again
        n_calls = (2 * n_calls[0], n_calls[1])
    # bf16 compute on the tensor cores; fp32 (15h's fp32 run) on the CUDA cores
    tc = n_calls if trainer_module.COMPUTE_DTYPE == torch.bfloat16 else (0, 0)
    counters = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(counters)
    losses, seconds = [], []
    for step in range(first, first + steps):
        before = k3_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.state, metrics = trainer.step_fn(trainer.state,
                                                 trainer.device_batches(next(loader)))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        metrics = {k: float(v) for k, v in metrics.items()}
        losses.append(metrics)
        calls = tuple(a - b for a, b in zip(k3_counts(), before))
        log(f"[{tag}] {what} step {step}: {seconds[-1]:.3f} s, K3 forward/backward calls "
            f"{calls[:2]}, on the tensor cores {calls[2:4]}, plain {calls[4]}, "
            f"loss {metrics['loss']:.6f}")
        check(all(math.isfinite(v) for v in metrics.values()), f"{what} step {step}: non-finite")
        check(calls == n_calls + tc + (0,),
              f"{what} step {step}: K3 calls {calls}, expected {n_calls} each, {tc} on the "
              "tensor cores and no plain call")
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: w.launches for k, (w, _) in counters.items()}
    return losses, seconds, peak, launches


def placement_counts(trainer) -> tuple:
    """[15b, 15h] How `shard_params` placed a Trainer's parameters on its
    mesh, read from the live parameters, and what the rule says at the
    Trainer's `train.fsdp_min_size` (`param_shardings`, `fsdp_dims`):
    ({kind: parameters}, the same by the rule). Kinds: "fsdp 0" / "fsdp 1"
    a DTensor over "data" sharded along that dim, "tp" one over "model",
    "replicated" a plain tensor."""
    from torch.distributed.tensor import DTensor

    from plangen_tpu_torch.parallel import mesh as pm

    mesh, min_size = trainer.mesh, trainer.cfg.train.fsdp_min_size
    tp = mesh["model"].size() if mesh["model"].size() > 1 else None
    fsdp = mesh["data"].size()
    kinds = pm.param_shardings(trainer.model, tp, fsdp, min_size)
    dims = pm.fsdp_dims(trainer.model, tp, fsdp, min_size)
    live, rule = {}, {}
    for n, p in trainer.model.named_parameters():
        if isinstance(p, DTensor):
            placement, sub = pm._mesh_dim(p)
            got = (f"fsdp {pm.split_dim(placement)}" if sub.mesh_dim_names == ("data",)
                   else "tp")
        else:
            got = "replicated"
        want = {"fsdp": f"fsdp {dims.get(n)}", "replicated": "replicated"}.get(kinds[n], "tp")
        live[got] = live.get(got, 0) + 1
        rule[want] = rule.get(want, 0) + 1
    return dict(sorted(live.items())), dict(sorted(rule.items()))


def parallel_trainer_run(torch, dev, what: str, overrides: dict, launches: dict):
    """[15b] One phase-9 Trainer (`options_trainer`) for PARALLEL_STEPS
    checked steps, then one more under the profiler: (trainer, its
    numbers). Under FSDP the parameters' placements by kind and dim, the
    live ones against the rule's."""
    import statistics

    trainer, loader, built = options_trainer(torch, dev, overrides,
                                             fsdp_tp_model_cfg(PARALLEL_TRAIN_LAYERS))
    check((trainer.mesh is None) == (what == "plain"), f"[15b] {what}: mesh {trainer.mesh}")
    placed = None
    if trainer.mesh is not None:
        check(trainer.cfg.train.fsdp_min_size == FSDP_MIN_SIZE,
              f"[15b] {what}: fsdp_min_size {trainer.cfg.train.fsdp_min_size}")
        placed, rule = placement_counts(trainer)
        log(f"[15b] {what}: fsdp_min_size {trainer.cfg.train.fsdp_min_size}, parameters "
            f"placed {placed} (the rule: {rule})")
        check(placed == rule == PARALLEL_PLACED, f"[15b] {what}: placed {placed}, the rule "
              f"says {rule}, expected {PARALLEL_PLACED}")
    losses, seconds, peak, got = trainer_steps(torch, "15b", what, trainer, loader,
                                               PARALLEL_STEPS)
    add_launches(launches, got)
    run = dict(losses=losses, s_step=statistics.median(seconds[1:]), step0_s=seconds[0],
               peak_gib=peak, built_s=built, placed=placed)
    log(f"[15b] {what}: built in {built:.2f} s, {run['s_step']:.4f} s/step (median of steps "
        f"1-{PARALLEL_STEPS - 1}; step 0 {seconds[0]:.3f} s), peak device memory "
        f"{peak:.2f} GiB, {nvidia_smi_line()}" + (
            f"; with every parameter FSDP-sharded along dim 0 (before `fsdp_min_size`): "
            f"{EVERY_PARAM_SHARDED_15B}" if what == "fsdp" else ""))
    profile_step(torch, trainer, loader, f"15b {what}")
    return trainer, run


def full_params_cpu(torch, model) -> dict:
    """Every parameter whole (a DTensor gathered) on the CPU."""
    from plangen_tpu_torch.parallel.mesh import full_tensor

    with torch.no_grad():
        return {n: full_tensor(p).to("cpu", copy=True) for n, p in model.named_parameters()}


def phase_parallel_train(torch, dev, launches: dict) -> dict:
    """[15b, c] the phase-9 Trainer (cut in depth to PARALLEL_TRAIN_LAYERS)
    plain, then with `fsdp=True` on the 1 x 1 mesh (FSDP2 over the world-1
    group), from the same seed on the same toy batches; then the FSDP run's
    checkpoint restored into a plain Trainer."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[15b] device memory allocated before the runs "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    trainer, plain = parallel_trainer_run(torch, dev, "plain", {}, launches)
    ref = full_params_cpu(torch, trainer.model)
    drop_trainer(torch, trainer)
    trainer, fsdp = parallel_trainer_run(
        torch, dev, "fsdp", {"fsdp": True, "mesh_shape": {"data": 1, "model": 1}}, launches)
    got = full_params_cpu(torch, trainer.model)
    steps = trainer.state.step
    diffs = {n: float((got[n].float() - ref[n].float()).abs().max()) for n in ref}
    diff, n_equal = max(diffs.values()), sum(d == 0.0 for d in diffs.values())
    loss_diff = max(abs(a[k] - b[k]) for a, b in zip(plain["losses"], fsdp["losses"]) for k in a)
    lr = trainer.cfg.train.optim.learning_rate
    log(f"[15b] fsdp against plain after {steps} steps: losses max abs diff "
        f"{loss_diff:.3e}, parameters max abs diff {diff:.3e} ({n_equal} of {len(ref)} tensors "
        f"bitwise equal)")
    check(loss_diff <= 1e-5 * max(abs(v) for v in plain["losses"][0].values()),
          f"[15b] fsdp losses {fsdp['losses']} against plain {plain['losses']}")
    check(diff <= 2 * lr * steps, f"[15b] fsdp parameters differ by up to {diff}")
    fsdp.update(param_max_abs_diff=diff, loss_max_abs_diff=loss_diff,
                tensors_bitwise_equal=n_equal, tensors=len(ref))
    del ref
    # [15c] the checkpoint: gathered (world 1) and written by the lead
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.ckpt.save(steps, trainer.state)
    saved_s = time.perf_counter() - t0
    out_dir = trainer.cfg.train.output_dir
    trainer.state = trainer.model = trainer.step_fn = None
    torch.cuda.empty_cache()
    back, _, _ = options_trainer(torch, dev, {"output_dir": out_dir},
                                 fsdp_tp_model_cfg(PARALLEL_TRAIN_LAYERS))
    t0 = time.perf_counter()
    step = back.maybe_resume()
    restored_s = time.perf_counter() - t0
    check(step == steps == PARALLEL_STEPS + 1 and back.mesh is None,
          f"[15c] restored step {step} of {steps}")
    unequal = [n for n, p in back.model.named_parameters() if not torch.equal(p.cpu(), got[n])]
    check(not unequal, f"[15c] restored parameters differ: {unequal[:5]}")
    log(f"[15c] the fsdp checkpoint (gathered, step {steps}) written in "
        f"{saved_s:.1f} s, restored into a plain Trainer in {restored_s:.1f} s: all "
        f"{len(got)} parameters bitwise equal")
    drop_trainer(torch, back)
    return dict(plain=plain, fsdp=fsdp, checkpoint_save_s=saved_s, restore_s=restored_s)


def tp2_rank(rank: int, port: int, inputs: dict, results) -> None:
    """[15e] one of two ranks on the one card over gloo: the seeded model in
    fp32, TP = 2, eager `generate_image_tokens` for TP2_STEPS steps."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        from plangen_tpu_torch.parallel import mesh as pm
        from plangen_tpu_torch.runtime.generate import generate_image_tokens
        from plangen_tpu_torch.tasks.pipeline import row_generators

        t0 = time.perf_counter()

        def stage(what):
            log(f"[15e] rank {rank}: {what} at {time.perf_counter() - t0:.1f} s")

        dev = torch.device("cuda:0")
        torch.cuda.set_device(dev)
        pm.init_distributed(f"localhost:{port}", 2, rank, device="cpu")  # gloo
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        parts = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(parts, torch.full((4,), float(rank), device=dev))
        stage(f"gloo all_reduce {t.tolist()} and all_gather_into_tensor {parts.tolist()} "
              "on CUDA tensors")
        mesh = pm.create_mesh({"data": 1, "model": 2}, device="cuda")
        stage(f"mesh {mesh}")
        pipe, cfg = build_pipeline(torch, dev, False)
        model = pm.shard_params(pipe.model.float(), mesh, tp_axis="model")
        stage("the seeded model built in fp32 and split")
        embeds = torch.from_numpy(inputs["embeds"]).to(dev)
        mask = torch.from_numpy(inputs["mask"]).to(dev)
        tokens = generate_image_tokens(
            model, cfg, embeds, mask, row_generators(inputs["seeds"], 1, dev),
            inputs["cfg_weight"], inputs["temperature"], num_tokens=TP2_STEPS, eager=True)
        stage(f"{TP2_STEPS} eager steps decoded")
        results.put((rank, tokens.cpu().numpy()))
    except BaseException:
        results.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def phase_tp2_one_card(torch, pipe, cfg) -> dict:
    """[15e] two ranks on the one card over gloo with CUDA tensors (NCCL
    refuses two ranks on one device): TP = 2, eager, on the phase-4 model in
    fp32; the ranks' tokens against each other and against the unsharded
    fp32 model's eager run on the same prompt and generators."""
    import multiprocessing
    import queue

    from plangen_tpu_torch.runtime.generate import generate_image_tokens
    from plangen_tpu_torch.tasks.pipeline import row_generators

    prep = pipe.prepare_layout_to_image(CAPTIONS[:1], GROUNDINGS[:1], seeds=SEEDS[:1])
    L = prep.embeds.shape[1]
    inputs = dict(embeds=prep.embeds.float().cpu().numpy(),
                  mask=prep.cfg_mask[:, :L + TP2_STEPS].cpu().numpy(),
                  seeds=SEEDS[:1], cfg_weight=pipe.gen.cfg_weight,
                  temperature=pipe.gen.temperature)
    model32 = copy.deepcopy(pipe.model).float()
    want = generate_image_tokens(
        model32, cfg, torch.from_numpy(inputs["embeds"]).to(pipe.device),
        torch.from_numpy(inputs["mask"]).to(pipe.device),
        row_generators(SEEDS[:1], 1, pipe.device), inputs["cfg_weight"],
        inputs["temperature"], num_tokens=TP2_STEPS, eager=True).cpu().numpy()
    del model32
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=tp2_rank, args=(r, port, inputs, results)) for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, res = results.get(timeout=TP2_TIMEOUT_S)
            got[rank] = res
    except queue.Empty:
        got["timeout"] = f"no result within {TP2_TIMEOUT_S} s"
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    seconds = time.perf_counter() - t0
    errors = {r: v for r, v in got.items() if isinstance(v, str)}
    check(not errors, "[15e] two ranks over gloo on the one card: " + "; ".join(
        f"rank {r}: {v.strip().splitlines()[-1]}" for r, v in errors.items()))
    check(all((got[r] == got[0]).all() for r in got), "[15e] the ranks' tokens differ")
    same = bool((got[0] == want).all())
    log(f"[15e] TP = 2 over gloo, two ranks on cuda:0, fp32, {TP2_STEPS} eager steps in "
        f"{seconds:.1f} s (both processes' start, build and decode): the ranks agree; "
        f"tokens {'equal' if same else 'differ from'} the unsharded fp32 model's "
        f"({int((got[0] != want).sum())} of {want.size} differ)")
    check(same, f"[15e] TP = 2 tokens {got[0].tolist()} against {want.tolist()}")
    return dict(seconds=seconds, steps=TP2_STEPS, tokens_equal=same)


def fsdp_tp_model_cfg(depth=FSDP_TP_LAYERS):
    """Janus-Pro-1B's widths (hidden 2048, 16 heads x 128, vocab 102400,
    SigLIP 1024 / 16 heads) at `depth` (LLaMA layers, SigLIP blocks),
    FSDP_TP_LAYERS by default."""
    import dataclasses

    from plangen_tpu_torch.config import PlanGenModelConfig

    base = PlanGenModelConfig()
    layers, blocks = depth
    return dataclasses.replace(base, llama=dataclasses.replace(base.llama, num_layers=layers),
                               vision=dataclasses.replace(base.vision, layers=blocks))


def fsdp_tp_steps(torch, what: str, trainer, loader, gather):
    """[15h] FSDP_TP_STEPS of `trainer_steps`, AdamW's first moment taken
    after the first (each tensor through `gather`): (losses, seconds, peak
    GiB, launches, {name: first moment})."""
    losses, seconds, peak, launches = trainer_steps(torch, "15h", what, trainer, loader, 1)
    mu = {n: gather(m) for n, m in trainer.state.opt.mu.items()}
    more = trainer_steps(torch, "15h", what, trainer, loader, FSDP_TP_STEPS - 1, first=1)
    return (losses + more[0], seconds + more[1], max(peak, more[2]),
            {k: v + more[3][k] for k, v in launches.items()}, mu)


def fsdp_tp_rank(rank: int, port: int, inputs: dict, results) -> None:
    """[15h] one of four ranks on the one card over gloo: the phase-9
    Trainer with `fsdp=True` on the data 2 x model 2 mesh. Right after
    `shard_params` every parameter gathered against the seeded weights,
    each rank's local heads; FSDP_TP_STEPS steps (K3 counted by
    `trainer_steps`), AdamW's first moment gathered after the first;
    then every parameter gathered; both compared on rank 0 with the plain
    Trainer's (saved by the parent)."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        from plangen_tpu_torch.convert.from_jax import init_params
        from plangen_tpu_torch.models.vlm import PlanGenModel
        from plangen_tpu_torch.parallel import mesh as pm

        t0 = time.perf_counter()

        def stage(what):
            log(f"[15h] rank {rank}: {what} at {time.perf_counter() - t0:.1f} s")

        dev = torch.device("cuda:0")
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        fsdp_tp_compute_dtype(torch, inputs["fp32"])
        pm.init_distributed(f"localhost:{port}", 4, rank, device="cpu")  # gloo
        model_cfg = fsdp_tp_model_cfg()
        trainer, loader, built = options_trainer(
            torch, dev, {"fsdp": True, "mesh_shape": FSDP_TP_MESH,
                         "gradient_checkpointing": True}, model_cfg=model_cfg)
        stage(f"Trainer built in {built:.1f} s")
        # the weights the Trainer seeds, drawn again on this rank
        seeded = PlanGenModel(model_cfg, dtype=torch.float32, device=dev)
        with torch.no_grad():
            init_params(seeded, torch.Generator(device=dev).manual_seed(trainer.cfg.train.seed))
            unequal = [n for n, p in trainer.model.named_parameters()
                       if not torch.equal(pm.full_tensor(p), seeded.get_parameter(n))]
        del seeded
        torch.cuda.empty_cache()
        placed, rule = placement_counts(trainer)
        layer = trainer.model.language_model.model.layers[0]
        block = trainer.model.vision_model.vision_tower.blocks[0]
        heads = {"llama": pm._local(layer.self_attn.q_proj.weight).shape[0]
                 // model_cfg.llama.head_dim,
                 "siglip": pm._local(block.attn.qkv.weight).shape[0] // 3 // block.attn.head_dim}
        stage(f"every parameter gathered against the seeded weights: {len(unequal)} differ; "
              f"local heads {heads}")
        keep = (lambda m: m.cpu()) if rank == 0 else (lambda m: None)  # a collective
        losses, seconds, peak, launches, mu = fsdp_tp_steps(
            torch, f"rank {rank}", trainer, loader, lambda m: keep(pm.full_tensor(m)))
        stage(f"{FSDP_TP_STEPS} steps")
        plain = torch.load(inputs["plain"], map_location="cpu", mmap=True,
                           weights_only=True) if rank == 0 else None
        diffs, mu_gaps = {}, {}
        with torch.no_grad():
            for n, p in trainer.model.named_parameters():
                whole = pm.full_tensor(p)
                if plain is not None:
                    diffs[n] = float((whole - plain["params"][n].to(dev)).abs().max())
            for n, m in mu.items() if plain is not None else ():
                want = plain["mu"][n]
                mu_gaps[n] = (float((m - want).norm()), float(want.norm()))
        stage("every parameter gathered after the steps")
        results.put((rank, dict(
            unequal_after_shard=unequal, heads=heads, losses=losses, seconds=seconds,
            peak_gib=peak, launches=launches, built_s=built, diffs=diffs, mu_gaps=mu_gaps,
            placed=placed, rule=rule)))
    except BaseException:
        results.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def fsdp_tp_compute_dtype(torch, fp32: bool) -> None:
    """[15h] The Trainer's compute dtype in this process: bf16, as it
    trains, or fp32 (`fp32`), to tell rounding from a fault."""
    from plangen_tpu_torch.train import trainer

    trainer.COMPUTE_DTYPE = torch.float32 if fp32 else torch.bfloat16


def phase_fsdp_tp(torch, dev, fp32: bool = False) -> dict:
    """[15h] FSDP x TP: the phase-9 Trainer (stage3, AdamW, fp32 masters,
    bf16 compute, or fp32 with `fp32`) at Janus-Pro-1B width, depth cut to
    FSDP_TP_LAYERS, under gradient_checkpointing, on a data 2 x model 2
    mesh with `fsdp=True`: four ranks on the one card over gloo with CUDA
    tensors (NCCL refuses two ranks on one device), against one plain
    Trainer on the card taking the same steps on the global batch. The
    smoke runs it in bf16; the fp32 run (not a phase) reads each tensor's
    first-moment gap without bf16's rounding, in the returned `mu_gaps`:
    `python3 -c "import torch, chip_smoke as cs; cs.phase_header(torch);
    cs.phase_build(); cs.phase_fsdp_tp(torch, torch.device('cuda:0'),
    fp32=True)"`."""
    import math
    import multiprocessing
    import queue
    import tempfile

    from plangen_tpu_torch.config import FlowConfig, PlanGenModelConfig

    model_cfg, full = fsdp_tp_model_cfg(), PlanGenModelConfig()
    log(f"[15h] depth cut to {model_cfg.llama.num_layers} LLaMA layers (of "
        f"{full.llama.num_layers}) and {model_cfg.vision.layers} SigLIP blocks (of "
        f"{full.vision.layers}) for the smoke's time limit; widths Janus-Pro-1B's")
    fsdp_tp_compute_dtype(torch, fp32)
    dp = FSDP_TP_MESH["data"]
    flows = tuple(FlowConfig(t, "toy", dp * b) for t, b in TRAIN_OPTION_FLOWS)
    plain_trainer, loader, built = options_trainer(
        torch, dev, {"train_data": flows, "gradient_checkpointing": True}, model_cfg=model_cfg)
    losses, seconds, peak, _, mu = fsdp_tp_steps(torch, "plain", plain_trainer, loader,
                                                 lambda m: m.cpu())
    lr = plain_trainer.cfg.train.optim.learning_rate
    tmp = tempfile.TemporaryDirectory(prefix="plangen_fsdp_tp_")
    path = str(pathlib.Path(tmp.name) / "plain.pt")
    torch.save({"params": {n: p.detach().cpu()
                           for n, p in plain_trainer.model.named_parameters()}, "mu": mu}, path)
    log(f"[15h] plain Trainer (global batch {[f.batch_size for f in flows]}): built in "
        f"{built:.1f} s, steps {[round(x, 3) for x in seconds]} s, peak {peak:.2f} GiB")
    drop_trainer(torch, plain_trainer)
    del plain_trainer

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=fsdp_tp_rank, args=(r, port, {"plain": path, "fp32": fp32},
                                                      results))
             for r in range(4)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, res = results.get(timeout=FSDP_TP_TIMEOUT_S)
            got[rank] = res
    except queue.Empty:
        got["timeout"] = f"no result within {FSDP_TP_TIMEOUT_S} s"
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        tmp.cleanup()
    wall = time.perf_counter() - t0
    errors = {r: v for r, v in got.items() if isinstance(v, str)}
    check(not errors, "[15h] four ranks over gloo on the one card: " + "; ".join(
        f"rank {r}: {v.strip().splitlines()[-1]}" for r, v in errors.items()))
    want_heads = {"llama": model_cfg.llama.num_heads // FSDP_TP_MESH["model"],
                  "siglip": model_cfg.vision.heads // FSDP_TP_MESH["model"]}
    for r, res in sorted(got.items()):
        log(f"[15h] rank {r}: built in {res['built_s']:.1f} s, steps "
            f"{[round(x, 3) for x in res['seconds']]} s, peak {res['peak_gib']:.2f} GiB, local "
            f"heads {res['heads']}, losses {[round(x['loss'], 6) for x in res['losses']]} "
            f"(plain {[round(x['loss'], 6) for x in losses]})")
    diffs, mu_gaps = got[0]["diffs"], got[0]["mu_gaps"]
    diff, limit = max(diffs.values()), FSDP_TP_PARAM_TOL * lr * FSDP_TP_STEPS
    n_equal = sum(d == 0.0 for d in diffs.values())
    per_tensor = sorted((g / w if w else (math.inf if g else 0.0), n)
                        for n, (g, w) in mu_gaps.items())
    mu_gap = per_tensor[len(per_tensor) // 2][0]  # the median tensor's
    whole = (sum(g * g for g, _ in mu_gaps.values())
             / sum(w * w for _, w in mu_gaps.values())) ** 0.5
    loss_gap = max(abs(res["losses"][i][k] - losses[i][k]) / abs(losses[i][k])
                   for res in got.values() for i in range(FSDP_TP_STEPS) for k in losses[i])
    log("[15h] the five tensors whose first moments part most: " + ", ".join(
        f"{n} {g:.3e}" for g, n in per_tensor[-5:][::-1]))
    log(f"[15h] FSDP x TP in {'fp32' if fp32 else 'bf16'} compute over four gloo ranks on "
        f"cuda:0 (parameters placed {got[0]['placed']}, by kind and dim, at fsdp_min_size "
        f"{FSDP_MIN_SIZE}), {FSDP_TP_STEPS} steps under remat in "
        f"{wall:.1f} s (the processes' start, build and steps); against the plain Trainer: "
        f"losses within {loss_gap:.3e} (relative, limit {FSDP_TP_LOSS_RTOL}); AdamW's first "
        f"moment after step 1 within {mu_gap:.3e} at the median tensor (relative L2, limit "
        f"{FSDP_TP_MU_RTOL}; worst {per_tensor[-1][0]:.3e} at {per_tensor[-1][1]}, the model "
        f"as one vector {whole:.3e}); the "
        f"parameters within {diff:.3e} (limit {FSDP_TP_PARAM_TOL} lr x steps = {limit:.3e}, "
        f"a bound on the steps; {n_equal} of {len(diffs)} tensors bitwise equal)")
    for r, res in sorted(got.items()):
        check(not res["unequal_after_shard"], f"[15h] rank {r}: right after shard_params "
              f"{res['unequal_after_shard'][:5]} differ from the seeded weights")
        check(res["heads"] == want_heads, f"[15h] rank {r}: local heads {res['heads']}")
        check(res["placed"] == res["rule"] == FSDP_TP_PLACED, f"[15h] rank {r}: parameters "
              f"placed {res['placed']}, the rule says {res['rule']}, expected {FSDP_TP_PLACED}")
        for step, (a, b) in enumerate(zip(res["losses"], losses)):
            for k, v in b.items():
                check(abs(a[k] - v) <= FSDP_TP_LOSS_RTOL * abs(v),
                      f"[15h] rank {r} step {step} {k}: {a[k]} against plain {v}")
    check(mu_gap <= FSDP_TP_MU_RTOL, f"[15h] AdamW's first moment differs from the plain "
          f"Trainer's by {mu_gap:.3e} at the median tensor (relative L2)")
    check(diff <= limit, f"[15h] the parameters differ from the plain Trainer's by {diff}")
    return dict(seconds=wall, losses={r: res["losses"] for r, res in got.items()},
                plain_losses=losses, param_max_abs_diff=diff, loss_max_rel_gap=loss_gap,
                mu_median_rel_gap=mu_gap, mu_max_rel_gap=per_tensor[-1][0],
                mu_whole_rel_gap=whole, mu_gaps={n: g for g, n in per_tensor},
                peak_gib={r: res["peak_gib"] for r, res in got.items()},
                s_step={r: res["seconds"] for r, res in got.items()},
                k3_launches={r: {k: v for k, v in res["launches"].items()
                                 if k.startswith("flash")} for r, res in got.items()})


def quantized_launches(cfg, quantize, n_rows: int, prompt_len: int,
                       kv_a8: bool = False) -> dict:
    """`expected_launches` of one image loop in a quantized form: the int4
    forms (and 'auto', whose x4 call runs the int4 view) K2 or K4 at every
    projection and K1-q8 (K1-a8 with `kv_a8`); int8, whose matmuls are plain
    torch, the decode attention alone."""
    if quantize == "int8":
        want = expected_launches(cfg, "int4", n_rows, prompt_len, kv_a8=kv_a8)
        return dict(want, int4_matmul_w16=0)
    return expected_launches(cfg, "int4" if quantize == "auto" else quantize, n_rows,
                             prompt_len, kv_a8=kv_a8)


def same_buffers(torch, a, b) -> list:
    """The names of the buffers that two models do not hold alike."""
    bufs_a, bufs_b = dict(a.named_buffers()), dict(b.named_buffers())
    if sorted(bufs_a) != sorted(bufs_b):
        return sorted(set(bufs_a) ^ set(bufs_b))
    return [n for n in bufs_a if not torch.equal(bufs_a[n], bufs_b[n])]


def phase_tp_quantized(torch, pipe, cfg, mesh, launches: dict) -> list:
    """[15f] The quantized forms under TP over the world-1 "model" axis on
    the phase-4 model. For each form the unsharded pipeline (a copy of the
    model, quantized in place), then the TP one (a copy split by
    `shard_params`, then quantized on its shards as the pipeline does:
    route a): `layout_to_image` x4 on the graph path each, tokens bitwise
    equal and launches the code's on both; for the forms that rewrite the
    weights, the unsharded quantized model split by `shard_params` (route
    b) holds the TP pipeline's bytes."""
    import numpy as np

    from plangen_tpu_torch.parallel import mesh as pm

    dev = pipe.device
    ids, mask = pipe.proc.uni_batch(CAPTIONS, GROUNDINGS)
    prompt_len = pipe.proc.cfg_batch(ids, mask)[0].shape[1]
    rows = []
    for mode in TP_QUANT_MODES:
        want = quantized_launches(cfg, mode, 2 * len(CAPTIONS), prompt_len)
        out = {}
        for what in ("unsharded", "tp"):
            model = copy.deepcopy(pipe.model)
            if what == "tp":
                pm.shard_params(model, mesh, tp_axis="model")
            qpipe, _ = build_pipeline(torch, dev, False, model=model, quantize=mode)
            torch.cuda.reset_peak_memory_stats()
            res, seconds, got, plain_calls, tc = counted(
                torch, dev, lambda: qpipe.layout_to_image(CAPTIONS, GROUNDINGS, seeds=SEEDS))
            check_launches("15f", f"{mode} {what} x4", got, want, plain_calls, tc)
            check_image_output(cfg, res, len(CAPTIONS))
            if what == "tp":
                add_launches(launches, got)
            out[what] = (np.asarray(res.image_tokens), seconds, qpipe,
                         torch.cuda.max_memory_allocated() / 2**30)
        diff = int((out["tp"][0] != out["unsharded"][0]).sum())
        check(diff == 0, f"[15f] {mode} tp x4: {diff} tokens differ from the unsharded model's")
        route_b = "n/a (the int4 view shares the dense model)"
        if mode != "auto":
            split = pm.shard_params(copy.deepcopy(out["unsharded"][2].model), mesh,
                                    tp_axis="model")
            unequal = same_buffers(torch, split, out["tp"][2].model)
            check(not unequal, f"[15f] {mode}: route b's buffers differ from route a's: "
                  f"{unequal[:5]}")
            route_b = "bitwise equal to route a"
            del split
        row = dict(mode=mode, unsharded_s=out["unsharded"][1], tp_s=out["tp"][1],
                   unsharded_peak_gib=out["unsharded"][3], tp_peak_gib=out["tp"][3])
        a8 = ""
        if mode == "int8":
            # kv_a8 on the same two int8 models: K1-a8 at the rank's H/tp heads
            want_a8 = quantized_launches(cfg, mode, 2 * len(CAPTIONS), prompt_len, kv_a8=True)
            for what in ("unsharded", "tp"):
                apipe, _ = build_pipeline(torch, dev, False, model=out[what][2].model,
                                          quantize=mode, kv_a8=True)
                res, seconds, got, plain_calls, tc = counted(
                    torch, dev, lambda: apipe.layout_to_image(CAPTIONS, GROUNDINGS, seeds=SEEDS))
                check_launches("15f", f"{mode} + kv_a8 {what} x4", got, want_a8, plain_calls, tc)
                check_image_output(cfg, res, len(CAPTIONS))
                if what == "tp":
                    add_launches(launches, got)
                row[f"kv_a8_{what}_s"] = seconds
                out[f"kv_a8_{what}"] = np.asarray(res.image_tokens)
            diff = int((out["kv_a8_tp"] != out["kv_a8_unsharded"]).sum())
            check(diff == 0, f"[15f] {mode} + kv_a8 tp x4: {diff} tokens differ from the "
                  "unsharded model's")
            a8 = (f"; with kv_a8 tp {row['kv_a8_tp_s']:.3f} s/call against "
                  f"{row['kv_a8_unsharded_s']:.3f} unsharded, tokens bitwise equal, K1-a8 "
                  "launches the code's on both")
        rows.append(row)
        log(f"[15f] {mode} x4 (graph): tp {row['tp_s']:.3f} s/call against "
            f"{row['unsharded_s']:.3f} unsharded ({100 * (row['tp_s'] / row['unsharded_s'] - 1):+.1f} %), "
            f"peak {row['tp_peak_gib']:.2f} / {row['unsharded_peak_gib']:.2f} GiB; tokens bitwise "
            f"equal, launches the code's on both; route b {route_b}{a8}; {nvidia_smi_line()}")
        del out
        torch.cuda.empty_cache()
    return rows


def rebuild_optimizer(trainer) -> None:
    """The trainer's optimizer and state made anew over its (now split)
    parameters, as the Trainer makes them after `shard_params`."""
    from plangen_tpu_torch.train.optim import make_optimizer
    from plangen_tpu_torch.train.step import init_train_state
    from plangen_tpu_torch.train.trainer import master_dtype

    opt, _ = make_optimizer(trainer.cfg.train.optim, trainer.model, trainer.tuning_mode)
    trainer.state = init_train_state(trainer.model, opt, master_dtype(trainer.cfg.train))


def validated(torch, trainer) -> tuple:
    """`trainer.validate` over one `plan` batch of the toy data: (the files
    it wrote, {path: bytes}; its `val/` metrics; seconds)."""
    logged = []
    trainer.logger.log = lambda step, metrics: logged.append(metrics)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.validate(trainer.state.step, max_len=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    root = pathlib.Path(trainer.cfg.train.output_dir) / "val"
    files = {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
             if p.is_file()}
    check(len(logged) == 1 and any(k.startswith("val/") for k in logged[0]),
          f"validate logged {logged}")
    return files, logged[0], seconds


def phase_parallel_options(torch, dev, mesh, launches: dict) -> dict:
    """[15f] The training options on a world-1 mesh at Janus-Pro-1B width
    (`options_trainer`): a LoRA step (`lora_tokens`, r 256) with the model
    split over the "model" axis against plain; Adafactor (fp32 masters)
    3 steps under FSDP against plain, then each trainer's `validate` over
    one toy `plan` batch. Every parameter, loss, layout file and `val/`
    metric bitwise equal."""
    from plangen_tpu_torch.config import FlowConfig
    from plangen_tpu_torch.parallel import mesh as pm

    out = {}
    lora = {"tuning_mode": "lora", "lora_rank": 256, "lora_alpha": 128}
    adafactor = {"optim.optimizer": "adafactor", "test_data": FlowConfig("plan", "toy", 2)}
    for label, overrides, steps in (("lora", lora, 1), ("adafactor", adafactor, PARALLEL_STEPS)):
        runs = {}
        for what in ("plain", "tp" if label == "lora" else "fsdp"):
            extra = {"fsdp": True, "mesh_shape": {"data": 1, "model": 1}} if what == "fsdp" else {}
            trainer, loader, built = options_trainer(torch, dev, {**overrides, **extra})
            if what == "tp":
                pm.shard_params(trainer.model, mesh, tp_axis="model")
                rebuild_optimizer(trainer)
            check(pm.is_sharded(trainer.model) == (what != "plain"),
                  f"[15f] {label} {what}: sharded {pm.is_sharded(trainer.model)}")
            losses, seconds, peak, got = trainer_steps(torch, "15f", f"{label} {what}", trainer,
                                                       loader, steps)
            add_launches(launches, got)
            run = dict(losses=losses, params=full_params_cpu(torch, trainer.model),
                       s_step=sum(seconds[1:] or seconds) / len(seconds[1:] or seconds),
                       peak_gib=peak, built_s=built)
            if label == "adafactor":
                run["val"] = validated(torch, trainer)
            drop_trainer(torch, trainer)
            runs[what] = run
            log(f"[15f] {label} {what}: built in {built:.2f} s, {run['s_step']:.4f} s/step, "
                f"peak {peak:.2f} GiB" + (f", validate {run['val'][2]:.2f} s" if "val" in run
                                          else "") + f"; {nvidia_smi_line()}")
        plain, other = runs["plain"], runs["tp" if label == "lora" else "fsdp"]
        unequal = [n for n in plain["params"] if not torch.equal(plain["params"][n],
                                                                 other["params"][n])]
        check(other["losses"] == plain["losses"] and not unequal,
              f"[15f] {label}: losses {other['losses']} against {plain['losses']}; "
              f"parameters differ: {unequal[:5]}")
        if label == "adafactor":
            check(other["val"][:2] == plain["val"][:2],
                  "[15f] the fsdp Trainer's validate differs from the plain one's")
        log(f"[15f] {label}: {steps} step(s) {'tp' if label == 'lora' else 'fsdp'} against "
            f"plain, losses and all {len(plain['params'])} parameters bitwise equal"
            + (f"; validate: {len(plain['val'][0])} files and the val/ metrics "
               f"{plain['val'][1]} bitwise equal" if label == "adafactor" else ""))
        out[label] = {w: {k: v for k, v in r.items() if k in ("s_step", "peak_gib", "built_s")}
                      for w, r in runs.items()}
        if label == "adafactor":
            for w, r in runs.items():
                out[label][w]["validate_s"] = r["val"][2]
        del runs, plain, other
        torch.cuda.empty_cache()
    return out


def forced_logits(torch, model, cfg, inputs, tokens) -> tuple:
    """The image loop teacher-forced on `tokens` [B, N] (eager, temperature
    0, the int8 cache), its kernel launches counted: (every step's
    CFG-combined logits [N, B, V] on the CPU, launches, plain calls)."""
    from plangen_tpu_torch.ops.sampling import cfg_combine
    from plangen_tpu_torch.runtime.generate import generate_image_tokens

    dev = torch.device("cuda", torch.cuda.current_device())
    dtype = model.language_model.model.embed_tokens.weight.dtype
    seen, logits = [], model.image_gen_logits
    model.image_gen_logits = lambda h: (seen.append(logits(h)), seen[-1])[1]
    forced = torch.from_numpy(tokens).to(dev)
    try:
        _, _, got, plain_calls, _ = counted(torch, dev, lambda: generate_image_tokens(
            model, cfg, torch.from_numpy(inputs["embeds"]).to(dev, dtype),
            torch.from_numpy(inputs["mask"]).to(dev), None, inputs["cfg_weight"], 0.0,
            gt_tokens=forced, regen_mask=torch.zeros_like(forced, dtype=torch.int32),
            num_tokens=tokens.shape[1], quantized_cache=True, eager=True))
    finally:
        del model.image_gen_logits
    combined = torch.stack([cfg_combine(x, inputs["cfg_weight"]).float().cpu() for x in seen])
    return combined, got, plain_calls


def row_witness(torch, dense_model, split_model, mode: str) -> dict:
    """[15g] layer 0's down_proj, a row split, on seeded fp32 rows x [8, I],
    the same on both ranks: the rank's product on its columns, summed over
    the ranks, against the layer quantized whole on the whole rows; for
    int4_a8 once more with each row's absmax taken on the rank's columns
    alone (the group MAX left out: a planted fault). Max abs differences
    over the whole product's largest magnitude."""
    import torch.distributed as dist

    from plangen_tpu_torch.ops.quant import Int4Linear

    dense = dense_model.language_model.model.layers[0].mlp.down_proj
    split = split_model.language_model.model.layers[0].mlp.down_proj
    with torch.no_grad():
        whole = Int4Linear.from_dense(dense.weight.t(), a8=mode == "int4_a8")
        gen = torch.Generator(device=dense.weight.device).manual_seed(4321)
        x = torch.randn(8, dense.in_features, generator=gen, device=dense.weight.device)
        want = whole(x)
        scale = want.abs().max()
        n, r = split.in_features, dist.get_rank(split.tp_split.group)
        mine = x[:, r * n:(r + 1) * n]
        out = dict(rel_err=float((split(mine) - want).abs().max() / scale))
        if mode == "int4_a8":
            group, split.absmax_group = split.absmax_group, None
            try:
                out["planted_rel_err"] = float((split(mine) - want).abs().max() / scale)
            finally:
                split.absmax_group = group
    return out


def tp2_quant_rank(rank: int, port: int, inputs: dict, results) -> None:
    """[15g] one of two ranks on the one card over gloo: the seeded bf16
    model split TP = 2, then quantized in place (route a) to each of
    `TP2_QUANT_MODES`, its bytes against the
    quantized model split by `shard_params` (route b); the image loop
    teacher-forced on the unsharded quantized model's greedy tokens (the
    logits of every step, K2 / K4 launches) and run free (greedy, its
    tokens); `row_witness`. With `inputs["witness"]` int4_a8's
    teacher-forced run is repeated with every row absmax taken on the
    rank's columns alone (the planted fault of `row_witness`, end to end)."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        from plangen_tpu_torch.ops.quant import quantize_model_
        from plangen_tpu_torch.parallel import mesh as pm
        from plangen_tpu_torch.runtime.generate import generate_image_tokens

        dev = torch.device("cuda:0")
        torch.cuda.set_device(dev)
        pm.init_distributed(f"localhost:{port}", 2, rank, device="cpu")  # gloo
        mesh = pm.create_mesh({"data": 1, "model": 2}, device="cuda")
        pipe, cfg = build_pipeline(torch, dev, False)
        out = {}
        t0 = time.perf_counter()
        for mode in TP2_QUANT_MODES:
            a = quantize_model_(pm.shard_params(copy.deepcopy(pipe.model), mesh,
                                                tp_axis="model"), mode)
            log(f"[15g] rank {rank} {mode}: route a at {time.perf_counter() - t0:.1f} s")
            b = pm.shard_params(quantize_model_(copy.deepcopy(pipe.model), mode), mesh,
                                tp_axis="model")
            unequal = same_buffers(torch, a, b)
            del b
            layer = a.language_model.model.layers[0]
            widths = {name: (mod.in_features, mod.out_features) for name, mod in (
                ("qkv_proj", layer.self_attn.qkv_proj), ("o_proj", layer.self_attn.o_proj),
                ("gate_up_proj", layer.mlp.gate_up_proj), ("down_proj", layer.mlp.down_proj),
                ("lm_head", a.language_model.lm_head), ("vision_head", a.gen_head.vision_head))}
            logits, launches, plain_calls = forced_logits(torch, a, cfg, inputs,
                                                          inputs["tokens"][mode])
            log(f"[15g] rank {rank} {mode}: teacher-forced at {time.perf_counter() - t0:.1f} s")
            row = row_witness(torch, pipe.model, a, mode)
            planted = None
            if inputs.get("witness") and mode == "int4_a8":
                rows = [m for m in a.modules() if getattr(m, "absmax_group", None) is not None]
                for m in rows:
                    m.absmax_group = None
                planted = forced_logits(torch, a, cfg, inputs, inputs["tokens"][mode])[0]
                for m in rows:
                    m.absmax_group = m.tp_split.group
                planted = planted.numpy()
            greedy = generate_image_tokens(
                a, cfg, torch.from_numpy(inputs["embeds"]).to(dev, torch.bfloat16),
                torch.from_numpy(inputs["mask"]).to(dev), None, inputs["cfg_weight"], 0.0,
                num_tokens=TP2_STEPS, quantized_cache=True, eager=True).cpu().numpy()
            log(f"[15g] rank {rank} {mode}: done at {time.perf_counter() - t0:.1f} s")
            out[mode] = dict(unequal=unequal, widths=widths, logits=logits.numpy(),
                             launches=launches, plain_calls=plain_calls, greedy=greedy,
                             row=row, planted=planted)
            del a
            torch.cuda.empty_cache()
        results.put((rank, out))
    except BaseException:
        results.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _step_gaps(got, want, scale: float, n: int = 4) -> list:
    """The first `n` steps' logit max abs differences over `scale`."""
    return [float(abs(got[i] - want[i]).max() / scale) for i in range(n)]


def phase_tp2_quantized(torch, pipe, cfg, witness: bool = False) -> dict:
    """[15g] two ranks on the one card over gloo at TP = 2 with the phase-4
    model quantized to int4 and int4_a8 on their shards: first K2 and K4
    at each TP-2 local shape against their plain versions, timed
    (`int4_case`); then, with bf16 activations (K2's tensor-core route),
    the unsharded quantized model's greedy tokens and logits (eager, the
    int8 cache) here, and the ranks' (`tp2_quant_rank`): route a's bytes
    equal route b's, the local widths halved, the ranks' free-running
    tokens and logits equal to each other's (the tokens reported against
    the unsharded), K2 / K4 launched at every projection of every step
    with no plain call, and the teacher-forced logits of every step within
    `TP2_LOGIT_TOL` of the unsharded model's (relative to the logits'
    largest magnitude); `row_witness` within `ROW_TOL`, its planted fault
    beyond `ROW_PLANTED_MIN`. `witness` adds two readings of int4_a8's
    end-to-end gap beside the TP run's: the planted fault end to end, and
    the unsharded model with 1 % of its prompt embeddings moved by one bf16
    ulp (a rounding difference and nothing else). Run it alone from the
    root with `python3 -c "import torch, chip_smoke as cs; cs.phase_header(torch);
    cs.phase_build(); pipe, cfg = cs.build_pipeline(torch, torch.device('cuda:0'), False);
    cs.phase_tp2_quantized(torch, pipe, cfg, witness=True)"`."""
    import multiprocessing
    import queue

    import numpy as np

    from plangen_tpu_torch.ops.quant import quantize_model_
    from plangen_tpu_torch.runtime.generate import generate_image_tokens

    dev = pipe.device
    gen = torch.Generator(device=dev).manual_seed(8765)
    rows = []
    for name, R, I, O in TP2_LOCAL_SHAPES:
        rows += int4_case(torch, dev, gen, name, R, I, O, tag="15g")
    prep = pipe.prepare_layout_to_image(CAPTIONS[:1], GROUNDINGS[:1], seeds=SEEDS[:1])
    L = prep.embeds.shape[1]
    # the bf16 embeddings as fp32 (exact) for numpy; each run casts them
    inputs = dict(embeds=prep.embeds.float().cpu().numpy(),
                  mask=prep.cfg_mask[:, :L + TP2_STEPS].cpu().numpy(),
                  cfg_weight=pipe.gen.cfg_weight, tokens={}, witness=witness)
    want, nudged = {}, None
    for mode in TP2_QUANT_MODES:
        model = quantize_model_(copy.deepcopy(pipe.model), mode)
        tokens = generate_image_tokens(
            model, cfg, prep.embeds, prep.cfg_mask[:, :L + TP2_STEPS], None,
            pipe.gen.cfg_weight, 0.0, num_tokens=TP2_STEPS, quantized_cache=True,
            eager=True).cpu().numpy()
        inputs["tokens"][mode] = tokens
        want[mode] = forced_logits(torch, model, cfg, inputs, tokens)[0].numpy()
        if witness and mode == "int4_a8":
            bits = inputs["embeds"].copy().view(np.uint32)  # bf16 values as fp32
            moved = np.random.default_rng(0).random(bits.shape) < 0.01
            bits[moved] += np.uint32(1 << 16)  # one bf16 ulp away from zero
            nudged = forced_logits(torch, model, cfg, dict(inputs, embeds=bits.view(np.float32)),
                                   tokens)[0].numpy()
        del model
        torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=tp2_quant_rank, args=(r, port, inputs, results))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, res = results.get(timeout=TP2_TIMEOUT_S)
            got[rank] = res
    except queue.Empty:
        got["timeout"] = f"no result within {TP2_TIMEOUT_S} s"
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    seconds = time.perf_counter() - t0
    errors = {r: v for r, v in got.items() if isinstance(v, str)}
    check(not errors, "[15g] two ranks over gloo on the one card: " + "; ".join(
        f"rank {r}: {v.strip().splitlines()[-1]}" for r, v in errors.items()))
    steps = TP2_STEPS
    matmul = {"int4": "int4_matmul_w16", "int4_a8": "int4_matmul_a8"}
    out = dict(seconds=seconds, steps=steps, activations="bfloat16", kernels=rows, modes={})
    for mode in TP2_QUANT_MODES:
        res = {r: got[r][mode] for r in (0, 1)}
        for r, x in res.items():
            check(not x["unequal"], f"[15g] {mode} rank {r}: route a's buffers differ from "
                  f"route b's: {x['unequal'][:5]}")
            # decode steps only: the prefill's rows x prompt exceed 256 (the dense route)
            n = steps * (4 * cfg.llama.num_layers + 1)
            check(x["launches"][matmul[mode]] == n and x["plain_calls"] == 0
                  and x["launches"]["prefix_decode_attention_q8"] == steps * cfg.llama.num_layers,
                  f"[15g] {mode} rank {r}: launches {x['launches']}, plain {x['plain_calls']}, "
                  f"expected {n} {matmul[mode]}")
        check(res[0]["widths"] == res[1]["widths"], "[15g] the ranks' local widths differ")
        check(np.array_equal(res[0]["greedy"], res[1]["greedy"])
              and np.array_equal(res[0]["logits"], res[1]["logits"]),
              f"[15g] {mode}: the ranks' tokens or logits differ")
        scale = float(np.abs(want[mode]).max())
        err = float(np.abs(res[0]["logits"] - want[mode]).max())
        parts = int((res[0]["greedy"] != inputs["tokens"][mode]).sum())
        row = [res[r]["row"] for r in (0, 1)]
        check(row[0] == row[1], f"[15g] {mode}: the ranks' row witnesses differ: {row}")
        row = row[0]
        log(f"[15g] {mode} row witness (layer 0's down_proj split over the two ranks, fp32 "
            f"rows, against the layer quantized whole): max abs diff {row['rel_err']:.3e} of "
            f"the product's scale (limit {ROW_TOL:.0e})" + (
                f"; the row absmax on the rank's columns alone (planted fault) "
                f"{row['planted_rel_err']:.3e} (must exceed {ROW_PLANTED_MIN:.0e})"
                if "planted_rel_err" in row else ""))
        check(row["rel_err"] <= ROW_TOL, f"[15g] {mode}: the row split's product differs "
              f"by {row['rel_err']} of its scale > {ROW_TOL}")
        check(row.get("planted_rel_err", 1.0) > ROW_PLANTED_MIN,
              f"[15g] {mode}: the row witness does not see the planted fault: {row}")
        gaps = _step_gaps(res[0]["logits"], want[mode], scale)
        out["modes"][mode] = dict(logit_max_abs_diff=err, logit_scale=scale,
                                  limit=TP2_LOGIT_TOL[mode], greedy_tokens_differ=parts,
                                  widths=res[0]["widths"], row_witness=row,
                                  first_step_gaps=gaps)
        log(f"[15g] {mode} TP = 2: the first steps' logit gaps {[f'{g:.2%}' for g in gaps]} "
            f"of the scale")
        if witness and mode == "int4_a8":
            for what, other in (("planted fault (row absmax on the rank's columns alone)",
                                 res[0]["planted"]), ("unsharded, 1 % of the prompt "
                                                      "embeddings one bf16 ulp away", nudged)):
                e = float(np.abs(other - want[mode]).max())
                log(f"[15g] {mode} witness, {what}: logits max abs diff {e:.4f} "
                    f"({e / scale:.2%} of the scale), the first steps' "
                    f"{[f'{g:.2%}' for g in _step_gaps(other, want[mode], scale)]}")
                out["modes"][mode]["witness " + what] = e / scale
        log(f"[15g] {mode} TP = 2 over gloo, bf16 activations (K2's tensor-core route): local "
            f"(in, out) {res[0]['widths']}; route a's bytes equal route b's on both ranks; "
            f"{steps} teacher-forced steps: logits max abs diff {err:.4f} against the unsharded "
            f"model's (scale {scale:.3f}, {err / scale:.2%}, limit {TP2_LOGIT_TOL[mode]:.0%}); "
            f"{matmul[mode]} {res[0]['launches'][matmul[mode]]} launches a rank, no plain call; "
            f"greedy tokens equal on both ranks, {parts} of {steps} differ from the unsharded "
            f"model's")
        check(err <= TP2_LOGIT_TOL[mode] * scale, f"[15g] {mode}: logits differ by {err} > "
              f"{TP2_LOGIT_TOL[mode]} x {scale}")
    log(f"[15g] two ranks in {seconds:.1f} s (both processes' start, build, the "
        f"quantizations and decodes)")
    return out


def tp_eager_against_graph(torch, tpipe, cfg) -> dict:
    """[15d] The TP model's image loop for TP_EAGER_STEPS steps, eager then
    graph, on the x4 prompt and generators: bitwise equal, device and host
    time a step (an eager step dispatches every DTensor op on the host)."""
    from plangen_tpu_torch.runtime.generate import generate_image_tokens
    from plangen_tpu_torch.tasks.pipeline import row_generators

    prep = tpipe.prepare_layout_to_image(CAPTIONS, GROUNDINGS, seeds=SEEDS)
    L, n = prep.embeds.shape[1], TP_EAGER_STEPS
    out = {}
    for kind in ("eager", "graph"):
        tokens, seconds, got, plain_calls, _ = counted(torch, tpipe.device, lambda: (
            generate_image_tokens(tpipe.model, cfg, prep.embeds, prep.cfg_mask[:, :L + n],
                                  row_generators(SEEDS, 1, tpipe.device), tpipe.gen.cfg_weight,
                                  tpipe.gen.temperature, num_tokens=n, eager=kind == "eager")))
        check(got["prefix_decode_attention"] == n * cfg.llama.num_layers and not plain_calls,
              f"[15d] tp {kind} x{n}: launches {got}, plain {plain_calls}")
        out[kind] = (tokens.cpu(), seconds)
    check(torch.equal(out["eager"][0], out["graph"][0]), "[15d] tp graph tokens differ from eager")
    row = dict(model="tp", steps=n, eager_s=out["eager"][1], graph_s=out["graph"][1])
    log(f"[15d] tp x4, {n} steps with the prefill: eager {row['eager_s']:.3f} s "
        f"({1e3 * row['eager_s'] / n:.1f} ms a step), graph {row['graph_s']:.3f} s (step 0 "
        "eager and the capture included); tokens bitwise equal")
    return row


def phase_parallel(torch, dev) -> dict:
    """[15] `parallel/mesh.py` on the one card (module docstring); returns
    the launches of its runs, each counted from 0."""
    import torch.distributed as dist

    from plangen_tpu_torch.parallel import mesh as pm

    launches = dict.fromkeys(kernel_counters(), 0)
    log(f"[15] {nvidia_smi_line()}")
    # (a) a world-1 NCCL group on cuda:0
    pm.init_distributed(f"localhost:{_free_port()}", 1, 0)
    mesh = pm.create_mesh({"data": 1, "model": 1})
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
          and mesh.device_type == "cuda", f"[15a] {dist.get_backend()} {mesh}")
    log(f"[15a] init_distributed: a world-1 {dist.get_backend()} group, mesh {mesh}")
    try:
        # (d) TP over the world-1 "model" axis on the phase-4 model
        pipe, cfg = build_pipeline(torch, dev, False)
        tp_model = pm.shard_params(copy.deepcopy(pipe.model), mesh, tp_axis="model")
        tpipe, _ = build_pipeline(torch, dev, False, model=tp_model)
        check(pm.is_sharded(tp_model), "[15d] no DTensor in the TP model")
        ids, mask = pipe.proc.uni_batch(CAPTIONS, GROUNDINGS)
        prompt_len = pipe.proc.cfg_batch(ids, mask)[0].shape[1]
        want = expected_launches(cfg, None, 2 * len(CAPTIONS), prompt_len)
        base = pipe.layout_to_image(CAPTIONS, GROUNDINGS, seeds=SEEDS).image_tokens
        rows = []
        for i, (what, p) in enumerate((("unsharded", pipe), ("tp", tpipe), ("tp", tpipe),
                                        ("unsharded", pipe))):
            loop = DecodeLoop(torch)
            torch.cuda.reset_peak_memory_stats()
            with loop:
                out, seconds, got, plain_calls, tc = counted(
                    torch, dev, lambda: p.layout_to_image(CAPTIONS, GROUNDINGS, seeds=SEEDS))
            check_launches("15d", f"{what} x4 turn {i + 1}", got, want, plain_calls, tc)
            if what == "tp":
                add_launches(launches, got)
            check_image_output(cfg, out, len(CAPTIONS))
            diff = int((out.image_tokens != base).sum())
            check(diff == 0, f"[15d] {what} x4: {diff} tokens differ from the unsharded "
                  "model's first call")
            rows.append(dict(model=what, s_per_call=seconds,
                             host_ms_per_step=loop.host_ms_per_step(),
                             capture_ms=loop.capture_ms[0],
                             peak_gib=torch.cuda.max_memory_allocated() / 2**30))
            log(f"[15d] {what} x4 turn {i + 1} (graph): {seconds:.3f} s/call, host "
                f"{rows[-1]['host_ms_per_step']:.3f} ms a replay, capture + instantiate "
                f"{rows[-1]['capture_ms']:.2f} ms, peak {rows[-1]['peak_gib']:.2f} GiB; tokens "
                "bitwise equal to the unsharded model's")
        rows.append(tp_eager_against_graph(torch, tpipe, cfg))
        budget = pipe.gen.max_new_text_tokens
        plan_len = pipe.proc.stage1_batch(CAPTIONS, budget)[0].shape[1]
        plans, plan_tokens, _, plain_s = text_call(
            torch, pipe, cfg, "15d", "plan x4 unsharded", lambda: pipe.plan(CAPTIONS), 4,
            plan_len)
        tplans, tplan_tokens, got, tp_s = text_call(
            torch, tpipe, cfg, "15d", "tp plan x4", lambda: tpipe.plan(CAPTIONS), 4, plan_len)
        add_launches(launches, got)
        check(tplans == plans and (tplan_tokens == plan_tokens).all(),
              "[15d] tp plan x4 differs from the unsharded model's")
        log(f"[15d] tp plan x4: {tp_s:.3f} s/call against {plain_s:.3f} unsharded; "
            "groundings and tokens bitwise equal")
        del tpipe, tp_model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()

        def took(what: str) -> None:
            nonlocal t0
            log(f"[time] 15 {what}: {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()

        quantized = phase_tp_quantized(torch, pipe, cfg, mesh, launches)
        took("f (quantized forms)")
        tp2 = phase_tp2_one_card(torch, pipe, cfg)
        took("e")
        tp2_quantized = phase_tp2_quantized(torch, pipe, cfg)
        took("g")
        del pipe
        torch.cuda.empty_cache()
        train = phase_parallel_train(torch, dev, launches)
        took("b, c")
        options = phase_parallel_options(torch, dev, mesh, launches)
        took("f (training options)")
        fsdp_tp = phase_fsdp_tp(torch, dev)
        took("h")
        log("[15] " + json.dumps(dict(decode_turns=rows, quantized=quantized, tp2=tp2,
                                      tp2_quantized=tp2_quantized, train=train,
                                      options=options, fsdp_tp=fsdp_tp)))
    finally:
        dist.destroy_process_group()
    log(f"[15] {nvidia_smi_line()}")
    return launches


# ------------------------------------------------------------ [10] serving


SERVE_WAIT_MS = 150.0  # long enough for a burst of client threads to batch
AUTO_TIMING_BATCHES = (4, 32, 48)


def write_checkpoint(torch, model, path: pathlib.Path) -> dict:
    """`model` as an HF checkout in `path`: its state dict in two
    `pytorch_model-0000{1,2}-of-00002.bin` shards (the released layout),
    and the first shard once more as safetensors through the port's writer
    in `path / "st"`, read back by its reader and held bitwise equal.
    Returns the CPU state dict."""
    from plangen_tpu_torch.convert import safetensors

    t0 = time.perf_counter()
    sd = {k: v.detach().to("cpu") for k, v in model.state_dict().items()}
    keys = list(sd)
    shards = (keys[:len(keys) // 2], keys[len(keys) // 2:])
    for i, part in enumerate(shards, 1):
        torch.save({k: sd[k] for k in part}, path / f"pytorch_model-0000{i}-of-00002.bin")
    (path / "st").mkdir()
    st_file = path / "st" / "model-00001-of-00002.safetensors"
    safetensors.save_file({k: sd[k] for k in shards[0]}, str(st_file))
    back = safetensors.load_file(str(st_file))
    check(sorted(back) == sorted(shards[0]), "safetensors shard: keys differ")
    for k in shards[0]:
        check(back[k].dtype == sd[k].dtype and torch.equal(back[k], sd[k]),
              f"safetensors shard: {k} differs after the round trip")
    nbytes = sum(v.numel() * v.element_size() for v in sd.values())
    log(f"[10] wrote the seeded model as 2 .bin shards ({nbytes / 2**30:.2f} GiB) and "
        f"{len(shards[0])} tensors as a safetensors shard "
        f"({st_file.stat().st_size / 2**30:.2f} GiB, read back bitwise equal) in "
        f"{time.perf_counter() - t0:.1f} s")
    return sd


class ServeClient:
    """The port's batcher and HTTP server in-process on 127.0.0.1:0, and
    client threads that fire requests at it."""

    def __init__(self, pipe, **kw):
        import threading

        from plangen_tpu_torch.serve import Batcher, make_server

        self.batcher = Batcher(pipe, **kw)
        self.httpd = make_server(self.batcher, "127.0.0.1", 0)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def post(self, path: str, payload: dict):
        import urllib.error
        import urllib.request

        req = urllib.request.Request(self.base + path, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=900) as r:
                code, body = r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            code, body = e.code, json.loads(e.read())
        return code, body, time.perf_counter() - t0

    def burst(self, requests) -> tuple:
        """[(path, payload)] fired at once from one thread each: (their
        (code, body, seconds) in order, wall seconds, batches run)."""
        import threading

        out = [None] * len(requests)
        batches = self.batcher.stats["batches"]

        def call(i):
            out[i] = self.post(*requests[i])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(requests))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        check(not any(t.is_alive() for t in threads), "a client thread did not return")
        wall = time.perf_counter() - t0
        for code, body, _ in out:
            check(code == 200, f"served request failed: {code} {body}")
        return out, wall, self.batcher.stats["batches"] - batches

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()


def noise_png(np, h: int, w: int, seed: int) -> str:
    import base64

    from plangen_tpu_torch.utils.visualize import encode_png

    img = np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)
    return base64.b64encode(encode_png(img)).decode()


def decoded_png(b64: str, size: int):
    import base64

    from plangen_tpu_torch.utils.visualize import decode_png

    img = decode_png(base64.b64decode(b64))
    check(img.shape == (size, size, 3), f"served PNG decodes to {img.shape}")
    return img


def check_served_tokens(cfg, tokens) -> None:
    check(len(tokens) == cfg.image_seq_len, f"{len(tokens)} served image tokens")
    check(0 <= min(tokens) and max(tokens) < cfg.image_token_size,
          f"served tokens out of range [{min(tokens)}, {max(tokens)}]")


def report_mode(tag: str, mode: str, results, wall: float, batches: int, peak: float,
                stats: dict) -> dict:
    """One burst's numbers; `stats` holds the batcher's `device_s` and
    `assembly_s` over the burst."""
    import numpy as np

    lat = [s for _, _, s in results]
    row = dict(mode=mode, requests=len(results), batches=batches,
               p50_s=float(np.median(lat)), requests_per_s=len(results) / wall,
               peak_gib=peak, **stats)
    log(f"[{tag}] {mode}: {len(results)} request(s) in {batches} batch(es), p50 latency "
        f"{row['p50_s']:.3f} s, {row['requests_per_s']:.3f} requests/s, batcher device_s "
        f"{stats['device_s']:.3f} s and assembly_s {stats['assembly_s']:.3f} s, peak "
        f"device memory {peak:.2f} GiB")
    return row


def phase_serving(torch, dev, checkout=None) -> dict:
    """[10] Serving at Janus-Pro-1B width from a checkpoint on disk: the
    seeded model written as an HF checkout, `tasks/eval.py::build_pipeline`
    from it (weights bitwise equal to the seeded model's), `serve.Batcher`
    and the HTTP server in-process; every endpoint from client threads,
    checked; then `quantize="auto"`: K2 and K1-q8 at 64 rows as
    `expected_launches` says and no dense LM matmul, no K2 at 66 rows; and
    both routes timed at B = 4, 32, 48. Returns the launches by kernel.
    With `checkout` (a directory), the checkout is written there and kept
    for phase 14."""
    import dataclasses
    import tempfile

    import numpy as np

    from plangen_tpu_torch.config import GenerationConfig, PlanGenConfig, PlanGenModelConfig
    from plangen_tpu_torch.convert import init_params
    from plangen_tpu_torch.data.preprocess import build_edit_region
    from plangen_tpu_torch.models.vlm import PlanGenModel
    from plangen_tpu_torch.tasks.eval import build_pipeline
    from plangen_tpu_torch.tasks.pipeline import PlanGenPipeline

    mcfg = PlanGenModelConfig()  # Janus-Pro-1B widths
    seeded = PlanGenModel(mcfg, dtype=torch.bfloat16, device=dev)
    init_params(seeded, torch.Generator(device=dev).manual_seed(0))
    seeded.eval()
    gen = GenerationConfig(cfg_weight=5.0, temperature=1.0, output_uint8=True)
    numbers = {}
    with tempfile.TemporaryDirectory(prefix="plangen_ckpt_") as tmp:
        path = pathlib.Path(checkout or tmp)
        write_checkpoint(torch, seeded, path)
        cfg = PlanGenConfig(model=mcfg, janus_path=str(path), generation=gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe = build_pipeline(cfg, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    own = dict(seeded.named_parameters())
    loaded = dict(pipe.model.named_parameters())
    check(sorted(own) == sorted(loaded), "loaded model: parameter names differ")
    for k, v in own.items():
        check(loaded[k].dtype == v.dtype and loaded[k].device.type == dev.type
              and torch.equal(loaded[k], v), f"loaded {k} is not bitwise the seeded weight")
    log(f"[10] build_pipeline from the checkout: {load_s:.1f} s, {len(own)} parameters "
        f"bitwise equal to the seeded model's, on {pipe.device}")
    del seeded, own, loaded
    torch.cuda.empty_cache()

    pipe.defer_fetch = True  # as serve() sets it
    size = mcfg.vision.image_size
    counters = kernel_counters()
    torch.cuda.synchronize()
    reset_counters(counters)
    server = ServeClient(pipe, max_batch=32, wait_ms=SERVE_WAIT_MS)
    rows = []
    try:
        def mode_run(mode, requests):
            torch.cuda.reset_peak_memory_stats()
            before = dict(server.batcher.stats)
            results, wall, batches = server.burst(requests)
            # a batch's stats are counted before its clients are answered
            stats = {k: server.batcher.stats[k] - before[k]
                     for k in ("device_s", "assembly_s")}
            rows.append(report_mode("10", mode, results, wall, batches,
                                    torch.cuda.max_memory_allocated() / 2**30, stats))
            return results, batches

        # the first batch of the process (kernels loaded, cuBLAS and the
        # capture stream set up) apart from a warm one
        for when in ("cold", "warm"):
            gens, batches = mode_run(f"/generate x4 ({when})", [
                ("/generate", {"caption": c, "grounding": g, "seed": s})
                for c, g, s in zip(CAPTIONS, GROUNDINGS, SEEDS)])
            check(batches == 1, f"4 concurrent /generate ran in {batches} batches, not 1")
        for (_, body, _), s in zip(gens, SEEDS):
            check_served_tokens(mcfg, body["tokens"])
            check(body["seed"] == s, f"seed {body['seed']} echoed for {s}")
            decoded_png(body["image_b64"], size)
        check(len({tuple(b["tokens"]) for _, b, _ in gens}) == 4,
              "4 requests got fewer than 4 token streams")

        plan_one, _ = mode_run("/plan x1", [("/plan", {"caption": CAPTIONS[1]})])
        mode_run("/plan x4", [("/plan", {"caption": c}) for c in CAPTIONS])
        mode_run("/understand x2 (384 px, 500 x 300 resized)", [
            ("/understand", {"image_b64": noise_png(np, size, size, 1)}),
            ("/understand", {"image_b64": noise_png(np, 300, 500, 2)})])
        joint, _ = mode_run("/joint x1", [("/joint", {"caption": CAPTIONS[0], "seed": 5})])
        check_served_tokens(mcfg, joint[0][1]["tokens"])
        decoded_png(joint[0][1]["image_b64"], size)
        box = [[0.25, 0.25, 0.75, 0.75]]
        edit, _ = mode_run("/edit x1 (edit_boxes)", [("/edit", {
            "caption": CAPTIONS[0], "grounding": GROUNDINGS[0], "seed": 9,
            "image_b64": gens[0][1]["image_b64"], "edit_boxes": box})])
        edit_tokens = edit[0][1]["tokens"]
        check_served_tokens(mcfg, edit_tokens)
        decoded_png(edit[0][1]["image_b64"], size)

        # the seed contract: seed 7 beside different companions, one bucket
        def seeded_group(companions):
            reqs = [("/generate", {"caption": CAPTIONS[2], "grounding": GROUNDINGS[2],
                                   "seed": 7})]
            reqs += [("/generate", {"caption": c, "grounding": g, "seed": s})
                     for c, g, s in companions]
            results, _, batches = server.burst(reqs)
            check(batches == 1, f"a seeded group of 4 ran in {batches} batches")
            return results[0][1]["tokens"]

        a = seeded_group([(CAPTIONS[0], GROUNDINGS[0], 101), (CAPTIONS[3], GROUNDINGS[3], 102),
                          (CAPTIONS[1], GROUNDINGS[1], 103)])
        b = seeded_group([(CAPTIONS[3], GROUNDINGS[3], 201), (CAPTIONS[0], GROUNDINGS[0], 202),
                          (CAPTIONS[1], GROUNDINGS[1], 203)])
        check(a == b, "seed 7 in bucket 4: tokens differ with other companions in "
              f"{sum(x != y for x, y in zip(a, b))} places")
        alone = server.post("/generate", {"caption": CAPTIONS[2], "grounding": GROUNDINGS[2],
                                          "seed": 7})[1]["tokens"]
        across = sum(x != y for x, y in zip(a, alone))
        log(f"[10] seed contract: seed 7 bitwise equal in bucket 4 beside two sets of "
            f"companions; alone in bucket 1 it differs in {across} of {len(a)} tokens "
            "(reported, not asserted)")
        stats = dict(server.batcher.stats)
    finally:
        server.close()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, (w, _) in counters.items()}
    plain_calls = sum(p.calls for _, p in counters.values())
    log(f"[10] serving launches {launches}, plain calls {plain_calls}")
    check(launches["prefix_decode_attention"] > 0, "serving launched no K1")
    check(plain_calls == 0, f"serving ran the plain versions {plain_calls} times")
    check(all(v == 0 for k, v in launches.items() if k != "prefix_decode_attention"),
          f"bf16 serving launched other kernels: {launches}")
    log(f"[10] batcher stats: {json.dumps(stats)}")
    numbers.update(modes=rows, stats=stats, seed_across_buckets_diff=across,
                   load_s=load_s)

    # the served answers, against direct calls (no server running)
    want_plan = pipe.plan([CAPTIONS[1]])[0]
    check(plan_one[0][1]["grounding"] == want_plan,
          "/plan differs from pipe.plan on the same caption")
    with torch.inference_mode():
        pixels = torch.from_numpy(
            decoded_png(gens[0][1]["image_b64"], size).astype(np.float32) / 127.5 - 1.0)
        codes = pipe.model.gen_vision_model.encode_to_indices(
            pixels[None].to(dev, torch.bfloat16))[0].cpu().numpy()
    keep = build_edit_region(np.asarray(box), grid=pipe.grid) == 0
    check(bool((np.asarray(edit_tokens)[keep] == codes[keep]).all()),
          "/edit: tokens outside the box differ from the image's VQ codes")
    log(f"[10] /plan equals pipe.plan; /edit keeps the {int(keep.sum())} tokens outside "
        "its box at the image's VQ codes")

    # quantize="auto" on the loaded model: the int4 view beside it
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    acfg = dataclasses.replace(cfg, generation=dataclasses.replace(gen, quantize="auto"))
    apipe = build_pipeline(acfg, model=pipe.model, device=dev)
    dense_calls = []
    hooks = [m.register_forward_pre_hook(lambda *args: dense_calls.append(1))
             for m in apipe.model.language_model.modules()
             if isinstance(m, torch.nn.Linear)]
    auto_launches = dict.fromkeys(counters, 0)
    try:
        for n in (32, 33):
            caps = [CAPTIONS[i % 4] for i in range(n)]
            grds = [GROUNDINGS[i % 4] for i in range(n)]
            ids, mask = apipe.proc.uni_batch(caps, grds)
            prompt_len = apipe.proc.cfg_batch(ids, mask)[0].shape[1]
            dense_calls.clear()
            out, seconds, got, plain, tc = counted(
                torch, dev, lambda: apipe.layout_to_image(caps, grds, seeds=list(range(n))))
            check_image_output(mcfg, out, n, uint8=True)
            if 2 * n <= apipe.gen.auto_int4_max_rows:
                want = expected_launches(mcfg, "int4", 2 * n, prompt_len)
                check(not dense_calls, f"auto at {2 * n} rows ran {len(dense_calls)} dense "
                      "LM matmuls")
            else:
                want = dict.fromkeys(counters, 0)
                want["prefix_decode_attention_q8"] = mcfg.image_seq_len * mcfg.llama.num_layers
                check(bool(dense_calls), f"auto at {2 * n} rows ran no dense LM matmul")
            check_launches("10", f"auto, {n} captions ({2 * n} rows)", got, want, plain, tc)
            add_launches(auto_launches, got)
            log(f"[10] auto, {n} captions ({2 * n} rows): {seconds:.3f} s/call, route "
                f"{'int4' if 2 * n <= 64 else 'dense'}, dense LM matmul calls "
                f"{len(dense_calls)}")
    finally:
        for h in hooks:
            h.remove()
    peak_auto = torch.cuda.max_memory_allocated() / 2**30
    view_bytes = sum(b.numel() * b.element_size() for b in apipe.model_int4.buffers())
    log(f"[10] auto: peak device memory {peak_auto:.2f} GiB with both trees resident "
        f"(int4 view buffers {view_bytes / 2**30:.3f} GiB beside the dense model)")
    numbers.update(auto_peak_gib=peak_auto, int4_view_gib=view_bytes / 2**30)

    # the auto crossover: each route at B = 4, 32, 48, a warm call then a timed one
    timing = []
    for route, max_rows in (("int4", 10**9), ("dense", 0)):
        rpipe = PlanGenPipeline(apipe.model, mcfg, apipe.proc, model_int4=apipe.model_int4,
                                gen_cfg=dataclasses.replace(apipe.gen,
                                                            auto_int4_max_rows=max_rows))
        for B in AUTO_TIMING_BATCHES:
            caps = [CAPTIONS[i % 4] for i in range(B)]
            grds = [GROUNDINGS[i % 4] for i in range(B)]
            rpipe.layout_to_image(caps, grds, seeds=list(range(B)))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rpipe.layout_to_image(caps, grds, seeds=list(range(B)))
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            timing.append(dict(route=route, B=B, s_per_call=s, images_per_s=B / s))
            log(f"[10] auto route {route}, B = {B} ({2 * B} rows): {s:.3f} s/call, "
                f"{B / s:.2f} images/s")
    numbers["route_timing"] = timing
    log("[10] " + json.dumps(numbers))
    del apipe, pipe
    torch.cuda.empty_cache()
    return add_launches(launches, auto_launches)


# ------------------------------------------------------------ phase 11

# COCO val2017 fixture: (image id, width, height, caption, [(category, x, y, w, h)])
COCO_FIXTURE = (
    (139, 640, 426, "a living room with a couch and a television",
     [("couch", 30.0, 180.0, 320.0, 160.0), ("tv", 400.0, 120.0, 150.0, 110.0)]),
    (285, 586, 640, "a brown bear standing in the grass",
     [("bear", 60.0, 90.0, 460.0, 520.0)]),
    (632, 640, 483, "a bedroom with a bed and a window",
     [("bed", 20.0, 200.0, 560.0, 270.0), ("potted plant", 500.0, 60.0, 90.0, 160.0),
      ("book", 300.0, 20.0, 40.0, 30.0)]),
    (724, 375, 500, "a stop sign on a street corner",
     [("stop sign", 100.0, 80.0, 180.0, 190.0)]),
)
# COCO-200 removal and edit fixture: (old box, new box, class), normalized xyxy
COCO200_FIXTURE = (([0.25, 0.30, 0.70, 0.62], [0.40, 0.35, 0.90, 0.70], "dog"),
                   ([0.10, 0.33, 0.55, 0.66], [0.20, 0.40, 0.60, 0.80], "chair"))
# NSR-1K counting records: (prompt, [(name, [x, y, w, h])]), normalized
NSR1K_FIXTURE = (
    ("two apples on a table", [("apple", [0.1, 0.5, 0.2, 0.2]), ("apple", [0.6, 0.5, 0.2, 0.2])]),
    ("a cat and a dog", [("cat", [0.05, 0.3, 0.4, 0.5]), ("dog", [0.5, 0.25, 0.45, 0.6])]),
    ("three birds in the sky", [("bird", [0.1, 0.1, 0.1, 0.1]), ("bird", [0.4, 0.2, 0.1, 0.1]),
                                ("bird", [0.7, 0.1, 0.1, 0.1])]),
    ("a car", [("car", [0.2, 0.4, 0.6, 0.4])]),
)


def fixture_image(np, h: int, w: int, seed: int):
    """Seeded uint8 [h, w, 3]: a smooth gradient with blocks of noise."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([255 * x / w, 255 * y / h, 128 + 0 * x], axis=-1)
    img = img + rs.randint(-40, 40, size=(h // 8 + 1, w // 8 + 1, 3)).repeat(8, 0).repeat(8, 1)[:h, :w]
    return np.clip(img, 0, 255).astype(np.uint8)


def write_eval_fixtures(root) -> dict:
    """Small datasets in the real formats under `root`, readable without HF
    `datasets`: COCO val2017 (the two annotation JSONs and 4 JPEGs of unequal
    sizes), the COCO-200 removal and edit sets (`image/`, `box/`,
    `box_new/`, `mask/`, 2 samples) and NSR-1K counting (4 records).
    Returns the config fields that point at them."""
    import numpy as np
    from PIL import Image

    root = pathlib.Path(root)
    (root / "coco" / "annotations").mkdir(parents=True, exist_ok=True)
    (root / "coco" / "val2017").mkdir(exist_ok=True)
    names = sorted({c for *_, objs in COCO_FIXTURE for c, *_ in objs})
    cats = [{"id": i + 1, "name": n, "supercategory": "thing"} for i, n in enumerate(names)]
    images, anns, caps = [], [], []
    for k, (img_id, w, h, caption, objs) in enumerate(COCO_FIXTURE):
        name = f"{img_id:012d}.jpg"
        images.append({"id": img_id, "width": w, "height": h, "file_name": name})
        Image.fromarray(fixture_image(np, h, w, k)).save(root / "coco" / "val2017" / name,
                                                         quality=90)
        caps.append({"id": 1000 + k, "image_id": img_id, "caption": caption})
        for c, x, y, bw, bh in objs:
            anns.append({"id": len(anns) + 1, "image_id": img_id, "bbox": [x, y, bw, bh],
                         "category_id": names.index(c) + 1, "iscrowd": 0,
                         "area": bw * bh})
    with open(root / "coco" / "annotations" / "instances_val2017.json", "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats}, f)
    with open(root / "coco" / "annotations" / "captions_val2017.json", "w") as f:
        json.dump({"images": images, "annotations": caps}, f)

    c200 = root / "coco200"
    for sub in ("image", "box", "box_new", "mask"):
        (c200 / sub).mkdir(parents=True, exist_ok=True)
    for i, (old, new, cls) in enumerate(COCO200_FIXTURE):
        Image.fromarray(fixture_image(np, 384, 384, 10 + i)).save(c200 / "image" / f"{i}.png")
        mask = np.zeros((384, 384), dtype=np.uint8)
        x1, y1, x2, y2 = (int(v * 384) for v in old)
        mask[y1:y2, x1:x2] = 255
        Image.fromarray(mask).save(c200 / "mask" / f"{i}.png")
        with open(c200 / "box" / f"{i}.json", "w") as f:
            json.dump({"obj_bbox": old, "obj_class": cls}, f)
        with open(c200 / "box_new" / f"{i}.json", "w") as f:
            json.dump({"obj_bbox": new, "obj_class": cls}, f)

    (root / "nsr1k" / "counting").mkdir(parents=True, exist_ok=True)
    with open(root / "nsr1k" / "counting" / "counting.val.json", "w") as f:
        json.dump([{"prompt": p, "object_list": [[n, b] for n, b in objs]}
                   for p, objs in NSR1K_FIXTURE], f)
    return {"coco_root": str(root / "coco"), "coco_200_path": str(c200),
            "nsr1k_path": str(root / "nsr1k")}


# (task, data, batch size, batches, FID / KID over SigLIP features)
EVAL_CALLS = (("uni", "coco", 4, 1, True), ("uni_2stage", "coco", 1, 1, False),
              ("mmu", "coco", 2, 1, False), ("plan", "layout", 4, 1, False),
              ("rm", "rm_coco", 2, 1, False), ("edit", "edit_coco", 2, 1, False))
LAYOUT_METRIC_KEYS = ["count_match", "miou", "n_gt", "n_pred", "precision", "recall"]
IMAGE_METRIC_KEYS = ["fid_siglip", "kid_siglip", "kid_siglip_std", "n_gt", "n_pr"]


class RecordedTextDecodes:
    """Records the token rows of every text decode any pipeline runs, by
    wrapping `PlanGenPipeline._text_decode` while the `with` block lasts
    (the harness builds its own pipeline, on its worker thread)."""

    def __enter__(self):
        from plangen_tpu_torch.tasks.pipeline import PlanGenPipeline

        self.cls, self.inner, self.runs = PlanGenPipeline, PlanGenPipeline._text_decode, []

        def record(pipe, *args, **kw):
            tokens = self.inner(pipe, *args, **kw)
            self.runs.append(tokens)
            return tokens

        PlanGenPipeline._text_decode = record
        return self.runs

    def __exit__(self, *exc):
        self.cls._text_decode = self.inner


def expected_eval_tree(ds, task: str, bs: int, n_batches: int, metrics: bool) -> set:
    """The files the JAX harness (`plangen_tpu/tasks/eval.py`) writes for
    these batches, relative to `<data>_<task>_<n>/`, at step 0."""
    files = {"0_metrics.json"} if metrics else set()
    for b in range(n_batches):
        files.add(f"0_batch/{b}_layout.json")
        if task in ("plan", "mmu"):
            continue
        files.add(f"0_batch/{b}.png")
        for i in range(bs):
            s = ds[b * bs + i]
            files.add(f"0/pr_image/{b * bs + i}.png")
            if s.image is not None:
                files.add(f"0/gt_image/{b * bs + i}.png")
            if s.image_id:
                files.add(f"0/image_ids/{s.image_id}.jpg")
                if s.image is not None:
                    files.add(f"0/gt_image_ids/{s.image_id}.jpg")
    return files


def mixed_steps(regions) -> int:
    """Decode steps `fast_edit` runs for a batch's regen mask: 16 for each
    chunk not forced in every row."""
    from plangen_tpu_torch.runtime.fast_edit import CHUNK, frozen_chunk_schedule

    return CHUNK * sum(not frozen for frozen in frozen_chunk_schedule(regions))


def edit_batch(ds, task: str, bs: int):
    """The arguments `tasks/eval.py::_run_batch` gives `edit_image` for the
    first batch of an rm / edit dataset."""
    import numpy as np

    samples = [ds[i] for i in range(bs)]
    kw = {}
    if task == "rm":
        kw = dict(neg_captions=[s.neg_base_caption for s in samples],
                  neg_groundings=[s.neg_gt_grounding for s in samples])
    return ([s.base_caption for s in samples], [s.gt_grounding for s in samples],
            np.stack([s.image for s in samples]), np.stack([s.edit_region for s in samples]),
            kw)


def phase_eval(torch, pipe, cfg) -> dict:
    """[11] The evaluation path at Janus-Pro-1B width on the phase-4 model:
    `tasks/eval.py::run_validation` over small datasets in the real formats
    (`write_eval_fixtures`) for `uni` on COCO (4, FID / KID on SigLIP
    features), `uni_2stage` (1), `mmu` (2) on COCO, `plan` on NSR-1K (4),
    `rm` on COCO-200 removal and `edit` on COCO-200 editing (2 each, with
    `fast_edit` and teacher forcing, as scripts/run_infer.sh sets them).
    Each call writes the JAX harness's file tree, its layout JSONs parse,
    its metrics JSON has the JAX keys, and its K1 launches are 24 x the
    decode steps its tokens imply (16 per mixed chunk under `fast_edit`),
    with no plain call. For `rm` and `edit` the same batch then runs
    through the pipeline with and without `fast_edit`: in bf16 the forced
    tokens equal the VQ codes and both are timed; on an fp32 copy of the
    model the two are bitwise equal (bf16 rounds the 16-row forwards apart
    from the loop's single rows, runtime/fast_edit.py). Returns the
    launches."""
    import tempfile

    import numpy as np

    from plangen_tpu_torch.config import PlanGenConfig, apply_overrides
    from plangen_tpu_torch.data.registry import get_dataset
    from plangen_tpu_torch.runtime.generate import text_decode_steps
    from plangen_tpu_torch.tasks import eval as teval
    from plangen_tpu_torch.tasks.image_metrics import SigLIPFeaturizer

    dev, model, L = pipe.device, pipe.model, cfg.llama.num_layers
    total = dict.fromkeys(kernel_counters(), 0)
    numbers = {}
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="plangen_eval_") as tmp:
        fields = write_eval_fixtures(pathlib.Path(tmp) / "data")
        for task, data, bs, n_batches, image_metrics in EVAL_CALLS:
            over = {**fields, "train.val_image_metrics": image_metrics}
            if task in ("rm", "edit"):
                over.update({"generation.use_teacher_forcing": True, "generation.fast_edit": True,
                             "generation.use_neg_box": task == "rm",
                             "generation.pad_edit_box": 0.1 if task == "edit" else 0.0})
            ecfg = apply_overrides(PlanGenConfig(model=cfg), over)
            ds = get_dataset(ecfg, data, is_test=True)
            with RecordedTextDecodes() as runs:
                results, seconds, launches, plain_calls, tc = counted(
                    torch, dev, lambda: teval.run_validation(
                        ecfg, task, data, n_batches, f"{tmp}/out", bs, model=model,
                        device=dev))
            eos = pipe.proc.tok.special.eos_id
            text_steps = sum(text_decode_steps(t.cpu(), eos) for t in runs)
            if task in ("rm", "edit"):
                image_steps = mixed_steps(np.stack([ds[i].edit_region for i in range(bs)]))
            else:
                image_steps = 0 if task in ("plan", "mmu") else cfg.image_seq_len * n_batches
            want = dict.fromkeys(launches, 0)
            want["prefix_decode_attention"] = L * (text_steps + image_steps)
            what = f"eval {task} on {data} ({n_batches} x {bs})"
            check_launches("11", what, launches, want, plain_calls, tc)

            base = pathlib.Path(tmp) / "out" / f"{data}_{task}_{n_batches}"
            tree = {str(f.relative_to(base)) for f in base.rglob("*") if f.is_file()}
            metrics = task in ("plan", "mmu") or image_metrics
            check(tree == expected_eval_tree(ds, task, bs, n_batches, metrics),
                  f"{what}: files {sorted(tree)}")
            for b in range(n_batches):
                layout = json.loads((base / "0_batch" / f"{b}_layout.json").read_text())
                check(sorted(layout) == ["base_caption", "gt_grounding", "pr_grounding"]
                      and all(len(v) == bs for v in layout.values()),
                      f"{what}: layout JSON {layout}")
            if metrics:
                got = json.loads((base / "0_metrics.json").read_text())
                keys = IMAGE_METRIC_KEYS if image_metrics else LAYOUT_METRIC_KEYS
                check(sorted(got) == keys and all(np.isfinite(v) for v in got.values()),
                      f"{what}: metrics {got}")
                log(f"[11] {what}: metrics {json.dumps(got)}")
            check(len(results) == n_batches, f"{what}: {len(results)} batches")
            for out in results:
                if task not in ("plan", "mmu"):
                    imgs = out["pr_image"]
                    size = cfg.vision.image_size
                    check(imgs.shape == (bs, size, size, 3) and bool(np.isfinite(imgs).all()),
                          f"{what}: images {imgs.shape}")
            log(f"[11] {what}: {seconds:.3f} s for {n_batches} batch(es), {text_steps} text "
                f"and {image_steps} image decode steps, {len(tree)} files")
            numbers[task] = dict(seconds=seconds, text_steps=text_steps,
                                 image_steps=image_steps, files=len(tree))
            add_launches(total, launches)

            if task in ("rm", "edit"):
                numbers[task].update(fast_against_standard(torch, ecfg, model, ds, task, bs))

        # the featurizer alone: SigLIP features of the 4 COCO images, twice
        coco = get_dataset(apply_overrides(PlanGenConfig(model=cfg), fields), "coco", True)
        images = np.stack([coco[i].image for i in range(len(coco))])
        featurizer = SigLIPFeaturizer(model, cfg, batch_size=4)
        for turn in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats = featurizer(images)
            torch.cuda.synchronize()
            feat_s = time.perf_counter() - t0
        check(feats.shape == (len(images), cfg.vision.width) and bool(np.isfinite(feats).all()),
              f"featurizer: {feats.shape}")
        log(f"[11] SigLIP featurizer on {len(images)} images: {feat_s:.3f} s (second call)")
        numbers["featurizer_s"] = feat_s
    numbers["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[11] peak device memory {numbers['peak_gib']:.2f} GiB")
    log("[11] " + json.dumps(numbers))
    return total


def time_frozen_chunk(torch, pipe, batch) -> dict:
    """One frozen chunk's Q = 16 forward over the batch's prefilled cache,
    run eagerly as `fast_edit` runs it: host ms a forward (10 forwards,
    synchronized), and from a profiled window of 5 the device kernel time
    and kernels a forward (the window set apart from 2 padding forwards by
    a 0.5 s idle gap, as the profiler loses records at a trace's end)."""
    from plangen_tpu_torch.runtime.generate import start_image_loop

    captions, groundings, images, regions, kw = batch
    prep = pipe.prepare_layout_to_image(captions, groundings, gt_images=images,
                                        edit_region=regions, teacher_forcing=True, **kw)
    model, cfg = pipe._model_for(int(prep.embeds.shape[0])), pipe.cfg
    with torch.inference_mode():
        _, _, mask, cache, _ = start_image_loop(
            model, cfg, prep.embeds, prep.cfg_mask, prep.generator, pipe.gen.cfg_weight,
            pipe.gen.temperature, prep.gt_tokens, prep.regen, cfg.image_seq_len,
            pipe._quantized_cache)
        L = prep.embeds.shape[1]
        embeds = model.gen_img_embeds(prep.gt_tokens[:, :16].repeat_interleave(2, 0))
        embeds = embeds.to(prep.embeds.dtype)
        positions = torch.arange(L, L + 16, dtype=torch.int32, device=embeds.device)

        def forward():
            model.language_model(embeds, mask, positions, cache)

        for _ in range(3):
            forward()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            forward()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 10 * 1e3
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                forward()
            torch.cuda.synchronize()
            time.sleep(0.5)
            for _ in range(2):
                forward()
            torch.cuda.synchronize()
    window = split_at_gaps(device_kernels(prof), 100e3)[0]
    device_ms = sum(end - start for start, end, _ in window) / 5 / 1e3
    log(f"[11] frozen-chunk forward ({prep.embeds.shape[0]} rows x 16 positions, eager): "
        f"{host_ms:.2f} ms a forward on the host clock; device kernels "
        f"{device_ms:.3f} ms and {len(window) / 5:.0f} kernels a forward (profiled)")
    return {"frozen_chunk_host_ms": host_ms, "frozen_chunk_device_ms": device_ms,
            "frozen_chunk_kernels": len(window) / 5}


def fast_against_standard(torch, ecfg, model, ds, task: str, bs: int) -> dict:
    """The first batch of `ds` through `edit_image` with `fast_edit` and
    without, in bf16 (forced tokens equal the VQ codes; s/call of each) and
    on an fp32 copy of the model (bitwise equal tokens)."""
    import dataclasses

    from plangen_tpu_torch.runtime.fast_edit import frozen_chunk_schedule
    from plangen_tpu_torch.tasks import eval as teval

    captions, groundings, images, regions, kw = edit_batch(ds, task, bs)
    sched = frozen_chunk_schedule(regions)
    std_cfg = dataclasses.replace(
        ecfg, generation=dataclasses.replace(ecfg.generation, fast_edit=False))
    keep = regions == 0
    out = {"frozen_chunks": int(sum(sched)), "chunks": len(sched),
           "regenerated": int((~keep).sum())}
    fp32 = copy.deepcopy(model).float()
    for label, m in (("bf16", model), ("fp32", fp32)):
        tokens = {}
        for name, c in (("fast", ecfg), ("standard", std_cfg), ("fast", ecfg)):
            p = teval.build_pipeline(c, model=m, device=next(m.parameters()).device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = p.edit_image(captions, groundings, images, regions, **kw)
            torch.cuda.synchronize()
            out[f"{label}_{name}_s"] = time.perf_counter() - t0
            tokens[name] = got.image_tokens
        with torch.inference_mode():
            vq = m.gen_vision_model
            codes = vq.encode_to_indices(torch.from_numpy(images).to(
                device=next(vq.parameters()).device,
                dtype=next(vq.parameters()).dtype)).cpu().numpy()
        for name, toks in tokens.items():
            check(bool((toks[keep] == codes[keep]).all()),
                  f"{task} {label} {name}: forced tokens differ from the VQ codes")
        differ = tokens["fast"] != tokens["standard"]
        out[f"{label}_differing_tokens"] = int(differ.sum())
        if label == "bf16":
            out.update(time_frozen_chunk(torch, p, (captions, groundings, images, regions, kw)))
        log(f"[11] {task} {label}, {bs} images, {int(sum(sched))} of {len(sched)} chunks "
            f"frozen: fast_edit {out[f'{label}_fast_s']:.3f} s/call (second call) against "
            f"standard {out[f'{label}_standard_s']:.3f} ({out[f'{label}_standard_s'] / out[f'{label}_fast_s']:.2f}x); "
            f"forced tokens all the VQ codes; {int(differ.sum())} of {int((~keep).sum())} "
            "regenerated tokens differ between the two")
    check(out["fp32_differing_tokens"] == 0,
          f"{task} fp32: fast_edit and the standard loop differ in "
          f"{out['fp32_differing_tokens']} tokens")
    del fp32
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phases 13, 14

SPEC_DRAFT_LAYERS, SPEC_DRAFT_LEN = 8, 4
SPEC_EAGER_TOKENS = 32  # graph against eager rounds: the first 32 tokens
JACOBI_FP32_BUDGET = 64
TIMED_REPLAYS = 32  # replays timed by CUDA events


class ReplayTimer:
    """While the `with` block lasts, every `StepGraph.replay` leaves its
    host clock at its start in `starts` and, for the first TIMED_REPLAYS,
    CUDA events around it in `pairs`; the first graph's capture +
    instantiate ms goes to `capture_ms`."""

    def __init__(self, torch):
        self.torch, self.starts, self.pairs, self.capture_ms = torch, [], [], None

    def __enter__(self):
        from plangen_tpu_torch.runtime import cuda_graph

        self.cls, replay = cuda_graph.StepGraph, cuda_graph.StepGraph.replay
        self.replay = replay

        def timed(graph):
            if self.capture_ms is None:
                self.capture_ms = graph.capture_ms
            pair = None
            if len(self.pairs) < TIMED_REPLAYS:
                pair = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
                pair[0].record()
            self.starts.append(time.perf_counter())
            replay(graph)
            if pair is not None:
                pair[1].record()
                self.pairs.append(pair)

        self.cls.replay = timed
        return self

    def __exit__(self, *exc):
        self.cls.replay = self.replay

    def device_ms(self) -> float:
        self.torch.cuda.synchronize()
        if not self.pairs:
            return float("nan")
        return sum(a.elapsed_time(b) for a, b in self.pairs) / len(self.pairs)

    def host_ms(self) -> float:
        """Host ms from one replay's start to the next's: the host's read of
        n between rounds included."""
        if len(self.starts) < 2:
            return float("nan")
        return (self.starts[-1] - self.starts[0]) * 1e3 / (len(self.starts) - 1)


class DecoderCalls:
    """While the `with` block lasts, every call the pipeline makes to the
    decoder entry point `name` (`generate_image_tokens_spec` or
    `jacobi_decode_text`) is timed whole, by two CUDA events and the host
    clock, and leaves `(steps, device_ms, host_ms)` in `calls`: a
    speculative call's rounds, or a Jacobi call's passes (the decoder's own
    count, through `return_iters=True`)."""

    def __init__(self, torch, name: str):
        self.torch, self.name, self.calls = torch, name, []

    def __enter__(self):
        from plangen_tpu_torch.tasks import pipeline

        self.mod, inner = pipeline, getattr(pipeline, self.name)
        self.inner = inner
        jacobi = self.name == "jacobi_decode_text"

        def timed(*args, **kw):
            start, end = (self.torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            out = inner(*args, **kw, **({"return_iters": True} if jacobi else {}))
            end.record()
            end.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            out, steps = out if jacobi else (out, out.rounds)
            self.calls.append((int(steps), start.elapsed_time(end), host_ms))
            return out

        setattr(pipeline, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.inner)

    def per_step(self) -> tuple:
        """(steps, device ms a step, host ms a step) over every call."""
        steps = sum(c[0] for c in self.calls)
        return (steps, sum(c[1] for c in self.calls) / steps,
                sum(c[2] for c in self.calls) / steps)


def first_difference(a, b) -> str:
    """Where two token rows first part, or "equal"."""
    import numpy as np

    diff = np.flatnonzero(np.asarray(a) != np.asarray(b))
    return "equal" if not len(diff) else f"column {diff[0]} ({a[diff[0]]} vs {b[diff[0]]})"


def phase_decoders(torch, pipe, cfg) -> dict:
    """[13] The opt-in decoders at Janus-Pro-1B width on the phase-4 model:
    speculative `layout_to_image` x1 in bf16 (K 8, d 4) against the graph
    base loop (K1 launches d x K a round, no plain call; graph rounds
    against the eager round loop, bitwise, over the first 32 tokens); on an
    fp32 copy, a full-depth draft bitwise equal to the graph base loop at
    temperature 1 in ceil(575 / 5) rounds and K 8 greedy equal to base
    greedy; Jacobi `plan` x4 at budget 512 in bf16 against the graph text
    loop (the decoder's passes, ms a pass from the whole call, where each
    row first parts), and at budget 64 in fp32 equal to it. Returns the
    launches by kernel of the speculative pipeline call."""
    import dataclasses

    from plangen_tpu_torch.runtime.generate import generate_image_tokens
    from plangen_tpu_torch.runtime.speculative import generate_image_tokens_spec
    from plangen_tpu_torch.tasks.pipeline import PlanGenPipeline

    card = nvidia_smi_line()
    t_phase = time.perf_counter()
    dev = pipe.device
    K, d, L, N = SPEC_DRAFT_LAYERS, SPEC_DRAFT_LEN, cfg.llama.num_layers, cfg.image_seq_len
    one = (CAPTIONS[:1], GROUNDINGS[:1])

    def variant(p, **kw):
        return PlanGenPipeline(p.model, cfg, p.proc, gen_cfg=dataclasses.replace(p.gen, **kw))

    # speculative through the pipeline, against the graph base loop
    spipe = variant(pipe, speculative=True, spec_draft_layers=K, spec_draft_len=d)
    base, base_s, base_launches, _, _ = counted(
        torch, dev, lambda: pipe.layout_to_image(*one, seeds=SEEDS[:1]))
    with DecoderCalls(torch, "generate_image_tokens_spec") as sc, ReplayTimer(torch) as rt:
        out, spec_s, launches, plain, tc = counted(
            torch, dev, lambda: spipe.layout_to_image(*one, seeds=SEEDS[:1]))
    check(len(sc.calls) == 1, f"{len(sc.calls)} speculative calls for one image")
    rounds = sc.calls[0][0]
    want = dict.fromkeys(kernel_counters(), 0)
    want["prefix_decode_attention"] = rounds * d * K
    check_launches("13", f"speculative x1 (K {K}, d {d}, {rounds} rounds)", launches, want,
                   plain, tc)
    check(base_launches["prefix_decode_attention"] == N * L, f"base: {base_launches}")
    check_image_output(cfg, out, 1)
    log(f"[13] speculative layout_to_image x1, bf16, K {K}, d {d}: {spec_s:.3f} s/call "
        f"against the graph base loop's {base_s:.3f} ({card}); {rounds} rounds, "
        f"{(N - 1) / rounds:.3f} tokens a round after token 0; a round: device "
        f"{rt.device_ms():.3f} ms (events over {len(rt.pairs)} replays), host "
        f"{rt.host_ms():.3f} ms (start to start, n read); capture + instantiate "
        f"{rt.capture_ms or float('nan'):.1f} ms; tokens parting from the base loop's at "
        f"{first_difference(out.image_tokens[0], base.image_tokens[0])}")

    def spec_call(model, embeds, mask, temperature, layers, eager, n_tok):
        g = (None if temperature == 0
             else torch.Generator(device=dev).manual_seed(SEEDS[0]))
        res = generate_image_tokens_spec(model, cfg, embeds, mask, g, pipe.gen.cfg_weight,
                                         temperature, num_tokens=n_tok, draft_layers=layers,
                                         draft_len=d, eager=eager)
        return res.tokens.cpu(), res.rounds

    prep = spipe.prepare_layout_to_image(*one, seeds=SEEDS[:1])
    n = min(SPEC_EAGER_TOKENS, N)
    mask_n = prep.cfg_mask[:, :prep.embeds.shape[1] + n]
    times = {}
    for eager in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        times[eager] = spec_call(spipe.model, prep.embeds, mask_n, 1.0, K, eager, n)
        torch.cuda.synchronize()
        times[eager] += (time.perf_counter() - t0,)
    (e_tok, e_rounds, e_s), (g_tok, g_rounds, g_s) = times[True], times[False]
    check(torch.equal(g_tok, e_tok) and g_rounds == e_rounds,
          f"speculative graph against eager rounds: {first_difference(g_tok[0], e_tok[0])}, "
          f"rounds {g_rounds} vs {e_rounds}")
    log(f"[13] speculative, first {n} tokens: graph rounds bitwise equal to the eager round "
        f"loop's ({g_rounds} rounds; graph {g_s:.3f} s, eager {e_s:.3f} s)")

    # the identities, on an fp32 copy
    t_fp32 = time.perf_counter()
    model32 = copy.deepcopy(pipe.model).float()
    e32 = prep.embeds.float()
    base32 = generate_image_tokens(model32, cfg, e32, prep.cfg_mask,
                                   torch.Generator(device=dev).manual_seed(SEEDS[0]),
                                   pipe.gen.cfg_weight, 1.0, num_tokens=N).cpu()
    full, full_rounds = spec_call(model32, e32, prep.cfg_mask, 1.0, L, False, N)
    check(torch.equal(full, base32), "fp32 full-depth draft against the base loop: "
          + first_difference(full[0], base32[0]))
    check(full_rounds == -(-(N - 1) // (d + 1)), f"full-depth rounds {full_rounds}")
    greedy32 = generate_image_tokens(model32, cfg, e32, prep.cfg_mask, None,
                                     pipe.gen.cfg_weight, 0.0, num_tokens=N).cpu()
    spec_greedy, greedy_rounds = spec_call(model32, e32, prep.cfg_mask, 0.0, K, False, N)
    check(torch.equal(spec_greedy, greedy32), "fp32 greedy K 8 against base greedy: "
          + first_difference(spec_greedy[0], greedy32[0]))
    log(f"[13] fp32: full-depth draft (K {L}) bitwise equal to the graph base loop at "
        f"temperature 1 in {full_rounds} rounds; K {K} greedy equal to base greedy in "
        f"{greedy_rounds} rounds ({time.perf_counter() - t_fp32:.1f} s for the four calls)")

    # Jacobi against the graph text loop
    jpipe = variant(pipe, jacobi=True)
    with TextTokens(pipe) as runs:
        _, graph_s, _, _, _ = counted(torch, dev, lambda: pipe.plan(CAPTIONS))
    graph_tokens = runs[0].cpu().numpy()
    with TextTokens(jpipe) as runs, DecoderCalls(torch, "jacobi_decode_text") as jc:
        plans, jac_s, jac_launches, plain, _ = counted(torch, dev, lambda: jpipe.plan(CAPTIONS))
    check(len(jc.calls) == 1, f"{len(jc.calls)} Jacobi calls for one plan batch")
    passes, pass_device_ms, pass_host_ms = jc.per_step()
    jac_tokens = runs[0].cpu().numpy()
    check(jac_tokens.shape == graph_tokens.shape and str(jac_tokens.dtype) == "int32",
          f"Jacobi tokens {jac_tokens.dtype} {jac_tokens.shape}")
    check(int(jac_tokens.min()) >= 0 and int(jac_tokens.max()) < cfg.llama.vocab_size,
          "Jacobi tokens out of the vocabulary")
    check(sum(jac_launches.values()) == 0 and plain == 0,
          f"Jacobi launched {jac_launches}, plain {plain}: it attends densely")
    check(len(plans) == len(CAPTIONS), f"Jacobi plans: {plans}")
    parts = [first_difference(j, g) for j, g in zip(jac_tokens, graph_tokens)]
    log(f"[13] Jacobi plan x4, bf16, budget {graph_tokens.shape[1]}: {jac_s:.3f} s/call "
        f"against the graph text loop's {graph_s:.3f} ({card}); {passes} passes; a "
        f"pass: device {pass_device_ms:.3f} ms, host {pass_host_ms:.3f} ms (the whole "
        f"decoder call over its passes); rows part from the graph loop at: {parts}")

    gen64 = dict(max_new_text_tokens=JACOBI_FP32_BUDGET)
    p32 = PlanGenPipeline(model32, cfg, pipe.proc,
                          gen_cfg=dataclasses.replace(pipe.gen, **gen64))
    j32 = variant(p32, jacobi=True)
    with TextTokens(p32) as seq_runs:
        p32.plan(CAPTIONS)
    with TextTokens(j32) as jac_runs, DecoderCalls(torch, "jacobi_decode_text") as jc32:
        j32.plan(CAPTIONS)
    check(torch.equal(jac_runs[0].cpu(), seq_runs[0].cpu()),
          "fp32 Jacobi against the graph text loop: " + str(
              [first_difference(a, b) for a, b in zip(jac_runs[0].cpu().numpy(),
                                                      seq_runs[0].cpu().numpy())]))
    log(f"[13] Jacobi plan x4, fp32, budget {JACOBI_FP32_BUDGET}: tokens equal to the graph "
        f"text loop's in {jc32.per_step()[0]} passes")
    del model32, p32, j32
    torch.cuda.empty_cache()
    log(f"[13] phase 13: {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_artifacts(torch, dev, checkout) -> dict:
    """[14] The weight artifacts at Janus-Pro-1B width, from phase 10's
    `.bin` checkout: `cli convert` plain and `--quantize int4` (fp32, the
    command's only form), `build_pipeline` from each `params_path` (weights
    bitwise equal to the `janus_path` model and to its int4 form quantized
    in place by convert's rule, `quantize_model_(eager=True)`: the
    pipeline's own in-place quantization follows JAX's jitted rule, a
    scale one rounding apart in some channels; load s and size on disk),
    the int4 artifact's `plan` x4 against that in-place int4 pipeline's
    (launches and tokens equal); `cli export` of the model
    (fp32 safetensors) read back through `load_params`, bitwise equal to
    the model's fp32 state dict. Returns the launches of the artifact's
    `plan`."""
    import contextlib
    import copy
    import dataclasses
    import io
    import shutil
    import tempfile

    from plangen_tpu_torch import cli
    from plangen_tpu_torch.config import GenerationConfig, PlanGenConfig, PlanGenModelConfig
    from plangen_tpu_torch.convert.loading import load_params
    from plangen_tpu_torch.ops.quant import quant_form, quantize_model_
    from plangen_tpu_torch.tasks.eval import build_pipeline

    card = nvidia_smi_line()
    t_phase = time.perf_counter()
    mcfg = PlanGenModelConfig()  # Janus-Pro-1B widths
    gen = GenerationConfig(cfg_weight=5.0, temperature=1.0)

    def run_cli(argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        torch.cuda.synchronize()
        return json.loads(buf.getvalue().strip().splitlines()[-1]), time.perf_counter() - t0

    def timed_pipeline(generation=gen, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = build_pipeline(PlanGenConfig(model=mcfg, generation=generation, **kw), device=dev)
        torch.cuda.synchronize()
        return p, time.perf_counter() - t0

    def gib(path: pathlib.Path) -> float:
        files = [path] if path.is_file() else [f for f in path.rglob("*") if f.is_file()]
        return sum(f.stat().st_size for f in files) / 2**30

    def same_weights(what, got, want):
        got, want = got.state_dict(), want.state_dict()
        check(sorted(got) == sorted(want), f"{what}: keys differ")
        for k, v in want.items():
            check(got[k].dtype == v.dtype and torch.equal(got[k], v),
                  f"{what}: {k} is not bitwise equal")
        return len(want)

    bins = sorted(checkout.glob("pytorch_model-*.bin"))
    ref, janus_s = timed_pipeline(janus_path=str(checkout))
    log(f"[14] build_pipeline from the janus_path checkout: {janus_s:.2f} s "
        f"({sum(gib(b) for b in bins):.2f} GiB of .bin shards); {card}")
    launches = dict.fromkeys(kernel_counters(), 0)
    with tempfile.TemporaryDirectory(prefix="plangen_artifacts_") as tmp:
        tmp = pathlib.Path(tmp)
        for form in (None, "int4"):
            out = tmp / f"params_{form or 'dense'}"
            printed, convert_s = run_cli(
                ["convert", "--janus-path", str(checkout), "--out", str(out)]
                + (["--quantize", form] if form else []))
            check(printed["saved"] == str(out.resolve()), f"convert printed {printed}")
            art, load_s = timed_pipeline(params_path=str(out))
            check(quant_form(art.model) == form and art.gen.quantize == form,
                  f"artifact form {quant_form(art.model)}, pipeline {art.gen.quantize}")
            if form is None:
                n = same_weights("fp32 artifact in bf16", art.model, ref.model)
                log(f"[14] cli convert (fp32): {convert_s:.2f} s, {printed['params_m']} M "
                    f"parameters, {gib(out):.2f} GiB; build_pipeline from params_path "
                    f"{load_s:.2f} s (janus_path {janus_s:.2f} s); {n} tensors bitwise equal "
                    f"to the janus_path model's; {card}")
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                inplace = build_pipeline(
                    PlanGenConfig(model=mcfg, generation=dataclasses.replace(gen, quantize=form)),
                    model=quantize_model_(copy.deepcopy(ref.model), form, eager=True),
                    device=dev)
                torch.cuda.synchronize()
                inplace_s = time.perf_counter() - t0
                n = same_weights("int4 artifact", art.model, inplace.model)
                plan_len = art.proc.stage1_batch(CAPTIONS, art.gen.max_new_text_tokens)[0].shape[1]
                plans = []
                for tag, p in (("int4 artifact", art), ("in-place int4", inplace)):
                    plans.append(text_call(torch, p, mcfg, "14", f"{tag} plan x4",
                                           lambda p=p: p.plan(CAPTIONS), len(CAPTIONS),
                                           plan_len))
                (_, a_tok, a_launches, a_s), (_, b_tok, b_launches, b_s) = plans
                check(a_launches == b_launches, f"int4 plans: {a_launches} vs {b_launches}")
                check(bool((a_tok == b_tok).all()), "int4 plans: tokens differ")
                add_launches(launches, a_launches)
                log(f"[14] cli convert --quantize int4: {convert_s:.2f} s, "
                    f"{printed['params_m']} M stored elements, {gib(out):.2f} GiB; "
                    f"build_pipeline from params_path {load_s:.2f} s (a copy of the janus_path "
                    f"model quantized in place {inplace_s:.2f} s); {n} tensors bitwise equal to "
                    f"the in-place int4 form's (convert's rule); plan x4 {a_s:.3f} s/call "
                    f"(in-place {b_s:.3f}), launches and "
                    f"tokens equal; {card}")
                del inplace
            del art
            torch.cuda.empty_cache()
            shutil.rmtree(out)

        export = tmp / "export"
        export.mkdir()
        printed, export_s = run_cli(["export", "--opt", f"janus_path={checkout}", "--out",
                                     str(export / "model.safetensors")])
        check(printed["keys"] == len(ref.model.state_dict()), f"export printed {printed}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = load_params(PlanGenConfig(model=mcfg, janus_path=str(export)), device=dev,
                           dtype=torch.float32)
        back_s = time.perf_counter() - t0
        n = same_weights("export", back, copy.deepcopy(ref.model).float())
        log(f"[14] cli export (fp32 safetensors): {export_s:.2f} s, {printed['keys']} keys, "
            f"{gib(export):.2f} GiB; read back through load_params in {back_s:.2f} s, {n} "
            f"tensors bitwise equal to the model's fp32 state dict; {card}")
        del back
    del ref
    torch.cuda.empty_cache()
    log(f"[14] phase 14: {time.perf_counter() - t_phase:.1f} s")
    return launches


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

    start = last = time.perf_counter()

    def mark(what: str) -> None:  # the smoke's own time, phase by phase
        nonlocal last
        now = time.perf_counter()
        log(f"[time] {what}: {now - last:.1f} s ({now - start:.1f} s in all)")
        last = now

    phase_header(torch)
    phase_build()
    mark("1-2 header and build")

    dev = torch.device("cuda:0")
    pipe, cfg = build_pipeline(torch, dev, output_uint8=False)
    ids, mask = pipe.proc.uni_batch(CAPTIONS, GROUNDINGS)
    prompt_len = pipe.proc.cfg_batch(ids, mask)[0].shape[1]
    k1 = phase_kernel_vs_plain(torch, prompt_len, dev)
    # K1 at the plan cache: the 4-caption stage-1 prompt and its budget,
    # the first text decode step (q_pos = L)
    from plangen_tpu_torch.runtime.generate import cache_length

    budget = pipe.gen.max_new_text_tokens
    plan_ids, plan_mask = pipe.proc.stage1_batch(CAPTIONS, budget)
    plan_len = plan_ids.shape[1]
    S_plan = cache_length(plan_len, budget)
    plan_mask = torch.nn.functional.pad(torch.from_numpy(plan_mask).to(dev),
                                        (0, S_plan - plan_mask.shape[1]))
    log(f"[3] K1 at the plan cache: 4 rows, prompt {plan_len} + budget {budget} -> S={S_plan}")
    k1_plan = phase_kernel_vs_plain(torch, plan_len, dev, dict(KERNEL_SHAPE, B=4, S=S_plan),
                                    q_positions=[plan_len], mask=plan_mask.contiguous())
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_plan["max_abs_err"])
    mark("3 K1")

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
    bf16, decoded = run_slice(torch, pipe, cfg, CAPTIONS, GROUNDINGS, SEEDS)
    pipe_u8, _ = build_pipeline(torch, dev, output_uint8=True, model=pipe.model)
    bf16_1, _ = run_slice(torch, pipe_u8, cfg, CAPTIONS[:1], GROUNDINGS[:1], SEEDS[:1])
    log(f"[4] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    launches = add_launches(dict.fromkeys(bf16, 0), bf16, bf16_1)
    del pipe_u8
    torch.cuda.reset_peak_memory_stats()
    add_launches(launches, phase_text_paths(torch, pipe, cfg, decoded.images))
    log(f"[4b] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del decoded
    mark("4, 4b")
    phase_text_graphs(torch, pipe, cfg, "4d", CAPTIONS, more=True)
    # 4 requests only: the 1-request comparison (~30 s) is left out to keep
    # the smoke within its time limit (phase 4 runs 1 request on the graph)
    phase_graph_vs_eager(torch, pipe, cfg, "4c", 4, GRAPH_TURNS)
    mark("4d, 4c")
    add_launches(launches, phase_eval(torch, pipe, cfg))
    mark("11")
    add_launches(launches, phase_decoders(torch, pipe, cfg))
    mark("13")

    int4 = phase_int4_vs_plain(torch, dev)
    k1q8 = phase_k1_q8_vs_plain(torch, prompt_len, dev)
    mark("5, 6")

    # the same seeded model, quantized in place (the bf16 phases are done)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    qpipe, _ = quantized_pipeline(torch, dev, "int4", model=pipe.model)
    del pipe
    k1q8["max_abs_err"] = max(k1q8["max_abs_err"], check_q8_prefill_cache(torch, qpipe, cfg))
    q4, _ = run_slice(torch, qpipe, cfg, CAPTIONS, GROUNDINGS, SEEDS)
    q4_plan = quantized_plan(torch, qpipe, cfg, CAPTIONS)
    log(f"[7] int4: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    phase_text_graphs(torch, qpipe, cfg, "7d", CAPTIONS)
    phase_graph_vs_eager(torch, qpipe, cfg, "7c", 4, GRAPH_TURNS)
    del qpipe
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    apipe, _ = quantized_pipeline(torch, dev, "int4_a8")
    a8, _ = run_slice(torch, apipe, cfg, CAPTIONS[:1], GROUNDINGS[:1], SEEDS[:1])
    a8_plan = quantized_plan(torch, apipe, cfg, CAPTIONS[:1])
    log(f"[7] int4_a8: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # 7c and 7d run on int4 only: int4_a8's eager image and text calls
    # (~38 and ~30 s) are left out to keep the smoke within its time limit;
    # its graph calls above and phase 15f's, and the card tests' graph
    # against eager cases, stay
    add_launches(launches, q4, q4_plan, a8, a8_plan)
    del apipe
    torch.cuda.empty_cache()
    mark("7")
    k1a8 = phase_k1_a8_vs_plain(torch, prompt_len, dev)
    kv_a8_launches, _ = phase_kv_a8(torch, dev)
    add_launches(launches, kv_a8_launches)
    mark("16")

    flash = phase_flash_vs_plain(torch, dev)
    torch.cuda.empty_cache()
    mark("8")
    add_launches(launches, phase_training(torch, dev))
    torch.cuda.empty_cache()
    mark("9")
    add_launches(launches, phase_train_options(torch, dev))
    torch.cuda.empty_cache()
    mark("12")
    add_launches(launches, phase_parallel(torch, dev))
    mark("15")
    import tempfile

    with tempfile.TemporaryDirectory(prefix="plangen_ckpt_") as checkout:
        add_launches(launches, phase_serving(torch, dev, pathlib.Path(checkout)))
        mark("10")
        add_launches(launches, phase_artifacts(torch, dev, pathlib.Path(checkout)))
        mark("14")

    kernels = [
        ("prefix_decode_attention", "prefix_decode_attention.cu",
         "plangen_tpu/ops/pallas_decode_attention.py:31", k1),
        ("prefix_decode_attention_q8", "prefix_decode_attention.cu",
         "plangen_tpu/ops/pallas_decode_attention.py:31", k1q8),
        # no Pallas kernel: the XLA s8 einsums of dot_product_attention_q8(a8=True)
        ("prefix_decode_attention_a8", "prefix_decode_attention_a8.cu",
         "plangen_tpu/ops/attention.py:229", k1a8),
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
        **{k: v for k, v in stats.items() if k.endswith("_by_rows")},
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
