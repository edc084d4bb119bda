"""Typed configuration system.

A copy of `plangen_tpu/config.py` (the port imports nothing of the JAX
package): the same dataclasses, fields, defaults and constructors, and
the same `apply_overrides` / `validate_config`, so a config reads the
same in both packages; tests/test_torch_copies.py holds the two equal.

Replaces the reference's mmengine flat-namespace configs
(reference: project/plangen/cfg/base.py, train.py:23-49) with frozen
dataclasses plus the same CLI ergonomics: dotted-key overrides
(``--opt test_data.task_type=uni``) deep-merge into the config tree.

Dead reference flags (use_2d_rope, beam_search, use_showo, trans_data_to_rm,
O1..O4, score_*, ...) are intentionally not carried over
(reference cfg/base.py documents them but no code path reads them).
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field, fields, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LlamaConfig:
    """Janus-Pro-1B language backbone (DeepSeek-LLM-1.3B architecture).

    Dims per the HF `deepseek-ai/Janus-Pro-1B` language_config; vocab size is
    also visible in the reference (plangen_base.py:881 logits comment: 102400).
    """

    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 24
    num_heads: int = 16
    num_kv_heads: int = 16
    head_dim: int = 128
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    max_position_embeddings: int = 16384

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclass(frozen=True)
class SigLIPConfig:
    """SigLIP-Large-patch16-384 understanding tower.

    Reference: three_party/Janus/janus/models/siglip_vit.py:628-637
    (width 1024 / 24 layers / 16 heads / mlp_ratio 4, no class token,
    attn-pool head dropped because ignore_head=True).
    """

    image_size: int = 384
    patch_size: int = 16
    width: int = 1024
    layers: int = 24
    heads: int = 16
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclass(frozen=True)
class VQConfig:
    """LlamaGen VQ-16 image tokenizer.

    Reference: three_party/Janus/janus/models/vq_model.py:31-43,519-524
    (codebook 16384 x 8, l2-normalized; ch 128, ch_mult [1,1,2,2,4],
    2 res blocks per level, z_channels 256, GroupNorm(32, eps 1e-6), swish).
    """

    codebook_size: int = 16384
    codebook_dim: int = 8
    l2_norm: bool = True
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    z_channels: int = 256
    out_channels: int = 3
    group_norm_groups: int = 32
    group_norm_eps: float = 1e-6
    commit_beta: float = 0.25

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)


@dataclass(frozen=True)
class ProjectorConfig:
    """MLP projector (reference: janus/models/projector.py:27-86)."""

    projector_type: str = "mlp_gelu"
    input_dim: int = 1024
    n_embed: int = 2048
    depth: int = 2


@dataclass(frozen=True)
class PlanGenModelConfig:
    """Composition root matching MultiModalityCausalLM submodules.

    Reference: janus/models/modeling_vlm.py:190-219.
    """

    llama: LlamaConfig = field(default_factory=LlamaConfig)
    vision: SigLIPConfig = field(default_factory=SigLIPConfig)
    vq: VQConfig = field(default_factory=VQConfig)
    aligner: ProjectorConfig = field(
        default_factory=lambda: ProjectorConfig(input_dim=1024, n_embed=2048, depth=2)
    )
    gen_aligner: ProjectorConfig = field(
        default_factory=lambda: ProjectorConfig(input_dim=8, n_embed=2048, depth=2)
    )
    # gen_head: Linear(n_embed -> image_token_embed) -> GELU -> Linear(-> image_token_size)
    # reference: janus/models/modeling_vlm.py:36-51
    image_token_embed: int = 2048
    image_token_size: int = 16384
    # gen_embed: Embedding(image_token_size, n_embed=8), modeling_vlm.py:214-216
    gen_embed_dim: int = 8

    def __post_init__(self):
        # the gen_head samples ids that index the VQ codebook at detokenize
        # time; a size mismatch makes the codebook gather go out of bounds,
        # which jnp's fill-mode take turns into SILENT NaN pixels
        if self.image_token_size != self.vq.codebook_size:
            raise ValueError(
                f"image_token_size ({self.image_token_size}) must equal "
                f"vq.codebook_size ({self.vq.codebook_size}): generated ids "
                "index the VQ codebook"
            )

    @property
    def image_seq_len(self) -> int:
        """576 image tokens for 384px (patch 16). plangen_base.py:129-132."""
        return (self.vision.image_size // self.vision.patch_size) ** 2

    @staticmethod
    def janus_pro_7b() -> "PlanGenModelConfig":
        """Janus-Pro-7B dims (deepseek-ai/Janus-Pro-7B HF config): the
        DeepSeek-LLM-7B backbone; SigLIP tower and VQ tokenizer are shared
        with 1B. The reference pins 1B (cfg/base.py:12) but the converter
        and every runtime path are dimension-agnostic, so the larger family
        member works end to end (serve it with tensor parallelism: bf16
        weights alone are ~15 GB, one v5e chip holds the model but not the
        batch-32 KV cache)."""
        return PlanGenModelConfig(
            llama=LlamaConfig(
                hidden_size=4096,
                intermediate_size=11008,
                num_layers=30,
                num_heads=32,
                num_kv_heads=32,
                head_dim=128,
            ),
            aligner=ProjectorConfig(input_dim=1024, n_embed=4096, depth=2),
            gen_aligner=ProjectorConfig(input_dim=8, n_embed=4096, depth=2),
            image_token_embed=4096,
        )

    @staticmethod
    def tiny() -> "PlanGenModelConfig":
        """A CPU-testable model with the same topology (for tests/CI)."""
        return PlanGenModelConfig(
            llama=LlamaConfig(
                vocab_size=512,
                hidden_size=64,
                intermediate_size=128,
                num_layers=2,
                num_heads=4,
                num_kv_heads=4,
                head_dim=16,
            ),
            vision=SigLIPConfig(
                image_size=32, patch_size=16, width=32, layers=2, heads=2
            ),
            # downsample 16x (5 levels) so the VQ grid matches the patch-16
            # image-token grid, like the real VQ-16 does at 384px
            vq=VQConfig(
                codebook_size=64,
                codebook_dim=8,
                ch=8,
                ch_mult=(1, 1, 1, 1, 2),
                num_res_blocks=1,
                z_channels=16,
                group_norm_groups=4,
            ),
            aligner=ProjectorConfig(input_dim=32, n_embed=64, depth=2),
            gen_aligner=ProjectorConfig(input_dim=8, n_embed=64, depth=2),
            image_token_embed=64,
            image_token_size=64,
            gen_embed_dim=8,
        )

    @staticmethod
    def tiny_7b() -> "PlanGenModelConfig":
        """CPU-testable model with the 7B family member's SHAPE relationships
        (janus_pro_7b: deeper stack, more heads, non-2x MLP ratio, wider
        image_token_embed) at tiny dims — cross-implementation parity on this
        preset proves no 1B dimension is hardcoded anywhere in the stack
        (three_party/Janus/README.md:115 lists the 7B member)."""
        t = PlanGenModelConfig.tiny()
        return dataclasses.replace(
            t,
            llama=LlamaConfig(
                vocab_size=512,
                hidden_size=96,
                intermediate_size=224,   # ~2.33x, like 11008/4096
                num_layers=3,            # deeper than tiny's 2
                num_heads=6,             # 7B: more heads, same head_dim story
                num_kv_heads=6,
                head_dim=16,
            ),
            aligner=dataclasses.replace(t.aligner, n_embed=96),
            gen_aligner=dataclasses.replace(t.gen_aligner, n_embed=96),
            image_token_embed=96,
        )


# ---------------------------------------------------------------------------
# Generation / task / train configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GenerationConfig:
    """Decode-loop knobs (reference defaults: plangen_base.py:336-338, cfg/base.py)."""

    cfg_weight: float = 5.0
    temperature: float = 1.0
    parallel_size: int = 1          # sampling width, cfg/base.py:158
    max_new_text_tokens: int = 512  # layout/MMU budget, plangen_base.py:520
    # (the image-token count is NOT a generation knob: it is
    # model.image_seq_len, derived from the vision/VQ geometry — a dead
    # `image_tokens` field here once let `--opt generation.image_tokens=`
    # validate and silently no-op)
    seed: int = 0
    use_teacher_forcing: bool = False
    use_neg_box: bool = False
    pad_edit_box: float = 0.0
    quantize: Optional[str] = None  # 'int8' = int8 weights + int8 KV cache;
    # 'int4' = packed-int4 weights (Pallas kernel) + int8 KV cache;
    # 'int4_a8' = int4 weights + int8 activations (s8 MXU dots) + int8 KV;
    # 'int8_kv' = bf16 weights + int8 KV cache only (the measured-best
    # large-batch serving config: at B>=48 images the 96+ CFG-row matmuls
    # run FASTER from bf16 weights than from any quantized form —
    # BENCH_SWEEP.json decode rows / step_budget);
    # 'auto' = dual-resident bf16 + int4 weight trees (int8 KV either way),
    # routed per batch at the measured crossover: <= auto_int4_max_rows
    # matmul rows decode from int4 (latency-bound, weight reads dominate),
    # above it from bf16 (throughput-bound, MXU int-operand rate dominates).
    # The int4 tree shares every non-LM subtree with the dense tree by
    # reference, so the extra residency is only the packed LM weights
    # (~0.7 GB for 1B); rejected at load for 7B-scale models where the
    # dense tree alone nearly fills one chip (tasks/eval.py).
    auto_int4_max_rows: int = 64  # routing threshold in MATMUL ROWS (images
    # x 2 CFG x parallel_size for image decode, rows for text decode):
    # B=32 images -> 64 rows int4 wins (3322 vs 2931 tok/s); B=64 -> 128
    # rows bf16+int8KV wins (4281 vs 3732) — BENCH_SWEEP.json
    # s8 x s8 MXU dots in decode-step attention over the int8 KV cache
    # (quantized query/probability rows). MEASURED SLOWER and kept flag-off
    # with exactness tests: decode attention at M=1 is MXU element-rate
    # bound, int8 operands stream at ~the bf16 rate, and the attention
    # einsum's int8 operand re-layouts dominate (DESIGN.md §8, closed by
    # tools/bench_mxu_stream.py). Requires `quantize` set.
    kv_a8: bool = False
    # concat the dense q|k|v (GQA: k|v) leaves into the fused key the layer
    # already consumes: ONE [I, 3H] dot instead of three [I, H] dots —
    # bit-identical (columns are independent, same K accumulation;
    # tests/test_dense_fuse.py). MEASURED MIXED e2e and kept OFF: the
    # same-hour A/B on int8_kv (BENCH_NO_FUSE rows vs fused) showed B=1
    # +26% (254 vs 201 tok/s) but B=32 -6% and B=64 -20% (3445 vs 4278) —
    # the isolated layer microbench's 1.13-1.19x (tools/bench_dense_fuse
    # .py) does not survive the real program at M>=64, where the fused
    # output's split/reshape costs more than the dot saves. The B=1 regime
    # this helps is already owned by the int4 route (664 tok/s), so the
    # flag stays opt-in for pure-bf16 B=1 latency setups only.
    fuse_dense_qkv: bool = False
    fast_edit: bool = False  # prefill frozen runs during teacher-forced editing
    # segmented growing KV cache: ~23% faster decode at B=32, token streams
    # matched the fixed buffer in every test and on-chip run
    # (docs/DESIGN.md); disable to get the single fixed-buffer program
    growing_cache: bool = True
    # convert generated pixels to uint8 ON DEVICE (4x smaller host fetch;
    # bit-identical to the host save conversion). Off = float [-1, 1] API.
    output_uint8: bool = False
    # self-speculative decoding (B=1 only, runtime/speculative.py):
    # distribution-exact; speed depends on trained-weight draft agreement
    speculative: bool = False
    # Jacobi parallel decoding for the GREEDY text paths (plan/mmu,
    # runtime/jacobi.py): token-exact at the fixed point; speed depends on
    # trained-weight convergence (random weights: no win)
    jacobi: bool = False
    spec_draft_layers: int = 8
    spec_draft_len: int = 4
    # long negative prompt, cfg/base.py `neg_prompt`
    neg_prompt: str = (
        "low quality, jpeg artifacts, ugly, duplicate, morbid, mutilated, extra "
        "fingers, mutated hands, poorly drawn hands, poorly drawn face, mutation, "
        "deformed, blurry, dehydrated, bad anatomy, bad proportions, extra limbs, "
        "cloned face, disfigured, gross proportions, malformed limbs, missing arms, "
        "missing legs, extra arms, extra legs, fused fingers, too many fingers."
    )


@dataclass(frozen=True)
class FlowConfig:
    """One training data flow (reference: cfg train_data entries)."""

    task_type: str = "uni"  # uni | mmu | plan | t2i
    data_name: Any = "toy"
    batch_size: int = 2


@dataclass(frozen=True)
class OptimConfig:
    """AdamW recipe (reference: cfg/base.py:53-60)."""

    learning_rate: float = 5e-5
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    adam_weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 0
    gradient_accumulation_steps: int = 1
    # "adamw" (reference recipe, cfg/base.py:53-60) | "adafactor" (factored
    # second moment, no first moment: optimizer state is ~rows+cols per
    # matrix instead of 2x params — makes full stage3 fit ONE 16 GB chip,
    # where AdamW's moments alone add ~5.8 GB at 1.45B trainable params)
    optimizer: str = "adamw"


@dataclass(frozen=True)
class TrainConfig:
    seed: int = 0
    output_dir: str = "out"
    max_train_steps: int = 200_000
    checkpointing_steps: int = 5000
    validation_steps: int = 5000
    checkpoints_total_limit: int = 3
    resume: Optional[str] = "latest"
    tuning_mode: str = "stage3"  # all | lm | stage1 | stage2 | stage3 | lora
    lora_rank: int = 256
    lora_alpha: int = 128
    tune_token_when_lora: bool = True
    gradient_checkpointing: bool = False
    remat_policy: str = "full"  # what jax.checkpoint saves when
    # gradient_checkpointing is on: "full" = layer inputs only (max memory
    # saving, recomputes the layer in the backward), "dots" = keep matmul
    # outputs (near-zero recompute, costs activation memory) — ops/remat.py
    use_flash_attention: bool = False  # Pallas flash kernel in training forwards
    fused_lm_ce: bool = False  # chunked lm_head CE: ~10x lower activation peak,
    # one extra lm_head matmul in the backward (measured ~8% slower at the
    # reference batch/seq — enable for longer-seq or larger-batch finetunes)
    use_local_edit_loss: bool = False  # restrict image CE to the edit region
    master_dtype: str = "float32"  # 'bfloat16' halves param memory (LoRA finetune)
    max_seq_len: int = 700
    # async input pipeline (torch DataLoader num_workers/prefetch role):
    # per-flow sample-fetch thread pool + batches prefetched ahead of the step
    num_workers: int = 4
    prefetch_depth: int = 2
    optim: OptimConfig = field(default_factory=OptimConfig)
    train_data: Tuple[FlowConfig, ...] = (FlowConfig(),)
    # validation workload (reference cfg `test_data` + cadence, train.py:208-210)
    test_data: FlowConfig = field(
        default_factory=lambda: FlowConfig(task_type="uni", data_name="toy",
                                           batch_size=1)
    )
    # batches per in-training validation pass (-1 = full test set); the old
    # hardcoded max_len=1 made the cadence a near-no-op
    val_max_len: int = 4
    # built-in FID/KID over SigLIP features for image-producing eval modes
    # (tasks/image_metrics.py; reference computes FID externally, SURVEY §4).
    # Off by default: it adds one SigLIP forward per gt+pr image.
    val_image_metrics: bool = False
    # loss scales: map loss-key substring -> multiplier; plan_lr_scale applies to
    # every '*lm*' loss key (reference forward: plangen_base.py:1077-1084)
    loss_scales: Dict[str, float] = field(default_factory=dict)
    plan_lr_scale: Optional[float] = None
    # mesh: axis name -> size; -1 means "all remaining devices"
    mesh_shape: Dict[str, int] = field(default_factory=lambda: {"data": -1, "model": 1})
    # ZeRO-3-style parameter sharding over the data axis: masters, moments
    # and grads shard with the params (required for full stage3 at 1B scale —
    # one chip cannot hold them, docs/DESIGN.md §6)
    fsdp: bool = False
    fsdp_min_size: int = 2 ** 20


@dataclass(frozen=True)
class PlanGenConfig:
    """Top-level config bundle."""

    model: PlanGenModelConfig = field(default_factory=PlanGenModelConfig)
    generation: GenerationConfig = field(default_factory=GenerationConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    janus_path: Optional[str] = None        # local Janus-Pro-1B dir (tokenizer+weights)
    params_path: Optional[str] = None       # orbax artifact from `cli convert`
    finetune_path: Optional[str] = None     # trainable_model_parameters.pth overlay
    # dataset roots (reference hardcodes cluster paths, cfg/base.py:12-16;
    # here they're config fields, None = dataset unavailable)
    layoutsam_path: Optional[str] = None
    layoutsam_image_root: str = ""          # SAM image dump for the raw train rows
    layoutsam_eval_path: Optional[str] = None
    coco_root: Optional[str] = None
    coco_200_path: Optional[str] = None
    nsr1k_path: Optional[str] = None
    oim_root: Optional[str] = None
    oim_class_csv: Optional[str] = None
    oim_caption_dir: Optional[str] = None
    grit_json: Optional[str] = None
    grit_image_dir: str = ""
    # GRiT training augmentation (debug_grit.py:51,56,645,662): caption
    # dropout for CFG and the IoU-constrained random crop; train-split only
    grit_empty_prompt_prob: float = 0.05
    grit_min_iou_crop: bool = False
    grit7k_json: Optional[str] = None
    edit_json: Optional[str] = None
    plan_json: Optional[str] = None
    plan_caps_jsonl: Optional[str] = None
    use_textual: bool = True                # 0-1000 int coords vs <h/w> tokens
    use_special_tokens: bool = True
    use_numhw_tokens: bool = False
    janus_hw: int = 384
    param_dtype: str = "bfloat16"


# ---------------------------------------------------------------------------
# Dotted-key override merging (mmengine DictAction ergonomics)
# ---------------------------------------------------------------------------


def validate_config(cfg: "PlanGenConfig") -> "PlanGenConfig":
    """Reject silently-inconsistent flag combinations (raises ValueError).

    Called by every entry point that builds a pipeline or trainer. Each rule
    guards a combination that would otherwise run and produce wrong results
    with no error — the misconfig class the lowercase-boolean fix also
    targets."""
    g = cfg.generation
    if not cfg.use_textual and not cfg.use_numhw_tokens:
        raise ValueError(
            "use_textual=False serializes <hN>/<wN> coordinate tokens, which "
            "require use_numhw_tokens=True (atomic tokenizer entries, "
            "plangen_base.py:121-127); without them every tag byte-fallback "
            "encodes into many ids and labels silently diverge"
        )
    _QUANT_MODES = (None, "int8", "int4", "int4_a8", "int8_kv", "auto")
    if g.quantize not in _QUANT_MODES:
        raise ValueError(
            f"generation.quantize={g.quantize!r} — expected one of "
            f"{_QUANT_MODES}"
        )
    if g.kv_a8 and g.quantize is None:
        raise ValueError(
            "generation.kv_a8 applies s8 dots over the int8 KV cache and "
            "requires generation.quantize to be set; without it the decode "
            "silently runs the plain bf16 path"
        )
    if g.speculative and (g.quantize is not None or g.kv_a8):
        raise ValueError(
            "generation.speculative supports only the bf16 cache "
            "(runtime/speculative.py); combining it with quantize/kv_a8 "
            "would silently decode without quantization"
        )
    if g.jacobi and g.quantize is not None:
        raise ValueError(
            "generation.jacobi is cacheless full-forward iteration whose "
            "fixed point equals the BF16 greedy stream; with quantize set "
            "the greedy path uses an int8 KV cache and the token-exactness "
            "contract between the two would silently break"
        )
    return cfg


def _parse_value(text: str) -> Any:
    # lowercase true/false/none would otherwise literal-eval-fail and survive
    # as TRUTHY strings — `--opt generation.jacobi=false` silently enabling
    # the flag is exactly the misconfig this guards against.
    # RESERVED LITERALS: bare true/false/none/null (any case) always coerce,
    # so a string-typed field cannot be set to those words bare; quote the
    # value to keep the string — `--opt generation.neg_prompt='"none"'`
    # literal-evals to the 4-char string (tests/test_cli.py pins this).
    low = text.strip().lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def apply_overrides(cfg: Any, overrides: Dict[str, Any]) -> Any:
    """Return a copy of dataclass `cfg` with dotted-key overrides applied.

    `apply_overrides(cfg, {"train.optim.learning_rate": 1e-4})` mirrors the
    reference's `--opt train.optim.learning_rate=1e-4` deep merge
    (reference: train.py:30-34).
    String values are literal-eval'd when possible.
    """
    for key, value in overrides.items():
        if isinstance(value, str):
            value = _parse_value(value)
        parts = key.split(".")
        cfg = _set_path(cfg, parts, value)
    return cfg


def _set_path(node: Any, parts: Sequence[str], value: Any) -> Any:
    head, rest = parts[0], parts[1:]
    if dataclasses.is_dataclass(node):
        names = {f.name for f in fields(node)}
        if head not in names:
            raise KeyError(f"unknown config key {head!r} on {type(node).__name__}")
        if rest:
            child = getattr(node, head)
            value = _set_path(child, rest, value)
        return replace(node, **{head: value})
    if isinstance(node, dict):
        out = dict(node)
        if rest:
            out[head] = _set_path(out.get(head, {}), rest, value)
        else:
            out[head] = value
        return out
    raise TypeError(f"cannot descend into {type(node)} at {head!r}")


def parse_opt_list(opts: List[str]) -> Dict[str, Any]:
    """Split ['a.b=1', 'c=x'] CLI fragments into an override dict.

    Values stay RAW strings: `apply_overrides` runs `_parse_value` exactly
    once. Parsing here too would double-parse — a quoted reserved literal
    (`neg_prompt='"none"'`) would literal-eval to the bare word and then
    coerce to None on the second pass (regression pinned in tests/test_cli).
    """
    out: Dict[str, Any] = {}
    for item in opts:
        if "=" not in item:
            raise ValueError(f"override {item!r} must be key=value")
        key, _, val = item.partition("=")
        out[key.strip()] = val.strip()
    return out
