"""Layout-to-image (task 'uni') over the port's runtime.

Port of `plangen_tpu/tasks/pipeline.py`: `PlanGenPipeline` with
`layout_to_image`, `prepare_layout_to_image`, `execute_image_gen` and
`_detokenize`. Host-side batch construction is the JAX package's processor
(copied to `tasks/processor.py`); the device work is the embed, the decode
loop of `runtime/generate.py` and the VQ decode.

Quantized serving (`GenerationConfig.quantize`): 'int8', 'int4' and
'int4_a8' quantize the model's matmuls in place at construction
(`ops/quant.py::quantize_model_`, the counterpart of `tasks/eval.py::
_apply_quantize`); 'int8_kv' keeps bf16 weights. All four decode over the
int8 KV cache. A model that is already quantized keeps its form: with
`quantize=None` the pipeline engages that form and the int8 cache, and any
other mode raises, as the JAX package does.

Options the port does not have yet raise `NotImplementedError` instead of
being ignored: `quantize='auto'`, `kv_a8`, `speculative`, `fast_edit`,
`jacobi`, and teacher-forced generation from `gt_images` / `edit_region`.
As in the JAX pipeline, `gt_images` and `edit_region` take effect only with
teacher forcing (the `teacher_forcing` argument, or
`GenerationConfig.use_teacher_forcing` when it is None); without it they
are ignored and the call generates as usual. `growing_cache` needs no
branch: both of its values compute the same function, which the port's
fixed cache and prefix kernels compute.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from plangen_tpu_torch.config import GenerationConfig, PlanGenModelConfig
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.ops.quant import MODES, quant_form, quantize_model_
from plangen_tpu_torch.ops.sampling import Generators
from plangen_tpu_torch.runtime.generate import generate_image_tokens
from plangen_tpu_torch.tasks.processor import PlanGenProcessor


def _unsupported_options(gen: GenerationConfig) -> List[str]:
    names = []
    if gen.quantize not in (None,) + MODES:
        names.append(f"quantize={gen.quantize!r}")
    for flag in ("kv_a8", "speculative", "fast_edit", "jacobi"):
        if getattr(gen, flag):
            names.append(f"{flag}=True")
    return names


def row_generators(
    seeds: Sequence[int], parallel_size: int, device
) -> List[torch.Generator]:
    """One generator per image row: row r is copy r // B of caption r % B.

    Copy 0 of a caption is seeded with its seed (mod 2**32, like the JAX
    package's per-row keys); copy c > 0 with `seed + c * 2**32`, so copies
    draw different streams and every stream depends only on (seed, copy)."""
    out = []
    for c in range(parallel_size):
        for s in seeds:
            g = torch.Generator(device=device)
            g.manual_seed((int(s) & 0xFFFFFFFF) + (c << 32))
            out.append(g)
    return out


@dataclass
class GenerationOutput:
    images: Optional[np.ndarray] = None  # [B*, H, W, 3]: float [-1, 1], or
    # uint8 when GenerationConfig.output_uint8
    image_tokens: Optional[np.ndarray] = None  # [B*, N]
    groundings: Optional[List[str]] = None


@dataclass
class PreparedImageGen:
    """Host-side batch for `execute_image_gen`: the embedded CFG dual batch,
    its mask, the sampling generators and the bookkeeping."""

    embeds: torch.Tensor  # [2B*, L, H] on the model's device
    cfg_mask: torch.Tensor  # [2B*, L + N] int32
    generator: Generators
    groundings: List[str]


class PlanGenPipeline:
    def __init__(
        self,
        model: PlanGenModel,
        model_cfg: PlanGenModelConfig,
        processor: PlanGenProcessor,
        gen_cfg: Optional[GenerationConfig] = None,
    ):
        self.model = model
        self.cfg = model_cfg
        self.proc = processor
        gen = gen_cfg or processor.gen
        unsupported = _unsupported_options(gen)
        if unsupported:
            raise NotImplementedError(
                "plangen_tpu_torch does not implement "
                + ", ".join(unsupported) + " yet"
            )
        have = quant_form(model)
        if have is None:
            if gen.quantize is not None:
                quantize_model_(model, gen.quantize)
        elif gen.quantize is None:
            # a quantized model engages its own serving form, int8 cache
            # included, rather than running with a dense cache
            gen = dataclasses.replace(gen, quantize=have)
        elif gen.quantize != have:
            raise ValueError(
                f"the model is already {have}-quantized but "
                f"GenerationConfig.quantize={gen.quantize!r}"
            )
        self.gen = gen
        self.device = model.language_model.model.embed_tokens.weight.device
        # the image-token grid is the VQ downsampling of the image (24 at 384px)
        self.grid = model_cfg.vision.image_size // model_cfg.vq.downsample_factor

    @property
    def _quantized_cache(self) -> bool:
        """Every quantized serving mode decodes over the int8 KV cache."""
        return self.gen.quantize in MODES

    @torch.inference_mode()
    def _detokenize(self, tokens: torch.Tensor) -> np.ndarray:
        """VQ ids -> pixels: uint8 converted on the device when
        `gen.output_uint8`, float32 in [-1, 1] otherwise."""
        vq = self.model.gen_vision_model
        grid = (self.grid, self.grid)
        if self.gen.output_uint8:
            return vq.decode_code_uint8(tokens, grid).cpu().numpy()
        return vq.decode_code(tokens, grid).float().cpu().numpy()

    def layout_to_image(
        self,
        captions: Sequence[str],
        groundings: Sequence[str],
        neg_captions: Optional[Sequence[str]] = None,
        neg_groundings: Optional[Sequence[str]] = None,
        gt_images: Optional[np.ndarray] = None,
        edit_region: Optional[np.ndarray] = None,
        seed: Optional[int] = None,
        seeds: Optional[Sequence[int]] = None,
        parallel_size: Optional[int] = None,
        teacher_forcing: Optional[bool] = None,
    ) -> GenerationOutput:
        """Layout-conditioned image generation (task 'uni').

        `seeds` gives each caption its own sampling stream (one generator
        per row), so a request's tokens do not depend on what else shares
        the batch; `seed` keeps one stream for the whole batch."""
        prep = self.prepare_layout_to_image(
            captions, groundings,
            neg_captions=neg_captions, neg_groundings=neg_groundings,
            gt_images=gt_images, edit_region=edit_region,
            seed=seed, seeds=seeds, parallel_size=parallel_size,
            teacher_forcing=teacher_forcing,
        )
        return self.execute_image_gen(prep)

    @torch.inference_mode()
    def prepare_layout_to_image(
        self,
        captions: Sequence[str],
        groundings: Sequence[str],
        neg_captions: Optional[Sequence[str]] = None,
        neg_groundings: Optional[Sequence[str]] = None,
        gt_images: Optional[np.ndarray] = None,
        edit_region: Optional[np.ndarray] = None,
        seed: Optional[int] = None,
        seeds: Optional[Sequence[int]] = None,
        parallel_size: Optional[int] = None,
        teacher_forcing: Optional[bool] = None,
    ) -> PreparedImageGen:
        """Host half of `layout_to_image`: tokenization, the CFG dual batch,
        its embedding on the device, and the sampling generators.

        `gt_images` / `edit_region` are ignored unless teacher forcing is on
        (`teacher_forcing`, or `gen.use_teacher_forcing` when it is None)."""
        if teacher_forcing is None:
            teacher_forcing = self.gen.use_teacher_forcing
        if gt_images is not None and teacher_forcing:
            raise NotImplementedError(
                "teacher-forced generation from gt_images / edit_region is "
                "not in plangen_tpu_torch yet; call with teacher_forcing=False "
                "to generate without it"
            )
        ps = parallel_size or self.gen.parallel_size
        captions = list(captions)
        ids, mask = self.proc.uni_batch(captions, list(groundings))
        cfg_ids, cfg_mask = self.proc.cfg_batch(
            ids, mask, neg_captions, neg_groundings, parallel_size=ps
        )
        ids_t = torch.from_numpy(np.asarray(cfg_ids, dtype=np.int64)).to(self.device)
        embeds = self.model.embed_text(ids_t)  # in the model's dtype
        if seeds is not None:
            if len(seeds) != len(captions):
                raise ValueError(f"{len(seeds)} seeds for {len(captions)} captions")
            generator = row_generators(seeds, ps, self.device)
        else:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self.gen.seed if seed is None else seed)
        return PreparedImageGen(
            embeds=embeds,
            cfg_mask=torch.from_numpy(np.asarray(cfg_mask, dtype=np.int32)).to(
                self.device
            ),
            generator=generator, groundings=list(groundings),
        )

    def execute_image_gen(self, prep: PreparedImageGen) -> GenerationOutput:
        """Device half of `layout_to_image`: the decode loop, then the VQ
        decode to pixels."""
        tokens = generate_image_tokens(
            self.model, self.cfg, prep.embeds, prep.cfg_mask,
            generator=prep.generator,
            cfg_weight=self.gen.cfg_weight,
            temperature=self.gen.temperature,
            num_tokens=self.cfg.image_seq_len,
            quantized_cache=self._quantized_cache,
        )
        return GenerationOutput(
            images=self._detokenize(tokens),
            image_tokens=tokens.cpu().numpy().astype(np.int32),
            groundings=prep.groundings,
        )
