"""The PlanGen task modes over the port's runtime.

Port of `plangen_tpu/tasks/pipeline.py`: `PlanGenPipeline` with
`layout_to_image` (task 'uni'; `prepare_layout_to_image`,
`execute_image_gen`), `plan` (layout planning; `prepare_plan`,
`plan_from_prepared`), `understand` ('mmu'; `prepare_understand`,
`understand_from_prepared`), `joint_generate` ('uni_2stage': plan, then
the image) and `edit_image` (teacher-forced editing and removal).
Host-side batch construction is the JAX package's processor (copied to
`tasks/processor.py`); the device work is the embeds (text, or SigLIP
features spliced into the text), the decode loops of `runtime/generate.py`
and the VQ encode and decode.

Quantized serving (`GenerationConfig.quantize`): 'int8', 'int4' and
'int4_a8' quantize the model's matmuls in place at construction
(`ops/quant.py::quantize_model_`, the counterpart of `tasks/eval.py::
_apply_quantize`); 'int8_kv' keeps bf16 weights. All four decode over the
int8 KV cache, text and image loops alike. A model that is already
quantized keeps its form: with `quantize=None` the pipeline engages that
form and the int8 cache, and any other mode raises, as the JAX package
does.

Options the port does not have yet raise `NotImplementedError` instead of
being ignored: `quantize='auto'`, `kv_a8`, `speculative`, `fast_edit` and
`jacobi`. As in the JAX pipeline, `gt_images` and `edit_region` take effect
only with teacher forcing (the `teacher_forcing` argument, or
`GenerationConfig.use_teacher_forcing` when it is None): the images are
VQ-encoded and every token outside the region (`edit_region` 0, all of them
by default) is forced to their codes. Without teacher forcing they are
ignored. `growing_cache` needs no branch: both of its values compute the
same function, which the port's fixed cache and prefix kernels compute.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from plangen_tpu_torch.config import GenerationConfig, PlanGenModelConfig
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.ops.quant import MODES, quant_form, quantize_model_
from plangen_tpu_torch.ops.sampling import Generators
from plangen_tpu_torch.runtime.generate import generate_image_tokens, greedy_decode_text
from plangen_tpu_torch.tasks.processor import PlanGenProcessor
from plangen_tpu_torch.text.grounding import truncate_grounding


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
    image_tokens: Optional[np.ndarray] = None  # [B*, N] int32
    groundings: Optional[List[str]] = None  # layout strings (planned or given)
    texts: Optional[List[str]] = None  # decoded texts (mmu)
    edit_mask: Optional[np.ndarray] = None  # [B*, N] regen mask used (teacher forcing)


@dataclass
class PreparedImageGen:
    """Host-side batch for `execute_image_gen`: the embedded CFG dual batch,
    its mask, the sampling generators and the bookkeeping."""

    embeds: torch.Tensor  # [2B*, L, H] on the model's device
    cfg_mask: torch.Tensor  # [2B*, L + N] int32
    generator: Generators
    groundings: List[str]
    gt_tokens: Optional[torch.Tensor] = None  # [B*, N] VQ codes of gt_images
    regen: Optional[torch.Tensor] = None  # [B*, N] int32, 1 = sample
    edit_mask_out: Optional[np.ndarray] = None  # host copy of `regen`


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
        embed = model.language_model.model.embed_tokens.weight
        self.device = embed.device
        self._dtype = embed.dtype  # the compute dtype, as the JAX pipeline's
        # the image-token grid is the VQ downsampling of the image (24 at 384px)
        self.grid = model_cfg.vision.image_size // model_cfg.vq.downsample_factor

    @property
    def _quantized_cache(self) -> bool:
        """Every quantized serving mode decodes over the int8 KV cache."""
        return self.gen.quantize in MODES

    def _ids(self, ids: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(ids, dtype=np.int64)).to(self.device)

    def _mask(self, mask: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(mask, dtype=np.int32)).to(self.device)

    @torch.inference_mode()
    def _detokenize(self, tokens: torch.Tensor) -> np.ndarray:
        """VQ ids -> pixels: uint8 converted on the device when
        `gen.output_uint8`, float32 in [-1, 1] otherwise."""
        vq = self.model.gen_vision_model
        grid = (self.grid, self.grid)
        if self.gen.output_uint8:
            return vq.decode_code_uint8(tokens, grid).cpu().numpy()
        return vq.decode_code(tokens, grid).float().cpu().numpy()

    # ------------------------------------------------------------------ plan

    def _text_decode(self, embeds: torch.Tensor, mask: torch.Tensor,
                     budget: int) -> torch.Tensor:
        """Greedy text decode over the pipeline's cache form."""
        return greedy_decode_text(
            self.model, self.cfg, embeds, mask, self.proc.tok.special.eos_id,
            max_new_tokens=budget, quantized_cache=self._quantized_cache,
        )

    def plan(self, captions: Sequence[str]) -> List[str]:
        """Text -> layout grounding strings (task 'plan')."""
        return self.plan_from_prepared(self.prepare_plan(captions))

    @torch.inference_mode()
    def prepare_plan(self, captions: Sequence[str]) -> Dict[str, Any]:
        """Host half of `plan`: the stage-1 prompt batch, embedded on the
        device."""
        budget = self.gen.max_new_text_tokens
        ids, mask = self.proc.stage1_batch(list(captions), budget)
        return {"embeds": self.model.embed_text(self._ids(ids)),
                "mask": self._mask(mask), "budget": budget}

    def plan_from_prepared(self, prep: Dict[str, Any]) -> List[str]:
        tokens = self._text_decode(prep["embeds"], prep["mask"], prep["budget"])
        texts = self.proc.decode_until_eos(tokens.cpu().numpy())
        return [truncate_grounding(t) for t in texts]

    # ------------------------------------------------------------------- mmu

    def understand(
        self, images: np.ndarray, question: Optional[str] = None
    ) -> GenerationOutput:
        """Image -> caption and layout description (task 'mmu').
        images: [B, H, W, 3] NHWC, CLIP-normalized."""
        return self.understand_from_prepared(
            self.prepare_understand(images, question)
        )

    @torch.inference_mode()
    def prepare_understand(
        self, images: np.ndarray, question: Optional[str] = None
    ) -> Dict[str, Any]:
        """Host half of `understand`: the mmu prompt batch and its embeds,
        SigLIP features spliced into the image placeholders."""
        budget = self.gen.max_new_text_tokens
        kwargs = {} if question is None else {"question": question}
        batch = self.proc.mmu_batch(images.shape[0], decode_budget=budget, **kwargs)
        pixels = torch.as_tensor(np.asarray(images)).to(device=self.device,
                                                         dtype=self._dtype)
        seq_mask = torch.from_numpy(np.asarray(batch.images_seq_mask)).to(self.device)
        embeds = self.model.prepare_inputs_embeds(self._ids(batch.input_ids), pixels,
                                                  seq_mask)  # in the model's dtype
        return {"embeds": embeds, "mask": self._mask(batch.attn_mask), "budget": budget}

    def understand_from_prepared(self, prep: Dict[str, Any]) -> GenerationOutput:
        tokens = self._text_decode(prep["embeds"], prep["mask"], prep["budget"])
        texts = self.proc.decode_until_eos(tokens.cpu().numpy())
        return GenerationOutput(texts=texts, groundings=texts)

    # ---------------------------------------------------------- layout2image

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
        its embedding on the device, the sampling generators and, with
        teacher forcing, the VQ codes of `gt_images` and the regen mask,
        replicated over `parallel_size`.

        `gt_images` / `edit_region` are ignored unless teacher forcing is on
        (`teacher_forcing`, or `gen.use_teacher_forcing` when it is None)."""
        ps = parallel_size or self.gen.parallel_size
        captions = list(captions)
        ids, mask = self.proc.uni_batch(captions, list(groundings))
        cfg_ids, cfg_mask = self.proc.cfg_batch(
            ids, mask, neg_captions, neg_groundings, parallel_size=ps
        )
        gt_tokens = regen = edit_mask_out = None
        if teacher_forcing is None:
            teacher_forcing = self.gen.use_teacher_forcing
        if gt_images is not None and teacher_forcing:
            pixels = torch.as_tensor(np.asarray(gt_images)).to(device=self.device,
                                                                dtype=self._dtype)
            gt_tok = self.model.gen_vision_model.encode_to_indices(pixels)
            if edit_region is None:
                edit_region = np.zeros((len(captions), self.cfg.image_seq_len),
                                       dtype=np.int32)
            # copy c of caption b is row c * B + b, as the CFG batch's copies
            gt_tokens = torch.cat([gt_tok] * ps, dim=0)
            edit_mask_out = np.concatenate(
                [np.asarray(edit_region, dtype=np.int32)] * ps, axis=0)
            regen = torch.from_numpy(edit_mask_out).to(self.device)
        embeds = self.model.embed_text(self._ids(cfg_ids))  # in the model's dtype
        if seeds is not None:
            if len(seeds) != len(captions):
                raise ValueError(f"{len(seeds)} seeds for {len(captions)} captions")
            generator = row_generators(seeds, ps, self.device)
        else:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self.gen.seed if seed is None else seed)
        return PreparedImageGen(
            embeds=embeds, cfg_mask=self._mask(cfg_mask), generator=generator,
            groundings=list(groundings), gt_tokens=gt_tokens, regen=regen,
            edit_mask_out=edit_mask_out,
        )

    def execute_image_gen(self, prep: PreparedImageGen) -> GenerationOutput:
        """Device half of `layout_to_image`: the decode loop, then the VQ
        decode to pixels."""
        tokens = generate_image_tokens(
            self.model, self.cfg, prep.embeds, prep.cfg_mask,
            generator=prep.generator,
            cfg_weight=self.gen.cfg_weight,
            temperature=self.gen.temperature,
            gt_tokens=prep.gt_tokens,
            regen_mask=prep.regen,
            num_tokens=self.cfg.image_seq_len,
            quantized_cache=self._quantized_cache,
        )
        return GenerationOutput(
            images=self._detokenize(tokens),
            image_tokens=tokens.cpu().numpy().astype(np.int32),
            groundings=prep.groundings,
            edit_mask=prep.edit_mask_out,
        )

    # ------------------------------------------------------------ uni_2stage

    def joint_generate(
        self, captions: Sequence[str], seed: Optional[int] = None,
        seeds: Optional[Sequence[int]] = None,
        parallel_size: Optional[int] = None,
    ) -> GenerationOutput:
        """Plan the layout, then generate the image conditioned on it (task
        'uni_2stage'); `groundings` of the output are the planned ones."""
        groundings = self.plan(captions)
        out = self.layout_to_image(captions, groundings, seed=seed, seeds=seeds,
                                   parallel_size=parallel_size)
        out.groundings = groundings
        return out

    # ---------------------------------------------------------- edit/removal

    def edit_image(
        self,
        captions: Sequence[str],
        groundings: Sequence[str],
        gt_images: np.ndarray,
        edit_region: np.ndarray,  # [B, N] 1 = regenerate
        neg_captions: Optional[Sequence[str]] = None,
        neg_groundings: Optional[Sequence[str]] = None,
        seed: Optional[int] = None,
        seeds: Optional[Sequence[int]] = None,
    ) -> GenerationOutput:
        """Layout-guided editing and object removal: the tokens outside
        `edit_region` are forced to the VQ codes of `gt_images`, those inside
        are sampled under the (possibly negative-grounded) CFG prompt."""
        return self.layout_to_image(
            captions,
            groundings,
            neg_captions=neg_captions,
            neg_groundings=neg_groundings,
            gt_images=gt_images,
            edit_region=edit_region,
            seed=seed,
            seeds=seeds,
            teacher_forcing=True,
        )
