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
and the VQ encode and decode. Each `prepare_*` is split in two: `host_*`
(tokenization and the CFG batch, numpy only, no CUDA call) and `embed_*`
(the device work), so a server can run the first on any thread and the
second on the one thread that owns the card.

Quantized serving (`GenerationConfig.quantize`): 'int8', 'int4' and
'int4_a8' quantize the model's matmuls in place at construction
(`ops/quant.py::quantize_model_`, the counterpart of `tasks/eval.py::
_apply_quantize`); 'int8_kv' keeps bf16 weights. 'auto' keeps the dense
model and an int4 view of it (`model_int4`, built by `ops/quant.py::
int4_view` when not given) that shares every module but the LM matmuls,
and routes each whole call, prefill included, by its matmul rows
(`_model_for`, the counterpart of `_params_for`): image generation by its
CFG rows (2 x captions x parallel_size), the text decode by its batch; at
<= `auto_int4_max_rows` rows the int4 view, above it the dense model. All
five decode over the int8 KV cache, text and image loops alike. A model
that is already quantized keeps its form: with `quantize=None` the
pipeline engages that form and the int8 cache, and any other mode
(`auto` included) raises, as the JAX package does.

`defer_fetch` (set by the server) leaves the pixels' copy to the host
queued: `_detokenize` enqueues a non-blocking copy into pinned host memory
and records a CUDA event, and the images come back as `DeferredPixels`,
which a consumer on another thread turns into an array by waiting on that
event (`np.asarray`), without any other CUDA call.

With `fast_edit` and teacher forcing, `execute_image_gen` runs
`runtime/fast_edit.py` (the 16-token chunks forced in every row as one
forward each) on the route `_model_for` picks, with the raw schedule of the
regen mask: the JAX pipeline canonicalizes it to bound its TPU compiles,
which the port does not have; both schedules give the same tokens.

The opt-in decoders: with `speculative`, a call of one image (B = 1, no
teacher forcing) runs `runtime/speculative.py`, the request's generator
driving its draws; `fast_edit` and teacher-forced calls keep their loops.
With `jacobi`, every text decode (`plan`, the plan of `joint_generate`,
`understand`) runs `runtime/jacobi.py`. Either with a quantized form raises
`ValueError`, as the JAX config check does, before anything is quantized.
The one option the port does not have, `kv_a8`, raises
`NotImplementedError` instead of being ignored. As in the
JAX pipeline, `gt_images` and `edit_region` take effect only with teacher
forcing (the `teacher_forcing` argument, or
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

from plangen_tpu_torch.config import (
    GenerationConfig, PlanGenConfig, PlanGenModelConfig, validate_config,
)
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.ops.quant import MODES, int4_view, quant_form, quantize_model_
from plangen_tpu_torch.ops.sampling import Generators, mix_seed
from plangen_tpu_torch.runtime.fast_edit import (
    frozen_chunk_schedule, generate_image_tokens_fast_edit,
)
from plangen_tpu_torch.runtime.generate import generate_image_tokens, greedy_decode_text
from plangen_tpu_torch.runtime.jacobi import jacobi_decode_text
from plangen_tpu_torch.runtime.speculative import generate_image_tokens_spec
from plangen_tpu_torch.tasks.processor import PlanGenProcessor
from plangen_tpu_torch.text.grounding import truncate_grounding


def _unsupported_options(gen: GenerationConfig) -> List[str]:
    names = []
    if gen.quantize not in (None, "auto") + MODES:
        names.append(f"quantize={gen.quantize!r}")
    if gen.kv_a8:
        names.append("kv_a8=True")
    return names


def copy_seed(seed: int, copy: int) -> int:
    """The generator seed of `copy` of a caption seeded `seed`: the seed
    itself (mod 2**32, like the JAX package's per-row keys) for copy 0,
    `ops/sampling.py::mix_seed` of (seed, copy) for the others."""
    return int(seed) & 0xFFFFFFFF if copy == 0 else mix_seed(seed, copy)


def row_generators(
    seeds: Sequence[int], parallel_size: int, device
) -> List[torch.Generator]:
    """One generator per image row: row r is copy r // B of caption r % B,
    seeded by `copy_seed`, so copies draw different streams and every
    stream depends only on (seed, copy)."""
    out = []
    for c in range(parallel_size):
        for s in seeds:
            g = torch.Generator(device=device)
            g.manual_seed(copy_seed(s, c))
            out.append(g)
    return out


@dataclass
class GenerationOutput:
    images: Optional[np.ndarray] = None  # [B*, H, W, 3]: float [-1, 1], or
    # uint8 when GenerationConfig.output_uint8; DeferredPixels with defer_fetch
    image_tokens: Optional[np.ndarray] = None  # [B*, N] int32
    groundings: Optional[List[str]] = None  # layout strings (planned or given)
    texts: Optional[List[str]] = None  # decoded texts (mmu)
    edit_mask: Optional[np.ndarray] = None  # [B*, N] regen mask used (teacher forcing)


class DeferredPixels:
    """Pixels whose copy to pinned host memory was enqueued on the card,
    with a CUDA event recorded after it; `np.asarray` waits on the event
    (the one CUDA call a consumer makes) and returns the host array."""

    def __init__(self, pixels: torch.Tensor):
        self._host = torch.empty(pixels.shape, dtype=pixels.dtype, pin_memory=True)
        self._host.copy_(pixels, non_blocking=True)
        self._ready = torch.cuda.Event()
        self._ready.record()

    def __array__(self, dtype=None, copy=None):
        self._ready.synchronize()
        out = self._host.numpy()
        return out if dtype is None else out.astype(dtype)


@dataclass
class HostImageGen:
    """The host half of `prepare_layout_to_image` (numpy only): the CFG
    dual batch's ids and mask and what the device half needs."""

    cfg_ids: np.ndarray  # [2B*, L]
    cfg_mask: np.ndarray  # [2B*, L + N]
    groundings: List[str]
    parallel_size: int
    seed: Optional[int] = None
    seeds: Optional[List[int]] = None
    gt_images: Optional[np.ndarray] = None  # [B, H, W, 3] with teacher forcing
    edit_mask: Optional[np.ndarray] = None  # [B*, N] int32, 1 = sample


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
        model_int4: Optional[PlanGenModel] = None,
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
        # the JAX config check's rules (speculative or jacobi with a
        # quantized form raise ValueError), before anything is quantized
        validate_config(PlanGenConfig(generation=gen))
        have = quant_form(model)
        if have is None:
            if gen.quantize == "auto":
                model_int4 = int4_view(model) if model_int4 is None else model_int4
            elif gen.quantize is not None:
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
        if model_int4 is not None and gen.quantize != "auto":
            raise ValueError(f"model_int4 is the quantize='auto' form, but "
                             f"GenerationConfig.quantize={gen.quantize!r}")
        self.gen = gen
        self.model_int4 = model_int4
        embed = model.language_model.model.embed_tokens.weight
        self.device = embed.device
        self._dtype = embed.dtype  # the compute dtype, as the JAX pipeline's
        # the image-token grid is the VQ downsampling of the image (24 at 384px)
        self.grid = model_cfg.vision.image_size // model_cfg.vq.downsample_factor

    # when True, `_detokenize` returns `DeferredPixels` on the card (module
    # docstring); the server sets it
    defer_fetch: bool = False

    @property
    def _quantized_cache(self) -> bool:
        """Every quantized serving mode decodes over the int8 KV cache,
        'auto' on both of its routes."""
        return self.gen.quantize in MODES + ("auto",)

    def _model_for(self, n_rows: int) -> PlanGenModel:
        """The model a call of `n_rows` matmul rows runs on: under 'auto'
        the int4 view up to `auto_int4_max_rows`, the dense model above;
        otherwise the one model."""
        if self.model_int4 is not None and n_rows <= self.gen.auto_int4_max_rows:
            return self.model_int4
        return self.model

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
            pixels = vq.decode_code_uint8(tokens, grid)
        else:
            pixels = vq.decode_code(tokens, grid).float()
        if self.defer_fetch and pixels.is_cuda:
            return DeferredPixels(pixels)
        return pixels.cpu().numpy()

    # ------------------------------------------------------------------ plan

    def _text_decode(self, embeds: torch.Tensor, mask: torch.Tensor,
                     budget: int) -> torch.Tensor:
        """Greedy text decode: the KV-cached loop over the pipeline's cache
        form, routed by its rows, or Jacobi iteration when `gen.jacobi`
        (token-exact either way), as the JAX pipeline chooses."""
        eos = self.proc.tok.special.eos_id
        if self.gen.jacobi:
            return jacobi_decode_text(self.model, self.cfg, embeds, mask, eos,
                                      max_new_tokens=budget)
        return greedy_decode_text(
            self._model_for(int(embeds.shape[0])), self.cfg, embeds, mask, eos,
            max_new_tokens=budget, quantized_cache=self._quantized_cache,
        )

    def plan(self, captions: Sequence[str]) -> List[str]:
        """Text -> layout grounding strings (task 'plan')."""
        return self.plan_from_prepared(self.prepare_plan(captions))

    def prepare_plan(self, captions: Sequence[str]) -> Dict[str, Any]:
        """The stage-1 prompt batch, embedded on the device."""
        return self.embed_plan(self.host_plan(captions))

    def host_plan(self, captions: Sequence[str]) -> Dict[str, Any]:
        """Host half of `prepare_plan`: the stage-1 prompt ids and mask."""
        budget = self.gen.max_new_text_tokens
        ids, mask = self.proc.stage1_batch(list(captions), budget)
        return {"ids": ids, "mask": mask, "budget": budget}

    @torch.inference_mode()
    def embed_plan(self, host: Dict[str, Any]) -> Dict[str, Any]:
        """Device half of `prepare_plan`."""
        return {"embeds": self.model.embed_text(self._ids(host["ids"])),
                "mask": self._mask(host["mask"]), "budget": host["budget"]}

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

    def prepare_understand(
        self, images: np.ndarray, question: Optional[str] = None
    ) -> Dict[str, Any]:
        """The mmu prompt batch and its embeds, SigLIP features spliced into
        the image placeholders."""
        return self.embed_understand(self.host_understand(images, question))

    def host_understand(
        self, images: np.ndarray, question: Optional[str] = None
    ) -> Dict[str, Any]:
        """Host half of `prepare_understand`: the mmu prompt batch."""
        budget = self.gen.max_new_text_tokens
        kwargs = {} if question is None else {"question": question}
        batch = self.proc.mmu_batch(images.shape[0], decode_budget=budget, **kwargs)
        return {"ids": batch.input_ids, "images": np.asarray(images),
                "images_seq_mask": np.asarray(batch.images_seq_mask),
                "mask": batch.attn_mask, "budget": budget}

    @torch.inference_mode()
    def embed_understand(self, host: Dict[str, Any]) -> Dict[str, Any]:
        """Device half of `prepare_understand`."""
        pixels = torch.as_tensor(host["images"]).to(device=self.device, dtype=self._dtype)
        seq_mask = torch.from_numpy(host["images_seq_mask"]).to(self.device)
        embeds = self.model.prepare_inputs_embeds(self._ids(host["ids"]), pixels,
                                                  seq_mask)  # in the model's dtype
        return {"embeds": embeds, "mask": self._mask(host["mask"]),
                "budget": host["budget"]}

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
        """The batch `execute_image_gen` decodes: `host_layout_to_image`,
        then `embed_layout_to_image`."""
        return self.embed_layout_to_image(self.host_layout_to_image(
            captions, groundings,
            neg_captions=neg_captions, neg_groundings=neg_groundings,
            gt_images=gt_images, edit_region=edit_region,
            seed=seed, seeds=seeds, parallel_size=parallel_size,
            teacher_forcing=teacher_forcing,
        ))

    def host_layout_to_image(
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
    ) -> HostImageGen:
        """Host half of `prepare_layout_to_image`: tokenization, the CFG
        dual batch and, with teacher forcing, the regen mask, replicated
        over `parallel_size`.

        `gt_images` / `edit_region` are ignored unless teacher forcing is on
        (`teacher_forcing`, or `gen.use_teacher_forcing` when it is None)."""
        ps = parallel_size or self.gen.parallel_size
        captions = list(captions)
        ids, mask = self.proc.uni_batch(captions, list(groundings))
        cfg_ids, cfg_mask = self.proc.cfg_batch(
            ids, mask, neg_captions, neg_groundings, parallel_size=ps
        )
        if seeds is not None and len(seeds) != len(captions):
            raise ValueError(f"{len(seeds)} seeds for {len(captions)} captions")
        if teacher_forcing is None:
            teacher_forcing = self.gen.use_teacher_forcing
        edit_mask = None
        if gt_images is not None and teacher_forcing:
            if edit_region is None:
                edit_region = np.zeros((len(captions), self.cfg.image_seq_len),
                                       dtype=np.int32)
            # copy c of caption b is row c * B + b, as the CFG batch's copies
            edit_mask = np.concatenate(
                [np.asarray(edit_region, dtype=np.int32)] * ps, axis=0)
        else:
            gt_images = None
        return HostImageGen(
            cfg_ids=cfg_ids, cfg_mask=cfg_mask, groundings=list(groundings),
            parallel_size=ps, seed=seed,
            seeds=None if seeds is None else [int(s) for s in seeds],
            gt_images=None if gt_images is None else np.asarray(gt_images),
            edit_mask=edit_mask,
        )

    @torch.inference_mode()
    def embed_layout_to_image(self, host: HostImageGen) -> PreparedImageGen:
        """Device half of `prepare_layout_to_image`: the embeds, the
        sampling generators and, with teacher forcing, the VQ codes of the
        images, replicated over `parallel_size`."""
        ps = host.parallel_size
        gt_tokens = regen = None
        if host.gt_images is not None:
            pixels = torch.as_tensor(host.gt_images).to(device=self.device,
                                                        dtype=self._dtype)
            gt_tok = self.model.gen_vision_model.encode_to_indices(pixels)
            gt_tokens = torch.cat([gt_tok] * ps, dim=0)
            regen = torch.from_numpy(host.edit_mask).to(self.device)
        embeds = self.model.embed_text(self._ids(host.cfg_ids))  # in the model's dtype
        if host.seeds is not None:
            generator = row_generators(host.seeds, ps, self.device)
        else:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self.gen.seed if host.seed is None else host.seed)
        return PreparedImageGen(
            embeds=embeds, cfg_mask=self._mask(host.cfg_mask), generator=generator,
            groundings=host.groundings, gt_tokens=gt_tokens, regen=regen,
            edit_mask_out=host.edit_mask,
        )

    def execute_image_gen(self, prep: PreparedImageGen) -> GenerationOutput:
        """Device half of `layout_to_image`: the decode loop, then the VQ
        decode to pixels."""
        # routed by the decode's matmul rows: the CFG dual of every image
        model = self._model_for(int(prep.embeds.shape[0]))
        kwargs = dict(generator=prep.generator, cfg_weight=self.gen.cfg_weight,
                      temperature=self.gen.temperature, gt_tokens=prep.gt_tokens,
                      regen_mask=prep.regen, num_tokens=self.cfg.image_seq_len,
                      quantized_cache=self._quantized_cache)
        if self.gen.fast_edit and prep.gt_tokens is not None:
            tokens = generate_image_tokens_fast_edit(
                model, self.cfg, prep.embeds, prep.cfg_mask,
                schedule=frozen_chunk_schedule(prep.edit_mask_out), **kwargs)
        elif self.gen.speculative and prep.embeds.shape[0] == 2 and prep.gt_tokens is None:
            # B = 1: the request's generator (its row's, under per-request
            # seeds) drives the draws, as the JAX pipeline passes row 0's key
            tokens = generate_image_tokens_spec(
                model, self.cfg, prep.embeds, prep.cfg_mask, prep.generator,
                self.gen.cfg_weight, self.gen.temperature,
                num_tokens=self.cfg.image_seq_len,
                draft_layers=self.gen.spec_draft_layers,
                draft_len=self.gen.spec_draft_len).tokens
        else:
            tokens = generate_image_tokens(model, self.cfg, prep.embeds, prep.cfg_mask,
                                           **kwargs)
        image_tokens = tokens.cpu().numpy().astype(np.int32)
        return GenerationOutput(
            images=self._detokenize(tokens),
            image_tokens=image_tokens,
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
