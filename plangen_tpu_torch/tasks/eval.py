"""Building the pipeline from a configuration, and the evaluation harness.

Port of `plangen_tpu/tasks/eval.py`.

`build_pipeline`: the tokenizer and processor from `cfg`, the weights
through `convert/loading.py::load_params` (seeded random init when `cfg`
names none, or the `model` given), then the serving form of
`cfg.generation.quantize`. The device is the card unless the caller names
another: `build_pipeline(cfg)` raises when there is no card, and
`device="cpu"` builds on the CPU.

`run_validation`: drive a task mode (`uni`, `t2i`, `uni_2stage`, `mmu`,
`plan`, `edit`, `rm`) over a dataset of `data/registry.py` and write the
JAX package's artifact tree, which external metric tooling reads:

  <out>/<data>_<task>_<n>/<step>/
      gt_image/{i}.png   pr_image/{i}.png   image_ids/{id}.jpg
      gt_image_ids/{id}.jpg
  <out>/<data>_<task>_<n>/<step>_batch/{batch}_layout.json   (captions,
      gt and predicted groundings)   {batch}.png   (grid with box overlays)
  <out>/<data>_<task>_<n>/<step>_metrics.json   (layout metrics of `plan`
      and `mmu`; FID / KID over SigLIP features with
      `train.val_image_metrics`)

As in the JAX harness, batch b + 1 is read and run on one worker thread
while batch b's artifacts are written on the calling thread. Every CUDA
call of the harness (the pipeline, the SigLIP featurizer) runs on that
worker: a CUDA graph captured while another thread makes a CUDA call may
fail (`runtime/cuda_graph.py`), so the calling thread gets host arrays only.
With `model` the harness runs on a model already built (the trainer's,
or the smoke's) instead of loading one.

The JAX helpers `_artifact_quant_form`, `_apply_quantize` and
`_build_auto_int4` have their counterparts in `PlanGenPipeline.__init__`
and `ops/quant.py` (`quant_form`, `quantize_model_`, `int4_view`): a model
that is already quantized engages its own form (and the int8 cache) when
`quantize` is unset; another mode raises, `auto` included, since the int4
view of `auto` is built from the dense model. The JAX
package refuses `auto` above 6e9 bytes of dense LM weights, a rule for a
16 GB chip; on the 80 GB card the dense 7B LM (14.5 GB of bf16) and its
int4 copy fit, so the port keeps no such limit.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from plangen_tpu_torch.config import PlanGenConfig, validate_config
from plangen_tpu_torch.convert.from_jax import init_params
from plangen_tpu_torch.convert.loading import load_params, load_tokenizer_for
from plangen_tpu_torch.data.registry import get_dataset
from plangen_tpu_torch.data.schema import Sample
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.tasks.pipeline import PlanGenPipeline
from plangen_tpu_torch.tasks.processor import PlanGenProcessor
from plangen_tpu_torch.text.grounding import parse_grounding
from plangen_tpu_torch.utils.visualize import draw_layout, save_image, save_image_grid


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when it is None; raises without a card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "plangen_tpu_torch serves on the card by default and "
                "torch.cuda.is_available() is False: pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def load_model(cfg: PlanGenConfig, device: torch.device) -> PlanGenModel:
    """The weights `cfg` names on `device`, else seeded random weights
    (`cfg.generation.seed`), in `cfg.param_dtype`."""
    dtype = getattr(torch, cfg.param_dtype)
    model = load_params(cfg, device=device, dtype=dtype)
    if model is None:
        model = PlanGenModel(cfg.model, dtype=dtype, device=device)
        init_params(model, torch.Generator(device=device).manual_seed(cfg.generation.seed))
    return model


def build_pipeline(cfg: PlanGenConfig, model: Optional[PlanGenModel] = None,
                   device=None) -> PlanGenPipeline:
    """The pipeline `cfg` describes, on `device` (the card by default):
    `model` when given (moved there), else the weights `cfg` names, else
    seeded random weights (`cfg.generation.seed`), in `cfg.param_dtype`."""
    validate_config(cfg)
    device = resolve_device(device)
    proc = PlanGenProcessor(
        load_tokenizer_for(cfg),
        image_tokens=cfg.model.image_seq_len,
        max_seq_len=cfg.train.max_seq_len,
        gen=cfg.generation,
    )
    if model is None:
        model = load_model(cfg, device)
    # the serving form of generation.quantize: PlanGenPipeline engages a
    # quantized model's own form, builds the int4 view of 'auto', quantizes
    # a dense model in place, and raises on a mismatch
    return PlanGenPipeline(model.to(device).eval(), cfg.model, proc, gen_cfg=cfg.generation)


def run_validation(
    cfg: PlanGenConfig,
    task_type: str = "uni",
    data_name: Any = "toy",
    max_len: int = 20,
    output_dir: str = "out/eval",
    batch_size: int = 2,
    model: Optional[PlanGenModel] = None,
    global_step: int = 0,
    start: int = 0,  # skip the first N batches (reference test_start)
    metrics_cb=None,  # callable(agg_metrics): the trainer's logging hook
    device=None,  # the card unless given (`build_pipeline`)
) -> List[Dict]:
    """Run `task_type` over up to `max_len` batches (-1: all) of
    `data_name` and write the artifact tree (module docstring); returns
    each batch's `{"pr_grounding", "pr_image"}`."""
    pipe = build_pipeline(cfg, model, device)
    ds = get_dataset(cfg, data_name, is_test=True)

    base = os.path.join(output_dir, f"{data_name}_{task_type}_{max_len}")
    path = os.path.join(base, str(global_step))
    batch_path = os.path.join(base, f"{global_step}_batch")
    for sub in ["gt_image", "pr_image", "image_ids", "gt_image_ids"]:
        os.makedirs(os.path.join(path, sub), exist_ok=True)
    os.makedirs(batch_path, exist_ok=True)

    results = []
    per_sample_metrics = []
    # FID / KID (train.val_image_metrics): SigLIP features of every gt / pr
    # image pair, computed on the worker with the batch, the metrics once at
    # the end; the featurizer reads the pipeline's vision tower
    featurizer = None
    if cfg.train.val_image_metrics:
        from plangen_tpu_torch.tasks.image_metrics import SigLIPFeaturizer

        featurizer = SigLIPFeaturizer(pipe.model, cfg.model, batch_size=max(2, batch_size))
    gt_feats: List[np.ndarray] = []
    pr_feats: List[np.ndarray] = []
    n_batches = min(max_len, -(-len(ds) // batch_size)) if max_len != -1 else -(
        -len(ds) // batch_size
    )

    def fetch(b):
        """On the worker: read batch b and run it (every CUDA call);
        returns host arrays only."""
        samples = [ds[b * batch_size + i] for i in range(batch_size)
                   if b * batch_size + i < len(ds)]
        if not samples:
            return None
        out = _run_batch(pipe, cfg, task_type, samples)
        feats = None
        if featurizer is not None and out["pr_image"] is not None:
            # GT side: for edit / rm the post-edit target when the dataset
            # carries one (Sample.edited_image), as the JAX harness pairs them
            pairs = [
                (s.edited_image if s.edited_image is not None else s.image,
                 np.asarray(out["pr_image"][i]))
                for i, s in enumerate(samples)
                if s.edited_image is not None or s.image is not None
            ]
            if pairs:
                feats = (featurizer(np.stack([p[0] for p in pairs])),
                         featurizer(np.stack([p[1] for p in pairs])))
        return samples, out, feats

    pool = ThreadPoolExecutor(max_workers=1)
    try:
        pending = pool.submit(fetch, start) if start < n_batches else None
        for b in range(start, n_batches):
            got = pending.result() if pending is not None else None
            pending = pool.submit(fetch, b + 1) if b + 1 < n_batches else None
            if got is None:
                break
            samples, out, feats = got
            _save_batch_artifacts(
                out, samples, task_type, path, batch_path, b, batch_size,
                textual=cfg.use_textual,
            )
            if task_type in ("plan", "mmu"):
                # layout metrics: predicted grounding vs GT grounding
                from plangen_tpu_torch.tasks.metrics import layout_metrics

                for s, pr in zip(samples, out["pr_grounding"]):
                    gt_b, _ = parse_grounding(s.gt_grounding, textual=cfg.use_textual)
                    pr_b, _ = parse_grounding(pr or "", textual=cfg.use_textual)
                    per_sample_metrics.append(layout_metrics(pr_b, gt_b))
            if feats is not None:
                gt_feats.append(feats[0])
                pr_feats.append(feats[1])
            results.append(out)
    finally:
        # an artifact-save error must still observe/stop the in-flight fetch
        pool.shutdown(wait=True)

    agg: Dict[str, float] = {}
    if per_sample_metrics:
        from plangen_tpu_torch.tasks.metrics import aggregate_layout_metrics

        agg.update(aggregate_layout_metrics(per_sample_metrics))
    if gt_feats:
        from plangen_tpu_torch.tasks.image_metrics import fid_kid_from_features

        g = np.concatenate(gt_feats)
        p = np.concatenate(pr_feats)
        if len(g) >= 2 and len(p) >= 2:
            agg.update(fid_kid_from_features(g, p))
        else:
            print("image metrics skipped: need >=2 gt/pr image pairs")
    if agg:
        with open(os.path.join(base, f"{global_step}_metrics.json"), "w") as f:
            json.dump(agg, f, indent=1)
        print(f"eval metrics: {agg}")
        if metrics_cb is not None:
            metrics_cb(agg)
    return results


def _run_batch(pipe: PlanGenPipeline, cfg, task_type: str, samples: List[Sample]):
    captions = [s.base_caption for s in samples]
    groundings = [s.gt_grounding for s in samples]
    if task_type == "plan":
        pr = pipe.plan(captions)
        return {"pr_grounding": pr, "pr_image": None}
    if task_type == "mmu":
        images = np.stack([s.image for s in samples])
        out = pipe.understand(images)
        return {"pr_grounding": out.texts, "pr_image": None}
    if task_type == "uni_2stage":
        out = pipe.joint_generate(captions)
        return {"pr_grounding": out.groundings, "pr_image": out.images}
    if task_type in ("edit", "rm"):
        images = np.stack([s.image for s in samples])
        regions = np.stack([s.edit_region for s in samples])
        neg_caps = [s.neg_base_caption for s in samples]
        neg_grounds = [s.neg_gt_grounding for s in samples] if task_type == "rm" else None
        out = pipe.edit_image(
            captions, groundings, images, regions,
            neg_captions=neg_caps if task_type == "rm" else None,
            neg_groundings=neg_grounds,
        )
        return {"pr_grounding": groundings, "pr_image": out.images}
    # 'uni' / 't2i': the GT layout conditions the image ('t2i': none)
    gt_images = (
        np.stack([s.image for s in samples])
        if all(s.image is not None for s in samples)
        else None
    )
    out = pipe.layout_to_image(
        captions,
        groundings if task_type == "uni" else [""] * len(captions),
        gt_images=gt_images,
    )
    return {"pr_grounding": groundings, "pr_image": out.images}


def _save_batch_artifacts(out, samples, task_type, path, batch_path, b,
                          batch_size, textual=True):
    data = {
        "base_caption": [s.base_caption for s in samples],
        "gt_grounding": [s.gt_grounding for s in samples],
        "pr_grounding": out["pr_grounding"],
    }
    with open(os.path.join(batch_path, f"{b}_layout.json"), "w") as f:
        json.dump(data, f, indent=1)

    if out["pr_image"] is None:
        return
    vis = []
    for i, s in enumerate(samples):
        pr = out["pr_image"][i]
        save_image(pr, os.path.join(path, "pr_image", f"{b * batch_size + i}.png"))
        if s.image is not None:
            save_image(
                s.image, os.path.join(path, "gt_image", f"{b * batch_size + i}.png")
            )
        if s.image_id:
            save_image(pr, os.path.join(path, "image_ids", f"{s.image_id}.jpg"))
            if s.image is not None:
                save_image(
                    s.image, os.path.join(path, "gt_image_ids", f"{s.image_id}.jpg")
                )
        boxes, labels = parse_grounding(out["pr_grounding"][i] or "", textual=textual)
        vis.append(draw_layout(pr, boxes, labels))
    save_image_grid(vis, os.path.join(batch_path, f"{b}.png"))
