"""Train-time collation: Sample lists -> device-ready flow batches.

A copy of `plangen_tpu/data/collate.py`, which the port cannot import:
`plangen_tpu/data/__init__.py` imports `preprocess.py`, which imports jax.
tests/test_torch_data.py holds the two copies' batches equal.


The numeric equivalent of the reference's `mmu_collate` (plangen_base.py:742-841)
restricted to what each task's loss consumes:

  uni/t2i: uni prompt ids (caption + gt_grounding + <begin_of_image>),
           mask extended by 576 image positions, images.
  mmu:     image-expanded MMU prompt with the serialized layout as the
           ANSWER text (reference: answer = batch['prompt']), images +
           images_seq_mask.
  plan:    uni prompt ids, text-only mask (HF slices the over-long uni mask
           to the text length — see train/loss.py plan notes).

All rows left-pad to a shared bucketed length; training truncation keeps the
tail at max_seq_len (pad_input_ids semantics).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from plangen_tpu_torch.data.schema import Sample
from plangen_tpu_torch.tasks.processor import PlanGenProcessor


def collate_uni(samples: List[Sample], proc: PlanGenProcessor) -> Dict[str, np.ndarray]:
    captions = [s.base_caption for s in samples]
    groundings = [s.gt_grounding for s in samples]
    ids, mask = proc.uni_batch(captions, groundings, for_train=True)
    images = np.stack([s.image for s in samples]).astype(np.float32)
    out = {"input_ids": ids, "attn_mask": mask, "images": images}
    if all(s.edit_region is not None for s in samples):
        out["edit_region"] = np.stack([s.edit_region for s in samples]).astype(
            np.int32
        )
    return out


def collate_mmu(samples: List[Sample], proc: PlanGenProcessor) -> Dict[str, np.ndarray]:
    batch = proc.mmu_batch(
        len(samples),
        answers=[s.prompt for s in samples],
    )
    images = np.stack([s.image for s in samples]).astype(np.float32)
    return {
        "input_ids": batch.input_ids,
        "attn_mask": batch.attn_mask,
        "images": images,
        "images_seq_mask": batch.images_seq_mask,
    }


def collate_plan(samples: List[Sample], proc: PlanGenProcessor) -> Dict[str, np.ndarray]:
    captions = [s.base_caption for s in samples]
    groundings = [s.gt_grounding for s in samples]
    ids, mask = proc.uni_batch(captions, groundings, for_train=True)
    return {"input_ids": ids, "attn_mask": mask[:, : ids.shape[1]]}


COLLATES = {"uni": collate_uni, "t2i": collate_uni, "mmu": collate_mmu, "plan": collate_plan}


def collate_flows(
    flow_samples: Dict[int, List[Sample]],
    flow_tasks: Dict[int, str],
    proc: PlanGenProcessor,
) -> Dict[int, Dict[str, np.ndarray]]:
    return {
        fid: COLLATES[flow_tasks[fid]](samples, proc)
        for fid, samples in flow_samples.items()
    }
