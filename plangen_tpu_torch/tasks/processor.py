"""Host-side prompt/batch construction for the five task modes.

A copy of `plangen_tpu/tasks/processor.py`, which cannot be imported from
here: `plangen_tpu/tasks/__init__.py` imports the JAX pipeline. The module
is numpy-only; tests/test_torch_processor.py holds the two copies' batches
equal.

The TPU-native replacement for the reference's `VLChatProcessor` +
`System.mmu_collate`/`t2i_infer_collate_batch` (processing_vlm.py,
plangen_base.py:636-841): builds left-padded int32 batches with attention
masks, the CFG dual batch, and MMU image-expanded sequences. All numpy — the
device only ever sees ready static-shape arrays.

Prompt-length bucketing (`bucket=32`) rounds batch length up so the jitted
decode programs see a small set of shapes instead of one per prompt length.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from plangen_tpu_torch.config import GenerationConfig
from plangen_tpu_torch.text.batching import (
    expand_image_tags,
    extend_mask_for_image,
    interleave_cfg,
    left_pad_batch,
    pad_to_common_length,
)
from plangen_tpu_torch.text.chat_template import MMU_QUESTION, DeepSeekTemplate
from plangen_tpu_torch.text.grounding import GROUNDING_OPEN
from plangen_tpu_torch.text.tokenizer import IMAGE_START_TAG, IMAGE_TAG, Tokenizer


def bucket_length(n: int, bucket: int = 32) -> int:
    return ((n + bucket - 1) // bucket) * bucket


@dataclass
class MMUBatch:
    input_ids: np.ndarray  # [B, L]
    attn_mask: np.ndarray  # [B, L]
    images_seq_mask: np.ndarray  # [B, L] bool


class PlanGenProcessor:
    def __init__(
        self,
        tokenizer: Tokenizer,
        image_tokens: int = 576,
        max_seq_len: int = 700,
        bucket: int = 32,
        gen: Optional[GenerationConfig] = None,
    ):
        self.tok = tokenizer
        self.template = DeepSeekTemplate()
        self.image_tokens = image_tokens
        self.max_seq_len = max_seq_len
        self.bucket = bucket
        self.gen = gen or GenerationConfig()

    # -- prompt wrapping (reference: plangen_base.py:210-291) ----------------

    def t2i_ids(self, caption: str) -> List[int]:
        return self.tok.encode(self.template.t2i_prompt(caption, IMAGE_START_TAG))

    def uni_ids(self, caption: str, grounding: str) -> List[int]:
        return self.tok.encode(
            self.template.uni_prompt(caption, grounding, IMAGE_START_TAG)
        )

    def stage1_ids(self, caption: str) -> List[int]:
        """Layout-planning prompt: ends right after the <grounding> token.

        wrap_uni_prompt(in_stage1=True) renders the assistant turn
        `<grounding>` + EOS and then drops the trailing EOS token id
        (plangen_base.py:255-260)."""
        ids = self.tok.encode(self.template.uni_prompt(caption, GROUNDING_OPEN, None))
        return ids[:-1]

    def mmu_ids(
        self, question: str = MMU_QUESTION, answer: str = ""
    ) -> Tuple[List[int], np.ndarray]:
        """MMU prompt with the image tag expanded to boi + N placeholders + eoi."""
        text = self.template.mmu_prompt(question, answer, IMAGE_TAG)
        ids = self.tok.encode(text)
        sp = self.tok.special
        return expand_image_tags(
            ids,
            image_tag_id=sp.image_tag_id,
            image_start_id=sp.image_start_id,
            image_end_id=sp.image_end_id,
            image_placeholder_id=sp.image_tag_id,
            num_image_tokens=self.image_tokens,
        )

    # -- batches -------------------------------------------------------------

    def _pad(
        self, ids_list: Sequence[Sequence[int]], for_train: bool = False
    ) -> Tuple[np.ndarray, np.ndarray]:
        max_len = bucket_length(max(len(x) for x in ids_list), self.bucket)
        ids, mask = left_pad_batch(
            ids_list,
            self.tok.special.pad_id,
            max_length=max_len,
            max_seq_len=self.max_seq_len if for_train else None,
        )
        return ids, mask

    def uni_batch(
        self, captions: Sequence[str], groundings: Sequence[str], for_train=False
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(ids [B, L], mask [B, L + image_tokens]) for the uni/t2i prompt."""
        ids, mask = self._pad(
            [self.uni_ids(c, g) for c, g in zip(captions, groundings)], for_train
        )
        return ids, extend_mask_for_image(mask, self.image_tokens)

    def stage1_batch(
        self, captions: Sequence[str], budget: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(ids [B, L], mask [B, L + budget]) for layout planning decode."""
        ids, mask = self._pad([self.stage1_ids(c) for c in captions])
        return ids, extend_mask_for_image(mask, budget)

    def mmu_batch(
        self,
        batch_size: int,
        question: str = MMU_QUESTION,
        answers: Optional[Sequence[str]] = None,
        decode_budget: int = 0,
    ) -> MMUBatch:
        rows = []
        masks = []
        for i in range(batch_size):
            ans = answers[i] if answers is not None else ""
            ids, seq_mask = self.mmu_ids(question, ans)
            rows.append(ids)
            masks.append(seq_mask)
        ids, attn = self._pad(rows)
        L = ids.shape[1]
        img_mask = np.zeros_like(ids, dtype=bool)
        for i, m in enumerate(masks):
            img_mask[i, L - len(rows[i]) :] = m
        if decode_budget:
            attn = extend_mask_for_image(attn, decode_budget)
        return MMUBatch(input_ids=ids, attn_mask=attn, images_seq_mask=img_mask)

    def cfg_batch(
        self,
        uni_ids: np.ndarray,  # [B, L] positive rows (already padded)
        uni_mask: np.ndarray,  # [B, L + image_tokens]
        neg_captions: Optional[Sequence[str]] = None,
        neg_groundings: Optional[Sequence[str]] = None,
        parallel_size: int = 1,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Build the interleaved cond/uncond dual batch.

        Default negative row = wrap_uni(neg_prompt, '') shared across the
        batch (plangen_base.py:672-686); with per-sample negatives
        (use_neg_box, removal mode) each row gets its own negative grounding
        (plangen_base.py:651-670). Returns ids [2*B*ps, L'], mask
        [2*B*ps, L' + image_tokens].
        """
        B = uni_ids.shape[0]
        text_mask = uni_mask[:, : uni_ids.shape[1]]
        if neg_captions is None and neg_groundings is None:
            neg_rows = [self.uni_ids(self.gen.neg_prompt, "")] * B
        else:
            # per-sample negatives (use_neg_box removal): a grounding without
            # captions rides the default neg prompt, matching the reference's
            # negative row construction (plangen_base.py:653-670)
            if neg_captions is None:
                neg_captions = [self.gen.neg_prompt] * B
            if neg_groundings is None:
                neg_groundings = [""] * B
            neg_rows = [
                self.uni_ids(c, g) for c, g in zip(neg_captions, neg_groundings)
            ]
        pos_ids, pos_mask, neg_ids, neg_mask = pad_to_common_length(
            uni_ids, text_mask, neg_rows, self.tok.special.pad_id
        )
        ids, mask = interleave_cfg(pos_ids, pos_mask, neg_ids, neg_mask)
        mask = extend_mask_for_image(mask, self.image_tokens)
        if parallel_size > 1:
            ids = np.concatenate([ids] * parallel_size, axis=0)
            mask = np.concatenate([mask] * parallel_size, axis=0)
        return ids, mask

    # -- decode --------------------------------------------------------------

    def decode_until_eos(self, token_rows: np.ndarray) -> List[str]:
        """Cut each row at EOS and decode (reference decode_mmu_text_batch,
        plangen_base.py:314-325)."""
        out = []
        eos = self.tok.special.eos_id
        for row in np.asarray(token_rows):
            row = list(row)
            if eos in row:
                row = row[: row.index(eos)]
            out.append(self.tok.decode(row))
        return out
