"""Left-pad batching and CFG batch construction (host-side, numpy).

A copy of `plangen_tpu/text/batching.py` (the port imports nothing of the
JAX package); tests/test_torch_copies.py holds the two equal.

The reference LEFT-pads prompts to the batch max with the pad id, extends the
attention mask with ones for the 576 image positions, and interleaves
cond/uncond rows for classifier-free guidance.

Reference: pad_input_ids plangen_base.py:699-725 (left pad + tail-keeping
truncation to max_seq_len during training); t2i_infer_collate_batch
plangen_base.py:636-697 (negative row + interleave); add_image_token
processing_vlm.py:215-258 (MMU image tag expansion).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def left_pad_batch(
    ids_list: Sequence[Sequence[int]],
    pad_id: int,
    max_length: Optional[int] = None,
    max_seq_len: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Left-pad a list of token id sequences.

    Returns (ids [B, L] int32, mask [B, L] int32). When `max_seq_len` is given
    and L exceeds it, the HEAD is cut (tail kept), matching reference
    pad_input_ids (plangen_base.py:714-723).
    """
    bs = len(ids_list)
    if max_length is None:
        max_length = max(len(x) for x in ids_list)
    ids = np.full((bs, max_length), pad_id, dtype=np.int32)
    mask = np.zeros((bs, max_length), dtype=np.int32)
    for i, row in enumerate(ids_list):
        row = list(row)
        if len(row) > max_length:
            row = row[-max_length:]  # keep tail
        ids[i, max_length - len(row) :] = row
        mask[i, max_length - len(row) :] = 1
    if max_seq_len is not None and max_length > max_seq_len:
        ids = ids[:, max_length - max_seq_len :]
        mask = mask[:, max_length - max_seq_len :]
    return ids, mask


def extend_mask_for_image(mask: np.ndarray, image_tokens: int) -> np.ndarray:
    """Append `image_tokens` ones to the attention mask (plangen_base.py:777-782)."""
    bs = mask.shape[0]
    ones = np.ones((bs, image_tokens), dtype=mask.dtype)
    return np.concatenate([mask, ones], axis=-1)


def interleave_cfg(
    cond_ids: np.ndarray,
    cond_mask: np.ndarray,
    neg_ids: np.ndarray,
    neg_mask: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Interleave cond/uncond rows -> [2B, L], cond at even rows.

    Reference: t2i_infer_collate_batch stacking (plangen_base.py:690-691);
    the sampling loop reads logits[0::2] as cond, logits[1::2] as uncond
    (plangen_base.py:580-581).
    """
    bs, L = cond_ids.shape
    ids = np.stack([cond_ids, neg_ids], axis=1).reshape(bs * 2, -1)
    mask = np.stack([cond_mask, neg_mask], axis=1).reshape(bs * 2, -1)
    return ids, mask


def pad_to_common_length(
    ids_a: np.ndarray,
    mask_a: np.ndarray,
    ids_b_list: Sequence[Sequence[int]],
    pad_id: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Left-extend batch A and pad list B so both share one max length.

    Used to align the positive (already padded) batch with the negative-prompt
    rows (reference: plangen_base.py:654-690).
    Masks here exclude image positions; the caller extends them afterwards.
    """
    bs, len_a = ids_a.shape
    len_b = max(len(x) for x in ids_b_list)
    max_len = max(len_a, len_b)
    if max_len > len_a:
        extra = max_len - len_a
        ids_a = np.concatenate(
            [np.full((bs, extra), pad_id, dtype=ids_a.dtype), ids_a], axis=1
        )
        mask_a = np.concatenate(
            [np.zeros((bs, extra), dtype=mask_a.dtype), mask_a], axis=1
        )
    ids_b, mask_b = left_pad_batch(ids_b_list, pad_id, max_length=max_len)
    return ids_a, mask_a, ids_b, mask_b


def expand_image_tags(
    ids: Sequence[int],
    image_tag_id: int,
    image_start_id: int,
    image_end_id: int,
    image_placeholder_id: int,
    num_image_tokens: int,
) -> Tuple[List[int], np.ndarray]:
    """Replace each <image_placeholder> id with boi + N placeholder ids + eoi.

    Returns (expanded ids, images_seq_mask) where the mask is True on the N
    placeholder positions (NOT on boi/eoi), matching reference add_image_token
    (processing_vlm.py:215-258, add_special_token=False semantics: the tag id
    itself is replaced by the boi token).
    """
    out: List[int] = []
    mask: List[bool] = []
    for tok in ids:
        if int(tok) == image_tag_id:
            out.append(image_start_id)
            mask.append(False)
            out.extend([image_placeholder_id] * num_image_tokens)
            mask.extend([True] * num_image_tokens)
            out.append(image_end_id)
            mask.append(False)
        else:
            out.append(int(tok))
            mask.append(False)
    return out, np.asarray(mask, dtype=bool)
