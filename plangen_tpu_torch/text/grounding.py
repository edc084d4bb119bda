"""Layout <grounding> string (de)serialization.

A copy of `plangen_tpu/text/grounding.py` (the port imports nothing of the
JAX package); tests/test_torch_copies.py holds the two equal.

A layout is a list of (description, [x1, y1, x2, y2]) pairs with coordinates
normalized to [0, 1]. The textual wire format matches the reference:

    {caption} <grounding><ref>desc</ref><box>[x1, y1, x2, y2]</box>...</grounding>

with integer 0-1000 coordinates (`round(1000*t)`, str() of a Python list, so
", "-separated). The alternative <h/w>-token format uses 0-99 coords:
`<box><h12>,<w34>,<h56>,<w78></box>`.

Reference: serialization data_hico.py:151-183 (get_grounding); parsing
plangen_base.py:460-473 (trans_gr_to_creati) and :296-306
(decode_plan_text_batch).
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

Box = Tuple[float, float, float, float]

GROUNDING_OPEN = "<grounding>"
GROUNDING_CLOSE = "</grounding>"

_TEXTUAL_RE = re.compile(r"<ref>(.*?)</ref><box>\[(.*?)\]</box>")
_NUMHW_RE = re.compile(
    r"<ref>(.*?)</ref><box><h(\d+)>,<w(\d+)>,<h(\d+)>,<w(\d+)></box>"
)


def serialize_grounding(
    base_caption: str,
    boxes: Sequence[Sequence[float]],
    descriptions: Sequence[str],
    valid: Optional[Sequence[bool]] = None,
    textual: bool = True,
) -> str:
    """Serialize a layout into the grounding string.

    Matches reference `Hico_dataset.get_grounding` (data_hico.py:151-183):
    returns the bare caption when there are no (valid) boxes; otherwise
    `{caption} <grounding>...</grounding>` (no leading space if caption empty).
    """
    any_valid = False
    for i in range(len(boxes)):
        if (valid is None or valid[i]) and any(abs(c) > 0 for c in boxes[i]):
            any_valid = True
            break
    if len(boxes) == 0 or not any_valid:
        return base_caption

    prompt = f"{base_caption} {GROUNDING_OPEN}" if base_caption else GROUNDING_OPEN
    for i, (box, des) in enumerate(zip(boxes, descriptions)):
        if valid is not None and not valid[i]:
            continue
        if textual:
            nbox = [round(1000 * float(t)) for t in box]
            prompt += f"<ref>{des}</ref>"
            prompt += f"<box>{nbox}</box>"
        else:
            nbox = [round(99 * float(t)) for t in box]
            tags = [f"<h{nbox[0]}>", f"<w{nbox[1]}>", f"<h{nbox[2]}>", f"<w{nbox[3]}>"]
            prompt += f"<ref>{des}</ref>"
            prompt += f"<box>{','.join(tags)}</box>"
    return prompt + GROUNDING_CLOSE


def parse_grounding(text: str, textual: bool = True) -> Tuple[List[Box], List[str]]:
    """Parse (boxes, descriptions) out of a grounding string.

    Matches reference `trans_gr_to_creati` (plangen_base.py:460-473): regex over
    <ref>/<box> pairs, integer coords / 1000 (textual) or / 99 (numhw). Silently
    skips malformed pairs, like the reference regex does.
    """
    boxes: List[Box] = []
    descs: List[str] = []
    if textual:
        for desc, body in _TEXTUAL_RE.findall(text):
            try:
                x1, y1, x2, y2 = (int(v) for v in body.split(","))
            except ValueError:
                continue
            boxes.append((x1 / 1000, y1 / 1000, x2 / 1000, y2 / 1000))
            descs.append(desc)
    else:
        for desc, h1, w1, h2, w2 in _NUMHW_RE.findall(text):
            boxes.append((int(h1) / 99, int(w1) / 99, int(h2) / 99, int(w2) / 99))
            descs.append(desc)
    return boxes, descs


def truncate_grounding(decoded_text: str) -> str:
    """Normalize a stage-1 layout decode into `<grounding>...</grounding>`.

    The stage-1 prompt already ends with the `<grounding>` token, so the model
    continuation lacks the opening tag; prepend it and cut at the close tag.
    Empty grounding when no close tag is produced.
    Reference: decode_plan_text_batch, plangen_base.py:296-306.
    """
    text = GROUNDING_OPEN + decoded_text
    end = text.find(GROUNDING_CLOSE)
    if end != -1:
        return text[: end + len(GROUNDING_CLOSE)]
    return GROUNDING_OPEN + GROUNDING_CLOSE


def extract_grounding_part(text: str) -> str:
    """Drop everything before the first `<grounding>` tag.

    Reference: get_pr_grounding_part, plangen_base.py:308-312.
    """
    pos = text.find(GROUNDING_OPEN)
    return text[pos:] if pos != -1 else text
