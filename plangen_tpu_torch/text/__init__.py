"""Host-side text handling: copies of `plangen_tpu/text/` (the port imports
nothing of the JAX package)."""

from plangen_tpu_torch.text.chat_template import DeepSeekTemplate, Message
from plangen_tpu_torch.text.grounding import (
    serialize_grounding,
    parse_grounding,
    truncate_grounding,
)
from plangen_tpu_torch.text.tokenizer import (
    SpecialTokens,
    ByteFallbackTokenizer,
    load_tokenizer,
)
from plangen_tpu_torch.text.batching import (
    left_pad_batch,
    interleave_cfg,
    extend_mask_for_image,
)

__all__ = [
    "DeepSeekTemplate",
    "Message",
    "serialize_grounding",
    "parse_grounding",
    "truncate_grounding",
    "SpecialTokens",
    "ByteFallbackTokenizer",
    "load_tokenizer",
    "left_pad_batch",
    "interleave_cfg",
    "extend_mask_for_image",
]
