"""Tokenizer layer.

A copy of `plangen_tpu/text/tokenizer.py` (the port imports nothing of the
JAX package); tests/test_torch_copies.py holds the two equal.

Host-side text processing (the reference keeps HF's Rust tokenizers on host
too — SURVEY.md Table B). Two backends behind one protocol:

  * `HFTokenizerAdapter` — wraps the Janus-Pro LlamaTokenizerFast from a local
    checkout of `deepseek-ai/Janus-Pro-1B`, adding PlanGen's special tokens in
    exactly the reference's order so token ids match
    (reference: plangen_base.py:110-127 adds <grounding> </grounding> <box>
    </box> <ref> </ref>, then optional <h0..99>/<w0..99> pairs).
  * `ByteFallbackTokenizer` — a deterministic, dependency-free byte-level
    tokenizer with the same special-token surface, used for tests and for
    running the framework without the upstream checkpoint.

Special tags per janus/models/processing_vlm.py:88-92: image tag
"<image_placeholder>", image start/end "<begin_of_image>"/"<end_of_image>",
pad "<｜▁pad▁｜>"; bos/eos are the DeepSeek sentence tokens.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence

BOS_TEXT = "<｜begin▁of▁sentence｜>"
EOS_TEXT = "<｜end▁of▁sentence｜>"
PAD_TEXT = "<｜▁pad▁｜>"
IMAGE_TAG = "<image_placeholder>"
IMAGE_START_TAG = "<begin_of_image>"
IMAGE_END_TAG = "<end_of_image>"

GROUNDING_TOKENS = (
    "<grounding>",
    "</grounding>",
    "<box>",
    "</box>",
    "<ref>",
    "</ref>",
)


def numhw_tokens() -> List[str]:
    """<h0>,<w0>,<h1>,<w1>,... interleaved, matching reference add order
    (plangen_base.py:121-127)."""
    out: List[str] = []
    for i in range(100):
        out.append(f"<h{i}>")
        out.append(f"<w{i}>")
    return out


@dataclass(frozen=True)
class SpecialTokens:
    bos_id: int
    eos_id: int
    pad_id: int
    image_tag_id: int
    image_start_id: int
    image_end_id: int
    grounding_ids: Dict[str, int] = field(default_factory=dict)


class Tokenizer(Protocol):
    special: SpecialTokens
    vocab_size: int

    def encode(self, text: str, add_bos: bool = True) -> List[int]: ...
    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str: ...


class ByteFallbackTokenizer:
    """Byte-level tokenizer with PlanGen's special-token surface.

    Layout: [0]=bos [1]=eos [2]=pad [3]=image_tag [4]=image_start [5]=image_end
    [6..11]=grounding tokens [then optional 200 numhw tokens] [then 256 bytes].
    Deterministic and reversible; used when no Janus tokenizer is present.
    """

    def __init__(self, vocab_size: int = 102400, use_numhw: bool = False):
        specials = [
            BOS_TEXT,
            EOS_TEXT,
            PAD_TEXT,
            IMAGE_TAG,
            IMAGE_START_TAG,
            IMAGE_END_TAG,
            *GROUNDING_TOKENS,
        ]
        if use_numhw:
            specials += numhw_tokens()
        self._special_to_id = {tok: i for i, tok in enumerate(specials)}
        self._id_to_special = {i: tok for tok, i in self._special_to_id.items()}
        self._byte_offset = len(specials)
        min_vocab = self._byte_offset + 256
        if vocab_size < min_vocab:
            raise ValueError(f"vocab_size must be >= {min_vocab}")
        self.vocab_size = vocab_size
        self._special_re = re.compile(
            "|".join(re.escape(t) for t in sorted(specials, key=len, reverse=True))
        )
        self.special = SpecialTokens(
            bos_id=self._special_to_id[BOS_TEXT],
            eos_id=self._special_to_id[EOS_TEXT],
            pad_id=self._special_to_id[PAD_TEXT],
            image_tag_id=self._special_to_id[IMAGE_TAG],
            image_start_id=self._special_to_id[IMAGE_START_TAG],
            image_end_id=self._special_to_id[IMAGE_END_TAG],
            grounding_ids={t: self._special_to_id[t] for t in GROUNDING_TOKENS},
        )

    def token_id(self, token: str) -> int:
        return self._special_to_id[token]

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids: List[int] = [self.special.bos_id] if add_bos else []
        pos = 0
        for m in self._special_re.finditer(text):
            ids.extend(b + self._byte_offset for b in text[pos : m.start()].encode())
            ids.append(self._special_to_id[m.group(0)])
            pos = m.end()
        ids.extend(b + self._byte_offset for b in text[pos:].encode())
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        parts: List[str] = []
        byte_buf = bytearray()

        def flush():
            if byte_buf:
                parts.append(byte_buf.decode(errors="replace"))
                byte_buf.clear()

        for i in ids:
            i = int(i)
            if i in self._id_to_special:
                flush()
                if not skip_special_tokens:
                    parts.append(self._id_to_special[i])
            elif i >= self._byte_offset and i < self._byte_offset + 256:
                byte_buf.append(i - self._byte_offset)
            else:
                flush()  # out-of-range (e.g. untrained head sampled): drop
        flush()
        return "".join(parts)


class HFTokenizerAdapter:
    """Wraps the HF Janus tokenizer, replicating PlanGen's token additions."""

    def __init__(self, path: str, use_special_tokens: bool = True, use_numhw: bool = False):
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(path)
        # the Janus processor adds <image_placeholder> if missing
        # (processing_vlm.py:99-105); in the released checkpoint it exists.
        if tok.vocab.get(IMAGE_TAG) is None:
            tok.add_special_tokens({"additional_special_tokens": [IMAGE_TAG]})
        if use_special_tokens:
            tok.add_tokens(list(GROUNDING_TOKENS), special_tokens=True)
        if use_numhw:
            tok.add_tokens(numhw_tokens(), special_tokens=True)
        self._tok = tok
        self.vocab_size = len(tok)
        vocab = tok.get_vocab()
        self.special = SpecialTokens(
            bos_id=tok.bos_token_id,
            eos_id=tok.eos_token_id,
            pad_id=vocab[PAD_TEXT],  # pad via vocab, processing_vlm.py:196-205
            image_tag_id=vocab[IMAGE_TAG],
            image_start_id=vocab[IMAGE_START_TAG],
            image_end_id=vocab[IMAGE_END_TAG],
            grounding_ids={t: vocab[t] for t in GROUNDING_TOKENS if t in vocab},
        )

    def token_id(self, token: str) -> int:
        return self._tok.get_vocab()[token]

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        if add_bos:
            ids = [self.special.bos_id] + ids
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)


class NativeBPEAdapter:
    """Janus tokenizer via the native C++ BPE engine (no transformers/Rust).

    Parses the checkpoint's tokenizer.json directly and replicates PlanGen's
    token additions in the reference's order (plangen_base.py:110-127), so
    ids match HFTokenizerAdapter exactly (tested in tests/test_native_bpe.py).
    """

    def __init__(self, path: str, use_special_tokens: bool = True,
                 use_numhw: bool = False):
        from plangen_tpu_torch.text.bpe_native import NativeBPE

        tok = NativeBPE(os.path.join(path, "tokenizer.json"))
        known = lambda t: t in tok.added or t in tok.vocab
        if not known(IMAGE_TAG):
            tok.add_tokens([IMAGE_TAG])  # processing_vlm.py:99-105
        if use_special_tokens:
            tok.add_tokens(list(GROUNDING_TOKENS))
        if use_numhw:
            tok.add_tokens(numhw_tokens())
        self._tok = tok
        self.vocab_size = tok.total_size
        ids = {**tok.vocab, **tok.added}
        self._ids = ids
        self.special = SpecialTokens(
            bos_id=ids[BOS_TEXT],
            eos_id=ids[EOS_TEXT],
            pad_id=ids[PAD_TEXT],
            image_tag_id=ids[IMAGE_TAG],
            image_start_id=ids[IMAGE_START_TAG],
            image_end_id=ids[IMAGE_END_TAG],
            grounding_ids={t: ids[t] for t in GROUNDING_TOKENS if t in ids},
        )

    def token_id(self, token: str) -> int:
        return self._ids[token]

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = self._tok.encode(text)
        if add_bos:
            ids = [self.special.bos_id] + ids
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        return self._tok.decode(ids, skip_special=skip_special_tokens)


def load_tokenizer(
    janus_path: Optional[str] = None,
    vocab_size: int = 102400,
    use_special_tokens: bool = True,
    use_numhw: bool = False,
) -> Tokenizer:
    """Return the Janus tokenizer when a local path exists (HF adapter, or
    the native C++ BPE engine when transformers is unavailable), else the
    byte fallback."""
    if janus_path and os.path.isdir(janus_path):
        try:
            return HFTokenizerAdapter(
                janus_path, use_special_tokens=use_special_tokens,
                use_numhw=use_numhw,
            )
        except ImportError:
            from plangen_tpu_torch.text.bpe_native import native_bpe_available

            if native_bpe_available() and os.path.exists(
                os.path.join(janus_path, "tokenizer.json")
            ):
                return NativeBPEAdapter(
                    janus_path, use_special_tokens=use_special_tokens,
                    use_numhw=use_numhw,
                )
            raise
    return ByteFallbackTokenizer(vocab_size=vocab_size, use_numhw=use_numhw)
