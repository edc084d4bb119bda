"""Native byte-level BPE tokenizer (C++ merge engine, ctypes).

A copy of `plangen_tpu/text/bpe_native.py` (the port imports nothing of the
JAX package); tests/test_torch_copies.py holds the two equal.

Re-provides the reference's Rust `tokenizers` dependency natively
(SURVEY.md Table B: HF LlamaTokenizerFast -> tokenizers crate). The
DeepSeek-LLM / Janus-Pro tokenizer is a byte-level BPE (GPT-2 style):

  * this module parses the HF `tokenizer.json` (vocab + merges + added
    tokens), maps tokens from the byte-level unicode alphabet back to raw
    bytes, and resolves each merge rule to an id triple;
  * pre-tokenization (the GPT-2 split pattern) and added-token splitting
    run here on host;
  * the per-pre-token merge loop — the hot part — runs in C++
    (native/plangen_bpe.cc, `make -C native`).

Parity with the HF fast tokenizer is asserted in tests/test_native_bpe.py
on a merges-bearing fixture across ascii/unicode/digit/punctuation inputs.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_SO_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "libplangen_bpe.so",
)

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_SO_PATH):
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
        lib.bpe_create.restype = ctypes.c_void_p
        lib.bpe_create.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.bpe_free.argtypes = [ctypes.c_void_p]
        lib.bpe_encode.restype = ctypes.c_int32
        lib.bpe_encode.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def native_bpe_available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# byte-level alphabet (GPT-2 bytes_to_unicode)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode map (the alphabet the
    tokenizer.json vocab is written in)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


@lru_cache(maxsize=1)
def unicode_to_bytes() -> Dict[str, int]:
    return {v: k for k, v in bytes_to_unicode().items()}


def token_to_bytes(tok: str) -> Optional[bytes]:
    """Vocab token string (byte-unicode alphabet) -> raw bytes; None if the
    token contains characters outside the alphabet (added/special tokens)."""
    u2b = unicode_to_bytes()
    out = bytearray()
    for ch in tok:
        b = u2b.get(ch)
        if b is None:
            return None
        out.append(b)
    return bytes(out)


# ---------------------------------------------------------------------------
# GPT-2 pre-tokenization
# ---------------------------------------------------------------------------

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")

# regex \s = Unicode White_Space; Python isspace() additionally returns True
# for U+001C-001F (FILE/GROUP/RECORD/UNIT SEPARATOR), which the HF pattern
# classifies as punctuation
_NOT_WS = "\x1c\x1d\x1e\x1f"


def _is_space(ch: str) -> bool:
    return ch.isspace() and ch not in _NOT_WS


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


def pretokenize_gpt2(text: str) -> List[str]:
    """The GPT-2 split pattern, scanner form:

        's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+
        |\\s+(?!\\S)|\\s+

    Whitespace semantics: a run followed by non-space keeps its last char
    for the next pre-token's optional leading space (the regex's
    backtracked `\\s+(?!\\S)`); a trailing run is one token. Equivalence
    with HF's ByteLevel pre-tokenizer is asserted in tests.
    """
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        matched = False
        for c in _CONTRACTIONS:
            if text.startswith(c, i):
                out.append(c)
                i += len(c)
                matched = True
                break
        if matched:
            continue
        ch = text[i]
        lead = ""
        j = i
        if ch == " " and i + 1 < n and not _is_space(text[i + 1]):
            lead = " "
            j = i + 1
            ch = text[j]
        if not _is_space(ch):
            k = j + 1
            if _is_letter(ch):
                while k < n and _is_letter(text[k]):
                    k += 1
            elif _is_number(ch):
                while k < n and _is_number(text[k]):
                    k += 1
            else:
                while k < n and not _is_space(text[k]) and not _is_letter(text[k]) \
                        and not _is_number(text[k]):
                    k += 1
            out.append(lead + text[j:k])
            i = k
        else:
            k = i
            while k < n and _is_space(text[k]):
                k += 1
            if k == n:
                out.append(text[i:k])  # trailing whitespace: one token
                i = k
            elif k - i >= 2:
                # keep the run's last char for the next token's lead
                out.append(text[i : k - 1])
                i = k - 1
            else:
                # single non-' ' whitespace before non-space ('\n' etc.)
                out.append(ch)
                i += 1
    return out


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


# the exact GPT-2 split pattern as HF tokenizer.json Split rules spell it
_GPT2_SPLIT_PATTERN = (
    "'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+"
    "|\\s+(?!\\S)|\\s+"
)


def _check_bytelevel(bl: dict) -> Optional[str]:
    if bl.get("type") != "ByteLevel":
        return f"pre_tokenizer type {bl.get('type')!r}"
    if bl.get("add_prefix_space", False):
        return "ByteLevel add_prefix_space=true"
    return None


def _unsupported_spec(spec: dict) -> Optional[str]:
    """Return a reason string if tokenizer.json declares a normalizer or
    pre-tokenizer this engine does not implement, else None.

    This module hardcodes GPT-2 ByteLevel pre-tokenization
    (`pretokenize_gpt2`), so any checkpoint whose spec differs (e.g. a Split
    rule chunking digit runs) would silently produce diverging ids if
    accepted — raise instead so load_tokenizer surfaces the real problem.
    Accepted forms: no normalizer (or an empty Sequence); a plain ByteLevel
    pre-tokenizer with its internal regex; or the equivalent
    Sequence[Split(GPT-2 pattern), ByteLevel(use_regex=false)] spelling.
    """
    norm = spec.get("normalizer")
    if norm is not None and not (
        norm.get("type") == "Sequence" and not norm.get("normalizers")
    ):
        return f"normalizer {norm.get('type')!r}"
    pre = spec.get("pre_tokenizer")
    if pre is None:
        return "missing pre_tokenizer (byte-level BPE requires ByteLevel)"
    if pre.get("type") == "ByteLevel":
        if not pre.get("use_regex", True):
            return "ByteLevel use_regex=false without a Split rule"
        return _check_bytelevel(pre)
    if pre.get("type") == "Sequence":
        subs = pre.get("pretokenizers", [])
        if (
            len(subs) == 2
            and subs[0].get("type") == "Split"
            and subs[0].get("pattern", {}).get("Regex") == _GPT2_SPLIT_PATTERN
            and subs[0].get("behavior") in ("Isolated", "isolated")
            and subs[0].get("invert", False) is False
            and subs[1].get("type") == "ByteLevel"
            and not subs[1].get("use_regex", True)
        ):
            return _check_bytelevel(subs[1])
        return "pre_tokenizer Sequence (only Split(GPT-2)+ByteLevel supported)"
    return f"pre_tokenizer type {pre.get('type')!r}"


class NativeBPE:
    """tokenizer.json-driven byte-level BPE with the C++ merge engine."""

    def __init__(self, tokenizer_json: str):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "libplangen_bpe.so not built — run `make -C native`"
            )
        with open(tokenizer_json) as f:
            spec = json.load(f)
        reason = _unsupported_spec(spec)
        if reason is not None:
            raise ValueError(
                f"NativeBPE supports only GPT-2 ByteLevel pre-tokenization; "
                f"{tokenizer_json} declares {reason}. Install transformers "
                f"to use the HF tokenizer for this checkpoint."
            )
        model = spec["model"]
        assert model.get("type", "BPE") == "BPE", "only BPE models supported"
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.id_to_token = {i: t for t, i in self.vocab.items()}

        # added tokens (specials) — split before BPE, like HF AddedToken
        self.added: Dict[str, int] = {}
        for a in spec.get("added_tokens", []):
            self.added[a["content"]] = a["id"]
            self.id_to_token[a["id"]] = a["content"]
        self._rebuild_added()

        b2u = bytes_to_unicode()
        byte_init = np.full(256, -1, dtype=np.int32)
        for b in range(256):
            tid = self.vocab.get(b2u[b])
            if tid is not None:
                byte_init[b] = tid
        if (byte_init < 0).any():
            missing = int((byte_init < 0).sum())
            raise ValueError(f"vocab lacks {missing} byte-level alphabet entries")

        merges = model.get("merges", [])
        triples = np.empty((len(merges), 3), dtype=np.int32)
        for rank, m in enumerate(merges):
            left, right = m.split(" ", 1) if isinstance(m, str) else (m[0], m[1])
            triples[rank] = (
                self.vocab[left],
                self.vocab[right],
                self.vocab[left + right],
            )
        self._lib = lib
        self._handle = lib.bpe_create(
            byte_init.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            triples.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            np.int32(len(merges)),
        )

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib is not None:
            self._lib.bpe_free(self._handle)
            self._handle = None

    def _encode_span(self, span: str) -> List[int]:
        ids: List[int] = []
        for pre in pretokenize_gpt2(span):
            raw = pre.encode("utf-8")
            # per-call buffer: encode() is called from worker threads (e.g.
            # tasks/eval.py's batch-ahead tokenization) — a shared buffer
            # would interleave concurrent outputs. Merges only ever shrink
            # the token count, so len(raw) slots always suffice.
            out_buf = np.empty(max(1, len(raw)), dtype=np.int32)
            got = self._lib.bpe_encode(
                self._handle,
                (ctypes.c_uint8 * len(raw)).from_buffer_copy(raw),
                np.int32(len(raw)),
                out_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                np.int32(out_buf.size),
            )
            if got < 0:
                raise RuntimeError("bpe output buffer overflow")
            ids.extend(int(i) for i in out_buf[:got])
        return ids

    def add_tokens(self, tokens: Sequence[str]) -> None:
        """Append added tokens with sequential ids (HF add_tokens semantics:
        next id = current total size, where tokens listed in BOTH model.vocab
        and added_tokens count ONCE — the real DeepSeek tokenizer.json keeps
        its specials in both places)."""
        for t in tokens:
            if t in self.added or t in self.vocab:
                continue
            nid = self.total_size
            self.added[t] = nid
            self.id_to_token[nid] = t
        self._rebuild_added()

    def _rebuild_added(self) -> None:
        self._added_re = (
            re.compile(
                "|".join(
                    re.escape(t)
                    for t in sorted(self.added, key=len, reverse=True)
                )
            )
            if self.added
            else None
        )
        self._added_ids = frozenset(self.added.values())

    @property
    def total_size(self) -> int:
        # distinct tokens: added entries that shadow vocab entries (same id)
        # must not double-count
        novel = sum(1 for t in self.added if t not in self.vocab)
        return len(self.vocab) + novel

    def encode(self, text: str) -> List[int]:
        """Encode text (added/special tokens split first, no bos)."""
        if self._added_re is None:
            return self._encode_span(text)
        ids: List[int] = []
        pos = 0
        for m in self._added_re.finditer(text):
            if m.start() > pos:
                ids.extend(self._encode_span(text[pos : m.start()]))
            ids.append(self.added[m.group(0)])
            pos = m.end()
        if pos < len(text):
            ids.extend(self._encode_span(text[pos:]))
        return ids

    def decode(self, ids: Sequence[int], skip_special: bool = False) -> str:
        parts: List[str] = []
        buf = bytearray()

        def flush():
            if buf:
                parts.append(buf.decode("utf-8", errors="replace"))
                buf.clear()

        u2b = unicode_to_bytes()
        for i in ids:
            tok = self.id_to_token.get(int(i))
            if tok is None:
                continue
            if int(i) in self._added_ids or tok in self.added:
                flush()
                if not skip_special:
                    parts.append(tok)
                continue
            raw = token_to_bytes(tok)
            if raw is None:
                flush()
                parts.append(tok)
            else:
                buf.extend(raw)
        flush()
        return "".join(parts)
