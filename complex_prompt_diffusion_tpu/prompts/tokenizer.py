"""CLIP BPE tokenizer (host-side, zero-dependency on HF hub).

The reference delegates to ``transformers.CLIPTokenizer`` /
``open_clip.tokenize`` (embedder.py:803,880), which require downloaded vocab
files. Here the BPE algorithm is implemented directly; vocab is loaded from
local files when available:
  * HF format: ``vocab.json`` + ``merges.txt``
  * OpenAI/OpenCLIP format: ``bpe_simple_vocab_16e6.txt.gz``

When no vocab file is present (air-gapped test environments) a deterministic
:class:`HashTokenizer` stands in: it preserves the sequence contract
(BOS/EOS/padding/truncation at 77) so every downstream component is
exercisable; real checkpoints ship with their vocab.

Padding conventions differ between the towers and matter for parity:
HF CLIPTokenizer pads with EOS (SD 1.x); OpenCLIP pads with 0 (SD 2.x).
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
import unicodedata
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["ClipBPETokenizer", "HashTokenizer", "get_tokenizer"]

# vocab files looked for in <checkout>/assets when no path is given
_ASSETS = Path(__file__).resolve().parents[2] / "assets"

# Unicode White_Space, the set the ``regex`` package's \s matches (the
# stdlib's \s adds U+001C-U+001F).
_WS = (
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f"
    "\u205f\u3000"
)


def _category_class(prefix: str) -> str:
    """Regex character-class body covering every code point whose Unicode
    general category starts with ``prefix`` ("L" letters, "N" numbers)."""
    parts, start = [], None
    for cp in range(0x110001):
        inside = cp <= 0x10FFFF and unicodedata.category(chr(cp)).startswith(
            prefix
        )
        if inside and start is None:
            start = cp
        elif not inside and start is not None:
            a, b = re.escape(chr(start)), re.escape(chr(cp - 1))
            parts.append(a if start == cp - 1 else f"{a}-{b}")
            start = None
    return "".join(parts)


@functools.lru_cache(maxsize=1)
def _pattern() -> "re.Pattern":
    """CLIP's pre-tokenisation pattern in the stdlib ``re``:
    ``'s|'t|...|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` with the
    property classes spelled out. Inputs are lowercased first, so case
    folding is not needed; U+0345 (a combining mark that case-folds to a
    letter) is left unmatched, as the ``regex`` package leaves it."""
    letters, numbers = _category_class("L"), _category_class("N")
    return re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        f"|[{letters}]+|[{numbers}]|[^{_WS}\u0345{letters}{numbers}]+"
    )


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte -> printable-unicode map (GPT-2/CLIP convention)."""
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


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(f"[{_WS}]+", " ", text)
    return text.strip()


class _TokenizerBase:
    """Shared sequence assembly: BOS + tokens + EOS, pad/truncate to 77."""

    bos_id: int
    eos_id: int
    pad_id: int
    max_length: int = 77

    def encode_text(self, text: str) -> List[int]:
        raise NotImplementedError

    def __call__(self, texts, max_length: Optional[int] = None) -> np.ndarray:
        """Tokenize str or list[str] -> int32 [N, max_length]."""
        if isinstance(texts, str):
            texts = [texts]
        L = max_length or self.max_length
        out = np.full((len(texts), L), self.pad_id, dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.bos_id] + self.encode_text(text)[: L - 2] + [self.eos_id]
            out[i, : len(ids)] = ids
        return out


class ClipBPETokenizer(_TokenizerBase):
    """Byte-pair-encoding tokenizer with the CLIP text regex and </w>
    end-of-word convention."""

    def __init__(
        self,
        vocab_path: str,
        merges_path: Optional[str] = None,
        pad_with_eos: bool = True,
    ):
        if vocab_path.endswith(".gz"):
            # OpenAI bpe_simple_vocab_16e6.txt.gz: merges define the vocab
            with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
                merges = f.read().split("\n")
            merges = [tuple(m.split()) for m in merges[1 : 49152 - 256 - 2 + 1]]
            vocab = [v for v in bytes_to_unicode().values()]
            vocab = vocab + [v + "</w>" for v in vocab]
            for m in merges:
                vocab.append("".join(m))
            vocab.extend(["<|startoftext|>", "<|endoftext|>"])
            self.encoder = dict(zip(vocab, range(len(vocab))))
        else:
            with open(vocab_path, encoding="utf-8") as f:
                self.encoder = json.load(f)
            if merges_path is None:
                merges_path = os.path.join(os.path.dirname(vocab_path), "merges.txt")
            with open(merges_path, encoding="utf-8") as f:
                lines = f.read().split("\n")
            merges = [
                tuple(m.split())
                for m in lines
                if m and not m.startswith("#version")
            ]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = bytes_to_unicode()
        self.cache = {}
        self.bos_id = self.encoder["<|startoftext|>"]
        self.eos_id = self.encoder["<|endoftext|>"]
        self.pad_id = self.eos_id if pad_with_eos else 0

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in _pattern().findall(_clean(text).lower()):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids


class HashTokenizer(_TokenizerBase):
    """Deterministic stand-in when no vocab file is available: one id per
    whitespace/punctuation token via stable FNV-1a hashing into
    [n_special, vocab_size). Sequence layout (BOS/EOS/pad/77) matches CLIP."""

    def __init__(
        self,
        vocab_size: int = 49408,
        pad_with_eos: bool = True,
    ):
        self.vocab_size = vocab_size
        self.bos_id = vocab_size - 2
        self.eos_id = vocab_size - 1
        self.pad_id = self.eos_id if pad_with_eos else 0

    @staticmethod
    def _fnv1a(s: str) -> int:
        h = 0x811C9DC5
        for ch in s.encode("utf-8"):
            h = ((h ^ ch) * 0x01000193) & 0xFFFFFFFF
        return h

    def encode_text(self, text: str) -> List[int]:
        toks = _pattern().findall(_clean(text).lower())
        space = self.vocab_size - 3
        return [1 + self._fnv1a(t) % (space - 1) for t in toks]


def get_tokenizer(
    vocab_path: Optional[str] = None,
    merges_path: Optional[str] = None,
    pad_with_eos: bool = True,
    vocab_size: int = 49408,
) -> _TokenizerBase:
    """Return a real BPE tokenizer if vocab files exist, else the hash
    fallback. Searches common local paths when vocab_path is None."""
    candidates = [vocab_path] if vocab_path else []
    candidates += [
        os.environ.get("CPD_TPU_CLIP_VOCAB", ""),
        str(_ASSETS / "vocab.json"),
        str(_ASSETS / "bpe_simple_vocab_16e6.txt.gz"),
    ]
    for cand in candidates:
        if cand and os.path.exists(cand):
            return ClipBPETokenizer(cand, merges_path, pad_with_eos)
    return HashTokenizer(vocab_size=vocab_size, pad_with_eos=pad_with_eos)
