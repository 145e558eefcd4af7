"""Deterministic offline tokenizer for the embedding encoder.

No external vocabularies are available offline, so this is a stable
feature-hashing word/byte tokenizer: words map to hashed ids in
[256, vocab), rare/unknown byte content falls back to byte ids [0, 256).
Deterministic across processes (uses blake2, not python hash()).
"""
from __future__ import annotations

import hashlib
import re
from typing import List

import numpy as np

_WORD_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)

_STOPWORDS = frozenset(
    "a an the is are was were be been being what which who whom how why when where "
    "do does did can could would should shall will may might must i you he she it we "
    "they me my your his her its our their of to in on at by for with about against "
    "and or not no nor so if then else as that this these those there here am please "
    "tell give describe explain me".split()
)


def _hash_word(word: str, vocab_size: int) -> int:
    h = hashlib.blake2b(word.encode("utf-8"), digest_size=8).digest()
    return 256 + int.from_bytes(h, "little") % (vocab_size - 256)


class HashTokenizer:
    """Stable word-level feature-hash tokenizer."""

    def __init__(self, vocab_size: int = 30522, max_len: int = 512, lowercase: bool = True):
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.lowercase = lowercase
        self.pad_id = 0
        self.cls_id = 1

    def encode(self, text: str) -> List[int]:
        if self.lowercase:
            text = text.lower()
        ids = [self.cls_id]
        for w in _WORD_RE.findall(text)[: self.max_len - 1]:
            ids.append(_hash_word(w, self.vocab_size))
        return ids

    def encode_batch(self, texts: List[str]) -> tuple:
        """Returns (ids [n, L] int32, mask [n, L] f32) padded to the longest."""
        encoded = [self.encode(t) for t in texts]
        L = max(8, max(len(e) for e in encoded))
        ids = np.zeros((len(texts), L), np.int32)
        mask = np.zeros((len(texts), L), np.float32)
        for i, e in enumerate(encoded):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1.0
        return ids, mask

    def ngrams(self, text: str, n_lo: int = 3, n_hi: int = 5) -> List[tuple]:
        """(hash, weight) features for the projection embedder: character
        n-grams (longer = heavier), content-word unigrams, and content-word
        bigrams. Function words are skipped at the word level so short
        template queries ("what is X?") don't dominate the content words."""
        if self.lowercase:
            text = text.lower()
        text = re.sub(r"\s+", " ", text.strip())
        out = []
        for n in range(n_lo, n_hi + 1):
            w = 0.15 * n  # char-grams give typo robustness; content words dominate
            for i in range(max(0, len(text) - n + 1)):
                g = text[i : i + n]
                h = hashlib.blake2b(g.encode("utf-8"), digest_size=8).digest()
                out.append((int.from_bytes(h, "little"), w))
        content = [w for w in _WORD_RE.findall(text) if w not in _STOPWORDS]
        for w_ in content:
            h = hashlib.blake2b(("w:" + w_).encode("utf-8"), digest_size=8).digest()
            out.append((int.from_bytes(h, "little"), 10.0))
        for a, b in zip(content, content[1:]):
            h = hashlib.blake2b(f"b:{a} {b}".encode("utf-8"), digest_size=8).digest()
            out.append((int.from_bytes(h, "little"), 12.0))
        return out
