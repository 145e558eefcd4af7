"""The cache's text encoder, restated: a feature-hashing word tokenizer and
a mean-pooled post-LN BERT encoder (Contriever's architecture), float32.

Weights are the benchmark's dict of tensors (``harness.weights.encoder``):
``tok_embed`` [V, d], ``pos_embed`` [max_len, d], ``ln_embed`` {w, b} and
per layer ``wq wk wv wo`` [d, d], ``ln1``, ``wi`` [d, F], ``bi``, ``wo2``
[F, d], ``bo2``, ``ln2``, all in ``x @ W`` layout.
"""
from __future__ import annotations

import hashlib
import re
from typing import List, Sequence

import torch
import torch.nn.functional as F

WORD_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)
PAD_ID, CLS_ID = 0, 1


def token_ids(text: str, vocab: int, max_len: int) -> List[int]:
    """[CLS] then one id per word or punctuation mark of the lowercased
    text, ``256 + blake2b-64(word) mod (vocab - 256)``, at most ``max_len``."""
    ids = [CLS_ID]
    for w in WORD_RE.findall(text.lower())[: max_len - 1]:
        h = hashlib.blake2b(w.encode("utf-8"), digest_size=8).digest()
        ids.append(256 + int.from_bytes(h, "little") % (vocab - 256))
    return ids


def _layer_norm(x, p, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["w"] + p["b"]


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest even), as float32:
    what a TF32 product does to its operands."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _exact(x):
    return x


def encode(weights: dict, ids: torch.Tensor, mask: torch.Tensor, heads: int,
           eps: float, rnd=_exact) -> torch.Tensor:
    """ids [n, L] int64, mask [n, L] float32 -> unit embeddings [n, d].
    ``rnd`` rounds every product's operands (``tf32`` for the control)."""
    n, L = ids.shape
    x = weights["tok_embed"][ids] + weights["pos_embed"][:L][None]
    x = _layer_norm(x, weights["ln_embed"], eps)
    bias = (1.0 - mask)[:, None, None, :] * -1e9
    mm = lambda a, b: rnd(a) @ rnd(b)  # noqa: E731
    for p in weights["layers"]:
        d = x.shape[-1]
        dh = d // heads
        q = mm(x, p["wq"]).view(n, L, heads, dh).transpose(1, 2)
        k = mm(x, p["wk"]).view(n, L, heads, dh).transpose(1, 2)
        v = mm(x, p["wv"]).view(n, L, heads, dh).transpose(1, 2)
        w = torch.softmax(mm(q, k.transpose(-1, -2)) / dh ** 0.5 + bias, dim=-1)
        o = mm(w, v).transpose(1, 2).reshape(n, L, d)
        x = _layer_norm(x + mm(o, p["wo"]), p["ln1"], eps)
        h = _gelu_tanh(mm(x, p["wi"]) + p["bi"])
        x = _layer_norm(x + mm(h, p["wo2"]) + p["bo2"], p["ln2"], eps)
    pooled = (x * mask[..., None]).sum(1) / mask.sum(1, keepdim=True).clamp(min=1.0)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-9)


@torch.no_grad()
def embed_texts(weights: dict, texts: Sequence[str], *, vocab: int, max_len: int, heads: int,
                eps: float, block_tokens: int = 1 << 16, rnd=_exact) -> torch.Tensor:
    """Unit embeddings [len(texts), d] on the weights' device, computed in
    blocks of texts of similar length (at most ``block_tokens`` padded
    tokens a block)."""
    dev = weights["tok_embed"].device
    enc = [token_ids(t, vocab, max_len) for t in texts]
    order = sorted(range(len(enc)), key=lambda i: len(enc[i]))
    out = torch.empty((len(enc), weights["tok_embed"].shape[1]), dtype=torch.float32,
                      device=dev)
    i = 0
    while i < len(order):
        L = len(enc[order[i]])
        j = i
        while j < len(order) and (j - i + 1) * len(enc[order[j]]) <= max(block_tokens, L):
            j += 1
        rows = order[i:j]
        L = len(enc[rows[-1]])
        ids = torch.zeros((len(rows), L), dtype=torch.int64)
        mask = torch.zeros((len(rows), L), dtype=torch.float32)
        for r, t in enumerate(rows):
            ids[r, :len(enc[t])] = torch.tensor(enc[t])
            mask[r, :len(enc[t])] = 1.0
        out[torch.tensor(rows, device=dev)] = encode(weights, ids.to(dev), mask.to(dev),
                                                     heads, eps, rnd)
        i = j
    return out
