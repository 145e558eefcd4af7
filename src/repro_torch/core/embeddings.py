"""Pluggable embedding models (the paper's "embeddings manager").

The paper's measured default is facebook/contriever-msmarco run locally; it
is implemented here as a PyTorch encoder (random-init offline — the
similarity *math* and performance profile are what the cache exercises).
``encoder_from_jax_params`` carries the reference package's parameter tree
over, so both packages compute the same embedding.

For functional end-to-end tests there is also ``NgramHashEmbedder``: a
deterministic character-n-gram feature-hashing embedder whose cosine
similarity genuinely tracks text overlap, so semantic-cache behavior
(hit/miss/generative-combination) is observable without pretrained weights.

New models plug in by subclassing EmbeddingModel and registering.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.contriever import CONTRIEVER_MSMARCO, E5_LARGE_V2, EncoderConfig
from repro_torch.configs.contriever import smoke as contriever_smoke
from repro_torch.core.tokenizer import HashTokenizer
from repro_torch.kernels.backend import DeviceLike, resolve_device


def _identity_forward(vecs):
    """Device leg of the default fused forward: the embedding was computed
    host-side, so the read program just consumes the uploaded [B, D] block."""
    return vecs


class EmbeddingModel:
    """Interface: embed a batch of texts into L2-normalized vectors."""

    name: str = "base"
    dim: int = 0

    def embed(self, texts: List[str]) -> np.ndarray:  # [n, dim], unit-norm
        raise NotImplementedError

    def embed_one(self, text: str) -> np.ndarray:
        return self.embed([text])[0]

    def embed_batch(self, texts: List[str]) -> np.ndarray:
        """Batched entry point for the cache pipeline (one forward for the
        whole request batch); semantically identical to ``embed``."""
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        return self.embed(texts)

    # -- read path (repro_torch.core.read_path) ---------------------------------

    def fused_forward(self):
        """The split of ``embed_batch`` the fused read program uses:
        ``(prepare, forward)`` where ``prepare(texts) -> (args, n, B)`` runs
        host-side (tokenize / featurize, B power-of-two bucketed >= n) and
        ``forward(*args) -> [B, dim]`` runs on the read's device, so embed
        -> search -> decide -> touch needs no host hop between stages. Host
        numpy ``args`` are uploaded by the read path. The default runs the
        whole embedding host-side in ``prepare`` and uploads the [B, D]
        block once. The pair is cached per instance."""
        if getattr(self, "_fused_fwd", None) is None:

            def prepare(texts: List[str]):
                from repro_torch.core.store_bank import pad_to_bucket

                vecs, n = pad_to_bucket(
                    np.asarray(self.embed_batch(list(texts)), np.float32)
                )
                return (vecs,), n, vecs.shape[0]

            self._fused_fwd = (prepare, _identity_forward)
        return self._fused_fwd


# ---------------------------------------------------------------------------
# N-gram feature-hash embedder (deterministic, overlap-sensitive)
# ---------------------------------------------------------------------------


class NgramHashEmbedder(EmbeddingModel):
    name = "ngram-hash"

    def __init__(self, dim: int = 256):
        self.dim = dim
        self.tok = HashTokenizer()

    def embed(self, texts: List[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            for h, w in self.tok.ngrams(t):
                idx = h % self.dim
                sign = 1.0 if (h >> 17) & 1 else -1.0
                out[i, idx] += sign * w
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-9)


# ---------------------------------------------------------------------------
# Contriever-style PyTorch encoder
# ---------------------------------------------------------------------------


def _bucket(n: int, start: int) -> int:
    b = start
    while b < n:
        b *= 2
    return b


class _LayerNorm(nn.Module):
    """Post-LN with the population variance (``jnp.var``: correction 0)."""

    def __init__(self, d: int, eps: float, device):
        super().__init__()
        self.w = nn.Parameter(torch.ones(d, device=device), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(d, device=device), requires_grad=False)
        self.eps = eps

    def forward(self, x):
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, correction=0)
        return (x - mu) * torch.rsqrt(var + self.eps) * self.w + self.b


class _Block(nn.Module):
    """One post-LN BERT block. Weights keep the reference's ``x @ W``
    layout ([d_in, d_out]), so a carried parameter tree loads as is."""

    def __init__(self, cfg: EncoderConfig, gen: torch.Generator, device):
        super().__init__()
        d, F_ = cfg.d_model, cfg.d_ff

        def dense(shape, fan_in=None):
            fan_in = fan_in or shape[0]
            w = torch.randn(shape, generator=gen, device=device) * (fan_in ** -0.5)
            return nn.Parameter(w, requires_grad=False)

        self.wq = dense((d, d))
        self.wk = dense((d, d))
        self.wv = dense((d, d))
        self.wo = dense((d, d))
        self.ln1 = _LayerNorm(d, cfg.norm_eps, device)
        self.wi = dense((d, F_))
        self.bi = nn.Parameter(torch.zeros(F_, device=device), requires_grad=False)
        self.wo2 = dense((F_, d), F_)
        self.bo2 = nn.Parameter(torch.zeros(d, device=device), requires_grad=False)
        self.ln2 = _LayerNorm(d, cfg.norm_eps, device)
        self.H = cfg.num_heads

    def forward(self, x, attn_bias):
        n, L, d = x.shape
        H = self.H
        dh = d // H
        q = (x @ self.wq).view(n, L, H, dh)
        k = (x @ self.wk).view(n, L, H, dh)
        v = (x @ self.wv).view(n, L, H, dh)
        # plain matmul + softmax attention, as in the reference encoder
        s = torch.einsum("nqhd,nkhd->nhqk", q, k) / (dh ** 0.5) + attn_bias
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("nhqk,nkhd->nqhd", w, v).reshape(n, L, d)
        x = self.ln1(x + o @ self.wo)
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ self.wi + self.bi, approximate="tanh")
        return self.ln2(x + h @ self.wo2 + self.bo2)


class ContrieverEncoder(nn.Module, EmbeddingModel):
    """Mean-pooled post-LN transformer bi-encoder (contriever architecture).

    Parameters live on ``device`` (None = CUDA, raising without one) and are
    drawn from a ``torch.Generator`` seeded with ``seed`` — not the
    reference's ``jax.random`` numbers; ``load_jax_params`` carries those
    over when both packages must agree."""

    def __init__(self, cfg: EncoderConfig = CONTRIEVER_MSMARCO, seed: int = 0,
                 device: DeviceLike = None):
        nn.Module.__init__(self)
        self.cfg = cfg
        self.name = cfg.name
        self.dim = cfg.d_model
        self.device = resolve_device(device)
        self.tok = HashTokenizer(vocab_size=cfg.vocab_size, max_len=cfg.max_seq_len)
        d = cfg.d_model
        gen = torch.Generator(device=self.device).manual_seed(seed)
        std = d ** -0.5
        self.tok_embed = nn.Parameter(
            torch.randn((cfg.vocab_size, d), generator=gen, device=self.device) * std,
            requires_grad=False,
        )
        self.pos_embed = nn.Parameter(
            torch.randn((cfg.max_seq_len, d), generator=gen, device=self.device) * std,
            requires_grad=False,
        )
        self.ln_embed = _LayerNorm(d, cfg.norm_eps, self.device)
        self.layers = nn.ModuleList(
            _Block(cfg, gen, self.device) for _ in range(cfg.num_layers)
        )
        self._fused_fwd = None

    @torch.no_grad()
    def load_jax_params(self, params: dict) -> "ContrieverEncoder":
        """Copy the reference encoder's parameter tree (numpy arrays, e.g.
        ``jax.tree_util.tree_map(np.asarray, enc.params)``) into this module."""

        def put(dst: torch.Tensor, src) -> None:
            src = torch.from_numpy(np.array(src, np.float32))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"shape {tuple(src.shape)} != {tuple(dst.shape)}")
            dst.copy_(src)

        def put_ln(ln: _LayerNorm, p: dict) -> None:
            put(ln.w, p["w"])
            put(ln.b, p["b"])

        if len(params["layers"]) != len(self.layers):
            raise ValueError(
                f"{len(params['layers'])} layers for a {len(self.layers)}-layer encoder"
            )
        put(self.tok_embed, params["tok_embed"])
        put(self.pos_embed, params["pos_embed"])
        put_ln(self.ln_embed, params["ln_embed"])
        for blk, lp in zip(self.layers, params["layers"]):
            for name in ("wq", "wk", "wv", "wo", "wi", "bi", "wo2", "bo2"):
                put(getattr(blk, name), lp[name])
            put_ln(blk.ln1, lp["ln1"])
            put_ln(blk.ln2, lp["ln2"])
        return self

    @torch.no_grad()
    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """ids [n, L] int, mask [n, L] f32 -> unit embeddings [n, d]."""
        n, L = ids.shape
        x = self.tok_embed[ids.long()] + self.pos_embed[:L][None]
        x = self.ln_embed(x)
        attn_bias = (1.0 - mask)[:, None, None, :] * -1e9  # [n, 1, 1, L]
        for blk in self.layers:
            x = blk(x, attn_bias)
        # mean pooling over valid tokens (contriever)
        pooled = (x * mask[..., None]).sum(1) / torch.clamp(mask.sum(1, keepdim=True), min=1.0)
        return pooled / torch.clamp(
            torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-9
        )

    def _tokenize(self, texts: List[str]):
        """Host tokenization, padded to power-of-two buckets: B from 1, L
        from 8 (the reference's buckets)."""
        ids, mask = self.tok.encode_batch(texts)
        n, L = ids.shape
        Lb = _bucket(L, 8)
        Bb = _bucket(n, 1)
        if (Bb - n) or (Lb - L):
            ids = np.pad(ids, ((0, Bb - n), (0, Lb - L)))
            mask = np.pad(mask, ((0, Bb - n), (0, Lb - L)))
        return ids.astype(np.int64), mask, n, Bb

    def embed(self, texts: List[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        ids, mask, n, _ = self._tokenize(texts)
        out = self(
            torch.as_tensor(ids, device=self.device),
            torch.as_tensor(mask, device=self.device),
        )
        return out[:n].cpu().numpy()

    def fused_forward(self):
        """``prepare`` only tokenizes (host); the encoder runs on the read's
        device inside the read program — token ids in, decisions out, with
        the [B, D] embedding leaving the device only with the decisions."""
        if self._fused_fwd is None:

            def prepare(texts: List[str]):
                ids, mask, n, Bb = self._tokenize(texts)
                return (ids, mask), n, Bb

            self._fused_fwd = (prepare, self)
        return self._fused_fwd


def encoder_from_jax_params(params_numpy: dict, cfg: EncoderConfig,
                            device: DeviceLike = None) -> ContrieverEncoder:
    """Build the port's encoder from the reference encoder's parameter tree
    (numpy arrays: ``tok_embed``, ``pos_embed``, ``ln_embed`` and per layer
    ``wq/wk/wv/wo/ln1/wi/bi/wo2/bo2/ln2``, in ``x @ W`` layout)."""
    return ContrieverEncoder(cfg, device=device).load_jax_params(params_numpy)


# ---------------------------------------------------------------------------
# Simulated remote models (the paper's OpenAI embedding endpoints)
# ---------------------------------------------------------------------------


class SimulatedRemoteEmbedder(EmbeddingModel):
    """Wraps a local embedder with the paper's remote-call profile:
    network latency + per-token monetary cost (Fig 7 / §2 discussion)."""

    def __init__(self, base: EmbeddingModel, name: str, latency_s: float, usd_per_mtok: float):
        self.base = base
        self.name = name
        self.dim = base.dim
        self.latency_s = latency_s
        self.usd_per_mtok = usd_per_mtok
        self.total_cost = 0.0

    def embed(self, texts: List[str]) -> np.ndarray:
        time.sleep(self.latency_s)  # simulated RTT
        self.total_cost += sum(len(t.split()) for t in texts) * self.usd_per_mtok / 1e6
        return self.base.embed(texts)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., EmbeddingModel]] = {}


def register(name: str, factory: Callable[..., EmbeddingModel]) -> None:
    _REGISTRY[name] = factory


def get_embedder(name: str, device: Optional[DeviceLike] = None) -> EmbeddingModel:
    """Build a registered embedder; ``device`` reaches the encoders (host
    embedders ignore it)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown embedder {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](device)


register("ngram-hash", lambda device: NgramHashEmbedder())
register("contriever-msmarco", lambda device: ContrieverEncoder(CONTRIEVER_MSMARCO, device=device))
register("e5-large-v2", lambda device: ContrieverEncoder(E5_LARGE_V2, device=device))
register("contriever-smoke", lambda device: ContrieverEncoder(contriever_smoke(), device=device))
# the paper's three OpenAI endpoints, simulated with their latency ordering
register(
    "text-embedding-ada-002",
    lambda device: SimulatedRemoteEmbedder(
        NgramHashEmbedder(1536), "text-embedding-ada-002", 0.05, 100.0),
)
register(
    "text-embedding-3-small",
    lambda device: SimulatedRemoteEmbedder(
        NgramHashEmbedder(1536), "text-embedding-3-small", 0.06, 20.0),
)
register(
    "text-embedding-3-large",
    lambda device: SimulatedRemoteEmbedder(
        NgramHashEmbedder(3072), "text-embedding-3-large", 0.08, 130.0),
)
