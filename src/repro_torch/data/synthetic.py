"""Deterministic synthetic data.

markov_token_stream — LM training batches from a fixed random bigram chain:
unlike uniform noise it has learnable structure, so a training run shows the
loss dropping below log(V) (used by examples/train_lm.py).

squad_like_qa — paraphrase-clustered QA pairs mirroring how the paper uses
SQuAD for cache experiments: each cluster has one canonical answer and a set
of paraphrases with controllable lexical overlap, so semantic-cache hit-rate
and the generative-combination behavior can be measured deterministically.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

# -- LM token stream ----------------------------------------------------------


def _bigram_logits(vocab: int, seed: int, branch: int = 32) -> np.ndarray:
    """Sparse-ish bigram transition table: each token has `branch` likely successors."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, size=(vocab, branch))
    return succ


def markov_token_stream(vocab: int, batch: int, seq_len: int, *, seed: int = 0):
    """Infinite iterator of [batch, seq_len] int32 batches (deterministic)."""
    succ = _bigram_logits(vocab, seed)
    step = 0
    while True:
        rng = np.random.default_rng((seed << 20) ^ step)
        toks = np.empty((batch, seq_len), np.int32)
        toks[:, 0] = rng.integers(0, vocab, size=batch)
        choices = rng.integers(0, succ.shape[1], size=(batch, seq_len))
        noise = rng.random((batch, seq_len)) < 0.05  # 5% random restarts
        rand_toks = rng.integers(0, vocab, size=(batch, seq_len))
        for t in range(1, seq_len):
            nxt = succ[toks[:, t - 1], choices[:, t]]
            toks[:, t] = np.where(noise[:, t], rand_toks[:, t], nxt)
        yield toks
        step += 1


# -- SQuAD-like QA clusters -----------------------------------------------------

_TOPICS = [
    "denial of service attacks", "transformer attention", "photosynthesis",
    "the french revolution", "tcp congestion control", "quantum entanglement",
    "gradient descent", "the krebs cycle", "plate tectonics", "public key cryptography",
    "virtual memory paging", "the roman senate", "mitochondrial dna", "b-tree indexes",
    "the doppler effect", "garbage collection", "monetary policy", "speciation",
    "raft consensus", "convolutional networks",
]

_Q_TEMPLATES = [
    "What is {t}?",
    "Please explain {t}.",
    "I would like to learn about {t}. Can you describe it?",
    "Give me an overview of {t}.",
    "How does {t} work?",
    "Describe the key ideas behind {t}.",
    "Could you tell me about {t} in detail?",
    "Summarize {t} for me.",
]

_ASPECTS = ["defending against", "the history of", "common examples of", "limitations of"]


def squad_like_qa(
    n_clusters: int = 20,
    paraphrases: int = 4,
    *,
    seed: int = 0,
    with_aspects: bool = False,
) -> List[Tuple[str, str, int]]:
    """Returns [(question, answer, cluster_id)]. Paraphrases within a cluster
    share the topic phrase (high lexical overlap — semantically similar);
    distinct clusters are unrelated. with_aspects adds 'aspect' clusters
    (e.g. 'defending against X') that pair with base clusters for generative
    combination experiments."""
    rng = np.random.default_rng(seed)
    out = []
    cid = 0
    for i in range(n_clusters):
        topic = _TOPICS[i % len(_TOPICS)]
        answer = f"Canonical answer about {topic} (cluster {cid})."
        order = rng.permutation(len(_Q_TEMPLATES))[:paraphrases]
        for j in order:
            out.append((_Q_TEMPLATES[j].format(t=topic), answer, cid))
        cid += 1
        if with_aspects:
            aspect = _ASPECTS[i % len(_ASPECTS)]
            answer_a = f"Canonical answer about {aspect} {topic} (cluster {cid})."
            for j in rng.permutation(len(_Q_TEMPLATES))[:paraphrases]:
                out.append((_Q_TEMPLATES[j].format(t=f"{aspect} {topic}"), answer_a, cid))
            cid += 1
    return out
