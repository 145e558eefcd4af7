"""The one traffic generator: it reads a mix's parameters (a JSON file
under ``bench/traffic/``) and makes, from ``--seed``, the cached corpus,
the candidate requests and the open-loop arrival schedule.

The corpus follows ``squad_like_qa``'s shape (clusters of paraphrases of
one question, each with one canonical answer, aspect clusters paired with
base clusters) with its eight question templates, but every topic is a
distinct phrase of seeded pseudo-words, so no two clusters share a
question text at any size.

Arrivals are one realisation of a Poisson process, drawn from a fixed
stream, and so are the positions of the fresh-document requests: every
seed offers the same load at the same instants. The seed draws the
content: the corpus, which cluster and paraphrase each request asks, and
each document's words.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

TEMPLATES = [
    "What is {t}?",
    "Please explain {t}.",
    "I would like to learn about {t}. Can you describe it?",
    "Give me an overview of {t}.",
    "How does {t} work?",
    "Describe the key ideas behind {t}.",
    "Could you tell me about {t} in detail?",
    "Summarize {t} for me.",
]
ASPECTS = ["defending against", "the history of", "common examples of", "limitations of"]
_SYLLABLES = ["ka", "ro", "mi", "te", "su", "lo", "ven", "dra", "pi", "nu", "zor", "qua", "bel",
              "tis", "fen", "gal", "mor", "shi", "da", "vex", "lu", "cor", "ny", "pha"]
SCHEDULE_STREAM = 0x5EED  # the fixed stream of the arrival instants and the documents' positions


@dataclass
class Cluster:
    cid: int
    answer: str
    inserted: str  # the paraphrase cached at set-up
    candidates: List[str]  # the other paraphrases, which requests ask


@dataclass
class Request:
    due_s: float  # offset into the window
    kind: str  # "hit" (a cached cluster's paraphrase) | "rag" (a fresh document)
    text: str


def _rng(seed: int, name: str) -> np.random.Generator:
    return np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, sum(map(ord, name))])


def _words(rng: np.random.Generator, n: int) -> List[str]:
    out = []
    for _ in range(n):
        k = int(rng.integers(2, 4))
        out.append("".join(_SYLLABLES[i] for i in rng.integers(0, len(_SYLLABLES), k)))
    return out


def corpus(mix: dict, seed: int) -> List[Cluster]:
    """``mix["clusters"]`` clusters (half base, half aspect) of
    ``mix["paraphrases"]`` paraphrases each; the first of each cluster's
    seeded template order is the one cached."""
    rng = _rng(seed, "corpus")
    n_topics = mix["clusters"] // 2
    topics: List[str] = []
    seen = set()
    while len(topics) < n_topics:
        t = " ".join(_words(rng, 3))
        if t not in seen:
            seen.add(t)
            topics.append(t)
    out = []
    for i, topic in enumerate(topics):
        for subject in (topic, f"{ASPECTS[i % len(ASPECTS)]} {topic}"):
            cid = len(out)
            order = rng.permutation(len(TEMPLATES))[: mix["paraphrases"]]
            texts = [TEMPLATES[j].format(t=subject) for j in order]
            out.append(Cluster(cid, f"Canonical answer about {subject} (cluster {cid}).",
                               texts[0], texts[1:]))
    return out


def rag_prompt(rng: np.random.Generator, words: int, own: int) -> str:
    """A question about a fresh topic followed by a passage written from
    ``own`` seeded words of the document's own, exactly ``words``
    whitespace-separated words in all. Its own words keep documents apart
    in the encoder's space, where passages drawn from one shared
    vocabulary embed to nearly one point."""
    q = TEMPLATES[int(rng.integers(len(TEMPLATES)))].format(t=" ".join(_words(rng, 3)))
    head = q.split()
    vocab = _words(rng, own)
    body = [vocab[i] for i in rng.integers(0, own, words - len(head))]
    return " ".join(head + body)


def schedule(mix: dict, seed: int, seconds: float, hits: Dict[int, List[str]],
             rate: float = None) -> List[Request]:
    """The window's requests in due order. ``hits`` maps each cluster that
    requests may ask to the paraphrases they may use; clusters are drawn
    Zipf(``zipf_s``) over a seeded ranking of those clusters, a
    paraphrase uniformly; ``rag_share`` of the requests carry a fresh
    document instead."""
    rate = mix["rate_rps"] if rate is None else rate
    fixed = np.random.default_rng(SCHEDULE_STREAM)
    n = int(round(rate * seconds))
    due = np.sort(fixed.uniform(0.0, seconds, n))
    n_rag = int(round(mix.get("rag_share", 0.0) * n))
    is_rag = np.zeros(n, bool)
    is_rag[fixed.permutation(n)[:n_rag]] = True
    rng = _rng(seed, "schedule")
    cids = sorted(hits)
    ranked = [cids[i] for i in rng.permutation(len(cids))]
    p = 1.0 / np.arange(1, len(ranked) + 1) ** mix["zipf_s"]
    draws = rng.choice(len(ranked), size=n, p=p / p.sum())
    out = []
    for i in range(n):
        if is_rag[i]:
            out.append(Request(float(due[i]), "rag",
                               rag_prompt(rng, mix["rag_words"], mix["rag_doc_words"])))
        else:
            texts = hits[ranked[draws[i]]]
            out.append(Request(float(due[i]), "hit", texts[int(rng.integers(len(texts)))]))
    return out


def warm_up_document(mix: dict, seed: int) -> str:
    """A fresh document of the mix's length that the window never asks:
    set-up sends it through the whole miss path once."""
    return rag_prompt(_rng(seed, "warm-up document"), mix["rag_words"], mix["rag_doc_words"])
