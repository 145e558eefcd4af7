"""The traffic generator: deterministic per seed, the same load for every
seed, distinct clusters, fresh documents of the stated length."""
import json
from pathlib import Path

import numpy as np

from harness import traffic

MIXES = {p.stem: json.loads(p.read_text()) for p in (Path(__file__).parent / "traffic").glob("*.json")}
BIG_SEED = 2 ** 31 + 12345


def _small(mix, **kw):
    return dict(mix, clusters=64, paraphrases=8, **kw)


def _hits(clusters):
    return {c.cid: c.candidates for c in clusters}


def test_corpus_is_deterministic_and_every_question_distinct():
    mix = _small(MIXES["cached_replay"])
    a, b = traffic.corpus(mix, BIG_SEED), traffic.corpus(mix, BIG_SEED)
    assert [(c.inserted, c.candidates, c.answer) for c in a] == \
           [(c.inserted, c.candidates, c.answer) for c in b]
    texts = [t for c in a for t in [c.inserted] + c.candidates]
    assert len(texts) == 64 * 8 == len(set(texts))
    assert len({c.answer for c in a}) == 64
    other = traffic.corpus(mix, BIG_SEED + 1)
    assert [c.inserted for c in other] != [c.inserted for c in a]


def test_schedule_is_deterministic_and_every_seed_offers_the_same_load():
    mix = _small(MIXES["rag_mixed"], rag_words=50)
    cl = traffic.corpus(mix, 7)
    s1 = traffic.schedule(mix, BIG_SEED, 5.0, _hits(cl))
    s2 = traffic.schedule(mix, BIG_SEED, 5.0, _hits(cl))
    assert [(r.due_s, r.kind, r.text) for r in s1] == [(r.due_s, r.kind, r.text) for r in s2]
    s3 = traffic.schedule(mix, BIG_SEED + 1, 5.0, _hits(cl))
    n = int(round(mix["rate_rps"] * 5.0))
    assert len(s1) == len(s3) == n
    # the same instants and kinds for every seed; other content
    assert [(r.due_s, r.kind) for r in s1] == [(r.due_s, r.kind) for r in s3]
    assert [r.text for r in s1] != [r.text for r in s3]
    assert all(0.0 <= a.due_s <= b.due_s <= 5.0 for a, b in zip(s1, s1[1:]))
    rag = [r for r in s1 if r.kind == "rag"]
    assert len(rag) == round(mix["rag_share"] * n)
    assert all(len(r.text.split()) == 50 for r in rag)
    # each passage is written from the document's own few words
    assert all(len(set(r.text.split()[-30:])) <= mix["rag_doc_words"] for r in rag)
    assert len({r.text for r in rag}) == len(rag)
    hits = {t for ts in _hits(cl).values() for t in ts}
    assert all(r.text in hits for r in s1 if r.kind == "hit")


def test_zipf_draws_favour_the_first_ranked_clusters():
    mix = _small(MIXES["cached_replay"], rate_rps=2000)
    cl = traffic.corpus(mix, 3)
    s = traffic.schedule(mix, 3, 5.0, _hits(cl))
    owner = {t: c.cid for c in cl for t in c.candidates}
    counts = np.bincount([owner[r.text] for r in s], minlength=64)
    top = np.sort(counts)[::-1]
    # Zipf(1) over 64 clusters: the most asked about a fifth of all requests
    assert 0.12 < top[0] / len(s) < 0.32 and top[-1] < top[0] / 10
