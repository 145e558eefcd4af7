"""The reference's ``tests/test_generative_rule.py`` retargeted to the port: the same
cases and assertions against ``repro_torch``, on the CPU (``device=None``
read as ``"cpu"``, see ``_torch_cpu.py``). The reference's docstring:

Generative-hit rule boundary cases (§3): t_single < t_s < t_combined.

Vectors are crafted so cosine similarities are exact by construction:
entries are orthogonal unit vectors e0, e1 and the query is
q = s0*e0 + s1*e1 + sqrt(1 - s0^2 - s1^2)*e_other, giving cos(q, ei) = si.
"""
import numpy as np
import pytest

from repro_torch.core.embeddings import NgramHashEmbedder
from repro_torch.core.generative_cache import GenerativeCache
import torch  # noqa: E402
from _torch_cpu import cpu_by_default  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    cpu_by_default(monkeypatch)


DIM = 256
T_SINGLE, T_S, T_COMBINED = 0.3, 0.8, 1.2


def unit(i: int) -> np.ndarray:
    v = np.zeros(DIM, np.float32)
    v[i] = 1.0
    return v


def query_vec(s0: float, s1: float) -> np.ndarray:
    rest = 1.0 - s0 * s0 - s1 * s1
    assert rest >= 0, "similarities must satisfy s0^2 + s1^2 <= 1"
    return (s0 * unit(0) + s1 * unit(1) + np.sqrt(rest) * unit(2)).astype(np.float32)


@pytest.fixture(params=["primary", "secondary"])
def cache(request):
    c = GenerativeCache(
        NgramHashEmbedder(DIM), threshold=T_S, t_single=T_SINGLE,
        t_combined=T_COMBINED, mode=request.param, cache_synthesized=False,
    )
    c.insert("entry zero", "A0", vec=unit(0))
    c.insert("entry one", "A1", vec=unit(1))
    return c


def test_threshold_ordering(cache):
    assert cache.t_single < cache.threshold < cache.t_combined


def test_sum_just_above_t_combined_is_generative_hit(cache):
    # s0 + s1 = 1.205 > 1.2, each in (t_single, t_s)
    r = cache.lookup("q", vec=query_vec(0.6025, 0.6025))
    assert r.hit and r.generative
    assert r.combined_similarity == pytest.approx(1.205, abs=1e-3)
    assert "A0" in r.response and "A1" in r.response


def test_sum_just_below_t_combined_is_miss(cache):
    # s0 + s1 = 1.195 < 1.2
    r = cache.lookup("q", vec=query_vec(0.5975, 0.5975))
    assert not r.hit
    assert r.combined_similarity == pytest.approx(1.195, abs=1e-3)


def test_below_t_single_excluded_from_X(cache):
    # e1's 0.25 < t_single: X = {e0}, sum = 0.7 < t_combined even though the
    # raw sum 0.95 + anything outside X must not count
    r = cache.lookup("q", vec=query_vec(0.7, 0.25))
    assert not r.hit
    assert len(r.sources) == 1
    assert r.combined_similarity == pytest.approx(0.7, abs=1e-3)


def test_just_above_t_single_joins_X(cache):
    # 0.52 > t_single joins X: sum = 1.22 > t_combined -> synthesis from both
    r = cache.lookup("q", vec=query_vec(0.7, 0.52))
    assert r.hit and r.generative
    assert len(r.sources) == 2


def test_single_overwhelming_match_is_direct_hit(cache):
    # best similarity 0.85 > t_s: served directly, no synthesis
    r = cache.lookup("q", vec=query_vec(0.85, 0.45))
    assert r.hit and not r.generative
    assert r.response == "A0"
    assert r.level == "semantic"


def test_generative_hit_count_in_stats(cache):
    cache.lookup("q", vec=query_vec(0.65, 0.65))
    assert cache.stats.generative_hits == 1
    assert cache.stats.hits == 1


def test_synthesized_answer_cached_when_enabled():
    c = GenerativeCache(
        NgramHashEmbedder(DIM), threshold=T_S, t_single=T_SINGLE,
        t_combined=T_COMBINED, cache_synthesized=True,
    )
    c.insert("entry zero", "A0", vec=unit(0))
    c.insert("entry one", "A1", vec=unit(1))
    qv = query_vec(0.65, 0.65)
    r = c.lookup("combined question", vec=qv)
    assert r.hit and r.generative
    # the synthesized answer is now a direct semantic hit for the same vector
    r2 = c.lookup("combined question", vec=qv)
    assert r2.hit and not r2.generative
    assert r2.response == r.response
