"""The slice as a whole: the same seeded ``squad_like_qa`` replay through
CacheService -> EnhancedClient (+ MockLLM) -> HierarchicalCache(
GenerativeCache, GenerativeCache) built from each package, on the kernel
search path (``use_pallas=True``; the reference runs its Pallas kernel in
interpret mode, the port its kernel's plain version on the CPU).

Statuses, responses, hit levels, generative flags and the ClientStats /
CacheStats / ServiceStats counts are identical — with the n-gram embedder,
and with the Contriever smoke encoder carrying the reference's weights
(embeddings within 1e-5; no score of this replay lies that close to a
threshold)."""
import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.configs import contriever as jcfg
from repro.data.synthetic import squad_like_qa
from repro.serving.service import CacheService as JService
from repro_torch.configs import contriever as tcfg
from repro_torch.data.synthetic import squad_like_qa as t_squad_like_qa
from repro_torch.serving.service import CacheService as TService

torch.set_num_threads(1)

# (threshold, t_single, t_combined) per embedder: the random-init encoder
# maps every text close together, so its bars sit higher
KNOBS = {"ngram": (0.85, 0.45, 1.0), "contriever": (0.9, 0.8, 2.5)}


def _embedders(kind):
    if kind == "ngram":
        return J.NgramHashEmbedder(), T.NgramHashEmbedder()
    jenc = J.ContrieverEncoder(jcfg.smoke(), seed=0)
    params = jax.tree_util.tree_map(np.asarray, jenc.params)
    return jenc, T.encoder_from_jax_params(params, tcfg.smoke(), device="cpu")


def _stack(P, Service, emb, kind, **kw):
    t, ts, tc = KNOBS[kind]

    def level(cap):
        return P.GenerativeCache(emb, threshold=t, t_single=ts, t_combined=tc,
                                 capacity=cap, use_pallas=True, **kw)

    l1, l2 = level(16), level(64)
    h = P.HierarchicalCache(l1, l2)
    client = P.EnhancedClient(cache=l1, hierarchy=h)
    client.register_backend(P.MockLLM("mock-llm"))
    return client, Service(client, max_batch=8)


def _replay(P, Service, emb, kind, data, **kw):
    client, service = _stack(P, Service, emb, kind, **kw)
    h = client.hierarchy
    warm = data[::3]  # a third of the answers are cached in the shared L2
    h.l2.insert_batch([q for q, _, _ in warm], [a for _, a, _ in warm])
    out = []
    prompts = [q for q, _, _ in data]
    for b in range(0, len(prompts), 8):
        reqs = [P.CacheRequest(p) for p in prompts[b : b + 8]]
        out.extend(service.complete(reqs))
    # the async front end: single submissions resolve through the futures
    for p in prompts[:3] + ["a question nobody asked before"]:
        out.append(service.submit(P.CacheRequest(p)).result(timeout=60))
    service.close()
    return client, service, out


def _summary(resp):
    cr = resp.cache_result
    return (
        resp.status, resp.text, resp.from_cache, resp.model,
        None if cr is None else (cr.level, cr.generative, cr.hit),
    )


@pytest.mark.parametrize("kind", ["ngram", "contriever"])
def test_replay_through_the_service_matches_reference(kind):
    data = squad_like_qa(10, 4, seed=2, with_aspects=True)
    assert t_squad_like_qa(10, 4, seed=2, with_aspects=True) == data
    jemb, temb = _embedders(kind)
    cj, sj, rj = _replay(J, JService, jemb, kind, data)
    ct, st, rt = _replay(T, TService, temb, kind, data, device="cpu")
    assert [_summary(r) for r in rt] == [_summary(r) for r in rj]
    levels = [r.cache_result.level for r in rt if r.cache_result is not None]
    # the replay exercises hits, generative hits and misses
    assert any("generative" in lv for lv in levels)
    assert any(lv.endswith(":semantic") for lv in levels)
    assert any(r.status == "generated" for r in rt)
    keys = ("requests", "cache_hits", "llm_calls", "llm_errors", "total_cost_usd")
    assert [getattr(ct.stats, k) for k in keys] == [getattr(cj.stats, k) for k in keys]
    keys = ("lookups", "hits", "generative_hits", "tier1_hits", "adds")
    for cache_j, cache_t in ((cj.hierarchy.l1, ct.hierarchy.l1), (cj.hierarchy.l2, ct.hierarchy.l2)):
        assert [getattr(cache_t.stats, k) for k in keys] == [getattr(cache_j.stats, k) for k in keys]
    keys = ("submitted", "hits", "generated", "expired", "deduped")
    assert [getattr(st.stats, k) for k in keys] == [getattr(sj.stats, k) for k in keys]
    # the reads went through the kernel wrapper on one shared bank
    bank = ct.hierarchy._shared_bank
    assert bank.use_pallas and bank.L == 2 and bank.dispatches > 0
