"""The port's traffic-replay harness against the reference's.

One seed gives both packages the same workload, field for field; the
report has the same keys and figures for the same recorded latencies; a
sequential in-process replay (each request resolved before the next is
submitted, so no batch depends on timing) lands every request in the same
class in both; ``prewarm`` demotes the corpus to tier 1 as the
reference's does; and the chaos replay's all-backends-down window serves
the same stale, hit and 503 counts, stale answers byte-identical, with
full availability and nothing dropped at the drain. The port's stacks
live on the CPU.
"""
import math
from collections import Counter
from dataclasses import asdict

import pytest
import torch

from repro.gateway import traffic as J
from repro_torch.gateway import traffic as T

torch.set_num_threads(1)

CONFIGS = {
    "default": {},
    # the card's paced replay: 256 requests from 24 users, 16 tokens each
    "paced": dict(n_requests=256, n_users=24, max_tokens=16),
    "poisson": dict(n_requests=160, n_users=8, corpus_size=16, arrival="poisson",
                    stream_fraction=0.25),
}


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_workload_matches_reference(config, seed):
    kw = dict(CONFIGS[config], seed=seed)
    tw = T.generate_workload(T.TrafficConfig(**kw))
    jw = J.generate_workload(J.TrafficConfig(**kw))
    assert [asdict(x) for x in tw] == [asdict(x) for x in jw]
    assert [x.to_payload() for x in tw] == [x.to_payload() for x in jw]
    assert T.make_corpus(T.TrafficConfig(**kw)) == J.make_corpus(J.TrafficConfig(**kw))


def test_stale_policy_matches_reference():
    cfg = dict(n_requests=64, n_users=4, seed=5)
    tw, jw = T.generate_workload(T.TrafficConfig(**cfg)), J.generate_workload(J.TrafficConfig(**cfg))
    T.apply_stale_policy(tw, 0.5, max_stale_s=30.0, seed=9)
    J.apply_stale_policy(jw, 0.5, max_stale_s=30.0, seed=9)
    assert [asdict(x) for x in tw] == [asdict(x) for x in jw]
    assert 0 < sum(x.allow_stale for x in tw) < len(tw)


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


def test_report_dict_matches_reference():
    reps = [T.TrafficReport("unit", n_requests=6), J.TrafficReport("unit", n_requests=6)]
    for rep in reps:
        for cls, ms in (("hit", 1.0), ("hit", 2.0), ("tier1", 3.0), ("miss", 100.0),
                        ("stale", 4.0)):
            rep.record(cls, ms / 1e3)
        rep.wall_s, rep.shed, rep.expired, rep.errors = 0.5, 1, 2, 1
    td, jd = (r.to_dict() for r in reps)
    assert list(td) == list(jd)
    assert _same(td, jd)
    assert td["hit_p50_ms"] == pytest.approx(2.0) and td["latency_ms"]["generative"]["n"] == 0
    assert math.isnan(T.TrafficReport("empty").to_dict()["hit_vs_miss_p50_ratio"])


class _Sequential:
    """A service whose ``submit`` returns only once the request resolved:
    ``run_inprocess`` then replays one request at a time."""

    def __init__(self, service):
        self.service = service

    def submit(self, request):
        fut = self.service.submit(request)
        fut.result(timeout=60)
        return fut

    def close(self):
        self.service.close()


def _sequential_replay(P, **dev):
    cfg = P.TrafficConfig(n_requests=64, n_users=4, corpus_size=8, seed=1,
                          deadline_fraction=0.0)
    service, client, cache = P.build_stack(backend_latency_s=0.0, tier1_capacity=64,
                                           capacity=16, max_inflight=256, **dev)
    P._warm(service, cache)
    P.prewarm(cache, P.make_corpus(cfg), churn=16)
    rep = P.run_inprocess(_Sequential(service), P.generate_workload(cfg), time_scale=0.0)
    return rep.to_dict(), client.stats


def test_sequential_inprocess_replay_matches_reference():
    td, tstats = _sequential_replay(T, device="cpu")
    jd, jstats = _sequential_replay(J)
    counts = {c: td["latency_ms"][c]["n"] for c in T.CLASSES}
    assert counts == {c: jd["latency_ms"][c]["n"] for c in J.CLASSES}
    for k in ("shed", "expired", "errors", "backend_unavailable", "dropped_at_drain",
              "drain_clean", "stale_served", "availability"):
        assert td[k] == jd[k], k
    assert (tstats.requests, tstats.cache_hits, tstats.llm_calls) == \
        (jstats.requests, jstats.cache_hits, jstats.llm_calls)
    # every class the harness is for, and every request accounted for
    assert all(counts[c] > 0 for c in ("hit", "generative", "tier1", "miss"))
    assert sum(counts.values()) == 64 and td["drain_clean"]


def test_prewarm_demotes_corpus_to_tier1_as_reference():
    levels = []
    for P, dev in ((T, {"device": "cpu"}), (J, {})):
        cfg = P.TrafficConfig(n_requests=8, n_users=2, corpus_size=8, seed=0)
        service, client, cache = P.build_stack(backend_latency_s=0.0, tier1_capacity=64,
                                               capacity=16, max_inflight=64, **dev)
        try:
            P._warm(service, cache)
            corpus = P.make_corpus(cfg)
            P.prewarm(cache, corpus, churn=16)
            levels.append(Counter(r.level for r in cache.lookup_batch(corpus) if r.hit))
        finally:
            service.close()
    assert levels[0] == levels[1]
    assert levels[0].get("tier1", 0) >= 4  # churned out of tier 0


def test_chaos_replay_window_matches_reference():
    out = []
    for P, dev in ((T, {"device": "cpu"}), (J, {})):
        cfg = P.TrafficConfig(n_requests=64, n_users=4, corpus_size=8, seed=3,
                              mean_interarrival_s=0.004)
        out.append(P.run_chaos_replay(cfg, backend_latency_s=0.005, **dev))
    tres, jres = out
    assert tres["all_down_window"] == jres["all_down_window"]
    w = tres["all_down_window"]
    assert w["stale_byte_parity"] and w["stale"] == w["n_expired"] and w["hit"] == w["n_valid"]
    assert w["http"]["novel_got_retry_after"]
    assert tres["chaos"]["availability"] == 1.0 and tres["chaos"]["dropped_at_drain"] == 0
    assert tres["fault_share"] > 0  # the schedule did fault calls
