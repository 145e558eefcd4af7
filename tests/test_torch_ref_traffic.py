"""The reference's ``tests/test_traffic.py`` retargeted to the port: the same
cases and assertions against ``repro_torch``, on the CPU (``device=None``
read as ``"cpu"``, see ``_torch_cpu.py``). The reference's docstring:

Traffic-replay harness: seeded determinism, workload shape (Zipf skew,
prompt-class mix, bursty arrivals), report integrity, and the in-process
replay's zero-dropped-at-drain gate.
"""
from collections import Counter

import pytest

from repro_torch.gateway.traffic import (
    TrafficConfig,
    TrafficReport,
    _warm,
    build_stack,
    generate_workload,
    make_corpus,
    prewarm,
    run_inprocess,
)
import torch  # noqa: E402
from _torch_cpu import cpu_by_default  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    cpu_by_default(monkeypatch)


CFG = TrafficConfig(n_requests=160, n_users=8, corpus_size=16, seed=7)


def _key(tr):
    return (tr.t, tr.user, tr.prompt, tr.canonical, tr.priority,
            tr.deadline_s, tr.ttl_s, tr.stream, tr.max_tokens)


def test_same_seed_same_workload_byte_for_byte():
    a = generate_workload(CFG)
    b = generate_workload(CFG)
    assert [_key(x) for x in a] == [_key(x) for x in b]


def test_different_seed_different_workload():
    other = TrafficConfig(**{**CFG.__dict__, "seed": 8})
    assert [_key(x) for x in generate_workload(CFG)] != [
        _key(x) for x in generate_workload(other)
    ]


def test_workload_is_time_sorted_and_sized():
    wl = generate_workload(CFG)
    assert len(wl) == CFG.n_requests
    assert all(a.t <= b.t for a, b in zip(wl, wl[1:]))
    assert {tr.user for tr in wl} == set(range(CFG.n_users))


def test_zipf_popularity_skew():
    wl = generate_workload(TrafficConfig(
        n_requests=600, n_users=8, corpus_size=16, seed=3,
        paraphrase_rate=0.0, combine_rate=0.0, novel_rate=0.0,
        uniform_rate=0.0,
    ))
    counts = Counter(tr.canonical for tr in wl)
    assert counts[0] > counts.get(8, 0) > counts.get(15, 0) * 0.0  # monotone-ish
    assert counts[0] >= 4 * max(counts.get(15, 0), 1)  # head dominates tail


def test_prompt_class_mix_matches_configured_rates():
    cfg = TrafficConfig(n_requests=2000, n_users=8, corpus_size=16, seed=5)
    wl = generate_workload(cfg)
    novel = sum(1 for tr in wl if tr.canonical == -2)
    combined = sum(1 for tr in wl if tr.canonical == -1)
    canonical = [tr for tr in wl if tr.canonical >= 0]
    paraphrased = sum(
        1 for tr in canonical if tr.prompt != make_corpus(cfg)[tr.canonical]
    )
    n = len(wl)
    assert novel / n == pytest.approx(cfg.novel_rate, abs=0.04)
    assert combined / n == pytest.approx(cfg.combine_rate, abs=0.03)
    assert paraphrased / n == pytest.approx(cfg.paraphrase_rate, abs=0.04)
    # novel prompts never repeat: each one is a guaranteed backend miss
    novel_prompts = [tr.prompt for tr in wl if tr.canonical == -2]
    assert len(novel_prompts) == len(set(novel_prompts))


def test_request_mapping_carries_extension_fields():
    wl = generate_workload(CFG)
    tr = next(x for x in wl if x.deadline_s is not None and x.ttl_s is not None)
    creq = tr.to_cache_request()
    assert creq.prompt == tr.prompt
    assert creq.deadline_s == tr.deadline_s
    assert creq.ttl_s == tr.ttl_s
    assert creq.stream == tr.stream
    payload = tr.to_payload()
    assert payload["deadline_ms"] == pytest.approx(tr.deadline_s * 1e3)
    assert payload["ttl_s"] == tr.ttl_s


def test_report_percentiles_and_dict_shape():
    rep = TrafficReport("unit", n_requests=3)
    for ms in (1.0, 2.0, 100.0):
        rep.record("hit" if ms < 50 else "miss", ms / 1e3)
    d = rep.to_dict()
    assert d["latency_ms"]["hit"]["n"] == 2
    assert d["latency_ms"]["miss"]["p50"] == pytest.approx(100.0, rel=0.01)
    assert d["hit_p50_ms"] == pytest.approx(1.5, rel=0.01)
    assert d["hit_vs_miss_p50_ratio"] == pytest.approx(100.0 / 1.5, rel=0.01)


def test_prewarm_demotes_corpus_to_tier1():
    cfg = TrafficConfig(n_requests=8, n_users=2, corpus_size=8, seed=0)
    service, client, cache = build_stack(
        backend_latency_s=0.0, tier1_capacity=64, capacity=16, max_inflight=64
    )
    try:
        _warm(service, cache)
        corpus = make_corpus(cfg)
        prewarm(cache, corpus, churn=16)
        levels = Counter(r.level for r in cache.lookup_batch(corpus) if r.hit)
        assert levels.get("tier1", 0) >= len(corpus) // 2  # churned out of tier 0
    finally:
        service.close()


def test_inprocess_replay_accounts_for_every_request_and_drains_clean():
    cfg = TrafficConfig(
        n_requests=48, n_users=4, corpus_size=8, seed=1,
        mean_interarrival_s=0.002, deadline_fraction=0.0,
    )
    wl = generate_workload(cfg)
    service, client, cache = build_stack(
        backend_latency_s=0.01, tier1_capacity=64, capacity=16, max_inflight=256
    )
    _warm(service, cache)
    prewarm(cache, make_corpus(cfg), churn=16)
    rep = run_inprocess(service, wl)
    d = rep.to_dict()
    recorded = sum(d["latency_ms"][c]["n"] for c in ("hit", "generative",
                                                     "tier1", "miss"))
    assert recorded + d["shed"] + d["expired"] + d["errors"] == cfg.n_requests
    assert d["dropped_at_drain"] == 0 and d["drain_clean"]
    assert d["latency_ms"]["miss"]["n"] > 0  # novel slice reached the backend
    assert recorded > d["latency_ms"]["miss"]["n"]  # and the cache served some
