"""Traffic-replay harness: reproducible heavy mixed load for the cache stack
(the port of the reference's ``gateway/traffic.py``; the same seed gives
the same workload in both packages).

SCALM's analysis of production chat traffic says real load is *skewed* and
*bursty*: query popularity is Zipfian (a few questions dominate), arrivals
cluster per user, and requests carry mixed priorities and deadlines. This
harness generates that shape deterministically (one seed = one workload,
byte-for-byte) and replays it two ways:

  * **in-process** — ``service.submit`` per arrival, futures resolving
    asynchronously (measures the serving stack without socket overhead);
  * **http** — per-user threads drive real ``GatewayClient`` connections
    against a live ``Gateway`` (streamed and non-streamed mixed), so the
    numbers include the full wire path.

Both report p50/p95/p99 latency per cache class (``hit`` / ``generative``
/ ``tier1`` / ``miss``), throughput, per-level hit fractions, shed (429 /
``AdmissionRejected``) and expiry counts, and — the drain gate — how many
accepted requests were left unresolved after graceful shutdown (must be
zero). ``main`` writes a JSON report (``--out``, by default
``build/traffic.json``), with the hit-p50-vs-miss-p50 ratio under the
mixed workload and the drain figures.

A third mode replays the SAME workload through ``build_chaos_stack`` — a
seeded ``FaultInjector`` dropping/slowing ~30% of backend calls while one
backend flaps — then kills every backend and keeps asking: the breaker +
retry + stale-if-error ladder must hold availability while cached answers
(valid -> ``hit``, expired -> ``stale``) keep flowing. ``--chaos`` writes
``build/chaos.json`` (availability, stale byte-parity, the hit path's
latency under faults).

The stacks' stores live on the card unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python -m repro_torch.gateway.traffic --smoke --device cpu
      PYTHONPATH=src python -m repro_torch.gateway.traffic --mode http --requests 512
      PYTHONPATH=src python -m repro_torch.gateway.traffic --chaos --smoke --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time
from concurrent.futures import Future
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.request import CacheRequest, CacheResponse
from repro_torch.kernels.backend import DeviceLike
from repro_torch.resilience.errors import AllBackendsFailed
from repro_torch.serving.coalescer import AdmissionRejected, ServiceClosed
from repro_torch.serving.service import CacheService

# paraphrase templates wrap a canonical query without destroying its n-gram
# signature — near-threshold lookups that exercise the semantic/generative
# decision, exactly the traffic the paper's rule is for
PARAPHRASES = (
    "could you tell me {}",
    "please explain {}",
    "{} - what is the answer",
    "quick question: {}",
    "i was wondering, {}",
)
COMBINER = "{} and also {}"  # two-source prompts poke the generative rule


@dataclass
class TrafficConfig:
    n_requests: int = 512
    n_users: int = 24
    corpus_size: int = 64
    zipf_s: float = 1.1  # popularity skew: weight(rank) ~ (rank+1)^-s
    uniform_rate: float = 0.15  # tail revisits: re-ask an evicted cold entry (tier-1 path)
    paraphrase_rate: float = 0.30
    combine_rate: float = 0.08
    novel_rate: float = 0.25  # one-off never-seen prompts: the true-miss slice
    arrival: str = "bursty"  # "poisson" | "bursty"
    mean_interarrival_s: float = 0.03  # per-user mean think time
    burst_len: int = 4
    burst_rate_factor: float = 25.0  # in-burst arrivals are this much faster
    priority_choices: Tuple[int, ...] = (0, 0, 0, 1, 3)
    deadline_fraction: float = 0.2
    deadline_ms: Tuple[float, float] = (250.0, 2000.0)
    ttl_fraction: float = 0.25
    ttl_choices_s: Tuple[float, ...] = (60.0, 600.0)
    stream_fraction: float = 0.5  # http mode: fraction served over SSE
    max_tokens: int = 64
    seed: int = 0


@dataclass
class TimedRequest:
    t: float  # arrival offset from replay start (seconds)
    user: int
    prompt: str
    canonical: int  # corpus rank the prompt derives from (-1 = combined)
    priority: int = 0
    deadline_s: Optional[float] = None
    ttl_s: Optional[float] = None
    stream: bool = False
    max_tokens: int = 64
    allow_stale: bool = False  # stale-if-error opt-in (chaos replays)
    max_stale_s: Optional[float] = None

    def to_cache_request(self) -> CacheRequest:
        return CacheRequest(
            self.prompt, max_tokens=self.max_tokens, priority=self.priority,
            deadline_s=self.deadline_s, ttl_s=self.ttl_s, stream=self.stream,
            allow_stale=self.allow_stale, max_stale_s=self.max_stale_s,
        )

    def to_payload(self) -> Dict[str, Any]:
        body: Dict[str, Any] = {
            "prompt": self.prompt, "max_tokens": self.max_tokens,
            "stream": self.stream, "priority": self.priority,
        }
        if self.deadline_s is not None:
            body["deadline_ms"] = self.deadline_s * 1e3
        if self.ttl_s is not None:
            body["ttl_s"] = self.ttl_s
        if self.allow_stale:
            body["allow_stale"] = True
            if self.max_stale_s is not None:
                body["max_stale_s"] = self.max_stale_s
        return body


def make_corpus(cfg: TrafficConfig) -> List[str]:
    """Seeded canonical queries, rank-ordered by popularity."""
    return [
        f"how does component {i} of the {['storage', 'serving', 'routing', 'billing'][i % 4]} "
        f"subsystem behave under heavy load"
        for i in range(cfg.corpus_size)
    ]


def generate_workload(cfg: TrafficConfig) -> List[TimedRequest]:
    """One seed -> one workload, independent of wall clock or host."""
    rng = np.random.default_rng(cfg.seed)
    corpus = make_corpus(cfg)
    weights = (np.arange(cfg.corpus_size) + 1.0) ** -cfg.zipf_s
    weights /= weights.sum()

    # spread the request budget across users, +-25% so users aren't uniform
    quota = np.maximum(
        1, rng.poisson(cfg.n_requests / cfg.n_users, size=cfg.n_users)
    )
    while quota.sum() > cfg.n_requests:
        quota[int(rng.integers(cfg.n_users))] = max(
            1, quota[int(rng.integers(cfg.n_users))] - 1
        )
    while quota.sum() < cfg.n_requests:
        quota[int(rng.integers(cfg.n_users))] += 1

    events: List[TimedRequest] = []
    novel_seq = 0
    for user in range(cfg.n_users):
        t = float(rng.exponential(cfg.mean_interarrival_s))
        burst_left = 0
        for _ in range(int(quota[user])):
            # mostly Zipf-popular queries; a uniform slice revisits the cold
            # tail, whose entries have usually demoted to tier 1 by then
            if rng.random() < cfg.uniform_rate:
                rank = int(rng.integers(cfg.corpus_size))
            else:
                rank = int(rng.choice(cfg.corpus_size, p=weights))
            roll = rng.random()
            if roll < cfg.novel_rate:
                # a question nobody asked before and nobody asks again: the
                # long tail that must reach the backend (the miss lane)
                novel_seq += 1
                prompt = (
                    f"one-off question {novel_seq} from user {user}: what is "
                    f"the provenance of artifact {novel_seq * 7919} in run {user}"
                )
                canonical = -2
            elif roll < cfg.novel_rate + cfg.combine_rate and cfg.corpus_size >= 2:
                other = int(rng.choice(cfg.corpus_size, p=weights))
                prompt = COMBINER.format(corpus[rank], corpus[other])
                canonical = -1
            elif roll < cfg.novel_rate + cfg.combine_rate + cfg.paraphrase_rate:
                tmpl = PARAPHRASES[int(rng.integers(len(PARAPHRASES)))]
                prompt, canonical = tmpl.format(corpus[rank]), rank
            else:
                prompt, canonical = corpus[rank], rank
            deadline_s = (
                float(rng.uniform(*cfg.deadline_ms)) / 1e3
                if rng.random() < cfg.deadline_fraction
                else None
            )
            ttl_s = (
                float(cfg.ttl_choices_s[int(rng.integers(len(cfg.ttl_choices_s)))])
                if rng.random() < cfg.ttl_fraction
                else None
            )
            events.append(TimedRequest(
                t, user, prompt, canonical,
                priority=int(cfg.priority_choices[int(rng.integers(len(cfg.priority_choices)))]),
                deadline_s=deadline_s, ttl_s=ttl_s,
                stream=bool(rng.random() < cfg.stream_fraction),
                max_tokens=cfg.max_tokens,
            ))
            # advance this user's clock: Poisson think time, or a burst of
            # near-back-to-back arrivals (ON/OFF, the SCALM burstiness shape)
            if cfg.arrival == "bursty":
                if burst_left > 0:
                    burst_left -= 1
                    t += float(rng.exponential(
                        cfg.mean_interarrival_s / cfg.burst_rate_factor
                    ))
                else:
                    if rng.random() < 0.35:
                        burst_left = cfg.burst_len - 1
                    t += float(rng.exponential(cfg.mean_interarrival_s))
            else:
                t += float(rng.exponential(cfg.mean_interarrival_s))
    events.sort(key=lambda e: (e.t, e.user))
    return events


def apply_stale_policy(
    workload: Sequence[TimedRequest],
    fraction: float = 1.0,
    *,
    max_stale_s: Optional[float] = None,
    seed: int = 1,
) -> None:
    """Mark a seeded ``fraction`` of ``workload`` as ``allow_stale`` in
    place — the opt-in the chaos replay uses. Drawn from its OWN rng so the
    base workload stays byte-identical to the non-chaos replay (same seed
    -> same prompts, arrivals, deadlines)."""
    rng = np.random.default_rng(seed)
    for tr in workload:
        if rng.random() < fraction:
            tr.allow_stale = True
            tr.max_stale_s = max_stale_s


# -- measurement ----------------------------------------------------------------


CLASSES = ("hit", "generative", "tier1", "miss", "stale")


@dataclass
class TrafficReport:
    mode: str
    n_requests: int = 0
    wall_s: float = 0.0
    latencies_s: Dict[str, List[float]] = field(
        default_factory=lambda: {c: [] for c in CLASSES}
    )
    shed: int = 0  # 429 / AdmissionRejected
    expired: int = 0  # 504 / DEADLINE_EXCEEDED
    errors: int = 0  # anything else that wasn't a served answer
    backend_unavailable: int = 0  # 503 / AllBackendsFailed with no stale entry
    dropped_at_drain: int = 0  # accepted but unresolved after shutdown — MUST be 0
    drain_clean: bool = True

    def record(self, cls: str, latency_s: float) -> None:
        self.latencies_s.setdefault(cls, []).append(latency_s)

    @property
    def hit_latencies(self) -> List[float]:
        return [
            x for c in ("hit", "generative", "tier1") for x in self.latencies_s[c]
        ]

    def to_dict(self) -> Dict[str, Any]:
        def pct(xs: Sequence[float], q: float) -> float:
            return float(np.percentile(np.asarray(xs) * 1e3, q)) if xs else float("nan")

        served = sum(len(v) for v in self.latencies_s.values())
        hits, misses = self.hit_latencies, self.latencies_s["miss"]
        hit_p50, miss_p50 = pct(hits, 50), pct(misses, 50)
        return {
            "mode": self.mode,
            "n_requests": self.n_requests,
            "wall_s": self.wall_s,
            "throughput_rps": served / self.wall_s if self.wall_s else 0.0,
            "latency_ms": {
                cls: {
                    "p50": pct(xs, 50), "p95": pct(xs, 95), "p99": pct(xs, 99),
                    "n": len(xs),
                }
                for cls, xs in self.latencies_s.items()
            },
            "level_fractions": {
                cls: len(xs) / served if served else 0.0
                for cls, xs in self.latencies_s.items()
            },
            "hit_p50_ms": hit_p50,
            "miss_p50_ms": miss_p50,
            "hit_vs_miss_p50_ratio": (
                miss_p50 / hit_p50 if hits and misses and hit_p50 > 0 else float("nan")
            ),
            "shed": self.shed,
            "expired": self.expired,
            "errors": self.errors,
            "backend_unavailable": self.backend_unavailable,
            "dropped_at_drain": self.dropped_at_drain,
            "drain_clean": self.drain_clean,
            "stale_served": len(self.latencies_s.get("stale", [])),
            # of requests that ran to a terminal outcome (sheds and queue
            # expiries excluded — those are load/deadline policy, not
            # failures), the fraction answered with content. Stale counts:
            # serving yesterday's answer IS the availability mechanism.
            "availability": (
                served / (served + self.errors + self.backend_unavailable)
                if served + self.errors + self.backend_unavailable
                else 1.0
            ),
        }


def _classify(resp: CacheResponse) -> str:
    return "expired" if resp.expired else resp.cache_status


# -- replays --------------------------------------------------------------------


def run_inprocess(
    service: CacheService,
    workload: Sequence[TimedRequest],
    *,
    time_scale: float = 1.0,
    close_service: bool = True,
) -> TrafficReport:
    """Replay arrivals against ``service.submit`` and drain at the end.

    Latency is submit-to-future-resolution per request. ``close_service``
    runs the graceful drain (``service.close()``) and counts futures still
    unresolved afterwards — the zero-dropped gate."""
    report = TrafficReport("inprocess", n_requests=len(workload))
    lock = threading.Lock()
    futures: List[Future] = []
    t0 = time.perf_counter()
    for tr in workload:
        target = t0 + tr.t * time_scale
        delay = target - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        t_submit = time.perf_counter()
        try:
            fut = service.submit(tr.to_cache_request())
        except AdmissionRejected:
            with lock:
                report.shed += 1
            continue
        except ServiceClosed:
            with lock:
                report.errors += 1
            continue
        futures.append(fut)

        def cb(f: Future, t_submit: float = t_submit) -> None:
            lat = time.perf_counter() - t_submit
            try:
                resp = f.result()
            except AllBackendsFailed:
                # every backend open/down and no stale entry could answer —
                # the degradation ladder's floor, counted apart from bugs
                with lock:
                    report.backend_unavailable += 1
                return
            except Exception:  # noqa: BLE001 — counted, not raised mid-replay
                with lock:
                    report.errors += 1
                return
            cls = _classify(resp)
            with lock:
                if cls == "expired":
                    report.expired += 1
                else:
                    report.record(cls, lat)

        fut.add_done_callback(cb)
    if close_service:
        service.close()  # graceful drain: every accepted future resolves
    else:
        for f in futures:
            try:
                f.result(timeout=60)
            except Exception:  # noqa: BLE001 — already counted by the callback
                pass
    report.wall_s = time.perf_counter() - t0
    report.dropped_at_drain = sum(1 for f in futures if not f.done())
    report.drain_clean = report.dropped_at_drain == 0
    return report


def run_http(
    host: str,
    port: int,
    workload: Sequence[TimedRequest],
    *,
    time_scale: float = 1.0,
) -> TrafficReport:
    """Replay over real HTTP: one thread + one keep-alive connection per
    user (the SDK-client shape), each replaying its own arrival timeline.
    Streamed requests count their latency to stream completion."""
    from repro_torch.gateway.client import GatewayClient

    report = TrafficReport("http", n_requests=len(workload))
    lock = threading.Lock()
    by_user: Dict[int, List[TimedRequest]] = {}
    for tr in workload:
        by_user.setdefault(tr.user, []).append(tr)
    t0 = time.perf_counter()

    def worker(items: List[TimedRequest]) -> None:
        with GatewayClient(host, port, timeout=60.0) as client:
            for tr in items:
                target = t0 + tr.t * time_scale
                delay = target - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                t_send = time.perf_counter()
                try:
                    reply = client.request("POST", "/v1/completions", tr.to_payload())
                except Exception:  # noqa: BLE001 — a vanished reply is a drop
                    with lock:
                        report.dropped_at_drain += 1
                    continue
                lat = time.perf_counter() - t_send
                with lock:
                    if reply.status == 200:
                        report.record(
                            reply.headers.get("x-cache", "miss"), lat
                        )
                    elif reply.status == 429:
                        report.shed += 1
                    elif reply.status == 503:
                        report.backend_unavailable += 1
                    elif reply.status == 504:
                        report.expired += 1
                    else:
                        report.errors += 1

    threads = [
        threading.Thread(target=worker, args=(items,), daemon=True)
        for items in by_user.values()
    ]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    report.wall_s = time.perf_counter() - t0
    report.drain_clean = report.dropped_at_drain == 0
    return report


# -- stack construction + CLI ---------------------------------------------------


def build_stack(
    *,
    backend_latency_s: float = 0.12,
    capacity: int = 2048,
    tier1_capacity: int = 0,
    max_inflight: int = 512,
    threshold: float = 0.8,
    device: DeviceLike = None,
):
    """A MockLLM-backed cache stack shaped like the serving deployments:
    GenerativeCache (semantic + generative rule), optional host-RAM tier 1
    behind a small tier 0 (so the replay exercises ``X-Cache: tier1``).
    The store lives on ``device`` (None = CUDA) and searches through the
    similarity_topk kernel there; the CPU runs its plain version."""
    from repro_torch.core import (
        EnhancedClient,
        GenerativeCache,
        MockLLM,
        NgramHashEmbedder,
    )
    from repro_torch.core.tiers import HostRamTier
    from repro_torch.core.vector_store import InMemoryVectorStore

    emb = NgramHashEmbedder()
    store = None
    if tier1_capacity:
        store = InMemoryVectorStore(
            emb.dim, capacity=capacity, eviction="lru",
            tier1=HostRamTier(emb.dim, capacity=tier1_capacity),
            use_pallas=True, device=device,
        )
    cache = GenerativeCache(
        emb, threshold=threshold, t_single=0.45, t_combined=1.0,
        capacity=capacity, store=store, cache_synthesized=False,
        use_pallas=True, device=device,
    )
    client = EnhancedClient(cache=cache)
    client.register_backend(MockLLM("replay-backend", latency_s=backend_latency_s))
    service = CacheService(client, max_batch=16, max_wait_ms=2.0,
                           max_inflight=max_inflight)
    return service, client, cache


CHAOS_BACKENDS = ("chaos-flappy", "chaos-primary", "chaos-reserve")


def build_chaos_stack(
    *,
    backend_latency_s: float = 0.04,
    capacity: int = 2048,
    tier1_capacity: int = 0,
    max_inflight: int = 512,
    threshold: float = 0.8,
    fault_rate: float = 0.3,
    flap_period: int = 6,
    seed: int = 0,
    device: DeviceLike = None,
):
    """``build_stack``'s resilience twin: three MockLLM backends behind ONE
    seeded ``FaultInjector`` — a primary that drops/slows ~``fault_rate``
    of calls, a flapping secondary (the mode that trips breakers via the
    health score), and a mostly-healthy reserve so the escalation ladder
    has a floor. Fast breaker recovery + tight backoffs keep the replay's
    wall clock bench-sized. Returns ``(service, client, cache, injector)``;
    replay the same workload against ``build_stack`` for the clean baseline
    (same seed -> same faults, the whole point of the seeded injector)."""
    from repro_torch.core import (
        EnhancedClient,
        GenerativeCache,
        MockLLM,
        NgramHashEmbedder,
    )
    from repro_torch.core.tiers import HostRamTier
    from repro_torch.core.vector_store import InMemoryVectorStore
    from repro_torch.resilience import CircuitBreaker, FaultInjector, FaultSpec, RetryPolicy

    emb = NgramHashEmbedder()
    store = None
    if tier1_capacity:
        store = InMemoryVectorStore(
            emb.dim, capacity=capacity, eviction="lru",
            tier1=HostRamTier(emb.dim, capacity=tier1_capacity),
            use_pallas=True, device=device,
        )
    cache = GenerativeCache(
        emb, threshold=threshold, t_single=0.45, t_combined=1.0,
        capacity=capacity, store=store, cache_synthesized=False,
        use_pallas=True, device=device,
    )
    client = EnhancedClient(
        cache=cache,
        retry_policy=RetryPolicy(max_attempts=2, base_backoff_s=0.004,
                                 max_backoff_s=0.02),
        breaker_factory=lambda name: CircuitBreaker(
            name, failure_threshold=3, recovery_s=0.2
        ),
    )
    # escalation order == registration order: the FLAPPING backend is first,
    # so every miss walks into the flap schedule (down phases trip its
    # breaker, up phases close it again), fails over to a lossy primary,
    # and only then to the mostly-healthy reserve
    injector = FaultInjector(seed=seed)
    injector.schedule(
        CHAOS_BACKENDS[0],
        FaultSpec("flap", period=flap_period, message="flapping upstream"),
        FaultSpec("error", p=0.1, message="injected connection reset"),
    )
    injector.schedule(
        CHAOS_BACKENDS[1],
        FaultSpec("error", p=fault_rate, message="injected connection reset"),
        FaultSpec("latency", p=0.1, latency_s=3 * backend_latency_s),
    )
    injector.schedule(
        CHAOS_BACKENDS[2],
        FaultSpec("error", p=0.05, message="injected connection reset"),
    )
    for name in CHAOS_BACKENDS:
        client.register_backend(
            injector.wrap_backend(MockLLM(name, latency_s=backend_latency_s))
        )
    # lookup batching stays at build_stack's 16, but dispatch groups are
    # capped small: each group is ONE failover walk, and the chaos replay
    # wants many walks through the fault schedule, not a handful of big
    # coalesced batches that dodge the injector
    service = CacheService(client, max_batch=16, max_wait_ms=2.0,
                           dispatch_batch=2, max_inflight=max_inflight)
    return service, client, cache, injector


def all_backends_down(injector) -> None:
    """Rewrite every chaos backend's schedule to hard-fail from here on —
    the total-outage window the stale-serving gate replays through."""
    from repro_torch.resilience import FaultSpec

    for name in CHAOS_BACKENDS:
        injector.schedule(name, FaultSpec("error", message="backend down"))


def _warm(service: CacheService, cache) -> None:
    """Run every lookup and insert batch bucket once outside the timed
    replay (first allocations, and on the card the kernels' first load)."""
    for b in (1, 2, 4, 8, 16):
        cache.lookup_batch([f"warmup probe {b} {j}" for j in range(b)])
        cache.insert_batch([f"warmup insert {b} {j}" for j in range(b)], ["w"] * b)
    service.submit(CacheRequest("warmup roundtrip request")).result()


def prewarm(cache, corpus: Sequence[str], *, churn: int) -> None:
    """Put the replay in a long-running deployment's steady state: the
    canonical corpus is already cached (these queries have been answered
    before), then ``churn`` filler inserts push every corpus entry out of
    tier 0 into the host tier. The replay's first ask of each rank is then
    a genuine tier-1 promote (``X-Cache: tier1``), repeats are tier-0
    hits, and only below-threshold paraphrases / non-synthesizable
    combines reach the backend. Also runs the eviction->demote and tier-1
    consult paths once outside the timed window."""
    answers = [f"warm answer for: {q}" for q in corpus]
    for i in range(0, len(corpus), 16):
        cache.insert_batch(list(corpus[i:i + 16]), answers[i:i + 16])
    fillers = [f"churn filler {i}" for i in range(churn)]
    for i in range(0, churn, 16):
        chunk = fillers[i:i + 16]
        cache.insert_batch(chunk, ["x"] * len(chunk))
    # the store is full now, so inserts take the evict->demote path; run it
    # once per batch bucket (and the tier-1 consult), with mixed TTLs as the
    # replay's backfills carry, before the timed window
    for b in (1, 2, 4, 8, 16):
        cache.insert_batch(
            [f"churn filler evict {b} {j}" for j in range(b)], ["x"] * b,
            ttls=[60.0 if j % 2 == 0 else None for j in range(b)],
        )
        cache.lookup_batch([f"absent tier1 probe {b} {j}" for j in range(b)])
    # run the tier-1 promote path (the probe promotes rank 0, which the
    # replay's first ask would have promoted within milliseconds anyway)
    cache.lookup_batch([corpus[0]])


# -- chaos mode -----------------------------------------------------------------


def _all_down_window(
    service: CacheService, cache, client, injector, *, n: int = 24, ttl_s: float = 0.05
) -> Dict[str, Any]:
    """Total-outage replay: cache 2n fresh answers (half on a tiny TTL),
    wait past expiry, kill every backend, then ask everything back plus a
    slice of never-cached prompts. The gate: valid entries still answer
    ``hit``, expired ones answer ``stale`` byte-identically (the ladder's
    stale-if-error rung), and only the never-cached slice surfaces the
    typed 503. Runs both in-process and through a live gateway so the
    ``X-Cache: stale|hit`` header contract is what's actually measured."""
    from repro_torch.gateway.app import serve_in_thread
    from repro_torch.gateway.client import GatewayClient

    # three textually DISJOINT prompt families (n-gram sim across families is
    # far below t_single), so an expired prompt can only be answered by its
    # own stale entry — never by a live hit or a generative synthesis from
    # the valid family, which would mask the ladder rung under test
    stale_prompts = [f"obsolete telemetry shard {i} checksum {i * 31 + 7}" for i in range(n)]
    fresh_prompts = [f"healthy inventory ledger {i} balance {i * 17 + 3}" for i in range(n)]
    novel_prompts = [f"uncharted frontier question {i} nobody ever asked" for i in range(max(2, n // 4))]
    # valid entries FIRST: inserting them after the TTL'd batch can land past
    # the short TTL, and the evictor reclaims expired slots before live ones —
    # it would overwrite the very stale inventory this window serves
    cache.insert_batch(fresh_prompts, [f"valid answer {i}" for i in range(n)])
    cache.insert_batch(
        stale_prompts, [f"expired answer {i}" for i in range(n)], ttls=[ttl_s] * n
    )
    time.sleep(2.5 * ttl_s)  # the TTL'd half is now past expiry
    all_backends_down(injector)

    win: Dict[str, Any] = {
        "n_expired": n, "n_valid": n, "n_novel": len(novel_prompts),
        "stale": 0, "hit": 0, "unavailable": 0, "other": 0,
        "stale_byte_parity": True,
    }
    for i, p in enumerate(stale_prompts):
        try:
            resp = service.submit(CacheRequest(p, allow_stale=True)).result(timeout=30)
        except AllBackendsFailed:
            win["unavailable"] += 1
            continue
        if resp.cache_status == "stale":
            win["stale"] += 1
            if resp.text != f"expired answer {i}":
                win["stale_byte_parity"] = False
        else:
            win["other"] += 1
    for p in fresh_prompts:
        resp = service.submit(CacheRequest(p, allow_stale=True)).result(timeout=30)
        win["hit" if resp.from_cache and resp.cache_status != "stale" else "other"] += 1
    for p in novel_prompts:
        try:
            service.submit(CacheRequest(p, allow_stale=True)).result(timeout=30)
            win["other"] += 1
        except AllBackendsFailed:
            win["unavailable"] += 1

    # the same contract over the wire: X-Cache is what clients dispatch on
    runner = serve_in_thread(service)
    http: Dict[str, Any] = {"stale": 0, "hit": 0, "503": 0, "other": 0}
    try:
        with GatewayClient("127.0.0.1", runner.gateway.port, timeout=30.0) as gw:
            probes = (
                [(p, "stale") for p in stale_prompts[: n // 2]]
                + [(p, "hit") for p in fresh_prompts[: n // 2]]
                + [(p, "503") for p in novel_prompts[:2]]
            )
            for p, want in probes:
                reply = gw.request(
                    "POST", "/v1/completions",
                    {"prompt": p, "allow_stale": True, "max_tokens": 64},
                )
                if reply.status == 503:
                    http["503"] += 1
                elif reply.status == 200:
                    xc = reply.headers.get("x-cache", "")
                    http[xc if xc in ("stale", "hit") else "other"] += 1
                else:
                    http["other"] += 1
                if want == "503":
                    http.setdefault("novel_got_retry_after", True)
                    if reply.status != 503 or not reply.headers.get("retry-after"):
                        http["novel_got_retry_after"] = False
    finally:
        runner.stop()
    win["http"] = http
    win["stale_serve_rate"] = win["stale"] / max(1, win["n_expired"])
    return win


def run_chaos_replay(
    cfg: TrafficConfig,
    *,
    backend_latency_s: float = 0.04,
    time_scale: float = 1.0,
    fault_rate: float = 0.3,
    stale_fraction: float = 0.9,
    seed: int = 0,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """The fault-schedule replay mode: the SAME seeded workload as the
    clean replay, driven through ``build_chaos_stack`` while ~``fault_rate``
    of backend calls fault and one backend flaps, then an all-backends-down
    window that must keep answering from the cache (``hit``/``stale``).
    Deterministic end to end: workload seed + injector seed fix which calls
    fault. Returns the chaos section of ``main``'s ``--chaos`` report."""
    from dataclasses import asdict as _asdict

    workload = generate_workload(cfg)
    apply_stale_policy(workload, stale_fraction, seed=cfg.seed + 1)
    service, client, cache, injector = build_chaos_stack(
        backend_latency_s=backend_latency_s, tier1_capacity=8 * cfg.corpus_size,
        capacity=2 * cfg.corpus_size, max_inflight=256,
        fault_rate=fault_rate, seed=seed, device=device,
    )
    _warm(service, cache)
    prewarm(cache, make_corpus(cfg), churn=2 * cfg.corpus_size)
    rep = run_inprocess(service, workload, time_scale=time_scale,
                        close_service=False)
    chaos = rep.to_dict()
    # fault accounting for the CHAOS phase only — the all-down window that
    # follows injects on every call and would swamp the ~fault_rate share
    chaos_faults = injector.snapshot()
    window = _all_down_window(service, cache, client, injector)
    service.close()
    chaos["dropped_at_drain"] = rep.dropped_at_drain
    faults = injector.snapshot()
    total_calls = sum(chaos_faults["calls"].values())
    return {
        "fault_rate": fault_rate,
        "stale_fraction": stale_fraction,
        "chaos": chaos,
        "all_down_window": window,
        "faults": faults,
        "chaos_faults": chaos_faults,
        "fault_share": chaos_faults["total_injected"] / max(1, total_calls),
        "breakers": client.breaker_snapshot(),
        "retry_budget": client.retry_budget.snapshot(),
        "client_stats": _asdict(client.stats),
        "service_stats": _asdict(service.stats),
    }


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true", help="CI-sized run")
    ap.add_argument("--chaos", action="store_true",
                    help="fault-schedule replay: faulting/flapping backends, "
                         "stale serving, and an all-backends-down window")
    ap.add_argument("--fault-rate", type=float, default=0.3)
    ap.add_argument("--mode", choices=("inprocess", "http", "both"), default="both")
    ap.add_argument("--requests", type=int, default=0)
    ap.add_argument("--users", type=int, default=0)
    ap.add_argument("--backend-latency-ms", type=float, default=0.0)
    ap.add_argument("--time-scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pace-ms", type=float, default=0.0,
                    help="gateway SSE pacing between chunks (http mode)")
    ap.add_argument("--out", default=None,
                    help="report path (default build/traffic.json, with --chaos "
                         "build/chaos.json)")
    ap.add_argument("--device", default=None,
                    help="where the stores live: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out_path = args.out or os.path.join(
        "build", "chaos.json" if args.chaos else "traffic.json")
    if os.path.dirname(out_path):
        os.makedirs(os.path.dirname(out_path), exist_ok=True)

    cfg = TrafficConfig(
        n_requests=args.requests or (192 if args.smoke else 512),
        n_users=args.users or (16 if args.smoke else 24),
        corpus_size=32 if args.smoke else 64,
        seed=args.seed,
    )
    backend_s = (args.backend_latency_ms or (120.0 if args.smoke else 200.0)) / 1e3
    workload = generate_workload(cfg)
    span = workload[-1].t if workload else 0.0
    print(f"workload: {len(workload)} requests / {cfg.n_users} users / "
          f"{cfg.corpus_size} canonical queries, span {span:.2f}s "
          f"(zipf_s={cfg.zipf_s}, paraphrase={cfg.paraphrase_rate}, "
          f"combine={cfg.combine_rate}, arrival={cfg.arrival})")

    out: Dict[str, Any] = {"config": asdict(cfg),
                           "backend_latency_ms": backend_s * 1e3}

    if args.chaos:
        res = run_chaos_replay(
            cfg, backend_latency_s=backend_s, time_scale=args.time_scale,
            fault_rate=args.fault_rate, seed=args.seed, device=args.device,
        )
        out.update(res)
        d, w = res["chaos"], res["all_down_window"]
        print(f"[chaos]     availability={d['availability']:.4f} | "
              f"fault_share={res['fault_share']:.2f} | "
              f"stale_served={d['stale_served']} "
              f"unavailable={d['backend_unavailable']} "
              f"dropped={d['dropped_at_drain']}")
        print(f"[all-down]  stale={w['stale']}/{w['n_expired']} "
              f"hit={w['hit']}/{w['n_valid']} 503={w['unavailable']} "
              f"byte_parity={w['stale_byte_parity']} http={w['http']}")
        with open(out_path, "w") as f:
            json.dump(out, f, indent=2)
        print(f"-> {out_path}")
        return out

    if args.mode in ("inprocess", "both"):
        service, client, cache = build_stack(
            backend_latency_s=backend_s, tier1_capacity=8 * cfg.corpus_size,
            capacity=2 * cfg.corpus_size, max_inflight=256, device=args.device,
        )
        _warm(service, cache)
        prewarm(cache, make_corpus(cfg), churn=2 * cfg.corpus_size)
        rep = run_inprocess(service, workload, time_scale=args.time_scale)
        out["inprocess"] = rep.to_dict()
        d = out["inprocess"]
        print(f"[inprocess] {d['throughput_rps']:.0f} req/s | hit p50 "
              f"{d['hit_p50_ms']:.1f} ms vs miss p50 {d['miss_p50_ms']:.1f} ms "
              f"({d['hit_vs_miss_p50_ratio']:.1f}x) | shed={d['shed']} "
              f"expired={d['expired']} dropped={d['dropped_at_drain']}")

    if args.mode in ("http", "both"):
        from repro_torch.gateway.app import serve_in_thread

        service, client, cache = build_stack(
            backend_latency_s=backend_s, tier1_capacity=8 * cfg.corpus_size,
            capacity=2 * cfg.corpus_size, max_inflight=256, device=args.device,
        )
        _warm(service, cache)
        prewarm(cache, make_corpus(cfg), churn=2 * cfg.corpus_size)
        runner = serve_in_thread(service, pace_ms=args.pace_ms, own_service=True)
        try:
            rep = run_http(
                "127.0.0.1", runner.gateway.port, workload,
                time_scale=args.time_scale,
            )
        finally:
            rep.drain_clean = runner.stop() and rep.drain_clean
        out["http"] = rep.to_dict()
        out["http"]["drain_clean"] = rep.drain_clean
        d = out["http"]
        print(f"[http]      {d['throughput_rps']:.0f} req/s | hit p50 "
              f"{d['hit_p50_ms']:.1f} ms vs miss p50 {d['miss_p50_ms']:.1f} ms "
              f"({d['hit_vs_miss_p50_ratio']:.1f}x) | shed={d['shed']} "
              f"expired={d['expired']} dropped={d['dropped_at_drain']}")

    # headline gate numbers: in-process when available, else http
    head = out.get("inprocess") or out.get("http")
    out["hit_p50_ms"] = head["hit_p50_ms"]
    out["miss_p50_ms"] = head["miss_p50_ms"]
    out["hit_vs_miss_p50_ratio"] = head["hit_vs_miss_p50_ratio"]
    out["dropped_at_drain"] = max(
        out[m]["dropped_at_drain"] for m in ("inprocess", "http") if m in out
    )

    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"-> {out_path}")
    return out


if __name__ == "__main__":
    main()
