"""Enhanced client for GenerativeCache (§5).

Coordinates multiple LLM backends behind one interface with the cache
integrated: embed -> cache lookup -> hit: return / miss: dispatch to a
backend, charge its cost, insert the answer.

The request path itself lives in ``repro_torch.serving.service.CacheService``
(async-first: ``submit(CacheRequest) -> Future[CacheResponse]`` with
priority/deadline scheduling and admission control). This client is the
thin synchronous facade kept for compatibility: ``query`` /
``complete_batch`` build ``CacheRequest`` envelopes and run them inline
through ``CacheService.complete``; ``query_many`` / ``broadcast`` ride the
service's scheduler so concurrent dispatch shares one embed forward and
one backend fan-out.

Cost optimization knobs from §3.1/§5.3: model selection (serve from cheaper
models while the user is satisfied, escalate on dissatisfaction), max_tokens
limits, and the feedback/cost controllers servoing t_s.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.adaptive import (
    DEFAULT_PRICE_TABLE,
    CostController,
    ModelCostInfo,
    QualityRateController,
    ThresholdPolicy,
)
from repro_torch.core.generative_cache import GenerativeCache
from repro_torch.core.hierarchy import HierarchicalCache
from repro_torch.core.request import CacheRequest, CacheResponse
from repro_torch.core.semantic_cache import CacheResult
from repro_torch.resilience.breaker import CircuitBreaker
from repro_torch.resilience.errors import AllBackendsFailed, BackendFailure
from repro_torch.resilience.retry import RetryBudget, RetryPolicy


def accepts_kwarg(cls, method_name: str, kwarg: str) -> bool:
    """Does ``cls.<method_name>`` declare ``kwarg``? Cached in the class's
    OWN dict, so a subclass overriding the method is re-probed on its own
    signature instead of inheriting its parent's cached answer. Used to
    call newer keyword arguments (``deadlines``, ``return_vecs``)
    compatibly past subclasses written against an older signature."""
    cache_attr = f"_accepts_{kwarg}_cached"
    cached = cls.__dict__.get(cache_attr)
    if cached is None:
        import inspect

        try:
            cached = kwarg in inspect.signature(getattr(cls, method_name)).parameters
        except (TypeError, ValueError):
            cached = False
        setattr(cls, cache_attr, cached)
    return cached


@dataclass
class LLMResponse:
    text: str
    model: str
    tokens_in: int = 0
    tokens_out: int = 0
    latency_s: float = 0.0
    cost_usd: float = 0.0
    # the backend canceled this generation because its deadline passed
    # mid-flight (text holds whatever partial decode existed); the service
    # maps it to a typed DEADLINE_EXCEEDED response and never caches it
    expired: bool = False


class LLMBackend:
    """Interface for a model endpoint."""

    name: str = "llm"
    # tri-state deadline capability: None = auto-detect from the
    # generate_batch signature; True/False = explicit declaration (set True
    # on wrappers that forward **kwargs to a deadline-aware backend)
    supports_deadlines: Optional[bool] = None

    def generate(self, prompt: str, max_tokens: int = 256, temperature: float = 0.0) -> LLMResponse:
        raise NotImplementedError

    def generate_batch(
        self, prompts: Sequence[str], max_tokens: int = 256, temperature: float = 0.0
    ) -> List[LLMResponse]:
        """Serve a batch of prompts. Backends that batch natively (e.g. the
        continuous-batching engine) override this; the default loops.
        Deadline-aware backends accept an extra ``deadlines`` kwarg
        (absolute perf_counter stamps per prompt) and mark responses whose
        deadline passed mid-generation ``expired=True`` — the dispatcher
        only passes it to backends whose signature declares it."""
        return [self.generate(p, max_tokens, temperature) for p in prompts]


class MockLLM(LLMBackend):
    """Deterministic offline backend with a configurable latency/price profile."""

    def __init__(
        self,
        name: str = "mock-llm",
        latency_s: float = 0.0,
        responder: Optional[Callable[[str], str]] = None,
        fail: bool = False,
    ):
        self.name = name
        self.latency_s = latency_s
        self.responder = responder or (lambda p: f"[{name}] answer to: {p}")
        self.fail = fail
        self.calls = 0

    def generate(self, prompt: str, max_tokens: int = 256, temperature: float = 0.0) -> LLMResponse:
        if self.fail:
            raise ConnectionError(f"{self.name} unresponsive")
        t0 = time.perf_counter()
        if self.latency_s:
            time.sleep(self.latency_s)
        self.calls += 1
        text = self.responder(prompt)
        words = text.split()
        if len(words) > max_tokens:
            text = " ".join(words[:max_tokens])
        return LLMResponse(
            text, self.name, tokens_in=len(prompt.split()), tokens_out=min(len(words), max_tokens),
            latency_s=time.perf_counter() - t0,
        )

    def generate_batch(
        self, prompts: Sequence[str], max_tokens: int = 256, temperature: float = 0.0,
        deadlines: Optional[Sequence[Optional[float]]] = None,
    ) -> List[LLMResponse]:
        # batched endpoint semantics: the batch travels together, so the
        # simulated RTT is paid once, not once per prompt
        if self.fail:
            raise ConnectionError(f"{self.name} unresponsive")
        t0 = time.perf_counter()
        if self.latency_s:
            time.sleep(self.latency_s)
        deadlines = deadlines if deadlines is not None else [None] * len(prompts)
        now = time.perf_counter()
        out = []
        for prompt, deadline_t in zip(prompts, deadlines):
            if deadline_t is not None and now > deadline_t:
                # deadline passed while the batch was in flight: canceled
                out.append(LLMResponse("", self.name, latency_s=now - t0, expired=True))
                continue
            self.calls += 1
            text = self.responder(prompt)
            words = text.split()
            if len(words) > max_tokens:
                text = " ".join(words[:max_tokens])
            out.append(LLMResponse(
                text, self.name, tokens_in=len(prompt.split()),
                tokens_out=min(len(words), max_tokens),
                latency_s=time.perf_counter() - t0,
            ))
        return out


@dataclass
class ClientResult:
    text: str
    from_cache: bool
    cache_result: Optional[CacheResult]
    llm_response: Optional[LLMResponse]
    model: str
    cost_usd: float
    latency_s: float
    request_id: int


@dataclass
class ClientStats:
    requests: int = 0
    cache_hits: int = 0
    llm_calls: int = 0
    llm_errors: int = 0
    retries: int = 0  # backend calls repeated after a failure (same backend)
    breaker_trips: int = 0  # closed/half-open -> open transitions
    breaker_open_skips: int = 0  # backends skipped without a call (fast-fail)
    all_backends_failed: int = 0  # failover walks that exhausted every backend
    total_cost_usd: float = 0.0
    total_latency_s: float = 0.0

    @property
    def avg_cost(self) -> float:
        return self.total_cost_usd / self.requests if self.requests else 0.0


class EnhancedClient:
    def __init__(
        self,
        cache: Optional[GenerativeCache] = None,
        hierarchy: Optional[HierarchicalCache] = None,
        policy: Optional[ThresholdPolicy] = None,
        price_table: Optional[Dict[str, ModelCostInfo]] = None,
        quality_target: float = 0.8,
        target_cost_per_request: Optional[float] = None,
        max_workers: int = 8,  # kept for signature compat; the service's schedulers replaced the pool
        retry_policy: Optional[RetryPolicy] = None,
        retry_budget: Optional[RetryBudget] = None,
        breaker_factory: Optional[Callable[[str], CircuitBreaker]] = None,
    ):
        if policy is not None:
            self.policy = policy
        elif cache is not None and cache.policy is not None:
            self.policy = cache.policy
        else:
            # inherit the cache's static threshold as the servo's starting base
            self.policy = ThresholdPolicy(base=cache.threshold if cache is not None else 0.8)
        if cache is not None and cache.policy is None:
            cache.policy = self.policy
        self.cache = cache
        self.hierarchy = hierarchy
        self.price_table = dict(price_table or DEFAULT_PRICE_TABLE)
        self.backends: Dict[str, LLMBackend] = {}
        self._order: List[str] = []  # registration order == escalation order (cheap -> pricey)
        self.quality_ctl = QualityRateController(self.policy, target=quality_target)
        self.cost_ctl = (
            CostController(self.policy, target_cost_per_request)
            if target_cost_per_request is not None
            else None
        )
        self.stats = ClientStats()
        self.max_workers = max_workers
        # lazily-built CacheService (repro_torch.serving.service)
        self._service = None  # guarded-by: _state_lock
        self._results: Dict[int, ClientResult] = {}  # guarded-by: _state_lock
        self._next_id = 0  # guarded-by: _state_lock
        # client-owned locks, so several CacheService instances sharing this
        # client cannot tear them: _state_lock guards stats/_next_id/_results,
        # _cache_lock serializes store lookups against backfill scatters
        self._state_lock = threading.Lock()
        self._cache_lock = threading.RLock()
        self._preferred_level = 0  # guarded-by: _state_lock
        # -- resilience (repro_torch.resilience): per-backend breakers + retry --
        # breakers/_breaker_factory mutate only at registration time (setup,
        # single-threaded by convention); each CircuitBreaker is internally
        # locked, so the dispatch path reads them lock-free
        self.retry_policy = retry_policy or RetryPolicy()
        self.retry_budget = retry_budget or RetryBudget()
        self._breaker_factory = breaker_factory or (lambda name: CircuitBreaker(name))
        self.breakers: Dict[str, CircuitBreaker] = {}
        self._retry_rng = random.Random(0)  # guarded-by: _state_lock

    # -- service delegation ----------------------------------------------------

    @property
    def service(self):
        """The CacheService every request path delegates to. Built lazily
        (runtime import: core and serving reference each other)."""
        if self._service is None:  # repro: noqa[RA301] — double-checked fast path; GIL-atomic read, confirmed under the lock below
            from repro_torch.serving.service import CacheService

            with self._state_lock:  # concurrent first use must not build two
                if self._service is None:
                    self._service = CacheService(self)
        return self._service  # repro: noqa[RA301] — monotonic once-set publish; rebuilt never, torn never (single reference assignment)

    def close(self) -> None:
        with self._state_lock:
            service = self._service
        if service is not None:
            service.close()

    @staticmethod
    def _to_client_result(resp: CacheResponse) -> ClientResult:
        return ClientResult(
            resp.text, resp.from_cache, resp.cache_result, resp.llm_response,
            resp.model, resp.cost_usd, resp.latency_s, resp.request_id,
        )

    # -- backend management --------------------------------------------------

    def register_backend(self, backend: LLMBackend, price: Optional[ModelCostInfo] = None):
        self.backends[backend.name] = backend
        if backend.name not in self._order:
            self._order.append(backend.name)
        self.breakers[backend.name] = self._breaker_factory(backend.name)
        if price is not None:
            self.price_table[backend.name] = price

    def breaker_snapshot(self) -> Dict[str, dict]:
        """Per-backend breaker state for /healthz and /v1/cache/stats."""
        return {name: br.snapshot() for name, br in self.breakers.items()}

    def _price(self, model: str) -> ModelCostInfo:
        return self.price_table.get(model, ModelCostInfo())

    def _cost_of(self, model: str, resp: LLMResponse) -> float:
        p = self._price(model)
        return (resp.tokens_in * p.usd_per_mtok_in + resp.tokens_out * p.usd_per_mtok_out) / 1e6

    def _select_model(self, model: Optional[str]) -> str:
        if model is not None:
            return model
        if not self._order:
            raise RuntimeError("no backends registered")
        with self._state_lock:
            level = self._preferred_level
        return self._order[min(level, len(self._order) - 1)]

    def _context_for(self, request: CacheRequest, chosen: str) -> dict:
        """ThresholdPolicy context (§2) for one request."""
        return {
            "model_info": self._price(chosen),
            "max_tokens": request.max_tokens,
            "connectivity": request.connectivity,
        }

    # -- main request path (thin sync wrappers over CacheService) ----------------

    def query(
        self,
        prompt: str,
        model: Optional[str] = None,
        max_tokens: int = 256,
        temperature: float = 0.0,
        use_cache: bool = True,
        force_fresh: bool = False,  # user explicitly wants a new LLM response
        cache_l1: bool = True,  # privacy hints (§4)
        cache_l2: bool = True,
        connectivity: float = 1.0,
    ) -> ClientResult:
        return self.complete_requests([
            CacheRequest(
                prompt, model=model, max_tokens=max_tokens, temperature=temperature,
                use_cache=use_cache, force_fresh=force_fresh, cache_l1=cache_l1,
                cache_l2=cache_l2, connectivity=connectivity,
            )
        ])[0]

    def complete_requests(self, requests: Sequence[CacheRequest]) -> List[ClientResult]:
        """Serve CacheRequests inline (one embed forward + one search +
        one batched miss dispatch) and return in request order."""
        return [self._to_client_result(r) for r in self.service.complete(requests)]

    def complete_batch(
        self,
        prompts: Sequence[str],
        model: Optional[str] = None,
        max_tokens: int = 256,
        temperature: float = 0.0,
        use_cache: bool = True,
        force_fresh: bool = False,
        cache_l1: bool = True,
        cache_l2: bool = True,  # privacy hints (§4); only meaningful with a hierarchy
        connectivity: float = 1.0,
    ) -> List[ClientResult]:
        """Serve B prompts through the batched cache pipeline (uniform knobs;
        build ``CacheRequest``s directly for per-request hints/priorities)."""
        return self.complete_requests([
            CacheRequest(
                p, model=model, max_tokens=max_tokens, temperature=temperature,
                use_cache=use_cache, force_fresh=force_fresh, cache_l1=cache_l1,
                cache_l2=cache_l2, connectivity=connectivity,
            )
            for p in prompts
        ])

    # -- async API (futures) -----------------------------------------------------

    def submit(self, request: CacheRequest):
        """Async entry: ``Future[CacheResponse]`` that resolves at hit speed
        for hits even when slow misses share the stream."""
        return self.service.submit(request)

    def asubmit(self, request: CacheRequest):
        return self.service.asubmit(request)

    # -- failover (used by the service's dispatch phase) -------------------------

    def _generate_with_failover(self, model, prompt, max_tokens, temperature) -> LLMResponse:
        """If an LLM is unresponsive, fall through to the other backends (§2)."""
        return self._generate_batch_with_failover(model, [prompt], max_tokens, temperature)[0]

    @staticmethod
    def _accepts_deadlines(backend: LLMBackend) -> bool:
        # explicit declaration wins: backends that delegate via *args/**kwargs
        # (no literal 'deadlines' parameter) can set supports_deadlines=True
        declared = getattr(backend, "supports_deadlines", None)
        if declared is not None:
            return bool(declared)
        return accepts_kwarg(type(backend), "generate_batch", "deadlines")

    def _jitter_draw(self) -> float:
        with self._state_lock:
            return self._retry_rng.random()

    def _generate_batch_with_failover(
        self, model, prompts, max_tokens, temperature, deadlines=None
    ) -> List[LLMResponse]:
        """Batched failover with per-backend retry + circuit breaking.

        Rows whose deadline has ALREADY passed resolve in place as typed
        ``expired`` responses — an expiry is the caller's clock running out,
        not a backend failure, so it burns no call, no retry, no failover
        hop, and no ``llm_errors`` bump. The live rows then walk the
        escalation order: backends whose breaker is open are skipped without
        a call; each admitted backend gets up to ``retry_policy.max_attempts``
        tries with exponential backoff + jitter, gated by the global retry
        budget and by deadline headroom (never sleep past the soonest live
        deadline). Exhausting every backend raises a typed
        ``AllBackendsFailed`` carrying structured per-backend causes.
        """
        n = len(prompts)
        out: List[Optional[LLMResponse]] = [None] * n
        stamps = list(deadlines) if deadlines is not None else [None] * n

        def _expire_passed(now: float) -> None:
            for i in range(n):
                if out[i] is None and stamps[i] is not None and now > stamps[i]:
                    out[i] = LLMResponse("", model or "", expired=True)

        def _live() -> List[int]:
            return [i for i in range(n) if out[i] is None]

        _expire_passed(time.perf_counter())
        if not _live():
            return [r for r in out if r is not None]

        self.retry_budget.deposit(len(_live()))
        causes: List[BackendFailure] = []
        names = [model] + [n_ for n_ in self._order if n_ != model]
        for name in names:
            backend = self.backends.get(name)
            if backend is None:
                continue
            _expire_passed(time.perf_counter())
            live = _live()
            if not live:
                break
            breaker = self.breakers.get(name)
            if breaker is not None and not breaker.allow():
                causes.append(BackendFailure(name, skipped=True))
                with self._state_lock:
                    self.stats.breaker_open_skips += 1
                continue
            failure = self._call_backend_with_retry(
                backend, breaker, out, stamps, live, prompts, max_tokens, temperature
            )
            if failure is None:
                return [r for r in out if r is not None]
            causes.append(failure)
        _expire_passed(time.perf_counter())
        if not _live():
            # every remaining row expired while we failed over: a typed
            # per-row expiry beats an exception that would also poison the
            # rows a backend DID answer earlier
            return [r for r in out if r is not None]
        with self._state_lock:
            self.stats.all_backends_failed += 1
        raise AllBackendsFailed(causes)

    def _call_backend_with_retry(
        self, backend, breaker, out, stamps, live, prompts, max_tokens, temperature
    ) -> Optional[BackendFailure]:
        """Try ONE backend for the ``live`` rows, retrying per policy.
        Returns None on success (results written into ``out``), else the
        structured failure record for the AllBackendsFailed envelope."""
        name = backend.name
        sub_prompts = [prompts[i] for i in live]
        sub_stamps = [stamps[i] for i in live]
        pass_deadlines = any(s is not None for s in sub_stamps) and self._accepts_deadlines(backend)
        soonest = min((s for s in sub_stamps if s is not None), default=None)
        failure = BackendFailure(name)
        for attempt in range(1, self.retry_policy.max_attempts + 1):
            failure.attempts = attempt
            try:
                if pass_deadlines:
                    rows = backend.generate_batch(
                        sub_prompts, max_tokens, temperature, deadlines=sub_stamps
                    )
                else:
                    rows = backend.generate_batch(sub_prompts, max_tokens, temperature)
            except Exception as e:  # noqa: BLE001 — failover on any backend error
                failure.errors.append(repr(e))
                failure.kinds.append(type(e).__name__)
                tripped = breaker.record_failure() if breaker is not None else False
                with self._state_lock:
                    self.stats.llm_errors += 1
                    if tripped:
                        self.stats.breaker_trips += 1
                if attempt >= self.retry_policy.max_attempts:
                    return failure
                backoff = self.retry_policy.backoff_s(attempt, self._jitter_draw())
                if soonest is not None and time.perf_counter() + backoff >= soonest:
                    return failure  # no headroom: retrying would land past the deadline
                if not self.retry_budget.try_spend():
                    return failure  # global retry budget dry: move on immediately
                with self._state_lock:
                    self.stats.retries += 1
                if backoff > 0:
                    time.sleep(backoff)
                continue
            if breaker is not None:
                breaker.record_success()
            for i, row in zip(live, rows):
                out[i] = row
            return None
        return failure  # unreachable, but keeps the type checker honest

    # -- parallel multi-LLM dispatch (§5.2) ---------------------------------------

    def query_many(
        self,
        prompts: Sequence[str],
        models: Optional[Sequence[Optional[str]]] = None,
        parallel: bool = True,
        **kwargs,
    ) -> List[ClientResult]:
        models = models or [None] * len(prompts)
        if not parallel:
            return [self.query(p, m, **kwargs) for p, m in zip(prompts, models)]
        # concurrent requests ride the service scheduler: one admitted batch
        # shares one embed forward and one backend fan-out per model group
        # (submit_many blocks for capacity instead of shedding, so a bulk
        # sync call never abandons already-submitted work)
        futures = self.service.submit_many(
            [CacheRequest(p, model=m, **kwargs) for p, m in zip(prompts, models)]
        )
        return [self._to_client_result(f.result()) for f in futures]

    def broadcast(self, prompt: str, models: Optional[Sequence[str]] = None, **kwargs) -> Dict[str, ClientResult]:
        """Ask several LLMs the same question concurrently (§5.2)."""
        models = list(models or self._order)
        futures = self.service.submit_many(
            [CacheRequest(prompt, model=m, use_cache=False, **kwargs) for m in models]
        )
        return {m: self._to_client_result(f.result()) for m, f in zip(models, futures)}

    # -- feedback (§3.1) ------------------------------------------------------------

    def feedback(self, result: ClientResult, satisfied: bool) -> None:
        """User feedback on a served result.

        Cache hits feed the quality-rate controller. Dissatisfaction with an
        *LLM* answer escalates model selection; satisfaction de-escalates
        toward the cheaper models.
        """
        if result.from_cache:
            self.quality_ctl.record(satisfied)
        else:
            with self._state_lock:
                if satisfied:
                    self._preferred_level = max(0, self._preferred_level - 1)
                else:
                    self._preferred_level = min(
                        len(self._order) - 1, self._preferred_level + 1
                    )
