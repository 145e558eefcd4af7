"""Request/response envelope for the cache serving path (§5).

``CacheRequest`` replaces the kwargs sprawl that was duplicated across
``EnhancedClient.query`` / ``complete_batch`` / ``query_many`` /
``broadcast`` with one dataclass carrying every per-request knob — the
cache hints (``use_cache``, ``force_fresh``, the §4 privacy hints) plus the
async-serving fields the scheduler acts on (``priority``, ``deadline_s``).

``CacheResponse`` is the typed result every submitted future resolves
with. Hits and generated answers carry text; a miss whose deadline expired
in queue resolves with ``status == DEADLINE_EXCEEDED`` and ``text=None``
instead of generating — the caller gets a typed result, never a silent
stall behind a slow backend.

``CacheChunk`` is the streaming unit: ``CacheService.astream`` replays a
resolved response token-by-token as chunks whose concatenated ``text`` is
byte-identical to the non-streamed ``CacheResponse.text`` — the HTTP
gateway serves hits and misses over the same SSE surface, so a client
cannot tell a millisecond cache replay from a live generation except by
reading the ``X-Cache`` header.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, List, Optional

if TYPE_CHECKING:  # typing only — avoids a runtime cycle with repro_torch.core.client
    from repro_torch.core.client import LLMResponse
    from repro_torch.core.semantic_cache import CacheResult

# CacheResponse.status values
HIT = "hit"  # served from cache (semantic or generative)
GENERATED = "generated"  # miss: a backend generated the answer
DEADLINE_EXCEEDED = "deadline_exceeded"  # miss expired in queue; no backend call
STALE = "stale"  # stale-if-error: expired entry served because every backend was down


@dataclass
class CacheRequest:
    prompt: str
    model: Optional[str] = None  # None -> the client's escalation ladder picks
    max_tokens: int = 256
    temperature: float = 0.0
    use_cache: bool = True
    force_fresh: bool = False  # skip lookup, still insert the fresh answer (§5.2)
    cache_l1: bool = True  # privacy hints (§4); cache_l2 only matters with a hierarchy
    cache_l2: bool = True
    connectivity: float = 1.0
    priority: int = 0  # higher is scheduled sooner
    deadline_s: Optional[float] = None  # relative to submit; expired misses don't generate
    ttl_s: Optional[float] = None  # backfilled answer's cache lifetime; None = store default
    stream: bool = False  # caller wants chunked delivery (CacheService.astream / SSE)
    # stale-if-error (resilience): when every backend is open/down, a request
    # that opted in may be answered from an EXPIRED cache entry instead of a
    # 503 — bounded by max_stale_s past expiry (None = any age)
    allow_stale: bool = False
    max_stale_s: Optional[float] = None
    metadata: Dict[str, Any] = field(default_factory=dict)


@dataclass
class CacheResponse:
    text: Optional[str]
    status: str  # HIT | GENERATED | DEADLINE_EXCEEDED
    from_cache: bool
    cache_result: Optional["CacheResult"]
    llm_response: Optional["LLMResponse"]
    model: str
    cost_usd: float
    latency_s: float
    request_id: int

    @property
    def expired(self) -> bool:
        return self.status == DEADLINE_EXCEEDED

    @property
    def cache_status(self) -> str:
        """Where the answer came from, as the gateway's ``X-Cache`` value:
        ``hit`` (plain semantic tier-0), ``generative`` (synthesized from
        several sources, §3), ``tier1`` (promoted from the host-RAM ring),
        ``stale`` (expired entry served stale-if-error while backends were
        down), or ``miss`` (a backend generated it — including expiries,
        which the gateway maps to an error status before this header
        matters)."""
        if self.status == STALE:
            return "stale"
        if self.status == HIT and self.cache_result is not None:
            level = self.cache_result.level or ""
            if "tier1" in level:
                return "tier1"
            if self.cache_result.generative or "generative" in level:
                return "generative"
            return "hit"
        return "miss"

    @property
    def similarity(self) -> Optional[float]:
        """Winning similarity score for cache hits, None for misses."""
        if self.cache_result is None:
            return None
        return float(self.cache_result.similarity)

    @property
    def resolved_level(self) -> str:
        """The hierarchy level that answered (``semantic``, ``L2:tier1``,
        ``generative``, ...) or ``miss``/``deadline_exceeded`` for the rest."""
        if self.status == HIT and self.cache_result is not None:
            return self.cache_result.level or "semantic"
        return "miss" if self.status == GENERATED else self.status


def split_stream_tokens(text: str) -> List[str]:
    """Split ``text`` into replayable streaming tokens (a word plus its
    trailing whitespace each) such that ``"".join(...)`` reproduces the
    input byte-for-byte — the invariant the gateway's SSE parity contract
    (and its tests) rest on. Leading whitespace rides the first token."""
    if not text:
        return []
    runs = re.findall(r"\s+|\S+", text)  # alternating runs; join(runs) == text
    tokens: List[str] = []
    for run in runs:
        if tokens and run.isspace():
            tokens[-1] += run
        else:
            tokens.append(run)
    return tokens


@dataclass
class CacheChunk:
    """One streamed piece of a resolved response (``CacheService.astream``).

    ``response`` carries the full ``CacheResponse`` on EVERY chunk so a
    consumer (the gateway writes cache-status headers before the first SSE
    event) never waits for the stream's end to learn hit/miss, similarity,
    or latency. ``final`` marks the last chunk; an empty response yields a
    single final chunk with ``text == ""``."""

    text: str
    index: int
    final: bool
    response: CacheResponse
