"""The HTTP gateway: OpenAI-compatible serving surface over ``CacheService``.

``Gateway`` binds the stdlib HTTP layer (``repro_torch.gateway.http``) to the
async cache service: POST bodies parse into ``CacheRequest``s, responses
come back as OpenAI ``chat.completion`` / ``text_completion`` objects with
the cache-status header contract (``X-Cache: hit|generative|tier1|miss``,
``X-Cache-Similarity``, ``X-Cache-Level``, ``X-Service-Latency-Ms``), and
``"stream": true`` serves Server-Sent Events for hits AND misses through
``CacheService.astream`` — a cached answer replays token-by-token with a
pacing knob (``pace_ms``) so a client watching the stream can't tell a
millisecond replay from a live generation.

Routes::

    GET  /healthz              liveness + drain state
    GET  /v1/cache/stats       service/cache/gateway counters (JSON)
    POST /v1/chat/completions  OpenAI chat API (messages array)
    POST /v1/completions       OpenAI completions API (prompt string)

Shutdown is a graceful drain (``aclose``): the listener stops accepting,
in-flight requests finish and their futures resolve, and only then — when
the gateway owns the service (``own_service=True``, the ``launch/serve
--http`` wiring) — does ``CacheService.close()`` run.

``serve_in_thread`` runs a gateway on a private event loop in a daemon
thread — the harness the HTTP traffic replay, the tests, and the example
all share.
"""
from __future__ import annotations

import asyncio
import threading
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.request import CacheRequest, CacheResponse
from repro_torch.gateway import errors as gwerrors
from repro_torch.gateway.http import GatewayHttpServer, HttpRequest, Response
from repro_torch.gateway.protocol import (
    SSE_DONE,
    cache_headers,
    completion_body,
    parse_chat_request,
    parse_completion_request,
    sse_event,
    stream_chunk_body,
)
from repro_torch.serving.service import CacheService


class GatewayStats:
    """Request-class counters for ``/v1/cache/stats`` — one bucket per
    ``X-Cache`` value plus the error statuses. Thread-safe: handler
    coroutines and stats readers may sit on different loops/threads."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_class: Dict[str, int] = {}  # guarded-by: _lock
        self._by_status: Dict[int, int] = {}  # guarded-by: _lock
        self._streamed = 0  # guarded-by: _lock

    def record(self, status: int, cache_class: Optional[str], streamed: bool) -> None:
        with self._lock:
            self._by_status[status] = self._by_status.get(status, 0) + 1
            if cache_class is not None:
                self._by_class[cache_class] = self._by_class.get(cache_class, 0) + 1
            if streamed:
                self._streamed += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            served = sum(self._by_class.values())
            return {
                "by_cache_class": dict(self._by_class),
                "by_status": {str(k): v for k, v in self._by_status.items()},
                "streamed": self._streamed,
                "hit_fraction": (
                    sum(v for k, v in self._by_class.items() if k != "miss") / served
                    if served
                    else 0.0
                ),
            }


class Gateway:
    def __init__(
        self,
        service: CacheService,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        pace_ms: float = 0.0,
        chunk_tokens: int = 1,
        own_service: bool = False,
    ):
        self.service = service
        self.http = GatewayHttpServer(self.handle, host=host, port=port)
        self.pace_s = pace_ms / 1e3
        self.chunk_tokens = max(1, chunk_tokens)
        self.own_service = own_service
        self.stats = GatewayStats()

    # -- lifecycle -------------------------------------------------------------

    async def start(self) -> Tuple[str, int]:
        return await self.http.start()

    async def aclose(self, timeout: float = 10.0) -> bool:
        """Graceful drain: stop accepting, flush in-flight requests (their
        service futures resolve before the HTTP response finishes), then —
        if the gateway owns it — close the service so its schedulers drain
        every remaining accepted future."""
        clean = await self.http.drain(timeout=timeout)
        if self.own_service:
            self.service.close()
        return clean

    @property
    def port(self) -> int:
        return self.http.port

    # -- routing ---------------------------------------------------------------

    async def handle(self, request: HttpRequest) -> Response:
        route = (request.method, request.path)
        if route == ("GET", "/healthz"):
            return self._healthz()
        if route == ("GET", "/v1/cache/stats"):
            return self._cache_stats()
        if route == ("POST", "/v1/chat/completions"):
            return await self._completions(request, chat=True)
        if route == ("POST", "/v1/completions"):
            return await self._completions(request, chat=False)
        if request.path in ("/healthz", "/v1/cache/stats"):
            status, headers, body = gwerrors.method_not_allowed(request.method, "GET")
        elif request.path in ("/v1/chat/completions", "/v1/completions"):
            status, headers, body = gwerrors.method_not_allowed(request.method, "POST")
        else:
            status, headers, body = gwerrors.not_found(request.path)
        self.stats.record(status, None, False)
        return Response(status, headers, body)

    # -- handlers --------------------------------------------------------------

    def _healthz(self) -> Response:
        breakers = self.service.client.breaker_snapshot()
        # the gateway stays "ok" while ANY backend is closed/half-open; all
        # breakers open means new misses ride the stale ladder or get 503s
        degraded = bool(breakers) and all(
            b["state"] == "open" for b in breakers.values()
        )
        status = "draining" if self.http.draining else ("degraded" if degraded else "ok")
        payload = {
            "status": status,
            "inflight_http": self.http.inflight,
            "inflight_service": self.service.inflight,
            "requests_served": self.http.requests_served,
            "breakers": breakers,
        }
        self.stats.record(200, None, False)
        return Response.json_response(payload)

    def _cache_stats(self) -> Response:
        svc, client = self.service.stats, self.service.client.stats
        lookup, dispatch = self.service.scheduler_stats
        payload = {
            "gateway": self.stats.snapshot(),
            "service": {
                "submitted": svc.submitted,
                "hits": svc.hits,
                "generated": svc.generated,
                "expired": svc.expired,
                "rejected": svc.rejected,
                "deduped": svc.deduped,
                "stale_served": svc.stale_served,
                "backend_unavailable": svc.backend_unavailable,
                "inflight": self.service.inflight,
            },
            "client": {
                "requests": client.requests,
                "cache_hits": client.cache_hits,
                "llm_calls": client.llm_calls,
                "llm_errors": client.llm_errors,
                "retries": client.retries,
                "breaker_trips": client.breaker_trips,
                "breaker_open_skips": client.breaker_open_skips,
                "all_backends_failed": client.all_backends_failed,
                "total_cost_usd": client.total_cost_usd,
            },
            "breakers": self.service.client.breaker_snapshot(),
            "retry_budget": self.service.client.retry_budget.snapshot(),
            "schedulers": {
                "lookup_avg_batch": lookup.avg_batch if lookup else 0.0,
                "dispatch_avg_batch": dispatch.avg_batch if dispatch else 0.0,
            },
        }
        self.stats.record(200, None, False)
        return Response.json_response(payload)

    async def _completions(self, request: HttpRequest, *, chat: bool) -> Response:
        # ProtocolError (malformed JSON / bad fields) propagates to the HTTP
        # layer's dispatcher, which maps it to a 400 — but record it here so
        # the stats see parse failures too
        try:
            creq = (parse_chat_request if chat else parse_completion_request)(
                request.json()
            )
        except Exception as e:  # noqa: BLE001 — re-raised after recording
            status, _, _ = gwerrors.map_exception(e)
            self.stats.record(status, None, False)
            raise
        if creq.stream:
            return await self._stream_response(creq, chat=chat)
        try:
            resp = await self.service.asubmit(creq)
        except Exception as e:  # noqa: BLE001 — typed shed/closed mapping
            status, headers, body = gwerrors.map_exception(e)
            self.stats.record(status, None, False)
            return Response(status, headers, body)
        if resp.expired:
            status, headers, body = gwerrors.map_expired_response(resp)
            self.stats.record(status, None, False)
            return Response(status, headers, body)
        self.stats.record(200, resp.cache_status, False)
        return Response.json_response(
            completion_body(resp, creq, chat=chat), headers=cache_headers(resp)
        )

    async def _stream_response(self, creq: CacheRequest, *, chat: bool) -> Response:
        """SSE for hits and misses alike. The stream generator is primed
        BEFORE headers go out: the first chunk (which already carries the
        fully resolved ``CacheResponse``) decides the cache-status headers,
        and a typed expiry becomes a clean 504 instead of a broken stream."""
        agen = self.service.astream(
            creq, pace_s=self.pace_s, chunk_tokens=self.chunk_tokens
        )
        try:
            first = await agen.__anext__()
        except StopAsyncIteration:  # astream always yields; belt and braces
            status, headers, body = gwerrors.map_exception(
                RuntimeError("empty stream")
            )
            self.stats.record(status, None, False)
            return Response(status, headers, body)
        except Exception as e:  # noqa: BLE001 — shed/closed before any byte
            status, headers, body = gwerrors.map_exception(e)
            self.stats.record(status, None, False)
            return Response(status, headers, body)
        resp = first.response
        if resp.expired:
            status, headers, body = gwerrors.map_expired_response(resp)
            self.stats.record(status, None, False)
            return Response(status, headers, body)
        self.stats.record(200, resp.cache_status, True)

        async def sse(resp: CacheResponse = resp) -> Any:
            sent_any = False
            chunk = first
            while True:
                body = stream_chunk_body(
                    resp, chat=chat, text=chunk.text, first=not sent_any,
                    final=chunk.final,
                )
                sent_any = True
                yield sse_event(body)
                if chunk.final:
                    break
                try:
                    chunk = await agen.__anext__()
                except StopAsyncIteration:
                    break
            yield SSE_DONE

        headers: List[Tuple[str, str]] = [
            ("Cache-Control", "no-cache"),
            *cache_headers(resp),
        ]
        return Response(
            200, headers, content_type="text/event-stream", chunks=sse()
        )


# -- threaded runner (tests, HTTP traffic replay, examples) ---------------------


class GatewayThread:
    """A gateway serving on its own event loop in a daemon thread.

    ``start()`` blocks until the port is bound and returns (host, port);
    ``stop()`` runs the graceful drain on the gateway's loop and joins the
    thread. The loop is private to this thread, so the caller's asyncio
    state (if any) is never touched."""

    def __init__(self, gateway: Gateway):
        self.gateway = gateway
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._stopped = threading.Event()
        self._addr: Optional[Tuple[str, int]] = None
        self._drained_clean: Optional[bool] = None

    def start(self, timeout: float = 10.0) -> Tuple[str, int]:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout=timeout):
            raise RuntimeError("gateway failed to start in time")
        assert self._addr is not None
        return self._addr

    def _run(self) -> None:
        asyncio.run(self._main())

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._addr = await self.gateway.start()
        self._ready.set()
        # serve until stop() flips the event from another thread
        while not self._stopped.is_set():
            await asyncio.sleep(0.02)
        self._drained_clean = await self.gateway.aclose()

    def stop(self, timeout: float = 15.0) -> bool:
        """Drain and shut down; returns True when every in-flight request
        finished before the drain timeout."""
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        return bool(self._drained_clean)

    def __enter__(self) -> "GatewayThread":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def serve_in_thread(
    service: CacheService,
    *,
    host: str = "127.0.0.1",
    port: int = 0,
    pace_ms: float = 0.0,
    own_service: bool = False,
) -> GatewayThread:
    """Convenience: build a ``Gateway`` and serve it from a daemon thread."""
    gw = Gateway(
        service, host=host, port=port, pace_ms=pace_ms, own_service=own_service
    )
    runner = GatewayThread(gw)
    runner.start()
    return runner
