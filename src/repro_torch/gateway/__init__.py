"""HTTP gateway + traffic-replay harness: the serving surface over
``CacheService`` (the port of the reference's ``gateway`` package).

Two halves:

  * ``repro_torch.gateway.app.Gateway`` — a stdlib-asyncio OpenAI-compatible
    front end (``/v1/chat/completions``, ``/v1/completions``, ``/healthz``,
    ``/v1/cache/stats``) with SSE streaming for hits and misses,
    cache-status headers, typed error mapping, and graceful drain;
  * ``repro_torch.gateway.traffic`` — reproducible Zipfian/bursty workload
    generation and replay (in-process or over real HTTP), reporting
    p50/p95/p99 per cache class into a JSON report (``--out``).
"""
from repro_torch.gateway.app import (  # noqa: F401
    Gateway,
    GatewayStats,
    GatewayThread,
    serve_in_thread,
)
from repro_torch.gateway.client import GatewayClient, GatewayReply, parse_sse  # noqa: F401
from repro_torch.gateway.http import GatewayHttpServer, HttpRequest, Response  # noqa: F401
from repro_torch.gateway.protocol import ProtocolError  # noqa: F401
