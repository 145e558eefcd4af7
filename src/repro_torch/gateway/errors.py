"""Typed service failure -> stable HTTP status + JSON error body.

Every way the serving stack can refuse or abandon a request has ONE
documented HTTP shape, so load-balancers and client retry loops can act on
the status code without parsing bodies:

    ==========================  ======  ===========================
    failure                     status  notes
    ==========================  ======  ===========================
    malformed request           400     ``ProtocolError`` (parse layer)
    unknown route               404
    wrong method on a route     405     ``Allow`` header
    ``AdmissionRejected``       429     ``Retry-After`` header (shed)
    ``AllBackendsFailed``       503     ``Retry-After``; structured causes
    ``ServiceClosed``           503     draining/closed
    ``DEADLINE_EXCEEDED`` resp  504     typed response, not an exception
    anything else               500     repr'd, never a raw traceback
    ==========================  ======  ===========================
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.core.request import CacheResponse
from repro_torch.gateway.protocol import ProtocolError, error_body
from repro_torch.resilience.errors import AllBackendsFailed
from repro_torch.serving.coalescer import AdmissionRejected, ServiceClosed

# (status, headers, body) — what the HTTP layer writes
ErrorTriple = Tuple[int, List[Tuple[str, str]], bytes]

RETRY_AFTER_S = 1  # advisory backoff for shed load; the budget drains in ms


def map_exception(exc: BaseException) -> ErrorTriple:
    """Map a request-handling exception to its wire shape."""
    if isinstance(exc, ProtocolError):
        return (
            exc.status,
            [],
            error_body(str(exc), exc.err_type, exc.code),
        )
    if isinstance(exc, AdmissionRejected):
        return (
            429,
            [("Retry-After", str(RETRY_AFTER_S))],
            error_body(
                f"server overloaded: {exc}", "rate_limit_error", "admission_rejected"
            ),
        )
    if isinstance(exc, AllBackendsFailed):
        # the degradation ladder's floor: every backend open/down AND no
        # stale entry could answer — a retryable outage, not a client error
        return (
            503,
            [("Retry-After", str(RETRY_AFTER_S))],
            error_body(
                f"no backend available: {exc}",
                "service_unavailable",
                "backend_unavailable",
            ),
        )
    if isinstance(exc, ServiceClosed):
        return (
            503,
            [],
            error_body(
                f"service unavailable: {exc}", "service_unavailable", "service_closed"
            ),
        )
    return (
        500,
        [],
        error_body(f"internal error: {exc!r}", "internal_error", None),
    )


def map_expired_response(resp: CacheResponse) -> ErrorTriple:
    """A miss whose deadline passed resolves typed (no backend call / a
    canceled mid-flight generation) — surface it as a gateway timeout."""
    return (
        504,
        [("X-Request-Id", str(resp.request_id))],
        error_body(
            f"deadline exceeded after {resp.latency_s * 1e3:.1f} ms in service",
            "timeout_error",
            "deadline_exceeded",
        ),
    )


def not_found(path: str) -> ErrorTriple:
    return 404, [], error_body(f"no route for {path}", "invalid_request_error", "not_found")


def method_not_allowed(method: str, allow: str) -> ErrorTriple:
    return (
        405,
        [("Allow", allow)],
        error_body(f"{method} not allowed here", "invalid_request_error", "method_not_allowed"),
    )


def draining_unavailable(reason: Optional[str] = None) -> ErrorTriple:
    return (
        503,
        [("Retry-After", str(RETRY_AFTER_S))],
        error_body(reason or "gateway is draining", "service_unavailable", "draining"),
    )
