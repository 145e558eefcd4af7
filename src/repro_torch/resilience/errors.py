"""Typed failure envelopes for the failover path.

The old loop raised ``ConnectionError(f"all backends failed: {tried}")`` —
the string kept the reprs but lost the exception *types*, so the gateway
could not tell an injected chaos error from an auth failure, and tests
could only assert on substrings. ``AllBackendsFailed`` keeps structured
per-backend causes (name, attempts, the exception kinds seen, whether the
breaker skipped it without a call) and the gateway maps it to a typed
``backend_unavailable`` 503 + Retry-After envelope.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class BackendFailure:
    """What happened on ONE backend during a failover walk."""

    backend: str
    attempts: int = 0  # calls actually made (0 == breaker fast-fail skip)
    skipped: bool = False  # breaker was open; no call burned
    errors: List[str] = field(default_factory=list)  # repr() per attempt
    kinds: List[str] = field(default_factory=list)  # exception type names

    def to_dict(self) -> dict:
        return {
            "backend": self.backend,
            "attempts": self.attempts,
            "skipped": self.skipped,
            "errors": list(self.errors),
            "kinds": list(self.kinds),
        }


class AllBackendsFailed(ConnectionError):
    """Every backend was skipped (breaker open) or exhausted its retries.

    Carries the structured per-backend causes so callers can branch on
    exception *types* (``kinds``) instead of parsing a repr string. The
    gateway maps this to 503 + ``Retry-After`` with error code
    ``backend_unavailable``; the service consults the serve-stale ladder
    before letting it reach a future.
    """

    def __init__(self, causes: List[BackendFailure], message: Optional[str] = None):
        self.causes = list(causes)
        if message is None:
            parts = []
            for c in self.causes:
                if c.skipped and not c.attempts:
                    parts.append(f"{c.backend}: breaker open")
                else:
                    kinds = ",".join(c.kinds) or "no error recorded"
                    parts.append(f"{c.backend}: {c.attempts} attempt(s) [{kinds}]")
            message = "all backends failed: " + "; ".join(parts) if parts else "no backends available"
        super().__init__(message)

    @property
    def skipped_backends(self) -> List[str]:
        return [c.backend for c in self.causes if c.skipped]

    def to_dict(self) -> dict:
        return {"causes": [c.to_dict() for c in self.causes]}


class InjectedFault(ConnectionError):
    """An error raised by the ``FaultInjector`` — typed so chaos tests can
    distinguish injected failures from organic ones, and so availability
    accounting in the chaos harness attributes errors correctly."""

    def __init__(self, message: str, kind: str = "error", backend: str = ""):
        super().__init__(message)
        self.kind = kind
        self.backend = backend
