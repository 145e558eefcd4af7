"""Resilience subsystem: fault injection + fault handling for the serving stack.

The paper's availability story ("If an LLM is unresponsive... other LLMs can
be queried", §2) needs more than a fall-through loop. This package supplies
the pieces the client/service/gateway thread together:

- ``errors``: typed failure envelopes (``AllBackendsFailed`` with structured
  per-backend causes, ``InjectedFault`` for chaos-originated errors).
- ``breaker``: a per-backend closed/open/half-open circuit breaker with an
  EMA health score, so a flapping backend fast-fails instead of eating a
  timeout per request.
- ``retry``: exponential-backoff-with-jitter retry policy plus a global
  retry token budget that caps retry storms under correlated failure.
- ``faults``: a seeded, schedule-driven ``FaultInjector`` whose wrappers
  make every failure mode (typed error, hang-until-deadline, latency spike,
  flapping, slow tokens) reproducible in tests and the traffic harness.

Everything here is deterministic under a fixed seed and injectable clock —
chaos runs replay bit-identically.
"""
from repro_torch.resilience.breaker import BreakerOpen, CircuitBreaker, CLOSED, HALF_OPEN, OPEN
from repro_torch.resilience.errors import AllBackendsFailed, BackendFailure, InjectedFault
from repro_torch.resilience.faults import FaultInjector, FaultSpec, FaultyBackend, FaultyTier
from repro_torch.resilience.retry import RetryBudget, RetryPolicy

__all__ = [
    "AllBackendsFailed",
    "BackendFailure",
    "BreakerOpen",
    "CircuitBreaker",
    "CLOSED",
    "FaultInjector",
    "FaultSpec",
    "FaultyBackend",
    "FaultyTier",
    "HALF_OPEN",
    "InjectedFault",
    "OPEN",
    "RetryBudget",
    "RetryPolicy",
]
