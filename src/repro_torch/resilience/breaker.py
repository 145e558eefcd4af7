"""Per-backend circuit breaker with health scoring.

Classic three-state machine:

    CLOSED --[trip: consecutive failures or health < floor]--> OPEN
    OPEN   --[recovery_s elapsed]--> HALF_OPEN (probe budget)
    HALF_OPEN --[probe succeeds]--> CLOSED
    HALF_OPEN --[probe fails]--> OPEN (recovery timer restarts)

While OPEN the breaker fast-fails ``allow()`` so a dead backend costs a
dict lookup instead of a connect timeout per request. Health is an EMA of
call outcomes (1.0 = success, 0.0 = failure) so a *flapping* backend —
which never accumulates ``failure_threshold`` consecutive failures — still
trips once its score sinks below ``health_floor``.

The clock is injectable (``time_fn``) so tests drive open -> half-open
transitions without sleeping, and every mutation happens under one lock
with ``# guarded-by:`` annotations (RA301).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class BreakerOpen(ConnectionError):
    """Raised by ``call``-style helpers when the breaker refuses a call."""

    def __init__(self, backend: str):
        super().__init__(f"circuit breaker open for backend {backend!r}")
        self.backend = backend


class CircuitBreaker:
    def __init__(
        self,
        name: str = "backend",
        failure_threshold: int = 3,
        recovery_s: float = 5.0,
        half_open_probes: int = 1,
        health_alpha: float = 0.2,
        health_floor: float = 0.25,
        time_fn: Optional[Callable[[], float]] = None,
    ):
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.recovery_s = float(recovery_s)
        self.half_open_probes = int(half_open_probes)
        self.health_alpha = float(health_alpha)
        self.health_floor = float(health_floor)
        self._time = time_fn or time.monotonic
        self._lock = threading.Lock()
        self._state = CLOSED  # guarded-by: _lock
        self._consecutive_failures = 0  # guarded-by: _lock
        self._health = 1.0  # guarded-by: _lock
        self._opened_at = 0.0  # guarded-by: _lock
        self._probes_inflight = 0  # guarded-by: _lock
        self._trips = 0  # guarded-by: _lock
        self._successes = 0  # guarded-by: _lock
        self._failures = 0  # guarded-by: _lock
        self._open_skips = 0  # guarded-by: _lock

    # -- state ---------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:  # repro: holds[_lock]
        if self._state == OPEN and self._time() - self._opened_at >= self.recovery_s:
            self._state = HALF_OPEN
            self._probes_inflight = 0

    def allow(self) -> bool:
        """May a call go to this backend right now? HALF_OPEN admits at most
        ``half_open_probes`` concurrent probes; OPEN admits none (and counts
        the skip)."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN:
                if self._probes_inflight < self.half_open_probes:
                    self._probes_inflight += 1
                    return True
                self._open_skips += 1
                return False
            self._open_skips += 1
            return False

    # -- outcome recording -----------------------------------------------------

    def record_success(self) -> None:
        with self._lock:
            self._successes += 1
            self._consecutive_failures = 0
            self._health += self.health_alpha * (1.0 - self._health)
            if self._state == HALF_OPEN:
                # probe came back healthy: close and forgive the score so the
                # next organic failure doesn't instantly re-trip on old EMA
                self._state = CLOSED
                self._probes_inflight = 0
                self._health = max(self._health, 0.5)

    def record_failure(self) -> bool:
        """Record a failed call. Returns True when THIS failure tripped the
        breaker (closed/half-open -> open), so callers can count trips."""
        with self._lock:
            self._failures += 1
            self._consecutive_failures += 1
            self._health += self.health_alpha * (0.0 - self._health)
            if self._state == HALF_OPEN:
                self._trip()
                return True
            if self._state == CLOSED and (
                self._consecutive_failures >= self.failure_threshold
                or self._health < self.health_floor
            ):
                self._trip()
                return True
            return False

    def _trip(self) -> None:  # repro: holds[_lock]
        self._state = OPEN
        self._opened_at = self._time()
        self._probes_inflight = 0
        self._trips += 1

    def force_open(self) -> None:
        """Administratively open (used by chaos drills / tests)."""
        with self._lock:
            if self._state != OPEN:
                self._trip()

    def reset(self) -> None:
        with self._lock:
            self._state = CLOSED
            self._consecutive_failures = 0
            self._health = 1.0
            self._probes_inflight = 0

    # -- introspection ---------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            self._maybe_half_open()
            return {
                "state": self._state,
                "health": round(self._health, 4),
                "consecutive_failures": self._consecutive_failures,
                "trips": self._trips,
                "successes": self._successes,
                "failures": self._failures,
                "open_skips": self._open_skips,
            }
