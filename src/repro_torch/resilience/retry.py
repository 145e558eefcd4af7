"""Retry policy (exponential backoff + jitter) and a global retry budget.

``RetryPolicy`` is pure arithmetic — the caller supplies the RNG draw so
determinism stays in one place (the client seeds one ``random.Random`` and
draws under its state lock). ``RetryBudget`` is the classic token bucket
that caps *fleet-wide* retry amplification: every first attempt deposits a
fraction of a token, every retry spends a whole one, so under a correlated
outage retries self-limit to ``ratio`` of organic traffic instead of
multiplying the load on whatever is still standing.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass


@dataclass(frozen=True)
class RetryPolicy:
    """How one backend is retried before failover moves on.

    ``max_attempts`` counts the first try: 3 means 1 call + up to 2
    retries. Backoff grows ``base * multiplier**(attempt-1)`` capped at
    ``max_backoff_s``; ``jitter`` is the +/- fraction applied from a
    uniform draw, which decorrelates retry waves across callers.
    """

    max_attempts: int = 3
    base_backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5

    def backoff_s(self, attempt: int, draw: float = 0.5) -> float:
        """Sleep before retry number ``attempt`` (1-based). ``draw`` is a
        uniform [0,1) sample supplied by the caller's seeded RNG."""
        base = min(self.base_backoff_s * (self.multiplier ** max(0, attempt - 1)), self.max_backoff_s)
        span = self.jitter * base
        return max(0.0, base - span + 2.0 * span * draw)


class RetryBudget:
    """Token bucket bounding total retries relative to organic traffic.

    Each first attempt deposits ``ratio`` tokens (capped at ``capacity``);
    each retry spends 1.0. When the bucket is dry, retries are refused and
    failover moves to the next backend immediately — the standard defense
    against retry storms amplifying an outage.
    """

    def __init__(self, capacity: float = 10.0, ratio: float = 0.1):
        self.capacity = float(capacity)
        self.ratio = float(ratio)
        self._lock = threading.Lock()
        self._tokens = float(capacity)  # guarded-by: _lock
        self._spent = 0  # guarded-by: _lock
        self._refused = 0  # guarded-by: _lock

    def deposit(self, n: int = 1) -> None:
        """Credit ``n`` first attempts."""
        with self._lock:
            self._tokens = min(self.capacity, self._tokens + self.ratio * n)

    def try_spend(self) -> bool:
        """Reserve one retry. False = budget exhausted, do not retry."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self._spent += 1
                return True
            self._refused += 1
            return False

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "tokens": round(self._tokens, 3),
                "capacity": self.capacity,
                "spent": self._spent,
                "refused": self._refused,
            }
