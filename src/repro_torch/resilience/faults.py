"""Seeded, schedule-driven fault injection for backends and tiers.

Chaos that can't be replayed can't be debugged: every wrapper here draws
from ONE seeded RNG owned by the ``FaultInjector`` and advances a
per-target call counter, so a fault schedule (``FaultSpec`` windows over
call indices) produces the *same* faults on the same call sequence — in a
unit test, in the traffic harness, and in CI.

Failure modes:

- ``error``: raise a typed ``InjectedFault`` immediately (connection-reset
  shaped).
- ``hang``: block until the batch's soonest deadline has passed (or
  ``hang_s`` when no deadline travels with the call), then raise — the
  shape of a TCP black hole.
- ``latency``: sleep ``latency_s`` before forwarding (slow but correct).
- ``flap``: alternate ``period`` calls down / ``period`` calls up — the
  mode that defeats consecutive-failure breakers and needs health scoring.
- ``slow_tokens``: forward, then stall proportionally to the tokens
  generated (decode-bound slowness rather than connect-bound).

``FaultyBackend`` deliberately does NOT import the client module (the
client imports this package; a module-level import back would cycle) — it
duck-types the ``LLMBackend`` surface (``name``, ``supports_deadlines``,
``generate``, ``generate_batch``) which is all the failover path touches.
"""
from __future__ import annotations

import inspect
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.resilience.errors import InjectedFault

KINDS = ("error", "hang", "latency", "flap", "slow_tokens")


@dataclass(frozen=True)
class FaultSpec:
    """One failure mode active over a window of call indices."""

    kind: str  # one of KINDS
    p: float = 1.0  # per-call probability inside the window
    start: int = 0  # first call index (inclusive)
    stop: Optional[int] = None  # first call index past the window; None = forever
    latency_s: float = 0.05  # latency / slow_tokens stall
    hang_s: float = 0.25  # hang duration when no deadline travels with the call
    period: int = 4  # flap: this many calls down, then this many up
    message: str = "injected fault"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected one of {KINDS}")

    def active(self, idx: int) -> bool:
        if idx < self.start or (self.stop is not None and idx >= self.stop):
            return False
        if self.kind == "flap":
            # phase 0 (down) first so a schedule starting at `start` faults
            return ((idx - self.start) // max(1, self.period)) % 2 == 0
        return True


class FaultInjector:
    """Owns the seed, the per-target call counters, and the schedules."""

    def __init__(self, seed: int = 0, sleep_fn=time.sleep, time_fn=time.perf_counter):
        self._rng = random.Random(seed)  # guarded-by: _lock
        self._sleep = sleep_fn
        self._time = time_fn
        self._lock = threading.Lock()
        self._schedules: Dict[str, Tuple[FaultSpec, ...]] = {}  # guarded-by: _lock
        self._calls: Dict[str, int] = {}  # guarded-by: _lock
        self._injected: Dict[str, int] = {}  # guarded-by: _lock

    def schedule(self, name: str, *specs: FaultSpec) -> None:
        """Attach ``specs`` to target ``name`` (replaces any prior schedule)."""
        with self._lock:
            self._schedules[name] = tuple(specs)
            self._calls.setdefault(name, 0)

    def plan(self, name: str) -> Tuple[int, Optional[FaultSpec]]:
        """Advance ``name``'s call counter and pick the fault (if any) for
        this call — first active spec whose probability draw fires."""
        with self._lock:
            idx = self._calls.get(name, 0)
            self._calls[name] = idx + 1
            for spec in self._schedules.get(name, ()):
                if not spec.active(idx):
                    continue
                if spec.p >= 1.0 or self._rng.random() < spec.p:
                    key = f"{name}:{spec.kind}"
                    self._injected[key] = self._injected.get(key, 0) + 1
                    return idx, spec
            return idx, None

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "calls": dict(self._calls),
                "injected": dict(self._injected),
                "total_injected": sum(self._injected.values()),
            }

    # -- wrappers -----------------------------------------------------------

    def wrap_backend(self, backend) -> "FaultyBackend":
        return FaultyBackend(backend, self)

    def wrap_tier(self, tier, name: str = "tier1") -> "FaultyTier":
        return FaultyTier(tier, self, name)


def _inner_accepts_deadlines(backend) -> bool:
    declared = getattr(backend, "supports_deadlines", None)
    if declared is not None:
        return bool(declared)
    try:
        return "deadlines" in inspect.signature(type(backend).generate_batch).parameters
    except (AttributeError, TypeError, ValueError):
        return False


class FaultyBackend:
    """Chaos wrapper around an ``LLMBackend`` (duck-typed, see module doc)."""

    def __init__(self, inner, injector: FaultInjector):
        self.inner = inner
        self.injector = injector
        self.name = inner.name
        # declare explicitly so the client's tri-state probe never inspects
        # THIS signature and mistakes the wrapper for the wrapped
        self.supports_deadlines = _inner_accepts_deadlines(inner)

    def generate(self, prompt: str, max_tokens: int = 256, temperature: float = 0.0):
        return self.generate_batch([prompt], max_tokens, temperature)[0]

    def generate_batch(
        self,
        prompts: Sequence[str],
        max_tokens: int = 256,
        temperature: float = 0.0,
        deadlines: Optional[Sequence[Optional[float]]] = None,
    ):
        _, spec = self.injector.plan(self.name)
        if spec is not None:
            if spec.kind in ("error", "flap"):
                raise InjectedFault(f"{self.name}: {spec.message}", spec.kind, self.name)
            if spec.kind == "hang":
                self._hang(deadlines, spec)
                raise InjectedFault(f"{self.name}: hang past deadline", "hang", self.name)
            if spec.kind == "latency":
                self.injector._sleep(spec.latency_s)
        out = self._forward(prompts, max_tokens, temperature, deadlines)
        if spec is not None and spec.kind == "slow_tokens" and out:
            stall = min(spec.hang_s, spec.latency_s * max(r.tokens_out for r in out))
            if stall > 0:
                self.injector._sleep(stall)
                for r in out:
                    r.latency_s += stall
        return out

    def _hang(self, deadlines, spec: FaultSpec) -> None:
        """Block like a black-holed connection: until the soonest deadline in
        the batch has passed (plus a hair), or ``hang_s`` with no deadline."""
        stamps = [d for d in (deadlines or []) if d is not None]
        if stamps:
            self.injector._sleep(max(0.0, min(stamps) - self.injector._time()) + 0.002)
        else:
            self.injector._sleep(spec.hang_s)

    def _forward(self, prompts, max_tokens, temperature, deadlines):
        if deadlines is not None and _inner_accepts_deadlines(self.inner):
            return self.inner.generate_batch(prompts, max_tokens, temperature, deadlines=deadlines)
        return self.inner.generate_batch(prompts, max_tokens, temperature)


class FaultyTier:
    """Chaos proxy for a host tier (``HostRamTier``-shaped): ``search`` /
    ``put`` / ``pop`` consult the schedule; everything else forwards."""

    _INTERCEPTED = ("search", "put", "pop")

    def __init__(self, inner, injector: FaultInjector, name: str = "tier1"):
        # bypass __setattr__-style surprises by writing through __dict__ is
        # unnecessary here; plain attributes are fine for a proxy
        self.inner = inner
        self.injector = injector
        self.fault_name = name

    def _gate(self, op: str):
        _, spec = self.injector.plan(self.fault_name)
        if spec is None:
            return
        if spec.kind in ("error", "flap", "hang"):
            raise InjectedFault(f"{self.fault_name}.{op}: {spec.message}", spec.kind, self.fault_name)
        if spec.kind in ("latency", "slow_tokens"):
            self.injector._sleep(spec.latency_s)

    def search(self, *args, **kwargs):
        self._gate("search")
        return self.inner.search(*args, **kwargs)

    def put(self, *args, **kwargs):
        self._gate("put")
        return self.inner.put(*args, **kwargs)

    def pop(self, *args, **kwargs):
        self._gate("pop")
        return self.inner.pop(*args, **kwargs)

    def __getattr__(self, item):
        return getattr(self.inner, item)

    def __len__(self):
        return len(self.inner)
