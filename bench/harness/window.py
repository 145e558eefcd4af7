"""The open loop: every request is submitted through ``CacheService.submit``
at its due time, whatever is still in flight, and timed from that due
time to its future resolving, so a stall also counts against the
requests it delays. One thread drives; it sleeps between arrivals.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

DRAIN_S = 60.0  # how long past the close a due request may still resolve


@dataclass
class Outcome:
    kind: str
    text: str
    due: float  # absolute perf_counter stamp
    submitted: float = 0.0
    done: Optional[float] = None
    response: object = None
    error: Optional[str] = None


@dataclass
class Window:
    t0: float
    seconds: float
    outcomes: List[Outcome] = field(default_factory=list)
    late_max_s: float = 0.0  # how far behind its schedule the driver ran at worst
    late_spells: List[tuple] = field(default_factory=list)  # (offset s, late s) past 50 ms

    def resolved_in_window(self) -> List[Outcome]:
        end = self.t0 + self.seconds
        return [o for o in self.outcomes if o.done is not None and o.error is None
                and self.t0 <= o.done <= end]


def drive(service, schedule, seconds: float, make_request: Callable,
          on_tick: Callable[[float], None] = lambda now: None) -> Window:
    """Offer ``schedule`` (``traffic.Request``s) to ``service`` from now
    on; ``on_tick(offset)`` runs between arrivals (the profiler's start and
    stop). Returns once every request resolved or ``DRAIN_S`` passed the
    close."""
    from repro_torch.serving.coalescer import AdmissionRejected

    win = Window(time.perf_counter() + 0.01, seconds)
    futs = []
    for req in schedule:
        o = Outcome(req.kind, req.text, win.t0 + req.due_s)
        win.outcomes.append(o)
        while True:
            now = time.perf_counter()
            on_tick(now - win.t0)
            if now >= o.due:
                break
            time.sleep(min(o.due - now, 0.002))
        o.submitted = time.perf_counter()
        late = o.submitted - o.due
        if late > 0.05 and (not win.late_spells
                            or o.due - win.t0 > win.late_spells[-1][0] + win.late_spells[-1][1]):
            win.late_spells.append((round(o.due - win.t0, 2), round(late, 3)))
        win.late_max_s = max(win.late_max_s, late)
        try:
            fut = service.submit(make_request(req))
        except AdmissionRejected as e:
            o.error = f"rejected: {e}"
            continue

        def done(f, o=o):
            t = time.perf_counter()
            try:
                o.response = f.result()
            except Exception as e:  # noqa: BLE001 — recorded as this request's failure
                o.error = repr(e)
            o.done = t

        fut.add_done_callback(done)
        futs.append((o, fut))
    while time.perf_counter() < win.t0 + seconds:
        on_tick(time.perf_counter() - win.t0)
        time.sleep(0.002)
    on_tick(seconds)
    deadline = win.t0 + seconds + DRAIN_S
    for o, f in futs:
        try:
            f.result(timeout=max(0.0, deadline - time.perf_counter()))
        except Exception:  # noqa: BLE001 — the callback recorded it; a timeout leaves done None
            pass
        # a waiter wakes before the done callbacks have run
        while f.done() and o.done is None and time.perf_counter() < deadline + 5.0:
            time.sleep(0.001)
    for o in win.outcomes:
        if o.done is None and o.error is None:
            o.error = "unresolved after the drain"
    return win
