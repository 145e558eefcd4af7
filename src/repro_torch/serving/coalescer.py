"""Priority-aware micro-batching scheduler (serving front door for the cache).

Concurrent callers submit items; a collector thread drains the bounded
priority heap into batches of up to ``max_batch``, waiting at most
``max_wait_ms`` after the first arrival so a lone request is never stalled
behind an empty batch. Each batch is handed to one ``handler`` call, which
amortizes the embed forward, the device search dispatch, and the backend
fan-out across every rider — the SCALM/MeanCache observation that
semantic-cache wins only materialize when lookup overhead is shared across
concurrent users.

This is also the ``CacheService`` scheduler, so batches are not FIFO:

  * items drain highest ``priority`` first (earliest deadline, then arrival
    order, break ties within a priority class);
  * items carrying a deadline that expired while queued are never handed to
    the handler — ``on_expired`` resolves their future (default: a typed
    ``DeadlineExceeded`` error);
  * admission is bounded: past ``max_queue`` pending items ``submit`` raises
    ``AdmissionRejected`` (a ``queue.Full`` subclass — typed fast-fail, not a
    surprise from a hidden queue);
  * ``submit`` after ``close`` raises ``ServiceClosed`` (a ``RuntimeError``
    subclass) instead of an opaque dead-worker error, and ``close`` drains
    the heap first so every accepted future resolves.

Futures-based: ``submit`` returns a ``concurrent.futures.Future`` resolved
with that item's element of the handler's returned list (or its exception).
With ``owns_futures=True`` the handler is called as ``handler(items,
futures)`` and resolves them itself — the ``CacheService`` mode, where hit
futures resolve mid-handler while misses are forwarded to another scheduler.
"""
from __future__ import annotations

import heapq
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence, Tuple


class ServiceClosed(RuntimeError):
    """``submit`` after ``close``: the scheduler no longer accepts work."""


class AdmissionRejected(queue.Full):
    """Typed load-shed: the queue bound / in-flight budget is exhausted."""


class DeadlineExceeded(TimeoutError):
    """The item's deadline passed while it waited in queue."""


@dataclass
class CoalescerStats:
    submitted: int = 0
    batches: int = 0
    batched_items: int = 0
    rejected: int = 0  # admission rejections (bounded queue)
    expired: int = 0  # deadline expiries resolved without a handler call
    batch_sizes: List[int] = field(default_factory=list)

    @property
    def avg_batch(self) -> float:
        return self.batched_items / self.batches if self.batches else 0.0


class BatchCoalescer:
    """Bounded priority-heap micro-batcher in front of a batch handler.

    Knobs:
      max_batch    — largest batch handed to the handler in one call
      max_wait_ms  — how long the collector holds an open batch for riders
      max_queue    — admission bound (0 = unbounded); ``submit`` raises
                     ``AdmissionRejected`` beyond it
      owns_futures — handler is called as ``handler(items, futures)`` and
                     resolves the futures itself (the CacheService mode)
      on_expired   — ``fn(item, future)`` for deadline-expired items; the
                     default resolves the future with ``DeadlineExceeded``
    """

    def __init__(
        self,
        handler: Callable[..., Optional[Sequence[Any]]],
        *,
        max_batch: int = 8,
        max_wait_ms: float = 2.0,
        max_queue: int = 1024,
        owns_futures: bool = False,
        on_expired: Optional[Callable[[Any, Future], None]] = None,
    ):
        assert max_batch >= 1
        self.handler = handler
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.max_queue = max_queue
        self.owns_futures = owns_futures
        self.on_expired = on_expired
        self.stats = CoalescerStats()
        # entries: (-priority, deadline_key, seq, item, future) — seq is unique,
        # so comparisons never reach the (unorderable) item
        self._heap: List[tuple] = []  # guarded-by: _cv
        self._seq = 0  # guarded-by: _cv
        self._cv = threading.Condition()
        self._closed = False  # guarded-by: _cv
        self._thread = threading.Thread(target=self._collect, daemon=True)
        self._thread.start()

    # -- client side -----------------------------------------------------------

    def submit(
        self,
        item: Any,
        *,
        priority: int = 0,
        deadline_s: Optional[float] = None,
        deadline_t: Optional[float] = None,
        future: Optional[Future] = None,
    ) -> "Future":
        """Enqueue one item; returns the future its result will resolve.

        ``deadline_s`` is relative to now, ``deadline_t`` an absolute
        ``time.perf_counter()`` stamp (the CacheService forwards a miss with
        the deadline its original submit established). ``future`` lets a
        caller thread an existing future through a second scheduler hop.
        """
        if deadline_t is None and deadline_s is not None:
            deadline_t = time.perf_counter() + deadline_s
        dl_key = deadline_t if deadline_t is not None else float("inf")
        with self._cv:
            if self._closed:
                raise ServiceClosed("coalescer is closed")
            if self.max_queue and len(self._heap) >= self.max_queue:
                self.stats.rejected += 1
                raise AdmissionRejected(f"coalescer queue full ({self.max_queue})")
            fut = future if future is not None else Future()
            heapq.heappush(self._heap, (-priority, dl_key, self._seq, item, fut))
            self._seq += 1
            self.stats.submitted += 1
            self._cv.notify()
            return fut

    def __call__(self, item: Any, **kwargs) -> Any:
        """Blocking convenience wrapper: submit and wait for the answer."""
        return self.submit(item, **kwargs).result()

    # -- collector -------------------------------------------------------------

    def _pop_batch(self) -> Tuple[List[tuple], List[tuple]]:
        """Block for the first item, then ride out max_wait_ms / max_batch.

        Returns (batch, expired): expired covers the WHOLE heap, not just the
        popped entries — a low-priority item starved by a sustained
        high-priority stream must still resolve typed at its deadline, not
        stall its caller until the queue drains."""
        with self._cv:
            while not self._heap:
                if self._closed:
                    return [], []
                self._cv.wait(timeout=0.05)
            deadline = time.perf_counter() + self.max_wait_s
            while len(self._heap) < self.max_batch and not self._closed:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            now = time.perf_counter()
            expired = [e for e in self._heap if e[1] <= now]
            if expired:
                self._heap = [e for e in self._heap if e[1] > now]
                heapq.heapify(self._heap)
            batch = [
                heapq.heappop(self._heap)
                for _ in range(min(self.max_batch, len(self._heap)))
            ]
            return batch, expired

    def _collect(self) -> None:
        while True:
            batch, expired = self._pop_batch()
            for _, dl_key, _, item, fut in expired:
                self.stats.expired += 1
                if self.on_expired is not None:
                    self.on_expired(item, fut)
                elif not fut.done():
                    fut.set_exception(
                        DeadlineExceeded(
                            f"deadline passed {time.perf_counter() - dl_key:.3f}s ago"
                        )
                    )
            if not batch:
                with self._cv:
                    if self._closed and not self._heap:
                        return
                continue
            items = [it for _, _, _, it, _ in batch]
            futs = [f for _, _, _, _, f in batch]
            self.stats.batches += 1
            self.stats.batched_items += len(batch)
            self.stats.batch_sizes.append(len(batch))
            try:
                if self.owns_futures:
                    self.handler(items, futs)
                else:
                    outs = self.handler(items)
                    if len(outs) != len(items):
                        raise RuntimeError(
                            f"handler returned {len(outs)} results for {len(items)} items"
                        )
                    for f, out in zip(futs, outs):
                        f.set_result(out)
            except Exception as e:  # noqa: BLE001 — propagate to every unresolved rider
                for f in futs:
                    if not f.done():
                        f.set_exception(e)

    # -- lifecycle ------------------------------------------------------------

    def close(self, timeout: Optional[float] = 10.0) -> None:
        """Stop admissions, drain the heap, and join the collector: every
        future accepted before close resolves (result, error, or expiry)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout)

    def __enter__(self) -> "BatchCoalescer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
