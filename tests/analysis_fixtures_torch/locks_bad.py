"""Bad: guarded attribute touched without its lock (expect RA301 x1)."""
import threading


class Service:
    def __init__(self):
        self._lock = threading.Lock()
        self._inflight = 0  # guarded-by: _lock

    def submit(self):
        self._inflight += 1  # RA301: no lock held

    def release(self):
        with self._lock:
            self._inflight -= 1
