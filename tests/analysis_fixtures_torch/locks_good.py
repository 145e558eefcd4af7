"""Good: every guarded access holds the lock (directly, via a condition
alias, or via a documented holds[] contract)."""
import threading


class Service:
    def __init__(self):
        self._lock = threading.Lock()
        self._capacity = threading.Condition(self._lock)
        self._inflight = 0  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock

    def submit(self):
        with self._capacity:  # condition built over _lock counts as holding it
            self._inflight += 1

    def close(self):
        with self._lock:
            self._closed = True

    def _drain(self):  # repro: holds[_lock]
        return self._inflight
