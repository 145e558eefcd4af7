"""Good: guarded counter increments, f32 only for relative offsets."""
import torch

_TICK_COMPACT_AT = 2**31 - 2**20


class Bank:
    def __init__(self):
        self._tick = 1

    def _compact_ticks(self):
        self._tick = 1

    def next_tick(self):
        if self._tick >= _TICK_COMPACT_AT:
            self._compact_ticks()
        self._tick += 1
        return self._tick

    def rel_stamp(self, created_rel):
        return torch.tensor(created_rel, dtype=torch.float32)  # relative seconds: f32 is plenty
