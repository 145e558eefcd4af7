"""Bad: unguarded int32 counter + f32 narrowing of absolute timestamps
(expect RA501 x1, RA502 x2)."""
import time

import torch

_TICK_COMPACT_AT = 2**31 - 2**20


class Bank:
    def __init__(self):
        self._tick = 1

    def compact_ticks(self):
        self._tick = 1

    def next_tick(self):
        self._tick += 1  # RA501: no rebase guard in this function
        return self._tick

    def stamp(self):
        return torch.tensor(time.time(), dtype=torch.float32)  # RA502: absolute epoch in f32

    def narrow(self, created_at):
        return created_at.to(torch.float32)  # RA502: *_at stamp narrowed
