"""KV-cache slot manager for continuous batching (a copy of the reference's
``serving/kv_cache.py`` without ``num_live``, which nothing reads).

The engine runs a fixed-size decode batch of `max_batch` slots; the manager
tracks which slots are live, their sequence lengths, and hands out slots to
newly admitted requests. (The cache itself is the model-defined stacked
cache from models.transformer.init_cache; slots are contiguous per
sequence.)
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class SlotManager:
    def __init__(self, max_batch: int):
        self.max_batch = max_batch
        self.free: List[int] = list(range(max_batch))
        self.lengths = np.zeros((max_batch,), np.int32)
        self.live = np.zeros((max_batch,), bool)

    def alloc(self) -> Optional[int]:
        if not self.free:
            return None
        slot = self.free.pop(0)
        self.live[slot] = True
        self.lengths[slot] = 0
        return slot

    def release(self, slot: int) -> None:
        if self.live[slot]:
            self.live[slot] = False
            self.lengths[slot] = 0
            self.free.append(slot)
