"""Deterministic, checkpointable, shardable data loader (a copy of the
reference's ``data/loader.py``: for a seed its batches are the reference's,
byte for byte).

Determinism is positional: batch ``i`` is a pure function of (seed, i), so
a restore at step k replays exactly the stream a fresh run would have
produced — the property that makes checkpoint/restart reproducible and lets
a replacement host take over without coordination. Batches are numpy int32
[global_batch / num_shards, seq_len]; the train step moves them to the
card.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.data.synthetic import _bigram_logits


class ShardedLoader:
    def __init__(
        self,
        vocab: int,
        global_batch: int,
        seq_len: int,
        *,
        seed: int = 0,
        start_step: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        assert global_batch % num_shards == 0
        self.vocab = vocab
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed
        self.step = start_step
        self.num_shards = num_shards
        self.shard_index = shard_index
        self._succ = _bigram_logits(vocab, seed)

    def _batch_at(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        B, S = self.global_batch, self.seq_len
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=B)
        choices = rng.integers(0, self._succ.shape[1], size=(B, S))
        noise = rng.random((B, S)) < 0.05
        rand_toks = rng.integers(0, self.vocab, size=(B, S))
        for t in range(1, S):
            nxt = self._succ[toks[:, t - 1], choices[:, t]]
            toks[:, t] = np.where(noise[:, t], rand_toks[:, t], nxt)
        shard = B // self.num_shards
        return toks[self.shard_index * shard : (self.shard_index + 1) * shard]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = {"tokens": self._batch_at(self.step)}
        self.step += 1
        return batch

    # -- checkpointing ---------------------------------------------------------

    def state(self) -> Dict:
        return {"seed": self.seed, "step": self.step}

    def restore(self, state: Dict) -> None:
        assert state["seed"] == self.seed, "loader seed mismatch"
        self.step = int(state["step"])
