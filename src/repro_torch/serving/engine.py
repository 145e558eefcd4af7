"""Continuous-batching serving engine (the port of the reference's
``serving/engine.py``).

A fixed decode batch of `max_batch` slots runs one ``decode_step`` per
tick; requests are admitted into free slots as they arrive (prefill writes
the slot's part of the stacked cache in place), finished sequences free
their slot immediately — the vLLM-style continuous batching loop, with the
semantic cache sitting in front via ModelBackend/EnhancedClient.

Every slot decodes every tick, live or not: a free slot carries token 0 at
position 0, as in the reference. Prefill runs at the prompt's exact length
and leaves the slot as a fresh cache would: a dense model's KV rows past
the prompt are cleared, an SSM's conv tail and state are overwritten (a
hybrid's nested cache, both). The engine serves text prompts; an audio
model's ``ModelBackend`` refuses them, as the reference's does.
"""
from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.client import LLMBackend, LLMResponse
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.kv_cache import SlotManager
from repro_torch.serving.sampler import sample_tokens


@dataclass
class Request:
    rid: int
    tokens: np.ndarray  # prompt token ids [S]
    max_new_tokens: int = 32
    temperature: float = 0.0
    out_tokens: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    # absolute time.perf_counter() stamp; the engine cancels the request
    # (freeing its decode slot) once this passes — even mid-generation
    deadline_t: Optional[float] = None
    expired: bool = False  # canceled by deadline; out_tokens hold the partial


def slot_view(cache, slot: int):
    """The slot's part of every leaf of the (possibly nested) stacked cache:
    views [n, 1, ...], so a prefill into them writes the cache in place."""
    return {k: slot_view(v, slot) if isinstance(v, dict) else v[:, slot:slot + 1]
            for k, v in cache.items()}


def _is_jax_tree(params) -> bool:
    """A parameter tree of numpy arrays (the reference's, carried over)
    rather than the port's tensors."""
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return not isinstance(leaf, torch.Tensor)


class ServingEngine:
    """``params`` is the port's parameter dict, the reference's tree as
    numpy arrays (carried over by ``transformer.params_from_jax``), or None
    for random weights from ``seed``. ``device=None`` means CUDA and raises
    without a card; pass ``device="cpu"`` for the plain versions."""

    def __init__(self, cfg, params=None, *, max_batch: int = 4, max_seq: int = 256,
                 eos_id: Optional[int] = None, seed: int = 0, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = T.init_params(cfg, seed, device=self.device)
        elif _is_jax_tree(params):
            params = T.params_from_jax(params, cfg, device=self.device)
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.slots = SlotManager(max_batch)
        self.cache = T.init_cache(cfg, max_batch, max_seq, device=self.device)
        # the submission queue is the engine's only cross-thread surface:
        # CacheService's miss dispatcher and sync callers may submit while
        # another thread drives run() (see `# guarded-by:` convention in
        # repro_torch.serving.service)
        self.pending: List[Request] = []  # guarded-by: _lock
        self._next_rid = 0  # guarded-by: _lock
        self._lock = threading.Lock()
        # decode state (active/slots/cache/_gen) is single-driver by design:
        # whoever calls run() owns it (ModelBackend serializes drivers)
        self.active: Dict[int, Request] = {}
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.metrics = {"prefill_tokens": 0, "decode_steps": 0, "requests": 0}

    # -- API --------------------------------------------------------------------

    def submit(self, tokens, max_new_tokens: int = 32, temperature: float = 0.0,
               deadline_t: Optional[float] = None) -> int:
        return self._submit_req(tokens, max_new_tokens, temperature, deadline_t).rid

    def _submit_req(self, tokens, max_new_tokens: int = 32, temperature: float = 0.0,
                    deadline_t: Optional[float] = None) -> Request:
        req = Request(0, np.asarray(tokens, np.int32), max_new_tokens, temperature,
                      submitted_at=time.perf_counter(), deadline_t=deadline_t)
        with self._lock:
            req.rid = self._next_rid
            self._next_rid += 1
            self.pending.append(req)
        self.metrics["requests"] += 1
        return req

    def _pop_pending(self) -> Optional[Request]:
        with self._lock:
            return self.pending.pop(0) if self.pending else None

    def _has_pending(self) -> bool:
        with self._lock:
            return bool(self.pending)

    def _expire(self, req: Request) -> None:
        req.done = True
        req.expired = True
        req.finished_at = time.perf_counter()
        self.metrics["deadline_cancels"] = self.metrics.get("deadline_cancels", 0) + 1

    def _admit(self) -> None:
        while self.slots.free:
            req = self._pop_pending()
            if req is None:
                return
            if req.deadline_t is not None and time.perf_counter() > req.deadline_t:
                self._expire(req)  # expired in queue: never claims a slot
                continue
            slot = self.slots.alloc()
            req.slot = slot
            S = len(req.tokens)
            # exact-length prefill straight into the slot (a view of the
            # stacked cache), which it leaves as a fresh cache would
            slot_cache = slot_view(self.cache, slot)
            tokens = torch.as_tensor(req.tokens[None], dtype=torch.int64, device=self.device)
            logits, _ = T.prefill(self.params, self.cfg, {"tokens": tokens}, slot_cache)
            # sample the first generated token directly from prefill logits
            tok = int(sample_tokens(logits, self._gen, temperature=req.temperature)[0])
            req.out_tokens.append(tok)
            req.first_token_at = time.perf_counter()
            self.slots.lengths[slot] = S  # tokens whose KV is in the cache
            self.metrics["prefill_tokens"] += S
            self.active[req.rid] = req

    def _tick_decode(self) -> None:
        # deadline cancellation: a request whose deadline passed mid-
        # generation stops decoding NOW and frees its slot for the next
        # pending request (capacity is returned to the continuous batch)
        now = time.perf_counter()
        expired = [
            r for r in self.active.values()
            if r.deadline_t is not None and now > r.deadline_t
        ]
        for req in expired:
            self._expire(req)
            self.slots.release(req.slot)
            del self.active[req.rid]
        if not self.active:
            return
        B = self.max_batch
        tokens = np.zeros((B, 1), np.int64)
        pos = np.zeros((B,), np.int64)
        for req in self.active.values():
            s = req.slot
            tokens[s, 0] = req.out_tokens[-1]  # newest generated token
            pos[s] = self.slots.lengths[s]  # position the new token occupies
        logits, _ = T.decode_step(self.params, self.cfg, torch.from_numpy(tokens).to(self.device),
                                  torch.from_numpy(pos).to(self.device), self.cache)
        self.metrics["decode_steps"] += 1
        any_temp = any(r.temperature > 0 for r in self.active.values())
        sampled = sample_tokens(logits, self._gen, temperature=1.0 if any_temp else 0.0)
        greedy = torch.argmax(logits, dim=-1)
        sampled, greedy = sampled.tolist(), greedy.tolist()
        finished = []
        for req in self.active.values():
            s = req.slot
            tok = int(sampled[s] if req.temperature > 0 else greedy[s])
            req.out_tokens.append(tok)
            self.slots.lengths[s] += 1
            if (
                len(req.out_tokens) >= req.max_new_tokens
                or (self.eos_id is not None and tok == self.eos_id)
                or self.slots.lengths[s] >= self.max_seq - 1
            ):
                req.done = True
                req.finished_at = time.perf_counter()
                finished.append(req.rid)
        for rid in finished:
            self.slots.release(self.active[rid].slot)
            del self.active[rid]

    def run(self) -> None:
        """Drive until all submitted work completes (continuous batching)."""
        while self._has_pending() or self.active:
            self._admit()
            self._tick_decode()

    def generate_ex(self, prompts: List[np.ndarray], max_new_tokens: int = 32,
                    temperature: float = 0.0,
                    deadlines: Optional[List[Optional[float]]] = None) -> List[Request]:
        """Continuous-batching generation returning the Request records
        (tokens + expiry state). ``deadlines`` are absolute perf_counter
        stamps; a request that outlives its deadline mid-generation is
        canceled — its slot frees immediately for the next pending request
        and it comes back with ``expired=True`` and the partial tokens."""
        deadlines = deadlines if deadlines is not None else [None] * len(prompts)
        # hold the Request records directly — another thread's run() may admit
        # (and drop from `pending`) anything we enqueue before we snapshot
        reqs = [
            self._submit_req(p, max_new_tokens, temperature, deadline_t=d)
            for p, d in zip(prompts, deadlines)
        ]
        self.run()
        return reqs

    def generate(self, prompts: List[np.ndarray], max_new_tokens: int = 32,
                 temperature: float = 0.0) -> List[List[int]]:
        return [
            r.out_tokens
            for r in self.generate_ex(prompts, max_new_tokens, temperature)
        ]


class ModelBackend(LLMBackend):
    """Adapts a ServingEngine to the EnhancedClient LLMBackend interface.

    Prompts are hashed to token ids (offline-deterministic); outputs are
    rendered as token-id text — deterministic, cacheable content."""

    def __init__(self, name: str, engine: ServingEngine, max_prompt_tokens: int = 32):
        self.name = name
        # the engine's slot/cache state is not reentrant: the CacheService
        # dispatcher and any sync caller must serialize their batches
        self.engine = engine  # guarded-by: _lock
        self.max_prompt_tokens = max_prompt_tokens
        # immutable config captured up front so the lock-free tokenize/guard
        # paths never reach through the guarded engine reference
        self._vocab_size = engine.cfg.vocab_size
        self._modality = engine.cfg.modality
        self._lock = threading.Lock()

    def _tokenize(self, prompt: str) -> np.ndarray:
        words = prompt.split()[: self.max_prompt_tokens] or ["empty"]
        V = self._vocab_size
        ids = [
            int.from_bytes(hashlib.blake2b(w.encode(), digest_size=4).digest(), "little") % V
            for w in words
        ]
        # pad deterministically to a FIXED length (pads are real tokens at
        # the front of the prompt, not maskable right-padding)
        while len(ids) < self.max_prompt_tokens:
            ids.insert(0, 7)  # deterministic BOS-ish filler
        return np.asarray(ids, np.int32)

    def generate(self, prompt: str, max_tokens: int = 32, temperature: float = 0.0) -> LLMResponse:
        return self.generate_batch([prompt], max_tokens, temperature)[0]

    def generate_batch(
        self, prompts: List[str], max_tokens: int = 32, temperature: float = 0.0,
        deadlines: Optional[List[Optional[float]]] = None,
    ) -> List[LLMResponse]:
        """Serve the whole miss batch in ONE continuous-batching pass: all
        prompts are submitted up front, so the engine keeps its decode slots
        full instead of draining one request at a time. ``deadlines``
        (absolute perf_counter stamps) propagate into the engine: a request
        whose deadline passes mid-generation is canceled, frees its decode
        slot, and resolves with ``expired=True`` (the service maps it to a
        typed ``deadline_exceeded`` response)."""
        t0 = time.perf_counter()
        if self._modality == "audio":
            raise NotImplementedError("audio backends serve token streams, not text prompts")
        toks = [self._tokenize(p) for p in prompts]
        with self._lock:
            reqs = self.engine.generate_ex(
                toks, max_new_tokens=max_tokens, temperature=temperature,
                deadlines=deadlines,
            )
        latency = time.perf_counter() - t0
        return [
            LLMResponse(" ".join(f"t{t}" for t in r.out_tokens), self.name,
                        tokens_in=len(tk), tokens_out=len(r.out_tokens),
                        latency_s=latency, expired=r.expired)
            for tk, r in zip(toks, reqs)
        ]
