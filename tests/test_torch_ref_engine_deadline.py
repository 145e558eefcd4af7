"""The reference's ``tests/test_engine_deadline.py`` retargeted to the port: the same
cases and assertions against ``repro_torch``, on the CPU (``device=None``
read as ``"cpu"``, see ``_torch_cpu.py``). The reference's docstring:

Deadline propagation into the ServingEngine: a request whose deadline
passes mid-generation is canceled, frees its decode slot (capacity returns
to the continuous batch), and surfaces as a typed ``deadline_exceeded``
resolution through ModelBackend -> CacheService.
"""
import time

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.core import (
    DEADLINE_EXCEEDED,
    CacheRequest,
    EnhancedClient,
    GenerativeCache,
    MockLLM,
    NgramHashEmbedder,
)
from repro_torch.serving.engine import ModelBackend, ServingEngine
import torch  # noqa: E402
from _torch_cpu import cpu_by_default  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    cpu_by_default(monkeypatch)


@pytest.fixture(scope="module")
def engine():
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    return ServingEngine(cfg, max_batch=1, max_seq=96, device="cpu")


def test_expired_slot_frees_engine_capacity(engine):
    """max_batch=1: request A expires mid-generation, B is pending behind
    it. Canceling A must free the only slot so B decodes to completion."""
    engine.generate([np.arange(4)], max_new_tokens=2)  # warm the jits
    now = time.perf_counter()
    reqs = engine.generate_ex(
        [np.arange(5), np.arange(5) + 7],
        max_new_tokens=60,
        deadlines=[now + 1e-4, None],  # A: expires ~immediately; B: none
    )
    a, b = reqs
    assert a.expired and a.done
    assert len(a.out_tokens) < 60  # canceled mid-generation, partial decode
    assert not b.expired
    assert len(b.out_tokens) == 60  # B got the freed slot and ran to the end
    assert engine.metrics.get("deadline_cancels", 0) >= 1
    assert engine.slots.free  # the slot came back after the batch drained


def test_expired_in_queue_never_claims_a_slot(engine):
    before = engine.metrics["prefill_tokens"]
    reqs = engine.generate_ex(
        [np.arange(6)], max_new_tokens=8,
        deadlines=[time.perf_counter() - 1.0],  # already past at submit
    )
    assert reqs[0].expired and reqs[0].out_tokens == []
    assert engine.metrics["prefill_tokens"] == before  # no prefill happened


def test_model_backend_marks_expired_responses(engine):
    backend = ModelBackend("m", engine)
    now = time.perf_counter()
    resps = backend.generate_batch(
        ["first prompt", "second prompt"], max_tokens=64,
        deadlines=[None, now - 1.0],
    )
    assert not resps[0].expired and resps[0].text
    assert resps[1].expired


def test_deadline_probe_not_inherited_by_overriding_subclass():
    """A subclass overriding generate_batch WITHOUT the deadlines kwarg
    must be probed on its own method, not inherit the parent's cached
    answer (which would feed it an unexpected kwarg and break failover)."""
    from repro_torch.core.client import EnhancedClient, LLMResponse

    class Legacy(MockLLM):
        def generate_batch(self, prompts, max_tokens=256, temperature=0.0):
            return [LLMResponse(f"legacy:{p}", self.name) for p in prompts]

    modern, legacy = MockLLM("modern"), Legacy("legacy")
    assert EnhancedClient._accepts_deadlines(modern) is True
    assert EnhancedClient._accepts_deadlines(legacy) is False
    client = EnhancedClient(cache=GenerativeCache(NgramHashEmbedder()))
    client.register_backend(legacy)
    resps = client._generate_batch_with_failover(
        "legacy", ["p"], 16, 0.0, deadlines=[time.perf_counter() + 60]
    )
    assert resps[0].text == "legacy:p"  # called without the kwarg, no failover


def test_service_resolves_midgen_expiry_typed():
    """A deadline that survives the queue but dies mid-generation resolves
    with DEADLINE_EXCEEDED (no cache insert), via the deadline-aware
    backend path (MockLLM honors ``deadlines``)."""
    cache = GenerativeCache(NgramHashEmbedder(), threshold=0.85, t_single=0.45,
                            t_combined=1.0)
    client = EnhancedClient(cache=cache)
    client.register_backend(MockLLM("slow", latency_s=0.15))
    svc = client.service
    adds_before = cache.stats.adds
    fut = svc.submit(CacheRequest("a never cached prompt", deadline_s=0.05))
    resp = fut.result(timeout=10)
    assert resp.status == DEADLINE_EXCEEDED and resp.text is None
    assert cache.stats.adds == adds_before  # expired answers are not cached
    assert svc.stats.expired == 1 and svc.stats.generated == 0
    # a request with headroom still generates normally afterwards
    ok = svc.submit(CacheRequest("another prompt", deadline_s=30.0)).result(timeout=10)
    assert ok.status == "generated" and ok.text
    svc.close()
