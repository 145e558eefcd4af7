"""The port's ServingEngine and ModelBackend against the reference's: the
qwen1.5-0.5b smoke config in float32, the reference's random weights carried
across, greedy decoding. Token lists and ``metrics`` are identical through
continuous batching with slot reuse (5 prompts over 2 slots), deadline
cancellation frees slots as in ``tests/test_engine_deadline.py``, and a
``CacheService`` replay with ``ModelBackend`` answering the misses gives the
same statuses and texts in both packages. Temperature sampling draws from
a ``torch.Generator``, not ``jax.random``: it is checked for determinism
per seed and range only."""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.configs import get_config as j_get_config
from repro.data.synthetic import squad_like_qa
from repro.models import transformer as JT
from repro.serving.engine import ModelBackend as JBackend
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.service import CacheService as JService
from repro_torch.configs import get_config
from repro_torch.serving.engine import ModelBackend as TBackend
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.sampler import sample_tokens
from repro_torch.serving.service import CacheService as TService

torch.set_num_threads(1)

LLM = "qwen1.5-0.5b"


@pytest.fixture(scope="module")
def setup():
    jc = dataclasses.replace(j_get_config(LLM, smoke=True), dtype="float32")
    tc = dataclasses.replace(get_config(LLM, smoke=True), dtype="float32")
    jp, _ = JT.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, jax.tree_util.tree_map(np.asarray, jp)


def test_continuous_batching_matches_reference(setup):
    jc, tc, jp, pn = setup
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jc.vocab_size, n).astype(np.int32) for n in (3, 17, 8, 11, 5)]
    je = JEngine(jc, jp, max_batch=2, max_seq=64)
    te = TEngine(tc, pn, max_batch=2, max_seq=64, device="cpu")
    assert te.generate(prompts, max_new_tokens=6) == je.generate(prompts, max_new_tokens=6)
    assert te.metrics == je.metrics
    assert te.metrics["decode_steps"] > 0 and sorted(te.slots.free) == [0, 1]
    # the slot caches end in the same state (free slots decode token 0 at row 0)
    np.testing.assert_allclose(te.cache["k"].numpy(), np.asarray(je.cache["k"]), atol=1e-4)


def test_generation_stops_at_max_seq(setup):
    jc, tc, jp, pn = setup
    prompt = [np.arange(10, dtype=np.int32)]
    je = JEngine(jc, jp, max_batch=1, max_seq=16)
    te = TEngine(tc, pn, max_batch=1, max_seq=16, device="cpu")
    assert te.generate(prompt, max_new_tokens=50) == je.generate(prompt, max_new_tokens=50)
    assert len(te.generate(prompt, max_new_tokens=50)[0]) == 16 - 1 - 10 + 1


@pytest.fixture
def engine(setup):
    _, tc, _, pn = setup
    return TEngine(tc, pn, max_batch=1, max_seq=96, device="cpu")


def test_expired_slot_frees_engine_capacity(engine):
    """max_batch=1: request A expires mid-generation, B is pending behind
    it. Canceling A must free the only slot so B decodes to completion."""
    engine.generate([np.arange(4)], max_new_tokens=2)
    now = time.perf_counter()
    a, b = engine.generate_ex([np.arange(5), np.arange(5) + 7], max_new_tokens=60,
                              deadlines=[now + 1e-4, None])
    assert a.expired and a.done and len(a.out_tokens) < 60
    assert not b.expired and len(b.out_tokens) == 60
    assert engine.metrics.get("deadline_cancels", 0) >= 1
    assert engine.slots.free


def test_expired_in_queue_never_claims_a_slot(engine):
    before = engine.metrics["prefill_tokens"]
    reqs = engine.generate_ex([np.arange(6)], max_new_tokens=8,
                              deadlines=[time.perf_counter() - 1.0])
    assert reqs[0].expired and reqs[0].out_tokens == []
    assert engine.metrics["prefill_tokens"] == before


def test_model_backend_tokenizes_like_reference_and_marks_expiry(setup, engine):
    jc, _, jp, _ = setup
    jb, tb = JBackend("m", JEngine(jc, jp, max_batch=1, max_seq=96)), TBackend("m", engine)
    for prompt in ("what is the capital of france", "", " ".join(["w"] * 40)):
        np.testing.assert_array_equal(tb._tokenize(prompt), jb._tokenize(prompt))
    resps = tb.generate_batch(["first prompt", "second prompt"], max_tokens=5,
                              deadlines=[None, time.perf_counter() - 1.0])
    assert resps[0].text == jb.generate_batch(["first prompt"], max_tokens=5)[0].text
    assert not resps[0].expired and resps[1].expired


def test_temperature_sampling_is_seeded_and_in_range():
    logits = torch.randn(6, 50, generator=torch.Generator().manual_seed(0))
    draws = [sample_tokens(logits, torch.Generator().manual_seed(s), temperature=0.8, top_k=5)
             for s in (3, 3, 4)]
    assert torch.equal(draws[0], draws[1])
    top5 = torch.topk(logits, 5, dim=-1).indices
    assert all((top5 == d[:, None]).any(-1).all() for d in draws)
    assert draws[0].dtype == torch.int32


def test_engine_samples_reproducibly_per_seed(setup):
    _, tc, _, pn = setup
    prompts = [np.arange(6), np.arange(9) + 3]
    outs = [TEngine(tc, pn, max_batch=2, max_seq=32, seed=s, device="cpu")
            .generate(prompts, max_new_tokens=5, temperature=1.0) for s in (5, 5)]
    assert outs[0] == outs[1]
    assert all(0 <= t < tc.vocab_size for o in outs[0] for t in o)


def test_engine_needs_a_card_unless_asked_for_the_cpu(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    _, tc, _, pn = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine(tc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine(tc, pn)


def _replay(P, Service, backend, data, **kw):
    emb = P.NgramHashEmbedder()

    def level(cap):
        return P.GenerativeCache(emb, threshold=0.85, t_single=0.45, t_combined=1.0,
                                 capacity=cap, use_pallas=True, **kw)

    l1, l2 = level(16), level(64)
    h = P.HierarchicalCache(l1, l2)
    client = P.EnhancedClient(cache=l1, hierarchy=h)
    client.register_backend(backend)
    service = Service(client, max_batch=8)
    h.l2.insert_batch([q for q, _, _ in data[::3]], [a for _, a, _ in data[::3]])
    prompts = [q for q, _, _ in data]
    out = []
    for b in range(0, len(prompts), 8):
        out.extend(service.complete([P.CacheRequest(p, max_tokens=4) for p in prompts[b:b + 8]]))
    service.close()
    return out


def test_service_replay_with_model_backend_matches_reference(setup):
    jc, tc, jp, pn = setup
    data = squad_like_qa(6, 3, seed=4, with_aspects=True)
    rj = _replay(J, JService, JBackend(LLM, JEngine(jc, jp, max_batch=4, max_seq=64)), data)
    rt = _replay(T, TService, TBackend(LLM, TEngine(tc, pn, max_batch=4, max_seq=64,
                                                    device="cpu")), data, device="cpu")
    assert [(r.status, r.text, r.from_cache) for r in rt] == \
        [(r.status, r.text, r.from_cache) for r in rj]
    generated = [r for r in rt if r.status == "generated"]
    assert generated and all(r.text.startswith("t") for r in generated)
    assert any(r.from_cache for r in rt)
