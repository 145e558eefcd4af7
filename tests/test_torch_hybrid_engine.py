"""The port's ``ServingEngine`` and ``ModelBackend`` over the hybrid
(zamba2-7b smoke config, float32, the reference's weights carried across)
against the reference's: the same token lists, ``metrics`` and final
nested cache through continuous batching with slot reuse, so a prefill
into a used slot leaves its Mamba2 states and its shared blocks' k/v rows
as a fresh cache would; the same texts through ``ModelBackend``. An audio
model's ``ModelBackend`` refuses text prompts with the reference's
``NotImplementedError``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as JT
from repro.serving.engine import ModelBackend as JBackend
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.serving.engine import ModelBackend as TBackend
from repro_torch.serving.engine import ServingEngine as TEngine

torch.set_num_threads(1)

LLM = "zamba2-7b"


@pytest.fixture(scope="module")
def f32():
    jc = dataclasses.replace(j_get_config(LLM, smoke=True), dtype="float32")
    tc = dataclasses.replace(get_config(LLM, smoke=True), dtype="float32")
    jp, _ = JT.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, jax.tree_util.tree_map(np.asarray, jp)


def _close_tree(t, j):
    assert set(t) == set(j)
    for k, v in t.items():
        if isinstance(v, dict):
            _close_tree(v, j[k])
        else:
            np.testing.assert_allclose(v.numpy(), np.asarray(j[k]), atol=1e-4, rtol=1e-4)


def test_engine_matches_reference_with_slot_reuse(f32):
    """Five prompts over two slots: every slot is prefilled at least twice,
    the second time over another request's Mamba2 state and k/v rows (the
    longer prompt first, so a shorter one must clear its rows)."""
    jc, tc, jp, pn = f32
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jc.vocab_size, n).astype(np.int32) for n in (1, 40, 2, 7, 11)]
    je = JEngine(jc, jp, max_batch=2, max_seq=64)
    te = TEngine(tc, pn, max_batch=2, max_seq=64, device="cpu")
    assert te.generate(prompts, max_new_tokens=6) == je.generate(prompts, max_new_tokens=6)
    assert te.metrics == je.metrics and te.metrics["decode_steps"] > 0
    assert sorted(te.slots.free) == [0, 1]
    assert set(te.cache) == {"mamba", "shared"}
    _close_tree(te.cache, je.cache)  # free slots decode token 0 every tick, in both


def test_model_backend_over_the_hybrid_engine_matches_reference(f32):
    jc, tc, jp, pn = f32
    jb = JBackend(LLM, JEngine(jc, jp, max_batch=2, max_seq=64))
    tb = TBackend(LLM, TEngine(tc, pn, max_batch=2, max_seq=64, device="cpu"))
    prompts = ["what does the shared block see", "", "how do the groups share weights"]
    got = tb.generate_batch(prompts, max_tokens=4)
    want = jb.generate_batch(prompts, max_tokens=4)
    assert [r.text for r in got] == [r.text for r in want]
    assert [r.tokens_out for r in got] == [r.tokens_out for r in want]


def test_audio_backend_refuses_text_prompts_as_the_reference_does():
    jc = j_get_config("musicgen-large", smoke=True)
    tc = get_config("musicgen-large", smoke=True)
    jb = JBackend("musicgen", JEngine(jc, JT.init_params(jc, jax.random.PRNGKey(1))[0],
                                      max_batch=1, max_seq=16))
    tb = TBackend("musicgen", TEngine(tc, max_batch=1, max_seq=16, device="cpu"))
    with pytest.raises(NotImplementedError) as want:
        jb.generate("a song", max_tokens=2)
    with pytest.raises(NotImplementedError) as got:
        tb.generate("a song", max_tokens=2)
    assert str(got.value) == str(want.value) == \
        "audio backends serve token streams, not text prompts"
    assert tb.engine.metrics["requests"] == 0  # refused before anything was queued
