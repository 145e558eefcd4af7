"""The port's ``ServingEngine`` and ``ModelBackend`` over the MoE models
(llama4-scout-17b-a16e and deepseek-v3-671b smoke configs, float32, the
reference's weights carried across) against the reference's: the same
token lists, ``metrics`` and final cache (GQA k/v, or MLA's latent
{"ckv", "kr"}) through continuous batching with slot reuse, at the
configs' own capacity factors, where a long prompt's prefill drops expert
assignments. Every slot decodes every tick, an idle one too (token 0 at
position 0): its rows route through the experts and take capacity, so the
tokens match only if the port feeds the same rows. The same texts come
back through ``ModelBackend``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as JT
from repro.serving.engine import ModelBackend as JBackend
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import ModelBackend as TBackend
from repro_torch.serving.engine import ServingEngine as TEngine

torch.set_num_threads(1)

ARCHS = ("llama4-scout-17b-a16e", "deepseek-v3-671b")
LENGTHS = (40, 1, 7, 2, 11)  # the longest first, so shorter prompts reuse its slot


@pytest.fixture(scope="module", params=ARCHS)
def f32(request):
    arch = request.param
    jc = dataclasses.replace(j_get_config(arch, smoke=True), dtype="float32")
    tc = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    jp, _ = JT.init_params(jc, jax.random.PRNGKey(3))
    return arch, jc, tc, jp, jax.tree_util.tree_map(np.asarray, jp)


def _prompts(jc):
    rng = np.random.default_rng(11)
    return [rng.integers(0, jc.vocab_size, n).astype(np.int32) for n in LENGTHS]


def test_engine_matches_reference_with_drops_and_idle_slots(f32):
    """Five prompts over two slots with 6 new tokens each: slots are
    reused, and the last request decodes beside an idle slot."""
    arch, jc, tc, jp, pn = f32
    prompts = _prompts(jc)
    # the 40-token prompt's prefill overflows an expert at the config's capacity
    _, jm = JT.forward(jp, jc, {"tokens": jnp.asarray(prompts[0][None])})[2:]
    tp = TT.params_from_jax(pn, tc, device="cpu")
    _, tm = TT.forward(tp, tc, {"tokens": torch.from_numpy(prompts[0][None])})
    assert np.float32(tm["moe_drop_fraction"]) == np.float32(jm["moe_drop_fraction"]) > 0
    je = JEngine(jc, jp, max_batch=2, max_seq=64)
    te = TEngine(tc, pn, max_batch=2, max_seq=64, device="cpu")
    assert te.generate(prompts, max_new_tokens=6) == je.generate(prompts, max_new_tokens=6)
    assert te.metrics == je.metrics and te.metrics["decode_steps"] > 0
    assert sorted(te.slots.free) == [0, 1]
    assert set(te.cache) == ({"ckv", "kr"} if jc.mla is not None else {"k", "v"})
    for k, v in te.cache.items():  # idle slots decode token 0 at row 0, in both
        np.testing.assert_allclose(v.numpy(), np.asarray(je.cache[k]), atol=1e-4, rtol=1e-4)


def test_model_backend_over_the_moe_engine_matches_reference(f32):
    arch, jc, tc, jp, pn = f32
    jb = JBackend(arch, JEngine(jc, jp, max_batch=2, max_seq=64))
    tb = TBackend(arch, TEngine(tc, pn, max_batch=2, max_seq=64, device="cpu"))
    prompts = ["which expert answers this", "", "how many experts share a token"]
    got = tb.generate_batch(prompts, max_tokens=4)
    want = jb.generate_batch(prompts, max_tokens=4)
    assert [r.text for r in got] == [r.text for r in want]
    assert [r.tokens_out for r in got] == [r.tokens_out for r in want]
