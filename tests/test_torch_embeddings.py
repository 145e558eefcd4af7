"""The port's tokenizer and embedders against the reference package: equal
token ids, equal n-gram vectors, and the Contriever smoke encoder with the
reference's weights carried over within atol 1e-5 (float32 sums taken in
another order)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import contriever as jcfg
from repro.core import embeddings as jemb
from repro.core.tokenizer import HashTokenizer as JTok
from repro.data.synthetic import squad_like_qa
from repro_torch.configs import contriever as tcfg
from repro_torch.core import embeddings as temb
from repro_torch.core.tokenizer import HashTokenizer as TTok

torch.set_num_threads(1)

TEXTS = [q for q, _, _ in squad_like_qa(6, 3, seed=1)] + [
    "", "Ünïcödé — punctuation!? and   spaces", "x" * 40, "a " * 300,
]


def _smoke_pair():
    jenc = jemb.ContrieverEncoder(jcfg.smoke(), seed=0)
    params = jax.tree_util.tree_map(np.asarray, jenc.params)
    tenc = temb.encoder_from_jax_params(params, tcfg.smoke(), device="cpu")
    return jenc, tenc


def test_tokenizer_ids_identical():
    for kw in ({}, {"vocab_size": 4096, "max_len": 128}):
        jt, tt = JTok(**kw), TTok(**kw)
        for t in TEXTS:
            assert jt.encode(t) == tt.encode(t)
            assert jt.ngrams(t) == tt.ngrams(t)
        ji, jm = jt.encode_batch(TEXTS)
        ti, tm = tt.encode_batch(TEXTS)
        np.testing.assert_array_equal(ji, ti)
        np.testing.assert_array_equal(jm, tm)


def test_ngram_vectors_identical():
    for dim in (64, 256):
        a = jemb.NgramHashEmbedder(dim).embed(TEXTS)
        b = temb.NgramHashEmbedder(dim).embed(TEXTS)
        np.testing.assert_array_equal(a, b)


def test_config_is_a_copy():
    assert tcfg.CONTRIEVER_MSMARCO.__dict__ == jcfg.CONTRIEVER_MSMARCO.__dict__
    assert tcfg.smoke().__dict__ == jcfg.smoke().__dict__


def test_contriever_smoke_with_carried_weights():
    jenc, tenc = _smoke_pair()
    texts = TEXTS[:12]
    a = jenc.embed(texts)
    b = tenc.embed(texts)
    assert b.shape == (len(texts), 64) and b.dtype == np.float32
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(b, axis=1), 1.0, atol=1e-5)
    # batch buckets: B from 1, L from 8, both powers of two
    np.testing.assert_allclose(tenc.embed(texts[:3]), b[:3], atol=1e-6)


def test_fused_forward_equals_embed_batch():
    _, tenc = _smoke_pair()
    texts = TEXTS[:5]
    prepare, forward = tenc.fused_forward()
    args, n, B = prepare(texts)
    assert (n, B) == (5, 8)
    out = forward(*(torch.as_tensor(a) for a in args))
    np.testing.assert_allclose(out[:n].numpy(), tenc.embed_batch(texts), atol=1e-6)
    hprep, hfwd = temb.NgramHashEmbedder(32).fused_forward()
    (v,), n, B = hprep(texts)
    assert (n, B) == (5, 8) and hfwd(v) is v


def test_random_init_is_seeded_and_on_the_given_device():
    a = temb.ContrieverEncoder(tcfg.smoke(), seed=3, device="cpu")
    b = temb.ContrieverEncoder(tcfg.smoke(), seed=3, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert all(p.device.type == "cpu" for p in a.parameters())
    with pytest.raises(ValueError):
        a.load_jax_params({"layers": []})
