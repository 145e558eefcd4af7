"""The benchmark's plain references against the port's CPU path at smoke
width, on the same seeded weights: the encoder and its tokenizer, the
served prompt's token ids, the SSD scan, and the SSM and hybrid models'
logits."""
import numpy as np
import pytest
import torch

from harness import smoke, weights
from reference import lm as ref_lm
from reference import textenc

TEXTS = ["What is kavoru telo?", "Please explain the history of sumiro fen.",
         "Could you tell me about belqua tisdra in detail?", "x"]


def _enc_conf():
    return dict(smoke.ENCODER, name="contriever-smoke", norm_eps=1e-12)


def test_encoder_and_tokenizer_match_the_port():
    from harness.stack import port_encoder_config
    from repro_torch.core import ContrieverEncoder
    from repro_torch.core.tokenizer import HashTokenizer

    conf = _enc_conf()
    w = weights.encoder(conf, 11, "cpu")
    enc = ContrieverEncoder(port_encoder_config(conf), device="cpu")
    enc.load_jax_params(weights.to_numpy(w))
    tok = HashTokenizer(conf["vocab_size"], conf["max_seq_len"])
    for t in TEXTS:
        assert textenc.token_ids(t, conf["vocab_size"], conf["max_seq_len"]) == tok.encode(t)
    got = enc.embed_batch(TEXTS)
    want = textenc.embed_texts(w, TEXTS, vocab=conf["vocab_size"], max_len=conf["max_seq_len"],
                               heads=conf["num_heads"], eps=conf["norm_eps"]).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)
    # the control's TF32 operands move the embedding measurably
    ctrl = textenc.embed_texts(w, TEXTS, vocab=conf["vocab_size"], max_len=conf["max_seq_len"],
                               heads=conf["num_heads"], eps=conf["norm_eps"],
                               rnd=textenc.tf32).numpy()
    assert np.abs(ctrl - want).max() > 1e-5


def test_prompt_ids_match_the_backend():
    from repro_torch.serving.engine import ModelBackend

    class _Cfg:
        vocab_size, modality = 512, "text"

    class _Engine:
        cfg = _Cfg()

    be = ModelBackend("m", _Engine(), max_prompt_tokens=16)
    for p in ["", "a b c", " ".join(f"w{i}" for i in range(40))]:
        assert ref_lm.prompt_ids(p, 512, 16) == be._tokenize(p).tolist()


def test_ssd_matches_the_port_scan():
    from repro_torch.kernels.ssd_scan import ssd_scan

    g = torch.Generator().manual_seed(3)
    B, S, H, G, P, N = 2, 70, 4, 2, 8, 16
    x = torch.randn(B, S, H, P, generator=g)
    Bm, Cm = torch.randn(B, S, G, N, generator=g), torch.randn(B, S, G, N, generator=g)
    dt = torch.rand(B, S, H, generator=g) * 0.1
    A = -torch.rand(H, generator=g) - 0.5
    D = torch.zeros(H)
    y, _ = ssd_scan(x, Bm, Cm, dt, A, D, chunk=32)
    torch.testing.assert_close(ref_lm.ssd(x, dt, A, Bm, Cm, chunk=16), y, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("family,port", [("ssm", "mamba2_1_3b"), ("hybrid", "zamba2_7b")])
def test_lm_logits_match_the_port(family, port):
    from harness.stack import port_lm_config
    from repro_torch.models import transformer as T

    arch = dict(smoke.SERVED[family], family=family, port_config=port, dtype="float32",
                d_conv=4, norm_eps=1e-5, smoke=True, num_shared_blocks=2, rope_theta=10000.0)
    cfg = port_lm_config(arch)
    params = weights.lm(arch, 5, "cpu")
    tokens = torch.randint(0, arch["vocab_size"], (2, 45), generator=torch.Generator().manual_seed(1))
    cache = T.init_cache(cfg, 2, 64, device="cpu")
    want, _ = T.prefill(params, cfg, {"tokens": tokens}, cache)
    got = ref_lm.logits_at(params, arch, tokens, [44])[:, 0]
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    # the fp8 control moves them
    ctrl = ref_lm.logits_at(params, arch, tokens, [44], cast=ref_lm.fp8_rounded)[:, 0]
    assert (ctrl - want).abs().max() > 1e-2
