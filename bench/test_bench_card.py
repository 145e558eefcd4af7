"""On the card: the reference encoder against the port's at full width
(contriever-msmarco, float32, TF32 off), on seeded weights. Skips without
a card; run on the card from the repository's root with
``python -m pytest -q -p no:cacheprovider -m cuda bench/test_bench_card.py``
(``bench/conftest.py`` imports no JAX)."""
import json
from pathlib import Path

import pytest

CONF = json.loads((Path(__file__).parent / "configs" / "c1m-mamba2-1.3b.json").read_text())


@pytest.mark.cuda
def test_full_width_encoder_matches_the_reference_on_the_card(cuda):
    import torch

    from harness import weights
    from harness.stack import port_encoder_config
    from reference import textenc
    from repro_torch.core import ContrieverEncoder

    enc = CONF["encoder"]
    w = weights.encoder(enc, 2 ** 31 + 5, cuda)
    port = ContrieverEncoder(port_encoder_config(enc), device=cuda)
    port.load_jax_params(weights.to_numpy(w))
    texts = [f"Could you tell me about topic number {i} in detail?" for i in range(64)]
    got = torch.as_tensor(port.embed_batch(texts))
    want = textenc.embed_texts(w, texts, vocab=enc["vocab_size"], max_len=enc["max_seq_len"],
                               heads=enc["num_heads"], eps=enc["norm_eps"]).cpu()
    assert (got - want).abs().max() < CONF["limits"]["hit_score_gap"]
