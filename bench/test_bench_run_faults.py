"""A run with the timed path broken underneath comes out not correct:
each fault a serving cell can have, planted in the port at smoke size on
the CPU (the one-card cells have no exchange between chips to leave out)."""
import pytest
import torch

from test_bench_run_cells import run_smoke


def _altered_tokens(monkeypatch):
    from repro_torch.models import transformer as T

    real = T.decode_step

    def step(params, cfg, tokens, pos, cache):
        logits, cache = real(params, cfg, tokens, pos, cache)
        nxt = (logits.argmax(-1) + 1) % logits.shape[-1]
        return logits.scatter_add(-1, nxt[:, None], torch.full_like(logits[:, :1], 1e3)), cache

    monkeypatch.setattr(T, "decode_step", step)


def _state_unchanged(monkeypatch):
    from repro_torch.models import transformer as T

    real = T.decode_step

    def step(params, cfg, tokens, pos, cache):
        saved = {k: {kk: vv.clone() for kk, vv in v.items()} for k, v in cache.items()}
        out = real(params, cfg, tokens, pos, cache)
        for k, v in saved.items():
            for kk, vv in v.items():
                cache[k][kk].copy_(vv)
        return out

    monkeypatch.setattr(T, "decode_step", step)


def _half_the_batch(monkeypatch):
    from repro_torch.core import read_path

    real = read_path.fused_read

    def read(bank, embedder, texts, thresholds, specs, vecs=None):
        dec = real(bank, embedder, texts, thresholds, specs, vecs=vecs)
        half = len(texts) // 2
        dec.winner[half:] = dec.hit.shape[1]
        dec.hit[half:] = False
        dec.generative[half:] = False
        return dec

    monkeypatch.setattr(read_path, "fused_read", read)


def _half_the_batch_raises(monkeypatch):
    # armed once set-up is done, so that it breaks the window alone
    from harness import cell
    from repro_torch.serving.service import CacheService

    real_run, real_warm = CacheService._run_lookup, cell._warm_up
    armed = []

    def run_lookup(self, pendings, futs):
        if armed:
            for f in futs[len(futs) // 2:]:
                f.set_exception(RuntimeError("planted: the read left this request out"))
        real_run(self, pendings, futs)

    def warm_up(*a, **k):
        real_warm(*a, **k)
        armed.append(True)

    monkeypatch.setattr(CacheService, "_run_lookup", run_lookup)
    monkeypatch.setattr(cell, "_warm_up", warm_up)


def _altered_answer(monkeypatch):
    from repro_torch.core import synthesis

    real = synthesis.combine
    monkeypatch.setattr(synthesis, "combine", lambda *a, **k: real(*a, **k) + " (altered)")


@pytest.mark.parametrize("name,fault", [
    ("cached_replay.c1m-mamba2-1.3b", _half_the_batch),
    ("cached_replay.c1m-mamba2-1.3b", _half_the_batch_raises),
    ("cached_replay.c1m-mamba2-1.3b", _altered_answer),
    ("rag_mixed.c1m-zamba2-7b", _altered_tokens),
    ("rag_mixed.c1m-zamba2-7b", _state_unchanged),
])
def test_a_broken_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    _, r = run_smoke(name, seed=12345)
    assert not r["correct"], r["checks"]
