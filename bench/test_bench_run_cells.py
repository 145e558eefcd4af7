"""Each cell driven end to end on the CPU at smoke size, past the look for
a card: its run comes out correct, and a run with its control (the
reference in the next lower precision) in the program's place comes out
not correct, judged by the same comparison."""
import pytest
import torch

from harness import cell, smoke

CELLS = ["cached_replay.c1m-mamba2-1.3b", "rag_mixed.c1m-zamba2-7b"]
SEED = 2 ** 31 + 77


def run_smoke(name, seed=SEED, seconds=3.0, trace=False, **kw):
    torch.set_num_threads(2)
    spec = smoke.shrink(cell.load(name))
    return spec, cell.run(spec, seed, seconds, trace=trace, device="cpu", **kw)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_its_control_is_not(name):
    spec, r = run_smoke(name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 10
    assert set(r["metrics"]) == {m["name"] for m in spec.end_to_end}
    if "rag" in name:
        assert r["extra"]["misses"] > 0 and r["checks"]["backfill_wrong"]["value"] == 0
    _, c = run_smoke(name, control=True)
    assert not c["correct"], c["checks"]
    over = {k for k, v in c["checks"].items() if v["value"] > v["limit"]}
    assert "hit_score_gap" in over
    if "rag" in name:
        assert "miss_token_gap" in over


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_traces_again_when_the_kernels_records_are_lost(monkeypatch, name):
    calls = []

    def lost(tr, sub):
        calls.append(sub)
        return True

    monkeypatch.setattr(cell, "_trace_lost", lost)
    spec, r = run_smoke(name, trace=True)
    assert r["correct"], r["checks"]
    assert len(calls) == 1 and r["extra"]["retraced"] == 1
    assert {m["name"] for m in spec.per_layer if m["source"] != "device_trace"} <= set(r["metrics"])
    assert r["device"]["window_s"] > 0
