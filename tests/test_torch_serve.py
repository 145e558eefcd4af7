"""The port's serving entry point (``repro_torch.launch.serve.main``, on the
CPU) against the reference's ``repro.launch.serve.main`` at its smoke
defaults: one request at a time, through ``CacheService`` (``--coalesce``)
and with a key-sharded L2 (``--shards 2``). The per-request HIT/MISS
sequence, the client's ``requests= hits= llm_calls=`` counts, the
engine's metrics and the ``service:`` line's counts are equal.

``--coalesce`` runs with a 1 s batching window in both, so the eight
concurrent submissions always form one lookup batch (``--coalesce-batch``
8) and no count depends on thread timing. ``--shards 2`` gives the port
two mesh positions on the CPU; the reference's CPU mesh has its one
device.
"""
import re

import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.launch import serve as tserve

torch.set_num_threads(1)

TAG = re.compile(r"^\[\s*\d+\] (\w+)", re.M)
CLIENT = re.compile(r"^requests=(\d+) hits=(\d+) hit_rate=\S+ llm_calls=(\d+) cost=(\S+)", re.M)
ENGINE = re.compile(r"^engine: (.*)$", re.M)
SERVICE = re.compile(r"^service: hits=(\d+) generated=(\d+) deduped=(\d+) expired=(\d+) "
                     r"rejected=(\d+) lookup_avg_batch=(\S+) dispatch_avg_batch=(\S+)$", re.M)


def _run(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    out = capsys.readouterr().out
    return (TAG.findall(out), CLIENT.findall(out), ENGINE.findall(out), SERVICE.findall(out)), out


@pytest.mark.parametrize("mode", [[], ["--coalesce", "--max-wait-ms", "1000"], ["--shards", "2"]],
                         ids=["sync", "coalesce", "shards"])
def test_serve_matches_reference(mode, capsys):
    argv = ["--requests", "8", *mode]
    (ttags, tclient, tengine, tservice), tout = _run(tserve.main, argv + ["--device", "cpu"], capsys)
    (jtags, jclient, jengine, jservice), _ = _run(jserve.main, argv, capsys)
    assert len(ttags) == 8 and set(ttags) <= {"HIT", "MISS"}
    assert ttags == jtags
    assert tclient == jclient and len(tclient) == 1
    assert tengine == jengine
    assert tservice == jservice and len(tservice) == (1 if "--coalesce" in mode else 0)
    if "--shards" in mode:
        assert "mesh: 2 positions on ['cpu']" in tout


def test_serve_without_a_card_raises_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--requests", "1"])
