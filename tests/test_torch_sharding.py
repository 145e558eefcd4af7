"""The port's sharding rules and device meshes: ``resolve_spec`` against the
reference's, case for case (a duck-typed mesh with ``axis_names`` and
``shape`` serves both, as tests/test_sharding.py uses), ``is_spec_leaf``,
``mesh_num_devices``, and the single-controller ``Mesh`` that
``make_test_mesh`` / ``make_cache_mesh`` build (positions may repeat a
device; no card means an error unless a device is given)."""
from collections import namedtuple

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.distributed import sharding as J
from repro_torch.distributed import sharding as T
from repro_torch.launch.mesh import Mesh, make_cache_mesh, make_test_mesh

torch.set_num_threads(1)


class FakeMesh:
    def __init__(self, shape):
        self._shape = shape

    @property
    def axis_names(self):
        return tuple(self._shape)

    @property
    def shape(self):
        return self._shape


MESHES = {
    "data4-model2": {"data": 4, "model": 2},
    "data4-model16": {"data": 4, "model": 16},
    "pod2-data16-model16": {"pod": 2, "data": 16, "model": 16},
    "data1": {"data": 1},
    "none": {},
}

CASES = [
    ((("pod", "data"), "model"), None),
    ((None, "model"), (8, 4)),
    ((None, "model"), (8, 32)),
    (((("pod", "data")), None), (4, 8)),
    ((("pod", "data"), None), (64, 8)),
    (("data", ("model", "data")), (8, 16)),
    ((("model", "data"), "model"), (32, 16)),
    (("data", "data"), (8, 8)),
    ((None, None, "model"), (2, 3, 48)),
    ((("data", "model"), ("pod", "model")), None),
    ((), ()),
]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("case", range(len(CASES)))
def test_resolve_spec_matches_reference(mesh_name, case):
    mesh = FakeMesh(MESHES[mesh_name])
    spec, shape = CASES[case]
    want = J.resolve_spec(spec, mesh, shape)
    got = T.resolve_spec(spec, mesh, shape)
    assert isinstance(got, tuple) and not isinstance(got, PartitionSpec)
    assert PartitionSpec(*got) == want


def test_axis_constants_and_spec_leaves():
    assert (T.BATCH, T.FSDP, T.TP, T.SEQ) == (J.BATCH, J.FSDP, J.TP, J.SEQ)
    Pair = namedtuple("Pair", "a b")
    for x in (("data", "model"), (), None, Pair("data", "model"), {"a": 1}, ("data", 3),
              (("pod", "data"), None)):
        assert T.is_spec_leaf(x) == J.is_spec_leaf(x)


def test_meshes_on_cpu():
    m = make_test_mesh((2, 4), ("pod", "data"), device="cpu")
    assert isinstance(m, Mesh)
    assert m.axis_names == ("pod", "data") and dict(m.shape) == {"pod": 2, "data": 4}
    assert m.devices.shape == (2, 4)
    assert all(d == torch.device("cpu") for d in m.devices.flat)  # positions repeat a device
    assert T.mesh_num_devices(m) == 8
    c = make_cache_mesh(8, device="cpu")
    assert c.axis_names == ("data",) and dict(c.shape) == {"data": 8}
    assert make_cache_mesh(device="cpu").shape["data"] == 1
    # the sharding rules read the port's mesh like the reference's
    assert T.resolve_spec((("pod", "data"), "model"), m, (16, 4)) == (("pod", "data"), None)
    with pytest.raises(ValueError):
        Mesh(np.empty((2, 2), object), ("data",))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card error")
def test_cache_mesh_needs_a_card_unless_given_a_device():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_cache_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_cache_mesh(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_test_mesh((1,), ("data",))
