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


def test_use_mesh_current_mesh_and_constrain():
    """``constrain`` is a no-op outside ``use_mesh``; under it the spec must
    resolve against x's shape, x comes back as it is, and the context
    nests and restores the outer mesh."""
    x = torch.zeros(4, 6, 8)
    assert T.current_mesh() is None
    assert T.constrain(x, (T.BATCH, None, None)) is x
    m = make_test_mesh((2, 2), ("data", "model"), device="cpu")
    inner = make_test_mesh((1, 4), ("data", "model"), device="cpu")
    with T.use_mesh(m) as got:
        assert got is m and T.current_mesh() is m
        assert T.constrain(x, (T.BATCH, None, None)) is x
        with T.use_mesh(inner):
            assert T.current_mesh() is inner
        assert T.current_mesh() is m
        with pytest.raises(ValueError):
            T.constrain(x, (T.BATCH, None))  # a 2-entry spec for a 3-d tensor
    assert T.current_mesh() is None
    with pytest.raises(ValueError):  # the mesh is restored after an error
        with T.use_mesh(m):
            raise ValueError("inside")
    assert T.current_mesh() is None


def test_shardings_for_and_device_put_tree_shard_shapes():
    """Each leaf's shards: the resolved spec cuts the dimensions (axes
    that do not divide one are dropped), every position holds its block
    on its device, and the blocks tile the leaf (a dimension over two axes
    is cut row-major over them)."""
    m = make_test_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    tree = {"w": torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6),
            "b": {"v": torch.arange(6.0)},
            "k": torch.arange(4 * 3 * 2.0).reshape(4, 3, 2)}
    specs = {"w": (T.BATCH, "model"), "b": {"v": ("model",)}, "k": (T.FSDP, "model", None)}
    sh = T.shardings_for(m, specs, tree)
    assert isinstance(sh["w"], T.NamedSharding)
    assert sh["w"].spec == (("pod", "data"), "model")
    assert sh["w"].shard_shape((8, 6)) == (2, 3)
    assert sh["b"]["v"].shard_shape((6,)) == (3,)
    assert sh["k"].spec == ("data", None, None)  # 3 heads do not split over model=2
    assert sh["k"].shard_shape((4, 3, 2)) == (2, 3, 2)
    assert T.shardings_for(m, specs)["k"].spec == ("data", "model", None)  # no shapes given
    with pytest.raises(ValueError):
        T.NamedSharding(m, ("model",)).shard_shape((3,))
    put = T.device_put_tree(tree, specs, m)
    w = put["w"]
    assert w.shape == (2, 2, 2)
    for idx in np.ndindex(2, 2, 2):
        p, d, mo = idx
        blk = w[idx]
        assert blk.shape == (2, 3) and blk.device == m.devices[idx]
        assert torch.equal(blk, tree["w"][(p * 2 + d) * 2:(p * 2 + d + 1) * 2, mo * 3:(mo + 1) * 3])
    assert torch.equal(put["b"]["v"][0, 1, 1], torch.tensor([3.0, 4.0, 5.0]))
    assert torch.equal(put["k"][1, 1, 0], tree["k"][2:4])
    # the state's NamedTuple structure maps through
    from repro_torch.training import TrainState

    st = T.shardings_for(m, TrainState(specs["b"], specs["b"], ()), TrainState(
        tree["b"], tree["b"], torch.zeros(())))
    assert isinstance(st, TrainState) and st.step.spec == ()
    # one walker: paths from the root (a NamedTuple's field names), and a
    # tree of shardings walks like its specs
    seen = []
    T.tree_map_specs(lambda path, s, x: seen.append((path, s.shard_shape(x.shape))), st,
                     TrainState(tree["b"], tree["b"], torch.zeros(())), path=())
    assert seen == [(("params", "v"), (3,)), (("opt_state", "v"), (3,)), (("step",), ())]
    assert sh["w"].over("model") == (False, True) and sh["w"].axis_split("data") == 2
    assert sh["k"].over("model") == (False, False, False) and sh["k"].axis_split("model") == 1


def test_production_meshes_are_meta():
    from repro_torch.launch.mesh import make_production_mesh

    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert dict(single.shape) == {"data": 16, "model": 16}
    assert dict(multi.shape) == {"pod": 2, "data": 16, "model": 16}
    assert T.mesh_num_devices(multi) == 512
    assert all(d == torch.device("meta") for d in multi.devices.flat)

