"""Checkpoints and the data pipeline of the port against the reference's:
``ShardedLoader`` batches equal the reference's byte for byte (seeds,
steps, shards); a checkpoint the reference writes (a TrainState with
bfloat16 parameters, float32 and int8 moments, the int32 step) restores
in the port into its own TrainState, and the reverse, leaf for leaf with
the same key paths, dtypes named alike in both manifests; then the
assertions of the reference's ``tests/test_checkpoint_data.py`` on the
port."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import get_config as j_get_config
from repro.data.loader import ShardedLoader as JLoader
from repro.training.train_loop import init_train_state as j_init_train_state
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synthetic import markov_token_stream, squad_like_qa
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train_loop import init_train_state

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,shards", [(0, 1), (3, 1), (7, 2)])
def test_loader_batches_equal_the_reference_byte_for_byte(seed, shards):
    for idx in range(shards):
        a = ShardedLoader(512, 8, 33, seed=seed, start_step=5, num_shards=shards, shard_index=idx)
        b = JLoader(512, 8, 33, seed=seed, start_step=5, num_shards=shards, shard_index=idx)
        for _ in range(3):
            x, y = next(a)["tokens"], next(b)["tokens"]
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
        assert a.state() == b.state()


def _flat_np(tree, pre=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_np(v, f"{pre}{k}/"))
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            out.update(_flat_np(getattr(tree, k), f"{pre}{k}/"))
    else:
        out[pre[:-1]] = tree
    return out


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes (bfloat16 as its int16 bits on both sides)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x).reshape(-1).view(np.uint8)


@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit"])
def test_checkpoints_cross_both_ways(tmp_path, optimizer):
    """bfloat16 parameters (``|V2`` in the npz), float32 or int8 + scale
    moments, the step: reference -> port and port -> reference."""
    jc = j_get_config("qwen1.5-0.5b", smoke=True)
    tc = get_config("qwen1.5-0.5b", smoke=True)
    import dataclasses

    jc, tc = (dataclasses.replace(c, optimizer=optimizer) for c in (jc, tc))
    jstate, _ = j_init_train_state(jc, jax.random.PRNGKey(0))
    jstate = jstate._replace(step=jnp.asarray(11, jnp.int32),
                             opt_state=jax.tree.map(lambda a: a + 1 if a.dtype != jnp.int8 else a,
                                                    jstate.opt_state))
    j_save(str(tmp_path / "ref"), 11, jstate, extra={"loader": {"seed": 0, "step": 11}})
    template = init_train_state(tc, seed=5, device="cpu")
    got, extra = restore_checkpoint(str(tmp_path / "ref"), template)
    assert extra == {"loader": {"seed": 0, "step": 11}} and int(got.step) == 11
    want = _flat_np(jax.tree.map(np.asarray, jstate))
    have = _flat_np(got)
    assert set(want) == set(have)
    for k, w in want.items():
        assert have[k].dtype == _flat_np(template)[k].dtype
        assert _bits(have[k]).tobytes() == _bits(w).tobytes(), k
    assert any(v.dtype == torch.bfloat16 for v in tree_leaves(got.params))

    # port -> reference, and the two manifests alike
    save_checkpoint(str(tmp_path / "port"), 11, got, extra=extra)
    jtemplate, _ = j_init_train_state(jc, jax.random.PRNGKey(1))
    back, extra2 = j_restore(str(tmp_path / "port"), jtemplate)
    assert extra2 == extra
    back = _flat_np(jax.tree.map(np.asarray, back))
    for k, w in want.items():
        assert back[k].dtype == w.dtype and _bits(back[k]).tobytes() == _bits(w).tobytes(), k
    manifests = [json.load(open(tmp_path / d / "step_00000011" / "manifest.json"))
                 for d in ("ref", "port")]
    assert manifests[0] == manifests[1]
    assert manifests[0]["dtypes"]["params/embed/table"] == "bfloat16"


# --- the reference's tests/test_checkpoint_data.py on the port ---------------


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 16), generator=g), "b": torch.zeros(16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def test_save_restore_roundtrip(tmp_path):
    s = _state()
    save_checkpoint(str(tmp_path), 7, s, extra={"loader": {"seed": 0, "step": 7}})
    restored, extra = restore_checkpoint(str(tmp_path), _zeros_like(s))
    for a, b in zip(tree_leaves(s), tree_leaves(restored)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert extra["loader"]["step"] == 7


def test_retention_keeps_last_k(tmp_path):
    for step in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), step, _state(), keep=2)
    assert latest_step(str(tmp_path)) == 5
    kept = sorted(os.listdir(tmp_path))
    assert len([d for d in kept if d.startswith("step_")]) == 2


def test_atomic_commit_never_leaves_partial(tmp_path):
    save_checkpoint(str(tmp_path), 1, _state())
    # a stale tmp dir from a crashed save must not confuse restore
    os.makedirs(tmp_path / "step_00000002.tmp", exist_ok=True)
    assert latest_step(str(tmp_path)) == 1
    restore_checkpoint(str(tmp_path), _zeros_like(_state()))


def test_loader_positional_determinism():
    a = ShardedLoader(512, 4, 16, seed=3)
    b = ShardedLoader(512, 4, 16, seed=3, start_step=2)
    n0, n1, n2 = next(a), next(a), next(a)
    m2 = next(b)
    np.testing.assert_array_equal(n2["tokens"], m2["tokens"])


def test_loader_sharding_partitions_batch():
    full = ShardedLoader(512, 8, 16, seed=1)
    s0 = ShardedLoader(512, 8, 16, seed=1, num_shards=2, shard_index=0)
    s1 = ShardedLoader(512, 8, 16, seed=1, num_shards=2, shard_index=1)
    f, a, b = next(full)["tokens"], next(s0)["tokens"], next(s1)["tokens"]
    np.testing.assert_array_equal(np.concatenate([a, b]), f)


def test_markov_stream_has_structure():
    batch = next(markov_token_stream(256, 4, 64, seed=0))
    assert batch.shape == (4, 64)
    succ_counts = {}
    for row in batch:
        for a, b in zip(row[:-1], row[1:]):
            succ_counts.setdefault(int(a), set()).add(int(b))
    assert np.mean([len(v) for v in succ_counts.values()]) < 64


def test_squad_like_clusters_share_answers():
    by_cluster = {}
    for q, a, cid in squad_like_qa(5, 4, seed=0):
        by_cluster.setdefault(cid, []).append((q, a))
    for items in by_cluster.values():
        qs = [q for q, _ in items]
        assert len({a for _, a in items}) == 1
        assert len(set(qs)) == len(qs)
