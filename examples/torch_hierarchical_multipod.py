"""Hierarchical caching (§4 Figure 1): client L1s over shared cooperating
L2s, with privacy hints — plus the mesh-sharded store that realizes the same
topology on a device mesh (pod-local shard = L1, cross-pod merge = L2), on
the PyTorch port.

The mesh's 8 positions take the visible cards in turn (all 8 on one card
where there is one), or all sit on the CPU with ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_hierarchical_multipod.py [--device cpu]
"""
import argparse

from repro_torch.core import GenerativeCache, HierarchicalCache, NgramHashEmbedder


def device_arg():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the stores live: cuda (the default) or cpu")
    return ap.parse_args().device


def host_side_hierarchy(device=None):
    emb = NgramHashEmbedder()

    def gc(cap):
        return GenerativeCache(emb, threshold=0.85, t_single=0.45, t_combined=1.0, capacity=cap,
                               device=device)

    l1a, l1b = gc(64), gc(64)  # two clients
    l2 = gc(512)  # shared L2
    peer = gc(512)  # a cooperating peer L2
    h_a = HierarchicalCache(l1a, l2, peers=[peer])
    h_b = HierarchicalCache(l1b, l2, peers=[peer])

    print("== client A asks; the answer lands in A's L1 and the shared L2")
    h_a.insert("What is tcp congestion control?", "TCP answer")
    print(f"   L1a={len(l1a.store)} L2={len(l2.store)}")

    print("== client B gets an L2 hit, promoted into B's L1")
    r = h_b.lookup("Please explain tcp congestion control.")
    print(f"   hit={r.hit} level={r.level}; L1b now has {len(l1b.store)} entries")

    print("== peer cooperation: content only a peer L2 holds is still served")
    peer.insert("What is raft consensus?", "raft answer")
    r = h_a.lookup("Explain the raft consensus protocol")
    print(f"   hit={r.hit} level={r.level}")

    print("== privacy hint: personal queries stay out of shared levels (§4)")
    h_a.insert("What are my lab results for patient 1234?", "personal", cache_l2=False)
    r = h_b.lookup("What are my lab results for patient 1234?")
    print(f"   other client hit={r.hit} (expected False); L1a={len(l1a.store)}")

    print("== generative synthesis ACROSS levels")
    l1a.insert("What is quantum entanglement?", "entanglement answer")
    l2.insert("What is the history of quantum entanglement?", "history answer")
    r = h_a.lookup("What is quantum entanglement, and what is the history of quantum entanglement?")
    print(f"   hit={r.hit} level={r.level} generative={r.generative}")


def batched_hierarchy(device=None):
    emb = NgramHashEmbedder()

    def gc(cap):
        # looser thresholds than the walkthrough above so the n-gram
        # embedder's paraphrase scores (~0.6-0.7) register as hits
        return GenerativeCache(emb, threshold=0.55, t_single=0.4, t_combined=1.0, capacity=cap,
                               device=device)

    l1, l2, peer = gc(64), gc(512), gc(512)
    h = HierarchicalCache(l1, l2, peers=[peer])
    l2.insert("What is tcp congestion control?", "TCP answer")
    peer.insert("What is raft consensus?", "raft answer")

    print("\n== batched hierarchy: one search dispatch per level for the batch")
    rs = h.lookup_batch([
        "Please explain tcp congestion control.",
        "Explain the raft consensus protocol",
        "What is the airspeed velocity of an unladen swallow?",
    ])
    for r in rs:
        print(f"   hit={r.hit} level={r.level}")
    print(f"   lower-level winners promoted: L1 now has {len(l1.store)} entries")


def mesh_sharded_store(device=None):
    from repro_torch.distributed.sharded_store import ShardedVectorStore
    from repro_torch.launch.mesh import make_test_mesh

    print("\n== mesh-sharded store: pod-local shards + cross-pod top-k merge")
    mesh = make_test_mesh(shape=(2, 4), axes=("pod", "data"), device=device)
    emb = NgramHashEmbedder(dim=64)
    store = ShardedVectorStore(mesh, dim=64, capacity=256, k=4)
    questions = [f"What is topic number {i}?" for i in range(24)]
    vecs = emb.embed(questions)
    store.add_batch(vecs, questions, [f"answer to {q}" for q in questions])
    probe = emb.embed(["Please explain topic number 7"])
    scores, idx = store.search(probe)
    q, a = store.payloads[int(idx[0, 0])]
    print(f"   best match: {q!r} (score {scores[0,0]:.3f}) across {store.n_shards} shards")


if __name__ == "__main__":
    dev = device_arg()
    host_side_hierarchy(dev)
    batched_hierarchy(dev)
    mesh_sharded_store(dev)
