"""B1 (``kernels/similarity_topk``, one launch a fused read) against its
roofline in the traced sub-window: the least time the card needs for the
reads launched there (each read's real queries against the levels' live
rows, ``counts.similarity_topk_bound``; the reads' batch sizes from the
lookup scheduler's ``batch_sizes``), over B1's device time in the trace.
Moves ``served_rps``."""
from harness import counts


def read(ctx):
    tr, sub = ctx["trace"], ctx["sub"]
    calls, qs = sub.get("launch", {}).get("b1", 0), list(sub.get("batches", []))
    t = tr.family_s.get("b1", 0.0)
    if not calls or not qs or t <= 0:
        return None
    qs = qs[:calls] + [sum(qs) / len(qs)] * max(0, calls - len(qs))
    conf = ctx["conf"]
    d, k = conf["encoder"]["d_model"], conf["cache"]["max_sources"]
    bound = sum(counts.similarity_topk_bound(q, ctx["live_rows"], d, 2, k) for q in qs)
    return 100.0 * bound / t
