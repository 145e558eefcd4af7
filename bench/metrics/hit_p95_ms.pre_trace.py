"""The 95th percentile of the hits' latency (ms, from each request's due
time to its future resolving), over the hits of the traced run that were
due before the profiler started: its stop holds the interpreter for
seconds, which would set the tail otherwise. On the host's clock this tail
moves too much from run to run to carry a bound (PERF.md), so it is a
layer's reading beside ``served_rps``, which it moves."""
import numpy as np


def read(ctx):
    t_on = ctx["profiled"][0]
    hits = [o for o in ctx["hits"] if t_on is None or o.due < t_on]
    if not hits:
        return None
    return float(np.percentile([(o.done - o.due) * 1e3 for o in hits], 95))
