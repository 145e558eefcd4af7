"""Bad: compile-cache hazards (expect RA201 x4, RA202 x1)."""
import functools

import torch


@functools.lru_cache(maxsize=64)
def plan(k, sizes):
    return k, sizes


def per_request(x, sizes):
    out = []
    for s in sizes:
        @functools.lru_cache(maxsize=8)
        def scaled(v):  # RA201: a fresh, empty cache every iteration
            return v * 2

        out.append(scaled(s))
    y = functools.lru_cache(maxsize=8)(lambda v: v + 1)(x)  # RA201: built and invoked at once
    p = plan(4, [1, 2])  # RA201: unhashable literal
    n = plan(len(sizes), ())  # RA201: per-request size
    return out, y, p, n


def branchy(x):  # repro: device-region
    if x.sum() > 0:  # RA202: Python branch on a device value
        return x + 1
    return x - 1
