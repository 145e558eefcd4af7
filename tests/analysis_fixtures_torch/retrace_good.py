"""Good: caches built once and keyed by buckets, branch-free device math."""
import functools

import torch

_cache = {}


@functools.lru_cache(maxsize=64)
def plan(k, sizes):
    return k, sizes


def bucket_len(n):
    b = 16
    while b < n:
        b *= 2
    return b


def lookup(x, sizes):
    for s in sizes:
        if s not in _cache:
            _cache[s] = functools.lru_cache(maxsize=8)(lambda v, s=s: v * s)  # kept by subscript
    return plan(bucket_len(len(sizes)), (1, 2))  # bucketed: O(log n) keys


def no_branch(x, scale: float):  # repro: device-region
    if scale > 1.0:  # a Python float: not a device value
        x = x * scale
    return torch.where(x > 0, x, -x)
