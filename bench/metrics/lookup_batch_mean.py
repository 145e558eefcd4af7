"""Requests per batch of the service's lookup scheduler (``serving/coalescer``'s
``CoalescerStats`` of ``CacheService``'s front scheduler), over the window:
how full each fused read is. Moves ``served_rps``."""


def read(ctx):
    batches, items = ctx["lookup"]
    return items / batches if batches else None
