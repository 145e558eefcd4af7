"""Misses per batch of the service's dispatch scheduler (its
``CoalescerStats``), over the window: how many prompts each
``generate_batch`` pass serves.
Moves ``served_rps`` (a miss answered sooner resolves inside the window)."""


def read(ctx):
    batches, items = ctx["dispatch"]
    return items / batches if batches else None
