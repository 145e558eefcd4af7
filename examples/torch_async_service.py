"""Async-first serving: futures, priorities, deadlines, asyncio.

Demonstrates the request-level API the paper's latency story needs: a
mixed stream where cache hits resolve in milliseconds while misses wait on
a slow backend — without the hits being dragged to miss latency — plus a
deadline that sheds a miss before it ever reaches the backend, and the
asyncio facade.

Run:  PYTHONPATH=src python examples/torch_async_service.py [--device cpu]
"""
import argparse
import asyncio
import time

from repro_torch.core import (
    CacheRequest,
    EnhancedClient,
    GenerativeCache,
    MockLLM,
    NgramHashEmbedder,
)
from repro_torch.serving.service import CacheService


def device_arg():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the cache's store lives: cuda (the default) or cpu")
    return ap.parse_args().device


def build_client(device=None) -> EnhancedClient:
    cache = GenerativeCache(
        NgramHashEmbedder(), threshold=0.85, t_single=0.45, t_combined=1.0,
        device=device,
    )
    client = EnhancedClient(cache=cache)
    client.register_backend(MockLLM("slow-llm", latency_s=0.4))
    cache.insert("what is semantic caching", "serving answers by meaning, not bytes")
    cache.insert("how do caches evict entries", "lru, lfu, or fifo over the slot array")
    return client


def futures_demo(client: EnhancedClient) -> None:
    print("== futures: hits resolve before the co-batched miss generates ==")
    with CacheService(client, max_batch=8, max_wait_ms=5.0) as service:
        t0 = time.perf_counter()
        miss = service.submit(CacheRequest("a brand new question", priority=0))
        hit = service.submit(CacheRequest("what is semantic caching", priority=5))
        r = hit.result()
        print(f"  hit   [{(time.perf_counter()-t0)*1e3:6.1f} ms] {r.text!r}")
        r = miss.result()
        print(f"  miss  [{(time.perf_counter()-t0)*1e3:6.1f} ms] {r.text!r}")

        # a deadline shorter than the backend's latency sheds the miss
        doomed = service.submit(CacheRequest("another fresh question", deadline_s=0.05))
        print(f"  expired -> status={doomed.result().status}")
        print(f"  service stats: {service.stats}")


async def asyncio_demo(client: EnhancedClient) -> None:
    print("== asyncio facade ==")
    with CacheService(client, max_wait_ms=5.0) as service:
        t0 = time.perf_counter()
        hit, miss = await asyncio.gather(
            service.acomplete("how do caches evict entries"),
            service.acomplete("an unseen question about schedulers"),
        )
        print(f"  gather done in {(time.perf_counter()-t0)*1e3:.1f} ms "
              f"(hit status={hit.status}, miss status={miss.status})")


def main(device=None):
    client = build_client(device)
    futures_demo(client)
    asyncio.run(asyncio_demo(client))


if __name__ == "__main__":
    main(device_arg())
