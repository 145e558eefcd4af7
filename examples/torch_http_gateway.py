"""HTTP gateway quickstart: the OpenAI-compatible serving surface.

Starts a gateway over a MockLLM-backed ``CacheService`` on a local port,
then talks to it like any OpenAI SDK would: a cold question generates
(``X-Cache: miss``), the repeat answers from the cache in milliseconds
(``X-Cache: hit``), and a streamed repeat replays the cached answer
token-by-token over SSE — byte-identical to the non-streamed body.

Run:  PYTHONPATH=src python examples/torch_http_gateway.py [--device cpu]

Against a real model instead of the mock:
      PYTHONPATH=src python -m repro_torch.launch.serve --http 8080
"""
import argparse

from repro_torch.core import EnhancedClient, GenerativeCache, MockLLM, NgramHashEmbedder
from repro_torch.gateway import GatewayClient, serve_in_thread
from repro_torch.serving.service import CacheService


def device_arg():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the cache's store lives: cuda (the default) or cpu")
    return ap.parse_args().device

QUESTION = "What is an application-level denial of service attack?"


def main(device=None):
    cache = GenerativeCache(
        NgramHashEmbedder(), threshold=0.8, t_single=0.45, t_combined=1.0,
        device=device,
    )
    client = EnhancedClient(cache=cache)
    client.register_backend(MockLLM("mock-model", latency_s=0.2))
    service = CacheService(client, max_batch=8, max_wait_ms=2.0)

    # pace_ms paces the cached replay so a streamed hit still *reads* like
    # a live generation; own_service ties the service drain to gateway stop
    runner = serve_in_thread(service, pace_ms=5.0, own_service=True)
    try:
        port = runner.gateway.port
        print(f"gateway on http://127.0.0.1:{port}\n")
        with GatewayClient("127.0.0.1", port) as http:
            # the first hit pays the search path's first-call set-up; the
            # second shows the steady-state cached latency
            for label in ("cold ", "warm1", "warm2"):
                reply = http.chat(QUESTION)
                print(f"{label} X-Cache={reply.headers['x-cache']:<5} "
                      f"latency={reply.headers['x-service-latency-ms']}ms  "
                      f"-> {reply.text[:48]}...")

            streamed = http.chat(QUESTION, stream=True)
            print(f"sse   X-Cache={streamed.headers['x-cache']:<5} "
                  f"chunks={len(streamed.events)} done={streamed.done}")
            assert streamed.text == http.chat(QUESTION).text  # byte parity

            stats = http.cache_stats().json()
            print(f"\nstats: {stats['gateway']['by_cache_class']} "
                  f"hit_fraction={stats['gateway']['hit_fraction']:.2f}")
    finally:
        clean = runner.stop()
        print(f"drained {'clean' if clean else 'DIRTY'}")


if __name__ == "__main__":
    main(device_arg())
