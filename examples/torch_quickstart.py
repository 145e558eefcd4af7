"""Quickstart: the paper's §3 worked example end-to-end, on the PyTorch port.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

from repro_torch.core import (
    EnhancedClient,
    GenerativeCache,
    MockLLM,
    ModelCostInfo,
    NgramHashEmbedder,
)

Q1 = "What is an application-level denial of service attack?"
Q2 = "What are the most effective techniques for defending against denial-of-service attacks?"
Q3 = ("What is an application-level denial of service attack, and what are the most "
      "effective techniques for defending against such attacks?")


def device_arg():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the cache's store lives: cuda (the default) or cpu")
    return ap.parse_args().device


def main(device=None):
    # A generative cache: t_single < t_s < t_combined  (§3)
    cache = GenerativeCache(
        NgramHashEmbedder(),
        threshold=0.88, t_single=0.45, t_combined=1.0,
        mode="secondary", synthesis_mode="template", device=device,
    )
    client = EnhancedClient(cache=cache)
    client.register_backend(MockLLM("gpt-3.5-turbo-0125", latency_s=0.15),
                            ModelCostInfo(0.5, 1.5, 3.0))
    client.register_backend(MockLLM("gpt-4-32k", latency_s=0.6),
                            ModelCostInfo(60.0, 120.0, 20.0))

    print("== 1. populate the cache with two LLM answers")
    for q in (Q1, Q2):
        r = client.query(q)
        print(f"   [{'cache' if r.from_cache else r.model:>18}] {q[:60]}")

    print("\n== 2. Q3 was never asked — generative caching synthesizes it")
    r3 = client.query(Q3)
    assert r3.from_cache and r3.cache_result.generative
    print(f"   hit={r3.from_cache} generative={r3.cache_result.generative} "
          f"combined_similarity={r3.cache_result.combined_similarity:.2f} "
          f"sources={len(r3.cache_result.sources)}")
    print("   " + r3.text.splitlines()[0])

    print("\n== 3. paraphrases now hit the cache directly")
    r = client.query("Please explain what an application-level denial of service attack is.")
    print(f"   hit={r.from_cache} sim={r.cache_result.similarity:.3f} "
          f"latency={r.latency_s*1e3:.1f}ms (vs ~150ms LLM)")

    print("\n== 4. feedback servos the threshold (§3.1)")
    before = client.policy.base
    for _ in range(6):
        r = client.query(Q1)
        client.feedback(r, satisfied=False)  # unhappy with cached answers
    print(f"   t_s: {before:.3f} -> {client.policy.base:.3f} (raised on low quality)")

    print(f"\nstats: {client.stats}")


if __name__ == "__main__":
    main(device_arg())
