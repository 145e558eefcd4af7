"""Serving entry point: a zoo model behind the GenerativeCache-fronted client
(the port of the reference's ``launch/serve.py``).

Runs batched requests (paraphrase-clustered synthetic queries) through the
full stack — embed -> semantic/generative lookup -> miss -> continuous-
batching engine -> insert — and prints hit-rate / latency / cost stats.

With ``--coalesce`` it simulates concurrent users against the
async-first ``CacheService``: each user submits a ``CacheRequest`` and gets
a future; the priority-aware front scheduler micro-batches the lookups (one
embed forward + one store search per admitted batch), hit futures resolve
immediately, and the miss residue coalesces by priority into engine passes
in the background. ``--deadline-ms`` attaches a deadline to every request:
misses that would outwait it resolve with a typed ``deadline_exceeded``
response instead of generating. ``--http PORT`` serves the OpenAI-compatible
gateway instead, and ``--shards N`` puts a key-sharded L2 behind the L1.

The engine and the cache's stores live on the card (the store searches
through the similarity_topk kernel, the engine through the attention
kernels) unless ``--device cpu`` is given.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b --requests 40
  PYTHONPATH=src python -m repro_torch.launch.serve --coalesce --coalesce-batch 8
  PYTHONPATH=src python -m repro_torch.launch.serve --coalesce --deadline-ms 2000
  PYTHONPATH=src python -m repro_torch.launch.serve --http 8123 --device cpu
"""
from __future__ import annotations

import argparse
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.configs import get_config
from repro_torch.core import CacheRequest, EnhancedClient, GenerativeCache, NgramHashEmbedder
from repro_torch.core.adaptive import ModelCostInfo
from repro_torch.data.synthetic import squad_like_qa
from repro_torch.kernels.backend import resolve_device
from repro_torch.serving.engine import ModelBackend, ServingEngine
from repro_torch.serving.service import CacheService


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--threshold", type=float, default=0.6)
    ap.add_argument("--coalesce", action="store_true",
                    help="serve concurrent requests through the async CacheService")
    ap.add_argument("--coalesce-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=4.0)
    ap.add_argument("--concurrency", type=int, default=16,
                    help="simulated concurrent users (--coalesce only)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request deadline; 0 disables (--coalesce only)")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve the OpenAI-compatible HTTP gateway on PORT "
                         "instead of replaying synthetic queries")
    ap.add_argument("--http-pace-ms", type=float, default=0.0,
                    help="SSE pacing between streamed chunks of a cached "
                         "replay (--http only)")
    ap.add_argument("--shards", type=int, default=0,
                    help="key-shard a shared L2 store over an N-position cache "
                         "mesh behind the L1 (0 = L1 only); on the card the "
                         "positions are min(N, visible cards)")
    ap.add_argument("--device", default=None,
                    help="where the engine and the stores live: cuda (the "
                         "default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # The reference sets its TPU kernel knobs here (an interpret override
    # and top-k tiling from a sweep). CUDA tiles are compile-time constants
    # of each kernel's source, so the port has no such knob.
    cfg = get_config(args.arch, smoke=True)
    engine = ServingEngine(cfg, max_batch=args.max_batch, max_seq=256, device=device)
    backend = ModelBackend(args.arch, engine)

    cache = GenerativeCache(
        NgramHashEmbedder(), threshold=args.threshold, t_single=0.45, t_combined=1.0,
        use_pallas=True, device=device,
    )
    hierarchy = None
    if args.shards > 0:
        # sharded deployment: the hot L1 stays on one device, the shared
        # L2's DB lanes are key-sharded over a cache mesh, and the hierarchy
        # serves both through one sharded read
        # (repro_torch.distributed.sharded_read)
        from repro_torch.core import HierarchicalCache
        from repro_torch.distributed.sharded_store import ShardedVectorStore
        from repro_torch.launch.mesh import make_cache_mesh

        if device.type == "cuda":
            mesh = make_cache_mesh(min(args.shards, torch.cuda.device_count()))
        else:
            mesh = make_cache_mesh(args.shards, device=device)
        print(f"mesh: {mesh.devices.size} positions on "
              f"{sorted({str(d) for d in mesh.devices.flat})}")
        emb = cache.embedder
        l2 = GenerativeCache(
            emb, threshold=args.threshold, t_single=0.45, t_combined=1.0,
            store=ShardedVectorStore(mesh, emb.dim, 4096, k=4, use_pallas=True),
        )
        hierarchy = HierarchicalCache(cache, l2)
    client = EnhancedClient(cache=cache, hierarchy=hierarchy)
    client.register_backend(backend, ModelCostInfo(0.5, 1.5, 3.0))

    if args.http is not None:
        # real serving surface: the gateway owns the service and drains it
        # (in-flight futures resolve) on Ctrl-C
        from repro_torch.gateway.app import serve_in_thread

        service = CacheService(
            client, max_batch=args.coalesce_batch, max_wait_ms=args.max_wait_ms
        )
        runner = serve_in_thread(
            service, port=args.http, pace_ms=args.http_pace_ms, own_service=True
        )
        host, port = runner.gateway.http.host, runner.gateway.port
        print(f"gateway listening on http://{host}:{port}")
        print(f"  POST http://{host}:{port}/v1/chat/completions")
        print(f"  POST http://{host}:{port}/v1/completions")
        print(f"  GET  http://{host}:{port}/healthz")
        print(f"  GET  http://{host}:{port}/v1/cache/stats")
        try:
            while True:
                time.sleep(0.5)
        except KeyboardInterrupt:
            pass
        clean = runner.stop()
        print(f"drained {'clean' if clean else 'DIRTY'}; "
              f"served={runner.gateway.http.requests_served}")
        return

    qa = squad_like_qa(n_clusters=max(args.requests // 4, 2), paraphrases=4)
    queries = [q for q, _, _ in qa][: args.requests]

    t0 = time.perf_counter()
    if args.coalesce:
        service = CacheService(
            client, max_batch=args.coalesce_batch, max_wait_ms=args.max_wait_ms
        )
        deadline_s = args.deadline_ms / 1e3 if args.deadline_ms > 0 else None

        def one(q: str):
            t = time.perf_counter()
            resp = service.submit(
                CacheRequest(q, max_tokens=args.max_new_tokens, deadline_s=deadline_s)
            ).result()
            return resp, time.perf_counter() - t

        with service, ThreadPoolExecutor(max_workers=args.concurrency) as users:
            results = list(users.map(one, queries))
        for i, (q, (r, wall)) in enumerate(zip(queries, results)):
            tag = {"hit": "HIT ", "generated": "MISS", "deadline_exceeded": "EXPD"}[r.status]
            print(f"[{i:3d}] {tag} {wall*1e3:7.1f} ms  {q[:60]}")
        sst = service.stats
        lk, dp = service.scheduler_stats
        print(f"service: hits={sst.hits} generated={sst.generated} "
              f"deduped={sst.deduped} expired={sst.expired} "
              f"rejected={sst.rejected} lookup_avg_batch={lk.avg_batch:.1f} "
              f"dispatch_avg_batch={dp.avg_batch if dp else 0.0:.1f}")
    else:
        for i, q in enumerate(queries):
            r = client.query(q, max_tokens=args.max_new_tokens)
            tag = "HIT " if r.from_cache else "MISS"
            print(f"[{i:3d}] {tag} {r.latency_s*1e3:7.1f} ms  {q[:60]}")
    wall = time.perf_counter() - t0

    s = client.stats
    print(f"\nrequests={s.requests} hits={s.cache_hits} "
          f"hit_rate={s.cache_hits / max(s.requests, 1):.2f} "
          f"llm_calls={s.llm_calls} cost=${s.total_cost_usd:.6f} wall={wall:.1f}s")
    print(f"engine: {engine.metrics}")
    cs = cache.stats
    print(f"cache: lookups={cs.lookups} generative_hits={cs.generative_hits} "
          f"embed_time={cs.embed_time_s:.2f}s search_time={cs.search_time_s:.3f}s")


if __name__ == "__main__":
    main()
