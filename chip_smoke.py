#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card (an H100): the cache read path
and, behind it, the miss path through the LLM serving engines (dense,
vision, audio, SSM, hybrid and MoE models).

    python3 chip_smoke.py [--profile]
                          [--attention-only | --topk-only | --ssd-only | --arch-only
                           | --moe-only | --sharded-only] [--src DIR]

It builds the port's four CUDA libraries from the sources in this checkout
(one nvcc each, all at once), holds every kernel against its plain PyTorch
version on the card, checks the full-width models against their CPU runs,
and then serves a burst of requests through the port's real entry points:

    CacheService -> EnhancedClient
      -> HierarchicalCache(L1 GenerativeCache 16384, L2 GenerativeCache 131072)
         one [2, 131072, 768] float32 bank (805 MB) searched by the
         similarity_topk lanes kernel (B1), Contriever-msmarco (12 x 768,
         random init from a seed) embedding the queries on the card
      -> on a miss: ModelBackend -> ServingEngine(qwen1.5-0.5b, 24 x 1024,
         bfloat16, random init from a seed; max_batch 4, max_seq 256)
         prefill through the flash_attention kernel (B4), every decode step
         through the decode_attention kernel (B3)
      -> or: ModelBackend -> ServingEngine(mamba2-1.3b, 48 x 2048, d_inner
         4096, 64 SSM heads, bfloat16, random init from a seed; max_batch 4,
         max_seq 256), every prefill through the ssd_scan kernel (B5), decode
         the recurrent update in plain torch
      -> or: ModelBackend -> ServingEngine(qwen3-8b, 36 x 4096, head width
         128) or ServingEngine(zamba2-7b: 81 Mamba2 blocks through B5 and 13
         applications of two shared attention blocks at 2 x 3584, head width
         224, through B4 and B3), bfloat16, random init from a seed

and, one model at a time, the other architectures of the port at full
depth and width in bfloat16: gemma2-27b, gemma3-4b (head width 256) and
llava-next-mistral-7b (text) behind ServingEngine, musicgen-large (4
codebooks) through its own prefill and decode calls; then the two MoE
models at full width cut in depth (neither fits one card whole) behind
ModelBackend -> ServingEngine: llama4-scout-17b-a16e (8 of 48 layers, 16
experts top-1, B4/B3 at H 40 over KH 8) and deepseek-v3-671b (3 dense + 2
MoE of 61 layers, 256 experts top-8, MLA: prefill through B4 at q/k width
192 and value width 128, decode absorbed into the latent space in plain
torch, without B3).

Lines it prints, in order: ``gpu:`` (card, power limit, torch/CUDA),
``build:`` (nvcc seconds per library; B1's stream route and main-path
grid), ``check:`` per kernel-vs-plain case (B1 with its route, streaming
or tile, incl. ``lane_rows`` below N, Q 1..64 across the small-Q threshold
and every k class; B2 = B1 at L = 1, B3, B4 at every head width up to
256 and at (q/k 192, v 128), B5), ``time:`` lines (kernel / plain /
library device times from a profiler trace, or from CUDA events after a
``timer:`` line where every trace came back empty or below the bound, the
kernel's host rate, and the bound, at the main-path shapes and one longer
shape each, with the card and its power limit; B1 at Q 1/2/4/8/64 on the
full bank and on the main path's lane_rows, with its route; B3 and B4 at
each engine's shapes, B4's with its route, B3's with its splits and grid;
B4 at (192, 128); B5's with its plan, CUDA kernels per call
and both its bf16 and FP32 bounds), ``model:`` per model
(full-width float32 model on the card against the CPU; qwen3-8b,
gemma2-27b, gemma3-4b, zamba2-7b, llava and musicgen cut to one pattern
cycle, the cut printed), per engine
``engine:`` lines (full-width bfloat16 engine: the kernels' launches per
prefill and per decode step, counted before any timing loop, then prefill
and decode-step p50 and tokens/s) and ``profile: decode`` (one decode step's
device time by kernel, kernels per step and busy share), after the qwen
engine's an ``engine: qwen1.5-0.5b long`` line (its model calls with a
[4, 8192] cache: a 2048-token prefill's and a decode step's p50 at
pos = 8191, beside B4's and B3's device ms per call), after the mamba2
engine's an ``engine: mamba2-1.3b long`` line (a 2048-token prefill's p50
and device ms, B5's device ms and kernels per call), ``fill:``,
``traffic:`` per replay (hits, generative hits, misses served by the
engine, latency p50s and the 5x gate, launch counts: MockLLM, then the
qwen1.5, mamba2, qwen3-8b and zamba2-7b engines, the last two built, with
their ``engine:`` lines and zamba2's long line, just before their
replays), ``decide:`` (one
read's decisions recomputed with the plain version), ``read:`` (p50 of one
fused read per batch bucket), ``store:`` (B2's path: a single-store cache's
lookups, each store search one call of ``ops.similarity_topk``),
``sharded:`` (the sharded read path: the main path's L2 entries in a
``ShardedVectorStore`` over ``make_cache_mesh(8, device="cuda")``, 8
positions on the card; one read at B = 8 against the single-device fused
read over the same entries, decisions and candidates' payloads, and
against the same read on a CPU copy, decisions, global ids and counter
deltas, with one position dead (``shard_mask``) and with L2 on the
lifecycle route (TTLs and a staleness weight: L2 plain, L1 still B1);
``make_cache_mesh()``'s
one-card deployment, kernel route against plain; the read's p50 per
bucket B = 1..8; one read's device ms, busy share and launches, B1 once
and B2 once per position; 64 requests through ``CacheService`` over a
sharded hierarchy, misses answered by the qwen1.5-0.5b engine, with the
5x gate), the
``engine:`` lines of gemma2-27b, gemma3-4b (and its long line) and llava,
``engine: musicgen-large model-level``, then the MoE models' lines, last
so that the host copies of their float32 lines come after every
host-bound line above: ``moe:`` per MoE model and token count (one
full-width MoE layer in float32, card against CPU: expert flips above a
1e-4 score gap, drop fractions, outputs), their ``model:`` lines (cut to
4 layers, and to 1 dense + 1 MoE layer), their ``engine:`` and
``profile:`` lines and an ``engine: ... ModelBackend`` line each,
``kernels:`` (launches per kernel on the main path), then a JSON line of
kernel figures, the ``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``.
``--profile`` adds ``profile:`` lines after ``read:``: one fused read's
device time by kernel and the device's busy share. ``--attention-only``
runs only B3 and B4 (build, checks, times, the long-engine line),
``--topk-only`` only B1 and B2 (build, checks, times), ``--ssd-only`` only
B5 (build, checks, times, the long mamba2 prefill line), ``--arch-only``
only the dense, frontend and hybrid architectures' lines (B3/B4 checks
and times, their six ``model:``
lines, the qwen3-8b and zamba2-7b replays, the other engines),
``--moe-only`` only the MoE models' lines (B4 at (192, 128) and B3/B4 at
llama4's shapes, checked and timed; ``moe:``, ``model:``, ``engine:``,
``profile:``), ``--sharded-only`` only the ``sharded:`` lines (B1/B2
and B3/B4 built, the qwen1.5-0.5b engine for the replay), and
``--src DIR`` drives the repro_torch package under DIR instead of this
checkout's, so that another tree (a parent commit unpacked beside it) is
measured by the same code in the same run. Any failure raises, and
the exit code is then non-zero. It exits non-zero without a CUDA device,
and when the ``src/repro_torch`` package is not beside it.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12  # H100 SXM FP32 outside the tensor cores (no TF32)
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
TOL = 2e-5  # the reference kernel tests' tolerance (float32 sums in another order)
BF16_TOL = 2e-2  # the same tests' bfloat16 tolerance
MODEL_TOL = 1e-3  # float32 logits after 24 or 48 layers summed in another order
SSD_TOL = 1e-4  # the reference SSD kernel tests' float32 tolerance
L1_CAP, L2_CAP, DIM, TOPK = 16384, 131072, 768, 4
LLM = "qwen1.5-0.5b"
SSM_LLM = "mamba2-1.3b"
ENGINE_BATCH, ENGINE_SEQ, NEW_TOKENS = 4, 256, 16
PROMPT = 32  # ModelBackend pads every prompt to 32 tokens
LONG_SEQ, LONG_PROMPT = 8192, 2048  # the long-engine line: a RAG-sized prompt and cache
# the MoE models; neither fits one card whole (107.8 B and 671 B parameters),
# so each runs at full width cut in depth: (layers, leading dense layers),
# MTP off (it is not on the serving path)
MOE_ARCHS = ("llama4-scout-17b-a16e", "deepseek-v3-671b")
MOE_MODEL_CUTS = {MOE_ARCHS[0]: (4, 0), MOE_ARCHS[1]: (2, 1)}  # float32 model: lines
MOE_ENGINE_CUTS = {MOE_ARCHS[0]: (8, 0), MOE_ARCHS[1]: (5, 3)}  # bfloat16 engines
MOE_TOKENS = (4, 128)  # the moe: lines' token counts
# host memory the CPU run of a model: line needs beside its weights' copy
# (activations of a 32-token prefill, well under 1 GB at full width)
HOST_HEADROOM = 2e9


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def host_ms(fn, iters=20, warmup=3, windows=5):
    """CUDA events around ``iters`` back-to-back calls, the median of
    ``windows`` such windows: where a call's kernels are short, this reads
    how fast the host queues them, not the device (and the host's speed
    wanders, hence the median)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_trace(fn, bound_ms, iters=20, warmup=3, traces=3):
    """Device time of one call of ``fn`` and the CUDA kernels it launches:
    the summed durations of the kernels (copies and memsets included) it runs
    on the card, from a torch.profiler trace of ``iters`` calls, the kernels
    (copies and memsets not counted) per call, and the device ms of each
    kernel of a call in launch order. Now and then CUPTI hands back a trace
    with no device activity in it, or one that lost kernel records; a trace
    that reads below ``bound_ms``, the least time the card could take for the
    work, is taken again, and after ``traces`` such readings the time comes
    from ``queued_event_ms`` instead (kernels per call and per kernel then
    None), with a ``timer:`` line saying so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    read = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        ms = sum(e.device_time_total for e in events) / 1e3 / iters
        if ms > 0 and ms >= bound_ms:
            kernels = [e for e in events if not e.name.startswith(("Memcpy", "Memset"))]
            per = len(kernels) // iters
            each = [sum(e.device_time_total for e in kernels[i::per]) / 1e3 / iters
                    for i in range(per)] if per * iters == len(kernels) else None
            return ms, len(kernels) / iters, each
        read.append(ms)
    ms = queued_event_ms(fn, iters)
    print(f"timer: {traces} profiler traces read {', '.join(f'{t:.4f}' for t in read)} ms, "
          f"none at or above the bound {bound_ms:.4f} ms; CUDA events behind a spin kernel "
          f"read {ms:.4f} ms")
    return ms, None, None


def device_ms(fn, bound_ms, iters=20, warmup=3, traces=3):
    """``device_trace``'s time alone."""
    return device_trace(fn, bound_ms, iters, warmup, traces)[0]


def queued_event_ms(fn, iters=20):
    """Device time of one call of ``fn`` from CUDA events around ``iters``
    calls that the host queued while a spin kernel held the stream, so the
    events read the device running them back to back, not the host's rate."""
    import torch

    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * enqueue_s + 1e-3) * 2e9))  # ~2 GHz SM clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def has_lane_rows(kern):
    """Whether the tree's kernel takes ``lane_rows`` (and routes small Q to
    a streaming kernel); an older tree measured with ``--src`` does not."""
    return hasattr(kern, "split_plan")


def route_of(kern, Q, D, k):
    return kern.route(Q, D, k) if has_lane_rows(kern) else "tile"


def check_case(name, db, valid, q, k, kern, ops_kw=None, lane_rows=None):
    """Kernel vs plain on the same card tensors; raises on disagreement.
    Returns the max abs score error."""
    import torch

    if ops_kw is None:
        rows = () if lane_rows is None else (lane_rows,)
        s1, i1 = kern.similarity_topk_lanes_cuda(db, valid, q, k, *rows)
        s2, i2 = kern.similarity_topk_lanes_plain(db, valid, q, k, *rows)
        name += f" route={route_of(kern, q.shape[0], db.shape[2], k)}"
    else:
        from repro_torch.kernels.similarity_topk import ops

        s1, i1 = ops._similarity_topk_lanes(db, valid, q, k=k, **ops_kw)
        s2, i2 = ops._similarity_topk_lanes(
            db, valid, q, k=k, topk=kern.similarity_topk_lanes_plain, **ops_kw
        )
    torch.cuda.synchronize()
    s1, i1, s2, i2 = (t.cpu() for t in (s1, i1, s2, i2))
    finite = (s2 > -1e38) & torch.isfinite(s2)
    same_inf = torch.equal(~finite, (s1 <= -1e38) | ~torch.isfinite(s1))
    err = float((s1[finite] - s2[finite]).abs().max()) if finite.any() else 0.0
    close = torch.allclose(s1[finite], s2[finite], atol=TOL, rtol=TOL)
    idx_eq = torch.equal(i1[finite], i2[finite])
    ok = close and idx_eq and same_inf
    print(f"check: {name} max_abs_err={err:.3e} idx_equal={idx_eq} "
          f"tol={TOL} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {name}")
    return err


def kernel_checks(kern, dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    for Q in (1, 8, 64):  # the main-path shape, per batch bucket
        db = torch.randn((2, L2_CAP, DIM), generator=g, device=dev)
        db /= torch.linalg.vector_norm(db, dim=-1, keepdim=True)
        valid = torch.rand((2, L2_CAP), generator=g, device=dev) < 0.9
        valid[0, L1_CAP:] = False  # lane 0 is the 16384-slot L1
        q = torch.randn((Q, DIM), generator=g, device=dev)
        q /= torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        worst = max(worst, check_case(f"main L=2 N={L2_CAP} D={DIM} Q={Q} k={TOPK}",
                                      db, valid, q, TOPK, kern))
        del db
    db = torch.randn((3, 700, 128), generator=g, device=dev)
    valid = torch.rand((3, 700), generator=g, device=dev) < 0.9
    q = torch.randn((3, 128), generator=g, device=dev)
    check_case("ragged L=3 N=700 D=128 Q=3 k=5", db, valid, q, 5, kern)
    valid_none = valid.clone()
    valid_none[1] = False
    check_case("all-invalid lane L=3 N=700 k=5", db, valid_none, q, 5, kern)
    unit = db / torch.linalg.vector_norm(db, dim=-1, keepdim=True)
    mixed = torch.stack([unit[0], db[1], unit[2]])
    check_case("mixed cosine/dot lanes L=3 N=700 k=4", mixed, valid, q, 4, kern,
               ops_kw=dict(metric=("cosine", "dot", "cosine"), prenormalized=True))
    base = torch.randint(-4, 5, (40, 64), generator=g, device=dev).float() / 4
    ties = torch.cat([base, base, base])[None].repeat(2, 1, 1).contiguous()
    valid_t = torch.ones((2, 120), dtype=torch.bool, device=dev)
    valid_t[1, :40] = False
    qt = torch.randint(-4, 5, (6, 64), generator=g, device=dev).float() / 4
    check_case("exact ties (dyadic duplicated rows) L=2 N=120 k=6", ties, valid_t, qt, 6, kern)
    if has_lane_rows(kern):
        worst = max(worst, lane_rows_checks(kern, dev, g))
    return worst


def lane_rows_checks(kern, dev, g):
    """The cases of the streaming kernel and of ``lane_rows``: the main
    path's bank with lane 0's rows past L1_CAP marked valid (they must stay
    unread), Q on both sides of the small-Q threshold with every k class,
    exact ties a block and a warp stage apart, an all-invalid lane, fewer
    valid rows than k and a lane holding fewer rows than k."""
    import torch

    worst = 0.0
    caps = (L1_CAP, L2_CAP)
    for Q in (1, 8):
        db = torch.randn((2, L2_CAP, DIM), generator=g, device=dev)
        db /= torch.linalg.vector_norm(db, dim=-1, keepdim=True)
        valid = torch.rand((2, L2_CAP), generator=g, device=dev) < 0.9  # valid past L1_CAP too
        q = torch.randn((Q, DIM), generator=g, device=dev)
        worst = max(worst, check_case(
            f"main-path lane_rows={caps} L=2 N={L2_CAP} D={DIM} Q={Q} k={TOPK}",
            db, valid, q, TOPK, kern, lane_rows=caps))
        del db
    db = torch.randn((2, 4096, DIM), generator=g, device=dev)
    valid = torch.rand((2, 4096), generator=g, device=dev) < 0.9
    for Q in (1, 2, 3, 4, 8, 16, 17, 64):
        q = torch.randn((Q, DIM), generator=g, device=dev)
        for k in (1, 4, 16, kern.KMAX, kern.KMAX + 1):
            for rows in (None, (1000, 4096)):
                worst = max(worst, check_case(
                    f"sweep L=2 N=4096 D={DIM} Q={Q} k={k} lane_rows={rows}",
                    db, valid, q, k, kern, lane_rows=rows))
    L, N, D, Q, k = 4, 4096, 64, 5, 8
    per = kern.split_plan((N,) * L)[0][0]
    db = torch.randint(-4, 5, (L, N, D), generator=g, device=dev).float() / 4
    base = db[:, :64].clone()
    db[:, 64:128] = base  # other warps and stages of the same block
    db[:, per:per + 64] = base  # the next block
    valid = torch.rand((L, N), generator=g, device=dev) < 0.9
    valid[1] = False  # an all-invalid lane
    valid[2] = False
    valid[2, [3, 3 + per, 2000]] = True  # fewer valid rows than k
    valid[3, :5] = True
    q = torch.randint(-4, 5, (Q, D), generator=g, device=dev).float() / 4
    for rows in (None, (N, N, N, 5)):  # lane 3 holding fewer rows than k
        check_case(f"ties a block apart, invalid lane, few rows L={L} N={N} D={D} Q={Q} "
                   f"k={k} lane_rows={rows}", db, valid, q, k, kern, lane_rows=rows)
    return worst


def kernel_times(kern, dev, gpu):
    """Kernel, plain and library device times per batch bucket, beside the
    card's bound for the same work and the kernel's host rate
    (``host_ms``), at two shapes of the [2, 131072, 768] bank: "full" (90%
    of every row valid, every row read) and "main-path" (the fused read's:
    lane 0 is the 16384-slot L1, nothing valid past it, and the kernel told
    so by ``lane_rows``; its bound counts the rows inside capacity). A tree
    without ``lane_rows`` reads the whole bank at the main-path shape too.
    Each line names the route (streaming or tile kernel) the call took."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    db = torch.randn((2, L2_CAP, DIM), generator=g, device=dev)
    db /= torch.linalg.vector_norm(db, dim=-1, keepdim=True)
    valid_full = torch.rand((2, L2_CAP), generator=g, device=dev) < 0.9
    valid_main = valid_full.clone()
    valid_main[0, L1_CAP:] = False
    L, N, D = db.shape
    out = {}
    for shape, valid, caps in (("full", valid_full, (N, N)),
                               ("main-path", valid_main, (L1_CAP, L2_CAP))):
        rows = (caps,) if has_lane_rows(kern) and shape == "main-path" else ()
        for Q in (1, 2, 4, 8, 64):
            q = torch.randn((Q, DIM), generator=g, device=dev)
            held = sum(caps)  # rows inside capacity: what the read must stream
            bound, by = _bound(held * D * 4 + held + q.numel() * 4 + 2 * L * Q * TOPK * 4,
                               2 * Q * held * D, FP32_FLOP_PER_S)
            k_ms = device_ms(lambda: kern.similarity_topk_lanes_cuda(db, valid, q, TOPK, *rows),
                             bound)
            h_ms = host_ms(lambda: kern.similarity_topk_lanes_cuda(db, valid, q, TOPK, *rows))
            p_ms = device_ms(lambda: kern.similarity_topk_lanes_plain(db, valid, q, TOPK, *rows),
                             bound, iters=5)

            def library():
                s = torch.matmul(q.unsqueeze(0), db.transpose(1, 2))
                return torch.topk(s.masked_fill(~valid[:, None, :], float("-inf")), TOPK, dim=-1)

            l_ms = device_ms(library, bound, iters=10)
            out[shape, Q] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound,
                                 bound_by=by)
            print(f"time: similarity_topk_lanes {shape} L=2 N={N} D={D} lane_rows={caps} "
                  f"Q={Q} k={TOPK} route={route_of(kern, Q, D, TOPK)} "
                  f"kernel_ms={k_ms:.4f} kernel_host_ms={h_ms:.4f} plain_ms={p_ms:.4f} "
                  f"library_ms={l_ms:.4f} "
                  f"bound_ms={bound:.4f} ({by}) share_of_bound={bound / k_ms:.3f} [{gpu}]")
    return out


def build_all(only=None):
    """One nvcc per CUDA source, all started together; prints each
    library's build time. ``only`` = "attention", "topk", "ssd" or
    "sharded" (B1/B2 and B3/B4) builds those kernels' libraries alone."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.similarity_topk import kernel as tk
    from repro_torch.kernels.ssd_scan import kernel as sk

    def timed(lib):
        t0 = time.perf_counter()
        lib.build()
        return lib.src.name, time.perf_counter() - t0

    libs = {"attention": [fk.LIB, dk.LIB], "topk": [tk.LIB], "ssd": [sk.LIB],
            "sharded": [tk.LIB, fk.LIB, dk.LIB]}.get(
        only, [tk.LIB, fk.LIB, dk.LIB, sk.LIB])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as ex:
        done = list(ex.map(timed, libs))
    for name, sec in done:
        print(f"build: {name} nvcc sm_90a {sec:.2f} s")
    print(f"build: all {len(libs)} libraries {time.perf_counter() - t0:.2f} s wall")


def close_check(name, got, want, tol):
    """Kernel output against its plain version on the same card tensors;
    raises on disagreement. Returns the max abs error."""
    import torch

    torch.cuda.synchronize()
    got, want = got.float().cpu(), want.float().cpu()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    ok = bool(torch.isfinite(got).all()) and torch.allclose(got, want, atol=tol, rtol=tol)
    print(f"check: {name} max_abs_err={err:.3e} tol={tol} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {name}")
    return err


def b2_checks(kern, dev):
    """B2, the single-store form: ops.similarity_topk launches the lanes
    kernel at L = 1; held against the same lookup through the plain version."""
    import torch

    from repro_torch.kernels.similarity_topk import ops

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    worst = 0.0
    # the first case is the store search's: unit cosine rows, prenormalized
    for (N, D, Q, k, metric, pre) in ((L2_CAP, DIM, 8, TOPK, "cosine", True),
                                      (700, 128, 3, 5, "dot", False),
                                      (2048, 768, 8, 4, "cosine", False)):
        db = torch.randn((N, D), generator=g, device=dev)
        if pre:
            db /= torch.linalg.vector_norm(db, dim=-1, keepdim=True)
        valid = torch.rand((N,), generator=g, device=dev) < 0.9
        q = torch.randn((Q, D), generator=g, device=dev)
        before = (kern.launches, ops.single_store_launches)
        s1, i1 = ops.similarity_topk(db, valid, q, k=k, metric=metric, prenormalized=pre)
        if (kern.launches, ops.single_store_launches) != (before[0] + 1, before[1] + 1):
            raise AssertionError("similarity_topk did not launch the lanes kernel once")
        s2, i2 = ops._similarity_topk_lanes(db[None], valid[None], q, k=k, metric=(metric,),
                                            prenormalized=pre,
                                            topk=kern.similarity_topk_lanes_plain)
        name = f"B2 similarity_topk N={N} D={D} Q={Q} k={k} {metric} prenormalized={pre}"
        worst = max(worst, close_check(name, s1, s2[:, 0], TOL))
        if not torch.equal(i1.cpu(), i2[:, 0].cpu()):
            raise AssertionError(f"indices differ: {name}")
    return worst


# llama4-scout-17b-a16e's attention: H 40 over KH 8 (G = 5, the first group
# on a path that is no power of two), Dh 128, its local layers' window 8192
MOE_FLASH_CASES = [
    # B, S, H, KH, Dh, window, softcap, causal
    (1, PROMPT, 40, 8, 128, 8192, 0.0, True),
    (1, 2048, 40, 8, 128, 8192, 0.0, True),
    (1, 77, 40, 8, 128, 0, 0.0, True),  # its NoPE-global layers: no window
]
MOE_DECODE_CASES = [
    # B, S, H, KH, Dh, window, softcap, lengths
    (ENGINE_BATCH, ENGINE_SEQ, 40, 8, 128, 8192, 0.0, (1, 17, 256, 40)),
    (ENGINE_BATCH, 9000, 40, 8, 128, 8192, 0.0, (9000, 8193, 100, 1)),  # the window bites
    (ENGINE_BATCH, 8192, 40, 8, 128, 0, 0.0, (8192, 1, 5000, 8191)),
]
# B4 with its own value width: deepseek-v3-671b's MLA prefill, q/k 192 and
# v 128, H = KH = 128, causal, scale 1/sqrt(192)
FLASH_PAIR_CASES = [
    # B, S, H, Dh, Dv
    (1, PROMPT, 128, 192, 128),
    (1, 2048, 128, 192, 128),
    (2, 77, 128, 192, 128),
]
FLASH_CASES = [
    # B, S, H, KH, Dh, window, softcap, causal
    (1, PROMPT, 16, 16, 64, 0, 0.0, True),  # the main path's prefill
    (1, 100, 8, 2, 64, 0, 0.0, True),  # ragged S (not a multiple of the 64-row tile), GQA
    (2, 256, 8, 2, 64, 0, 0.0, True),  # GQA
    (2, 512, 4, 1, 64, 128, 50.0, True),  # MQA + window + softcap
    (1, 128, 4, 4, 128, 0, 30.0, True),  # softcap, Dh 128
    (2, 77, 4, 2, 16, 7, 0.0, True),  # ragged + window, Dh 16 (the smoke model's)
    (1, 2048, 16, 16, 64, 0, 0.0, True),  # the longer shape
    # the wide heads: gemma3-4b's (Dh 256, G = 2; its local layers' window of
    # 1024 bites at S = 2048) and zamba2-7b's shared attention (Dh 224, G = 1)
    (1, PROMPT, 8, 4, 256, 0, 0.0, True),
    (1, 2048, 8, 4, 256, 1024, 0.0, True),
    (1, PROMPT, 32, 32, 224, 0, 0.0, True),
    (1, 2048, 32, 32, 224, 0, 0.0, True),
    (2, 300, 8, 2, 224, 100, 50.0, True),  # G = 4, ragged, window + softcap
    (2, 100, 8, 2, 256, 0, 30.0, False),  # G = 4, non-causal
] + MOE_FLASH_CASES + [  # every head width, S around and past the tile: plain, window + softcap, non-causal
    (1, S, 4, 2, Dh, w, cap, causal) for Dh in (16, 32, 64, 128, 224, 256)
    for S in (1, 63, 65, 100, 2048)
    for w, cap, causal in ((0, 0.0, True), (48, 30.0, True), (0, 0.0, False))
]
DECODE_CASES = [
    # B, S, H, KH, Dh, window, softcap, lengths
    (ENGINE_BATCH, ENGINE_SEQ, 16, 16, 64, 0, 0.0, (1, 17, 256, 40)),  # the main path's decode
    (2, 512, 8, 2, 64, 0, 0.0, (256, 170)),  # GQA
    (3, 1024, 8, 8, 32, 256, 0.0, (512, 341, 256)),  # window
    (2, 512, 4, 1, 64, 128, 50.0, (1, 512)),  # MQA + window + softcap
    (2, 300, 4, 4, 128, 0, 0.0, (0, 299)),  # an empty sequence gives zeros
    (ENGINE_BATCH, 8192, 16, 16, 64, 0, 0.0, (8192,) * 4),  # the longer shape
    # head groups over a split cache: G = 2, 4, 8 (GQA), 8 and 16 (MQA), 3
    (2, 4096, 16, 8, 64, 0, 30.0, (4096, 1234)),
    (2, 4096, 16, 4, 64, 0, 30.0, (4096, 1234)),
    (2, 4096, 16, 2, 64, 0, 30.0, (4096, 1234)),
    (2, 4096, 8, 1, 64, 0, 30.0, (4096, 1234)),
    (2, 4096, 16, 1, 64, 0, 30.0, (4096, 1234)),
    (2, 4096, 6, 2, 64, 0, 30.0, (4096, 1234)),
    # the wide heads at the engines' decode (zamba2-7b G = 1, gemma3-4b G = 2),
    # G = 4 with a window and a softcap, an empty sequence, and the long caches
    (ENGINE_BATCH, ENGINE_SEQ, 32, 32, 224, 0, 0.0, (1, 17, 256, 40)),
    (ENGINE_BATCH, ENGINE_SEQ, 8, 4, 256, 0, 0.0, (1, 17, 256, 40)),
    (2, 512, 8, 2, 224, 128, 50.0, (1, 512)),
    (2, 512, 8, 2, 256, 100, 30.0, (1, 512)),
    (2, 300, 8, 8, 256, 0, 0.0, (0, 299)),
    (ENGINE_BATCH, 8192, 32, 32, 224, 0, 0.0, (8192,) * 4),
    (ENGINE_BATCH, 8192, 8, 4, 256, 1024, 0.0, (8192, 1, 5000, 8191)),
] + MOE_DECODE_CASES


def decode_split_cases(dk, dtype, B=ENGINE_BATCH, S=8192, H=16, Dh=64, KH=None):
    """B3 over a split cache (the longer shape): lengths ending at a split
    boundary, one row before and after it; 0, 1 and S; a window that
    straddles a boundary. The boundary comes from the kernel's own plan
    (none for a tree without one)."""
    KH = KH or H
    if not hasattr(dk, "split_plan"):
        return []
    rows = dk.split_plan(B, KH, S, Dh, dtype)[1]
    return [(B, S, H, KH, Dh, 0, 0.0, (rows, rows - 1, rows + 1, 2 * rows)),
            (B, S, H, KH, Dh, 0, 0.0, (0, 1, S, S - 1)),
            (B, S, H, KH, Dh, 700, 0.0, (rows + 300, 2 * rows + 10, S, 1))]


def wide_split_cases(dk, dtype):
    """``decode_split_cases`` at the wide heads: zamba2-7b's (Dh 224, G = 1)
    and gemma3-4b's (Dh 256, G = 2)."""
    return (decode_split_cases(dk, dtype, H=32, Dh=224)
            + decode_split_cases(dk, dtype, H=8, KH=4, Dh=256))


def attention_checks(dev, flash_cases=FLASH_CASES, decode_cases=DECODE_CASES,
                     pair_cases=FLASH_PAIR_CASES, split=True):
    """B4 (flash) and B3 (decode) against their plain versions on the card,
    float32 at 2e-5 and bfloat16 at 2e-2: ``flash_cases``, B4 with its own
    value width at ``pair_cases``, ``decode_cases`` and, with ``split``,
    the split-boundary cases. Returns the worst error of each."""
    import torch

    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    worst = {"flash": 0.0, "decode": 0.0}
    skipped = sorted({c[4] for c in flash_cases + decode_cases
                      if c[4] not in fk.HEAD_DIMS or c[4] not in dk.HEAD_DIMS})
    if skipped:  # an older tree measured with --src
        print(f"check: head widths {skipped} skipped: this tree's kernels build "
              f"{fk.HEAD_DIMS} (B4) and {dk.HEAD_DIMS} (B3)")
    pairs = getattr(fk, "WIDTH_PAIRS", ())
    if any(c[3:] not in pairs for c in pair_cases):
        print(f"check: B4 width pairs skipped: this tree's kernel builds {pairs}")
    for dt, tol in ((torch.float32, TOL), (torch.bfloat16, BF16_TOL)):
        tag = "f32" if dt == torch.float32 else "bf16"
        for B, S, H, Dh, Dv in pair_cases:
            if (Dh, Dv) not in pairs:
                continue
            q, k = (torch.randn((B, S, H, Dh), generator=g, device=dev).to(dt) for _ in "qk")
            v = torch.randn((B, S, H, Dv), generator=g, device=dev).to(dt)
            got = fk.flash_attention_cuda(q, k, v, scale=Dh ** -0.5)
            want = fk.flash_attention_plain(q, k, v, scale=Dh ** -0.5)
            err = close_check(f"B4 flash {tag} B={B} S={S} H={H} KH={H} q/k={Dh} v={Dv} "
                              f"causal=True (MLA prefill)", got, want, tol)
            worst["flash"] = max(worst["flash"], err)
            worst[f"flash {tag}"] = max(worst.get(f"flash {tag}", 0.0), err)
            del q, k, v, got, want
        for B, S, H, KH, Dh, w, cap, causal in flash_cases:
            if Dh not in fk.HEAD_DIMS:
                continue
            q, k, v = (torch.randn((B, S, n, Dh), generator=g, device=dev).to(dt)
                       for n in (H, KH, KH))
            got = fk.flash_attention_cuda(q, k, v, causal=causal, window=w, softcap=cap)
            want = fk.flash_attention_plain(q, k, v, causal=causal, window=w, softcap=cap)
            name = (f"B4 flash {tag} B={B} S={S} H={H} KH={KH} Dh={Dh} window={w} "
                    f"softcap={cap} causal={causal}")
            err = close_check(name, got, want, tol)
            worst["flash"] = max(worst["flash"], err)
            worst[f"flash {tag}"] = max(worst.get(f"flash {tag}", 0.0), err)
        split = decode_split_cases(dk, dt) if split else []
        if split and 224 in dk.HEAD_DIMS:
            split += wide_split_cases(dk, dt)
        for B, S, H, KH, Dh, w, cap, lens in decode_cases + split:
            if Dh not in dk.HEAD_DIMS:
                continue
            q = torch.randn((B, H, Dh), generator=g, device=dev).to(dt)
            k, v = (torch.randn((B, S, KH, Dh), generator=g, device=dev).to(dt) for _ in "kv")
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            got = dk.decode_attention_cuda(q, k, v, lengths, window=w, softcap=cap)
            want = dk.decode_attention_plain(q, k, v, lengths, window=w, softcap=cap)
            splits = getattr(dk, "num_splits", lambda *a: 1)(B, KH, S, Dh, dt)
            name = (f"B3 decode {tag} B={B} S={S} H={H} KH={KH} Dh={Dh} window={w} "
                    f"softcap={cap} lengths={list(lens)} splits={splits}")
            err = close_check(name, got, want, tol)
            worst["decode"] = max(worst["decode"], err)
            worst[f"decode {tag}"] = max(worst.get(f"decode {tag}", 0.0), err)
    print("check: worst " + " ".join(f"{k.replace(' ', '_')}={v:.3e}"
                                     for k, v in worst.items() if " " in k))
    return worst


def _bound(nbytes, flops, flop_rate):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# B4 time lines: (model, B, S, H, KH, Dh, window); the first two are the
# qwen1.5-0.5b engine's (the JSON line's), then the engines' of this slice
FLASH_TIMES = [
    (LLM, 1, PROMPT, 16, 16, 64, 0), (LLM, 1, 2048, 16, 16, 64, 0),
    ("qwen3-8b", 1, PROMPT, 32, 8, 128, 0), ("qwen3-8b", 1, 2048, 32, 8, 128, 0),
    ("gemma3-4b", 1, PROMPT, 8, 4, 256, 0), ("gemma3-4b", 1, 2048, 8, 4, 256, 0),
    ("gemma3-4b local", 1, 2048, 8, 4, 256, 1024),
    ("zamba2-7b", 1, PROMPT, 32, 32, 224, 0), ("zamba2-7b", 1, 2048, 32, 32, 224, 0),
] + [(MOE_ARCHS[0], 1, S, 40, 8, 128, 8192) for S in (PROMPT, 2048)]
# B4 with its own value width: (model, B, S, H, Dh, Dv), H = KH
PAIR_TIMES = [(MOE_ARCHS[1], 1, S, 128, 192, 128) for S in (PROMPT, 2048)]
# B3 time lines: (model, B, S, H, KH, Dh, window, lengths)
ENGINE_LENS = (48, 40, 33, 1)  # the traffic's lengths at a decode step
DECODE_TIMES = [
    (LLM, ENGINE_BATCH, ENGINE_SEQ, 16, 16, 64, 0, ENGINE_LENS),
    (LLM, ENGINE_BATCH, 8192, 16, 16, 64, 0, (8192,) * 4),
    ("qwen3-8b", ENGINE_BATCH, ENGINE_SEQ, 32, 8, 128, 0, ENGINE_LENS),
    ("qwen3-8b", ENGINE_BATCH, 8192, 32, 8, 128, 0, (8192,) * 4),
    ("gemma3-4b", ENGINE_BATCH, ENGINE_SEQ, 8, 4, 256, 0, ENGINE_LENS),
    ("gemma3-4b", ENGINE_BATCH, 8192, 8, 4, 256, 0, (8192,) * 4),
    ("gemma3-4b local", ENGINE_BATCH, 8192, 8, 4, 256, 1024, (8192,) * 4),
    ("zamba2-7b", ENGINE_BATCH, ENGINE_SEQ, 32, 32, 224, 0, ENGINE_LENS),
    ("zamba2-7b", ENGINE_BATCH, 8192, 32, 32, 224, 0, (8192,) * 4),
] + [(MOE_ARCHS[0], ENGINE_BATCH, ENGINE_SEQ, 40, 8, 128, 8192, ENGINE_LENS),
     (MOE_ARCHS[0], ENGINE_BATCH, 8192, 40, 8, 128, 8192, (8192,) * 4),
     (MOE_ARCHS[0] + " global", ENGINE_BATCH, 8192, 40, 8, 128, 0, (8192,) * 4)]


def flash_bound(B, S, H, KH, Dh, window, Dv=None):
    """The card's least time for causal prefill attention: q, k, v read once
    and o written once, against 2 (Dh + Dv) FLOP per (query, key) pair a
    query attends to (the causal pairs, cut to the window); Dv = Dh but for
    MLA's value width."""
    Dv = Dv or Dh
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(S))
    return _bound(2 * (B * S * H * (Dh + Dv) + B * S * KH * (Dh + Dv)),
                  2 * B * H * (Dh + Dv) * pairs, BF16_FLOP_PER_S)


def decode_bound(B, H, KH, Dh, window, lens):
    """The card's least time for one decode step's attention: the live K/V
    rows (inside the window) read once, q read and o written once, the
    lengths, against 4 Dh FLOP per (query head, live row)."""
    rows = sum(min(n, window) if window else n for n in lens)
    return _bound(2 * rows * KH * Dh * 2 + 2 * B * H * Dh * 2 + B * 4,
                  4 * H * Dh * rows, BF16_FLOP_PER_S)


def attention_times(dev, gpu, flash_times=FLASH_TIMES, decode_times=DECODE_TIMES,
                    pair_times=PAIR_TIMES):
    """Kernel, plain and library device times (bfloat16, the engines'
    dtype), and the kernel's host rate, for B4 at each engine's prefill
    (B=1, S=32) and at S=2048, B4 with MLA's value width at the same S, and
    for B3 at each engine's decode (B=4, S=256, the traffic's lengths) and
    at S=8192 (``FLASH_TIMES``, ``PAIR_TIMES``, ``DECODE_TIMES``); bounds
    count the keys each query really attends to.
    The library is ``scaled_dot_product_attention`` (a yardstick only: the
    port never calls it). Shapes whose head width this
    tree's kernels do not build are skipped. Returns the figures of the
    qwen1.5-0.5b engine's shapes, keyed ("flash" | "decode", S)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    bf16 = torch.bfloat16
    out = {}
    for model, B, S, H, Dh, Dv in pair_times:
        if (Dh, Dv) not in getattr(fk, "WIDTH_PAIRS", ()):
            continue
        q, k = (torch.randn((B, S, H, Dh), generator=g, device=dev).to(bf16) for _ in "qk")
        v = torch.randn((B, S, H, Dv), generator=g, device=dev).to(bf16)
        bound, by = flash_bound(B, S, H, H, Dh, 0, Dv)
        sc = Dh ** -0.5
        k_ms = device_ms(lambda: fk.flash_attention_cuda(q, k, v, scale=sc), bound)
        h_ms = host_ms(lambda: fk.flash_attention_cuda(q, k, v, scale=sc))
        p_ms = device_ms(lambda: fk.flash_attention_plain(q, k, v, scale=sc), bound, iters=5)
        l_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True, scale=sc),
            bound)
        print(f"time: flash_attention {model} bf16 B={B} S={S} H={H} KH={H} q/k={Dh} v={Dv} "
              f"window=0 causal route=wgmma (q/k tiles {Dh}, v tiles {Dv}) kernel_ms={k_ms:.4f} "
              f"kernel_host_ms={h_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
              f"bound_ms={bound:.4f} ({by}) share_of_bound={bound / k_ms:.3f} [{gpu}]")
        del q, k, v
    for model, B, S, H, KH, Dh, w in flash_times:
        if Dh not in fk.HEAD_DIMS:
            continue
        q, k, v = (torch.randn((B, S, n, Dh), generator=g, device=dev).to(bf16)
                   for n in (H, KH, KH))
        bound, by = flash_bound(B, S, H, KH, Dh, w)
        pos = torch.arange(S, device=dev)
        mask = (pos[None] <= pos[:, None]) & ((pos[None] > pos[:, None] - w) if w else True)
        k_ms = device_ms(lambda: fk.flash_attention_cuda(q, k, v, window=w), bound)
        h_ms = host_ms(lambda: fk.flash_attention_cuda(q, k, v, window=w))
        p_ms = device_ms(lambda: fk.flash_attention_plain(q, k, v, window=w), bound, iters=5)
        sdpa = dict(is_causal=True) if not w else dict(attn_mask=mask)
        l_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), enable_gqa=KH != H,
            **sdpa), bound)
        if model == LLM:
            out["flash", S] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound,
                                   bound_by=by)
        route = "wgmma" if Dh % 64 == 0 else "wgmma (padded to 256)" if Dh > 128 else "mma.sync"
        print(f"time: flash_attention {model} bf16 B={B} S={S} H={H} KH={KH} Dh={Dh} "
              f"window={w} causal route={route} kernel_ms={k_ms:.4f} kernel_host_ms={h_ms:.4f} "
              f"plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
              f"bound_ms={bound:.4f} ({by}) share_of_bound={bound / k_ms:.3f} [{gpu}]")
    for model, B, S, H, KH, Dh, w, lens in decode_times:
        if Dh not in dk.HEAD_DIMS:
            continue
        q = torch.randn((B, H, Dh), generator=g, device=dev).to(bf16)
        k, v = (torch.randn((B, S, KH, Dh), generator=g, device=dev).to(bf16) for _ in "kv")
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        pos = torch.arange(S, device=dev)[None]
        mask = pos < lengths[:, None]
        if w:
            mask &= pos > lengths[:, None] - 1 - w
        mask = mask[:, None, None, :]
        bound, by = decode_bound(B, H, KH, Dh, w, lens)
        k_ms = device_ms(lambda: dk.decode_attention_cuda(q, k, v, lengths, window=w), bound)
        h_ms = host_ms(lambda: dk.decode_attention_cuda(q, k, v, lengths, window=w))
        p_ms = device_ms(lambda: dk.decode_attention_plain(q, k, v, lengths, window=w), bound,
                         iters=5)
        l_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=KH != H), bound)
        if model == LLM:
            out["decode", S] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound,
                                    bound_by=by)
        if hasattr(dk, "launch_grid"):
            (gx, ns), threads = dk.launch_grid(B, H, KH, S, Dh, bf16)
            grid = f"splits={ns} grid=({gx},{ns})x{threads}"
        else:
            grid = "splits=n/a grid=n/a"
        print(f"time: decode_attention {model} bf16 B={B} S={S} H={H} KH={KH} Dh={Dh} "
              f"window={w} lengths={list(lens)} {grid} kernel_ms={k_ms:.4f} "
              f"kernel_host_ms={h_ms:.4f} plain_ms={p_ms:.4f} "
              f"library_ms={l_ms:.4f} bound_ms={bound:.4f} ({by}) "
              f"share_of_bound={bound / k_ms:.3f} [{gpu}]")
    return out


SSD_CASES = [
    # B, S, H, G, P, N, chunk
    (1, PROMPT, 64, 1, 64, 128, 256),  # the engine's prefill (mamba2-1.3b, ngroups 1)
    (1, 300, 64, 1, 64, 128, 256),  # ragged: two chunks, the second partial
    (1, 256, 64, 1, 64, 128, 256),  # S = L: the longest one-chunk (one-launch) call
    (1, 257, 64, 1, 64, 128, 256),  # S = L + 1: the shortest of more chunks (three launches)
    (1, 1, 64, 1, 64, 128, 256),  # S = 1
    (1, 2048, 64, 1, 64, 128, 256),  # the longer shape: 8 chunks
    (2, 100, 64, 64, 64, 128, 64),  # B/C per head (the reference's repeated layout)
    (2, 77, 16, 4, 32, 16, 32),  # groups of 4 heads, ragged, the smoke model's widths
]


def ssd_inputs(B, S, H, G, P, N, dtype, g):
    """x, Bm, Cm (``dtype``), dt (post-softplus), A (< 0), D (float32)."""
    import torch
    import torch.nn.functional as F

    dev = g.device
    x = torch.randn((B, S, H, P), generator=g, device=dev).to(dtype)
    Bm, Cm = ((0.5 * torch.randn((B, S, G, N), generator=g, device=dev)).to(dtype)
              for _ in "BC")
    dt = F.softplus(torch.randn((B, S, H), generator=g, device=dev) - 1.0)
    A = -torch.exp(0.3 * torch.randn((H,), generator=g, device=dev))
    D = torch.randn((H,), generator=g, device=dev)
    return x, Bm, Cm, dt, A, D


def ssd_checks(dev):
    """B5 against its plain version on the card: y within 1e-4 in float32
    and ``BF16_TOL`` in bfloat16, the float32 state within 1e-4. Returns the
    worst y error."""
    import torch

    from repro_torch.kernels.ssd_scan import kernel as sk

    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    worst = 0.0
    for dt_, tol in ((torch.float32, SSD_TOL), (torch.bfloat16, BF16_TOL)):
        tag = "f32" if dt_ == torch.float32 else "bf16"
        for B, S, H, G, P, N, chunk in SSD_CASES:
            args = ssd_inputs(B, S, H, G, P, N, dt_, g)
            y1, st1 = sk.ssd_scan_cuda(*args, chunk=chunk)
            y2, st2 = sk.ssd_scan_plain(*args, chunk=chunk)
            name = f"B5 ssd_scan {tag} B={B} S={S} H={H} G={G} P={P} N={N} chunk={chunk}"
            worst = max(worst, close_check(name + " y", y1, y2, tol))
            close_check(name + " state", st1, st2, SSD_TOL)
    return worst


def ssd_flops(S, H, G, P, N, L):
    """FLOP of one scan at batch 1, counting the causal half of each chunk's
    [L, L] products (the pairs s <= l) as the attention bounds do. C B^T
    depends only on the B/C group, so it counts once per group (over N);
    each head adds the inter-chunk term and the state update (2 L P N each),
    its scores times x (the causal pairs, over P) and the skip term."""
    total = 0
    for c0 in range(0, S, L):
        lc = min(L, S - c0)
        total += G * N * lc * (lc + 1) + H * (4 * lc * P * N + P * lc * (lc + 1) + 2 * lc * P)
    return total


def ssd_times(dev, gpu):
    """B5 in bfloat16 at the engine's prefill (S = 32) and at S = 2048, at
    mamba2-1.3b's widths with its B/C groups unrepeated: kernel and plain
    device times, the CUDA kernels per call, the kernel's host rate and two
    bounds: ``bound_ms`` with the products at the bf16 tensor-core rate (the
    kernel's) and ``fp32_bound_ms`` at the FP32 rate (the figure kept since
    the first port, for continuity). No single PyTorch call computes the
    scan: the library time is none."""
    import torch

    from repro_torch.kernels.ssd_scan import kernel as sk

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    out = {}
    H, G, P, N, chunk = 64, 1, 64, 128, 256
    for S in (PROMPT, 2048):
        args = x, Bm, Cm, dt, A, D = ssd_inputs(1, S, H, G, P, N, torch.bfloat16, g)
        nbytes = (2 * x.numel() * 2 + (Bm.numel() + Cm.numel()) * 2 + dt.numel() * 4
                  + 2 * H * 4 + H * P * N * 4)  # x in, y out, B/C, dt, A/D, state out
        flops = ssd_flops(S, H, G, P, N, min(chunk, S))
        bound, by = _bound(nbytes, flops, BF16_FLOP_PER_S)
        fp32_bound, fp32_by = _bound(nbytes, flops, FP32_FLOP_PER_S)
        k_ms, kernels, each = device_trace(lambda: sk.ssd_scan_cuda(*args, chunk=chunk), bound)
        h_ms = host_ms(lambda: sk.ssd_scan_cuda(*args, chunk=chunk))
        p_ms = device_ms(lambda: sk.ssd_scan_plain(*args, chunk=chunk), bound, iters=5)
        out[S] = dict(ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=bound, bound_by=by)
        plan = sk.plan(1, S, H, P, N, chunk) if hasattr(sk, "plan") else None
        route = "n/a" if plan is None else (
            f"chunks={plan.chunks} warps={plan.warps} p_slice={plan.p_slice} "
            f"blocks={plan.out_blocks}+{plan.state_blocks}")
        print(f"time: ssd_scan bf16 B=1 S={S} H={H} G={G} P={P} N={N} chunk={chunk} {route} "
              f"cuda_kernels_per_call={'n/a' if kernels is None else f'{kernels:g}'} "
              f"kernel_ms_each={'n/a' if each is None else '/'.join(f'{t:.4f}' for t in each)} "
              f"kernel_ms={k_ms:.4f} kernel_host_ms={h_ms:.4f} plain_ms={p_ms:.4f} "
              f"library_ms=none bound_ms={bound:.4f} ({by}, bf16 tensor cores) "
              f"fp32_bound_ms={fp32_bound:.4f} ({fp32_by}, FP32) MB={nbytes / 1e6:.2f} "
              f"GFLOP={flops / 1e9:.3f} share_of_bound={bound / k_ms:.3f} [{gpu}]")
    return out


def b2_times(kern, dev, gpu, Q=1, N=L2_CAP):
    """B2 at its path's shape: one [N, 768] float32 store of unit rows
    searched for Q queries: one query over 131072 rows, as
    ``InMemoryVectorStore.search`` does, or a batch of 8 over one sharded
    position's 16384 rows, as the sharded read does."""
    import torch

    from repro_torch.kernels.similarity_topk import ops

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    db = torch.randn((N, DIM), generator=g, device=dev)
    db /= torch.linalg.vector_norm(db, dim=-1, keepdim=True)
    valid = torch.rand((N,), generator=g, device=dev) < 0.9
    q = torch.randn((Q, DIM), generator=g, device=dev)
    q /= torch.linalg.vector_norm(q, dim=-1, keepdim=True)

    def kernel():
        return ops.similarity_topk(db, valid, q, k=TOPK, metric="cosine", prenormalized=True)

    bound, by = _bound(db.numel() * 4 + valid.numel() + q.numel() * 4 + 2 * Q * TOPK * 4,
                       2 * Q * N * DIM, FP32_FLOP_PER_S)
    k_ms, h_ms = device_ms(kernel, bound), host_ms(kernel)
    p_ms = device_ms(lambda: kern.similarity_topk_lanes_plain(db[None], valid[None], q, TOPK),
                     bound, iters=5)
    l_ms = device_ms(lambda: torch.topk((q @ db.T).masked_fill(~valid[None], float("-inf")),
                                        TOPK, dim=-1), bound, iters=10)
    print(f"time: similarity_topk (B2, lanes kernel at L=1) N={N} D={DIM} Q={Q} "
          f"k={TOPK} route={route_of(kern, Q, DIM, TOPK)} "
          f"kernel_ms={k_ms:.4f} kernel_host_ms={h_ms:.4f} plain_ms={p_ms:.4f} "
          f"library_ms={l_ms:.4f} "
          f"bound_ms={bound:.4f} ({by}) share_of_bound={bound / k_ms:.3f} [{gpu}]")
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound, bound_by=by)


def cut_config(name, layers=None, dense=0, dtype=None):
    """``get_config(name)`` in ``dtype``, cut to ``layers`` layers; a MoE
    model's cut keeps ``dense`` leading dense layers and drops the MTP head
    (training only)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(name)
    kw = {"dtype": dtype} if dtype else {}
    if layers:
        kw["num_layers"] = layers
        if cfg.moe is not None:
            kw.update(moe=dataclasses.replace(cfg.moe, first_k_dense=dense), mtp_depth=0)
    return dataclasses.replace(cfg, **kw)


def cut_text(cfg):
    """How ``cfg`` is cut from its architecture's full depth."""
    from repro_torch.configs import get_config

    full = get_config(cfg.name)
    text = f"layers={cfg.num_layers}"
    if cfg.num_layers != full.num_layers:
        text += f" (cut from {full.num_layers})"
    if cfg.moe is not None:
        fkd = cfg.moe.first_k_dense
        text += (f" = {fkd} dense + {cfg.num_layers - fkd} MoE (full: {full.moe.first_k_dense}"
                 f" + {full.num_layers - full.moe.first_k_dense}) mtp_depth={cfg.mtp_depth}")
    return text


def host_available_bytes():
    """MemAvailable of this host (/proc/meminfo), in bytes."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable line")


def model_check(dev, name=LLM, steps=4, layers=None, patches=0, dense=0):
    """The full-width model ``name`` in float32 with one set of weights, on
    the card (kernels, TF32 off) and on the CPU (plain versions): one
    32-token prefill (after a prefix of ``patches`` projected patch
    embeddings for a vision model; [1, K, 32] codebook tokens for audio) and
    ``steps`` teacher-forced decode steps. ``layers`` cuts the depth (for
    the hybrid: Mamba2 blocks, one group of ``hybrid_period`` and its shared
    block; for a MoE model ``dense`` of them dense, ``cut_config``). Raises
    if a logit differs by more than ``MODEL_TOL``, or if greedy tokens differ
    where the CPU logits' top-2 gap exceeds 2e-3. The weights are drawn on
    the card (fast at full width) and copied to the CPU; where this host
    cannot hold the copy, a MoE model is cut to half its layers (at least
    one MoE layer) and the line says why."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    cfg = cut_config(name, layers, dense, "float32")
    cpu = torch.device("cpu")
    params_dev = T.init_params(cfg, SEED, device=dev)
    why = ""
    while cfg.moe is not None:
        need = sum(x.numel() * x.element_size() for x in _leaves(params_dev))
        avail = host_available_bytes()
        if need + HOST_HEADROOM < avail or cfg.num_layers == 1:
            break
        fkd = cfg.moe.first_k_dense // 2
        cfg = cut_config(name, max(cfg.num_layers // 2, fkd + 1), fkd, "float32")
        why += (f" [host RAM {avail / 1e9:.1f} GB available cannot hold the {need / 1e9:.1f} GB "
                f"copy: cut to {cfg.num_layers} layers]")
        del params_dev
        free_card()
        params_dev = T.init_params(cfg, SEED, device=dev)
    params_cpu = _tree_to(params_dev, cpu)
    rng = np.random.default_rng(SEED)
    lead = (1, cfg.num_codebooks) if cfg.modality == "audio" else (1,)
    toks = rng.integers(0, cfg.vocab_size, lead + (PROMPT + steps,))
    vision = rng.standard_normal((1, patches, cfg.d_frontend)).astype(np.float32)
    worst, flips, runs = 0.0, 0, []
    for params, d in ((params_dev, dev), (params_cpu, cpu)):
        cache = T.init_cache(cfg, 1, ENGINE_SEQ, device=d)
        t = torch.as_tensor(toks, device=d)
        batch = {"tokens": t[..., :PROMPT]}
        if patches:
            batch["vision_embeds"] = torch.as_tensor(vision, device=d)
        logits, _ = T.prefill(params, cfg, batch, cache)
        out = [logits.cpu()]
        for i in range(steps):
            pos = torch.tensor([patches + PROMPT + i], device=d)
            logits, _ = T.decode_step(params, cfg, t[..., PROMPT + i:PROMPT + i + 1], pos, cache)
            out.append(logits.cpu())
        runs.append(out)
        del cache
    for got, want in zip(*runs):
        worst = max(worst, float((got - want).abs().max()))
        top2 = torch.topk(want, 2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) > 2e-3
        flips += int((decided & (got.argmax(-1) != want.argmax(-1))).sum())
    finite = all(bool(torch.isfinite(x).all()) for x in runs[0])
    cut = cut_text(cfg) + why
    if cfg.family == "hybrid":
        cut += f" = {cfg.num_layers // cfg.hybrid_period} group(s) of {cfg.hybrid_period} " \
               f"Mamba2 blocks + a shared block"
    extra = f" vision_patches={patches}" if patches else ""
    if cfg.modality == "audio":
        extra += f" codebooks={cfg.num_codebooks} logits={list(runs[0][0].shape)}"
    if cfg.mla is not None:
        extra += f" mla=q/k {cfg.mla.qk_head_dim} v {cfg.mla.v_head_dim}"
    if cfg.moe is not None:
        extra += f" experts={cfg.moe.num_experts} top_k={cfg.moe.top_k}"
    print(f"model: {name} float32 {cut} d_model={cfg.d_model} head_dim={cfg.head_dim}{extra} "
          f"params={sum(x.numel() for x in _leaves(params_cpu))} prefill S={PROMPT} + "
          f"{steps} decode steps, card (kernels) vs CPU (plain) max_abs_logit_err={worst:.3e} "
          f"tol={MODEL_TOL} greedy_flips={flips} finite={finite} "
          f"{time.perf_counter() - t0:.1f} s")
    if worst > MODEL_TOL or flips or not finite:
        raise AssertionError("the model on the card disagrees with its CPU run")
    return worst


# this slice's model: lines: (arch, layers it is cut to, vision patches)
ARCH_MODEL_CHECKS = [
    ("qwen3-8b", 2, 0), ("gemma2-27b", 2, 0), ("gemma3-4b", 6, 0), ("zamba2-7b", 6, 0),
    ("llava-next-mistral-7b", 2, 64), ("musicgen-large", 2, 0),
]


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def path_kernels(cfg):
    """The port's kernels a model's engine launches: kernel -> (the engine
    call it launches in, launches per call). Once per layer, except the
    hybrid's attention: once per group of ``hybrid_period`` Mamba2 blocks."""
    if cfg.family == "ssm":
        return {"ssd_scan": ("prefill", cfg.num_layers)}
    if cfg.family == "hybrid":
        groups = cfg.num_layers // cfg.hybrid_period
        return {"ssd_scan": ("prefill", cfg.num_layers), "flash_attention": ("prefill", groups),
                "decode_attention": ("decode_step", groups)}
    if cfg.mla is not None:  # MLA decodes in the latent space, without B3
        return {"flash_attention": ("prefill", cfg.num_layers),
                "decode_attention": ("decode_step", 0)}
    return {"flash_attention": ("prefill", cfg.num_layers),
            "decode_attention": ("decode_step", cfg.num_layers)}


def engine_kernels():
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_scan import kernel as sk

    return {"flash_attention": fk, "decode_attention": dk, "ssd_scan": sk}


def engine_launches():
    return {name: k.launches for name, k in engine_kernels().items()}


def reset_engine_launches():
    for k in engine_kernels().values():
        k.reset_launches()


def expected_launches(cfg, prefills, steps, on_card=True):
    """What each engine kernel must count for ``prefills`` prefills and
    ``steps`` decode steps of ``cfg``'s engine (0 for another family's
    kernels, and for all on the CPU, which runs the plain versions)."""
    want = dict.fromkeys(engine_kernels(), 0)
    if on_card:
        for name, (call, per) in path_kernels(cfg).items():
            want[name] = per * (prefills if call == "prefill" else steps)
    return want


def p50_ms(fn, n=15, warmup=3):
    """Median host-clock ms of ``fn`` run to completion on the card, after
    ``warmup`` calls (counted in the ``n``)."""
    import torch

    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ts[warmup:])


def engine_phase(dev, gpu, name=LLM, lengths=(5, 32, 12, 27, 9, 20), cfg=None):
    """ServingEngine for ``name`` (``cfg``, default its full config) at full
    width in bfloat16 on the card: prompts of ``lengths`` through
    ``generate``; the kernels' launches against the engine's own counts
    (printed before any timing loop), then prefill and decode-step p50 and
    tokens/s, and where one decode step's time goes. Returns the engine,
    warm, for the traffic."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine, slot_view

    cfg = cfg or get_config(name)
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, max_batch=ENGINE_BATCH, max_seq=ENGINE_SEQ, seed=SEED,
                           device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    engine.generate([rng.integers(0, cfg.vocab_size, 8)], max_new_tokens=2)  # warm-up
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lengths]
    reset_engine_launches()
    m0 = dict(engine.metrics)
    t1 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=NEW_TOKENS)
    wall = time.perf_counter() - t1
    steps = engine.metrics["decode_steps"] - m0["decode_steps"]
    got = engine_launches()  # read before the timing loops below
    want = expected_launches(cfg, len(prompts), steps, on_card=dev.type == "cuda")
    per = {"prefill": len(prompts), "decode_step": steps}
    print(f"engine: {name} launches={got} for prefills={len(prompts)} decode_steps={steps}: "
          + " ".join(f"{k}_per_{call}={got[k] / max(per[call], 1):g}"
                     for k, (call, _) in path_kernels(cfg).items()) + f" [{gpu}]")
    if got != want:
        raise AssertionError(f"engine kernel launches {got} != {want}")
    if [len(o) for o in outs] != [NEW_TOKENS] * len(prompts):
        raise AssertionError(f"generated lengths {[len(o) for o in outs]}")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError("a generated token lies outside the vocabulary")

    # the two model calls the engine makes, timed at its shapes
    slot = slot_view(engine.cache, 0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, PROMPT)), device=dev)

    def prefill():
        return T.prefill(engine.params, cfg, {"tokens": toks}, slot)

    step_toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (ENGINE_BATCH, 1)), device=dev)
    step_pos = torch.tensor([48, 40, 33, 0], device=dev)

    def decode():
        return T.decode_step(engine.params, cfg, step_toks, step_pos, engine.cache)

    pre_ms, dec_ms = p50_ms(prefill), p50_ms(decode)
    cut = f"{cut_text(cfg)} " if cfg != get_config(name) else ""
    print(f"engine: {name} bfloat16 {cut}params={sum(x.numel() for x in _leaves(engine.params))} "
          f"max_batch={ENGINE_BATCH} max_seq={ENGINE_SEQ} setup_s={setup_s:.1f} "
          f"prompts={[len(p) for p in prompts]} new_tokens={NEW_TOKENS} "
          f"decode_steps={steps} wall_s={wall:.3f} "
          f"tokens_per_s={len(prompts) * NEW_TOKENS / wall:.1f} "
          f"prefill_S{PROMPT}_p50_ms={pre_ms:.3f} decode_step_B{ENGINE_BATCH}_p50_ms={dec_ms:.3f} "
          f"[{gpu}]")
    profile_decode(decode, gpu, name)
    return engine


KERNEL_NAMES = {"flash_attention": "flash_fwd", "decode_attention": "decode_fwd",
                "ssd_scan": "ssd_"}  # a substring of each kernel's CUDA function names


def engine_long_phase(dev, gpu, params, cfg, name=LLM):
    """A full-width bfloat16 attention (or hybrid) model's own calls at long
    lengths, as ``engine_phase`` times them at the engine's: a [4, 8192]
    cache from ``T.init_cache``, then the p50 of one 2048-token prefill into
    one slot and of a B = 4 decode step at pos = 8191 (every sequence 8192
    rows long), with each path kernel's device ms per launch (B4 and B3;
    B5 too for the hybrid) from a profiler trace of the same calls.
    Launches, counted over every call, as ``expected_launches`` says."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import slot_view

    cache = T.init_cache(cfg, ENGINE_BATCH, LONG_SEQ, device=dev)
    cache_gb = sum(v.numel() * v.element_size() for v in _leaves(cache)) / 1e9
    slot = slot_view(cache, 0)
    rng = np.random.default_rng(SEED + 10)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, LONG_PROMPT)), device=dev)
    step_toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (ENGINE_BATCH, 1)), device=dev)
    pos = torch.full((ENGINE_BATCH,), LONG_SEQ - 1, dtype=torch.int64, device=dev)
    calls = {"prefill": 0, "decode_step": 0}
    outs = []

    def prefill():
        calls["prefill"] += 1
        outs.append(T.prefill(params, cfg, {"tokens": toks}, slot)[0])

    def decode():
        calls["decode_step"] += 1
        outs.append(T.decode_step(params, cfg, step_toks, pos, cache)[0])

    torch.cuda.synchronize()
    reset_engine_launches()
    pre_ms, dec_ms = p50_ms(prefill, n=10), p50_ms(decode, n=10)
    torch.cuda.synchronize()
    got = engine_launches()
    want = expected_launches(cfg, calls["prefill"], calls["decode_step"])
    if got != want:
        raise AssertionError(f"long-engine kernel launches {got} != {want}")
    if not all(bool(torch.isfinite(x).all()) for x in outs):
        raise AssertionError("the long-engine logits are not finite")
    per_launch, call_ms = {}, {}
    for fn, call in ((prefill, "prefill"), (decode, "decode_step")):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        call_ms[call] = sum(e.device_time_total for e in events) / 1e3 / 3
        for kernel, (kcall, per) in path_kernels(cfg).items():
            if kcall == call:
                mine = [e.device_time_total / 1e3 for e in events
                        if KERNEL_NAMES[kernel] in e.name]
                per_launch[kernel] = sum(mine) / (3 * per)
    print(f"engine: {name} long {cfg.dtype} cache=[{ENGINE_BATCH}, {LONG_SEQ}] "
          f"cache_GB={cache_gb:.2f} prefill_S{LONG_PROMPT}_p50_ms={pre_ms:.3f} "
          f"decode_step_B{ENGINE_BATCH}_pos{LONG_SEQ - 1}_p50_ms={dec_ms:.3f} "
          + " ".join(f"{k.split('_')[0]}_device_ms_per_call={v:.4f}"
                     for k, v in per_launch.items())
          + f" prefill_device_ms={call_ms['prefill']:.3f} "
          f"decode_step_device_ms={call_ms['decode_step']:.3f} launches={got} [{gpu}]")
    del cache, slot, outs


def ssm_long_phase(dev, gpu, params, cfg, name=SSM_LLM, n_trace=3):
    """The full-width bfloat16 SSM model's prefill at a RAG length, as
    ``engine_long_phase`` times the dense model's: the p50 of ``T.prefill``
    on one ``LONG_PROMPT``-token prompt into a batch-1 cache, then, from a
    profiler trace of ``n_trace`` prefills, the device ms per prefill and
    B5's device ms and CUDA kernels per scan call (every kernel whose name
    holds ``ssd_``). Launches, counted over the timed prefills: ssd_scan ==
    layers x prefills."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T

    cache = T.init_cache(cfg, 1, LONG_PROMPT, device=dev)
    rng = np.random.default_rng(SEED + 11)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, LONG_PROMPT)), device=dev)
    calls, outs = [0], []

    def prefill():
        calls[0] += 1
        outs.append(T.prefill(params, cfg, {"tokens": toks}, cache)[0])

    torch.cuda.synchronize()
    reset_engine_launches()
    pre_ms = p50_ms(prefill, n=10)
    torch.cuda.synchronize()
    got = engine_launches()
    want = expected_launches(cfg, calls[0], 0)
    if got != want:
        raise AssertionError(f"long SSM prefill kernel launches {got} != {want}")
    if not all(bool(torch.isfinite(x).all()) for x in outs):
        raise AssertionError("the long SSM prefill's logits are not finite")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_trace):
            prefill()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    scans = [e for e in events if "ssd_" in e.name]
    per_scan = n_trace * cfg.num_layers
    dev_ms = sum(e.device_time_total for e in events) / 1e3 / n_trace
    scan_ms = sum(e.device_time_total for e in scans) / 1e3 / per_scan
    print(f"engine: {name} long {cfg.dtype} prefill_S{LONG_PROMPT}_p50_ms={pre_ms:.3f} "
          f"prefill_device_ms={dev_ms:.3f} ssd_device_ms_per_call={scan_ms:.4f} "
          f"ssd_device_ms_per_prefill={scan_ms * cfg.num_layers:.3f} "
          f"ssd_cuda_kernels_per_call={len(scans) / per_scan:g} "
          f"launches={got} for prefills={calls[0]} [{gpu}]")
    del cache, outs


def profile_decode(decode, gpu, name, steps=5):
    """Where one decode step's time goes: device time per kernel from a
    torch.profiler trace, launches per step, and the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    decode()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(steps):
            decode()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3 / steps
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.device_time_total / 1e3 / steps, n + 1)
    device_ms = sum(ms for ms, _ in by_name.values())
    launches = sum(n for _, n in by_name.values()) / steps
    if device_ms == 0.0:
        print(f"profile: decode step {name}: the trace holds no device time; busy share not "
              f"measured [{gpu}]")
        return
    groups = {"decode_attention": 0.0, "matmul": 0.0, "sort_scatter_gather": 0.0,
              "elementwise": 0.0, "other": 0.0}
    for kname, (ms, _) in by_name.items():
        low = kname.lower()
        if "decode_fwd" in kname:
            groups["decode_attention"] += ms
        elif any(t in low for t in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90")):
            groups["matmul"] += ms
        elif any(t in low for t in ("sort", "scatter", "gather", "index", "scan")):
            # the MoE dispatch (argsorts, the bincount, the cumsum, the slot
            # scatter and the gathers); embedding lookups and cache writes too
            groups["sort_scatter_gather"] += ms
        elif "elementwise" in low or "vectorized" in low:
            groups["elementwise"] += ms
        else:
            groups["other"] += ms
    print(f"profile: decode step {name} B={ENGINE_BATCH} wall_ms={wall_ms:.3f} "
          f"device_ms={device_ms:.3f} busy_share={device_ms / wall_ms:.3f} "
          f"kernels_per_step={launches:.1f} "
          + " ".join(f"{g}_ms={v:.3f}" for g, v in groups.items()) + f" [{gpu}]")
    for kname, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"profile:   {ms:.4f} ms/step  x{n / steps:g}  {kname[:100]}")


def store_phase(enc, dev, gpu, queries, cap=L2_CAP):
    """B2's own path: a standalone cache over one store (one [1, cap, 768]
    lane) answering ``lookup`` one query at a time; each store search is a
    call of ``ops.similarity_topk``, the single-store form. Counts are set
    to 0 just before the lookups and read just after."""
    import numpy as np
    import torch

    from repro_torch.core import GenerativeCache
    from repro_torch.kernels.similarity_topk import kernel as kern
    from repro_torch.kernels.similarity_topk import ops

    cache = GenerativeCache(enc, threshold=0.9, t_single=0.5, t_combined=1.5, capacity=cap,
                            max_sources=TOPK, use_pallas=True, device=dev)
    rng = np.random.default_rng(SEED + 6)
    n_fill = int(0.9 * cap)
    vecs = rng.standard_normal((n_fill, enc.dim)).astype(np.float32)
    cache.insert_batch([f"store {i}" for i in range(n_fill)],
                       [f"store answer {i}" for i in range(n_fill)], vecs=vecs)
    for q in queries[:4]:  # warm-up
        cache.lookup(q)
    bank = cache.store._bank
    if dev.type == "cuda":
        torch.cuda.synchronize()
    kern.reset_launches()
    ops.reset_single_store_launches()
    d0 = bank.dispatches
    t0 = time.perf_counter()
    for q in queries:
        cache.lookup(q)
    wall = time.perf_counter() - t0
    launches, lanes, searches = ops.single_store_launches, kern.launches, bank.dispatches - d0
    print(f"store: single-store GenerativeCache bank={tuple(bank.buf.shape)} "
          f"live={len(cache.store)} lookups={len(queries)} store_searches={searches} "
          f"similarity_topk_launches={launches} lanes_kernel_launches={lanes} "
          f"wall_ms={wall * 1e3:.3f} [{gpu}]")
    expect = searches if dev.type == "cuda" else 0
    if bank.L != 1 or launches != expect or lanes != expect or searches < len(queries):
        raise AssertionError(f"store searches {searches} != single-store launches {launches} "
                             f"(lanes kernel {lanes})")
    return launches


def traffic_setup(enc):
    """The main path's traffic from ``squad_like_qa``: one paraphrase per
    cluster to cache (``cached``), the others as ``probes``, 64 of them as
    the replayed ``traffic``, and (t_s, t_single, t_combined) from this
    encoder's similarity quantiles, so the random-init encoder's traffic
    shows every class (semantic hit, generative hit, miss)."""
    import numpy as np

    from repro_torch.data.synthetic import squad_like_qa

    data = squad_like_qa(100, 4, seed=SEED, with_aspects=True)
    by_cluster = {}
    for qtext, ans, cid in data:
        by_cluster.setdefault(cid, []).append((qtext, ans))
    cached = [v[0] for v in by_cluster.values()]  # one paraphrase per cluster is cached
    probes = [p for v in by_cluster.values() for p in v[1:]]
    rng = np.random.default_rng(SEED)
    traffic = [probes[i] for i in rng.permutation(len(probes))[:64]]
    ce = enc.embed_batch([q for q, _ in cached])
    pe = enc.embed_batch([q for q, _ in traffic])
    S = np.sort(pe @ ce.T, axis=1)[:, ::-1]
    t_s = float(np.quantile(S[:, 0], 0.75))
    t_single = float(np.quantile(S[:, 0], 0.25))
    below = S[S[:, 0] <= t_s][:, :TOPK]
    sums = np.where(below > t_single, below, 0.0).sum(1)
    t_comb = float(np.quantile(sums[sums > 0], 0.5)) if (sums > 0).any() else 2 * t_s
    return cached, probes, traffic, (t_s, t_single, t_comb)


def main_path(dev, gpu, backends, cfg=None, l1_cap=L1_CAP, l2_cap=L2_CAP, profile=False):
    """The port's read path end to end through its user entry points: the
    same burst replayed with ``MockLLM`` answering the misses, then with
    each of ``backends`` in turn (zero-argument callables that return an
    ``LLMBackend``, built when its replay starts and dropped after it: a
    ``ModelBackend`` over the dense engine, then over the SSM engine, then
    any others). ``cfg``/caps default to the full-width configuration;
    smaller ones rehearse the same path on the CPU. ``profile`` adds a
    traced breakdown of one fused read (``profile_read``). Returns the
    kernels' launches during the traffic (B1, B3 and B4 from the first
    backend's replay, B5 from the second's), and the encoder and probes for
    ``store_phase``."""
    import numpy as np
    import torch

    from repro_torch.configs.contriever import CONTRIEVER_MSMARCO
    from repro_torch.core import (
        CacheRequest,
        ContrieverEncoder,
        EnhancedClient,
        GenerativeCache,
        HierarchicalCache,
        MockLLM,
    )
    from repro_torch.core import read_path
    from repro_torch.kernels.similarity_topk import kernel as kern
    from repro_torch.kernels.similarity_topk import ops
    from repro_torch.serving.service import CacheService

    cfg = CONTRIEVER_MSMARCO if cfg is None else cfg
    dim = cfg.d_model
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    enc = ContrieverEncoder(cfg, seed=SEED, device=dev)
    n_params = sum(p.numel() for p in enc.parameters())
    cached, probes, traffic, (t_s, t_single, t_comb) = traffic_setup(enc)

    def level(cap):
        return GenerativeCache(enc, threshold=t_s, t_single=t_single, t_combined=t_comb,
                               capacity=cap, max_sources=TOPK, use_pallas=True, device=dev)

    def replay(llm):
        """A freshly filled hierarchy serves the traffic as one burst, with
        ``llm`` answering the misses. Counts run from 0 over the burst."""
        t0 = time.perf_counter()
        l1, l2 = level(l1_cap), level(l2_cap)
        n_fill = int(0.9 * l2_cap) - len(cached)
        filler = np.random.default_rng(SEED + 7).standard_normal((n_fill, dim)).astype(np.float32)
        l2.insert_batch([f"filler {i}" for i in range(n_fill)],
                        [f"filler answer {i}" for i in range(n_fill)], vecs=filler)
        l2.insert_batch([q for q, _ in cached], [a for _, a in cached])  # through the encoder
        h = HierarchicalCache(l1, l2)
        client = EnhancedClient(cache=l1, hierarchy=h)
        client.register_backend(llm)
        service = CacheService(client, max_batch=8, max_wait_ms=2.0)
        bank = h._shared_bank
        if bank is None or tuple(bank.buf.shape) != (2, l2_cap, dim) or not bank.use_pallas:
            raise AssertionError(f"expected one [2, {l2_cap}, {dim}] kernel-path bank")
        sync()
        print(f"fill: encoder params={n_params} bank={tuple(bank.buf.shape)} "
              f"bank_MB={bank.buf.numel() * 4 / 1e6:.1f} L2_live={len(l2.store)} "
              f"t_s={t_s:.4f} t_single={t_single:.4f} t_combined={t_comb:.4f} "
              f"setup_s={time.perf_counter() - t0:.1f}")
        # warm the service (first CUDA/cuBLAS calls), then count from zero
        service.submit(CacheRequest("warm-up question about nothing",
                                    max_tokens=NEW_TOKENS)).result(timeout=300)
        engine = getattr(llm, "engine", None)
        kern.reset_launches()
        reset_engine_launches()
        ops.reset_dispatch_count()
        d0 = bank.dispatches
        m0 = dict(engine.metrics) if engine is not None else None
        futs = [service.submit(CacheRequest(q, max_tokens=NEW_TOKENS)) for q, _ in traffic]
        resps = [f.result(timeout=600) for f in futs]
        launches = {"similarity_topk_lanes": kern.launches, **engine_launches()}
        reads = bank.dispatches - d0
        dispatches = ops.dispatch_count()
        service.close()
        client.close()
        if h._shared_bank is not bank:
            raise AssertionError("the hierarchy left its shared bank during the traffic")
        hits = [r for r in resps if r.from_cache and not r.cache_result.generative]
        gen = [r for r in resps if r.from_cache and r.cache_result.generative]
        miss = [r for r in resps if r.status == "generated"]
        if len(hits) + len(gen) + len(miss) != len(resps):
            raise AssertionError(f"unexpected statuses: {[r.status for r in resps]}")
        for r in resps:
            if not r.text:
                raise AssertionError(f"empty answer: {r}")
        if not (hits and gen and miss):
            raise AssertionError("the traffic must show semantic hits, generative hits and misses")
        p50 = lambda rs: statistics.median(r.latency_s for r in rs) * 1e3  # noqa: E731
        # a CPU rehearsal runs the plain versions: no launch is counted there
        per_launch = 1 if on_card else 0
        expect = {"similarity_topk_lanes": per_launch * reads,
                  **dict.fromkeys(engine_kernels(), 0)}
        engine_part = ""
        if engine is not None:
            prefills = (engine.metrics["prefill_tokens"] - m0["prefill_tokens"]) // PROMPT
            steps = engine.metrics["decode_steps"] - m0["decode_steps"]
            expect.update(expected_launches(engine.cfg, prefills, steps, on_card))
            engine_part = f"engine_prefills={prefills} engine_decode_steps={steps} "
            if prefills == 0 or steps == 0:
                raise AssertionError("the engine answered no miss")
        ratio = p50(miss) / p50(hits + gen)
        print(f"traffic: llm={llm.name} requests={len(resps)} hits={len(hits)} "
              f"generative_hits={len(gen)} misses={len(miss)} "
              f"hit_p50_ms={p50(hits + gen):.3f} miss_p50_ms={p50(miss):.3f} "
              f"miss_over_hit_p50={ratio:.2f} gate_5x={'pass' if ratio >= 5 else 'FAIL'} "
              f"fused_reads={reads} {engine_part}launches={launches} service={service.stats} "
              f"[{gpu}]")
        if launches != expect or reads == 0 or dispatches != reads:
            raise AssertionError(f"kernel launches {launches} != {expect} (fused reads {reads})")
        return h, bank, launches

    # the same burst with the stand-in LLM (20 ms of sleep) first, so the
    # engines' effect on hit latency is read within one run; then the main
    # path proper, each engine answering the misses in turn
    replay(MockLLM("mock-llm", latency_s=0.02))
    counts = []
    for make in backends:
        llm = make()
        h, bank, replay_launches = replay(llm)
        counts.append(replay_launches)
        del llm
        if on_card:
            free_card()
    launches = dict(counts[0])
    if len(counts) > 1:
        launches["ssd_scan"] = counts[1]["ssd_scan"]

    # one read's decisions recomputed with the plain version on the same bank
    levels = [c for _, c in h._levels()]
    specs = tuple(read_path.level_spec(c, TOPK) for c in levels)
    unseen = [p for p in probes if p not in traffic]
    texts = [q for q, _ in traffic[:4] + unseen[:4]]  # seen (L1 hits) and fresh rows
    thr = np.asarray([[c.effective_threshold(t, None) for c in levels] for t in texts])
    dec = read_path.fused_read(bank, enc, texts, thr, specs)
    q = torch.as_tensor(dec.vecs, device=dev)
    s, i = ops._similarity_topk_lanes(bank.buf, bank.valid, q, k=TOPK, metric=bank.metrics,
                                      prenormalized=bank.prenormalized,
                                      topk=kern.similarity_topk_lanes_plain,
                                      lane_rows=tuple(bank.capacities))
    qmask = torch.ones(len(texts), dtype=torch.bool, device=dev)
    thr_d = torch.as_tensor(thr, dtype=torch.float32, device=dev)
    winner, hit, gen_m, _ = read_path.make_decide(specs, TOPK, bank.device)(s, thr_d, qmask)
    same = (np.array_equal(dec.winner, winner.cpu().numpy())
            and np.array_equal(dec.hit, hit.cpu().numpy())
            and np.array_equal(dec.generative, gen_m.cpu().numpy()))
    s_err = float(np.abs(dec.scores - s.cpu().numpy()).max())
    print(f"decide: kernel-vs-plain decisions identical={same} "
          f"winner={dec.winner.tolist()} score_max_abs_err={s_err:.3e}")
    if not same:  # where they part: each differing read's best scores and thresholds
        s_plain, w_plain = s.cpu().numpy(), winner.cpu().numpy()
        for b in np.flatnonzero((dec.winner != w_plain) | (dec.hit != hit.cpu().numpy()).any(-1)
                                | (dec.generative != gen_m.cpu().numpy()).any(-1)):
            print(f"decide:   read {b}: winner kernel={dec.winner[b]} plain={w_plain[b]} "
                  f"best kernel={dec.scores[b, :, 0].tolist()} plain={s_plain[b, :, 0].tolist()} "
                  f"thresholds={thr[b].tolist()}")
    if not same or s_err > TOL:
        raise AssertionError("the read's decisions differ between kernel and plain version")
    if not (np.isfinite(dec.vecs).all() and dec.vecs.shape == (8, dim)):
        raise AssertionError(f"embeddings are not finite [8, {dim}]")

    # p50 of one fused read (tokenize + encoder + kernel + decide + touch) per bucket
    parts = []
    for B in (1, 2, 4, 8, 16, 32, 64):
        tb = [q for q, _ in (traffic * 2)[:B]]
        thr_b = np.asarray([[c.effective_threshold(t, None) for c in levels] for t in tb])
        ts = []
        for _ in range(7):
            t1 = time.perf_counter()
            read_path.fused_read(bank, enc, tb, thr_b, specs)
            ts.append((time.perf_counter() - t1) * 1e3)
        parts.append(f"B{B}={statistics.median(ts[2:]):.3f}")
    print(f"read: fused_read p50_ms {' '.join(parts)} [{gpu}]")
    if profile:
        tb = [q for q, _ in traffic[:8]]
        thr_b = np.asarray([[c.effective_threshold(t, None) for c in levels] for t in tb])
        profile_read(lambda: read_path.fused_read(bank, enc, tb, thr_b, specs),
                     lambda: enc.fused_forward()[0](tb), gpu)
    return launches, enc, [q for q, _ in traffic]


SHARDS = 8  # positions of the sharded L2 (all on the one card)


def _decisions_equal(a, b):
    import numpy as np

    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in ("winner", "hit", "generative"))


def sharded_fill(enc, cached, l2_cap=L2_CAP):
    """The main path's L2 entries (90% of ``l2_cap``): the seeded filler
    rows, then the cached paraphrases through the encoder."""
    import numpy as np

    n_fill = int(0.9 * l2_cap) - len(cached)
    rows = np.concatenate([
        np.random.default_rng(SEED + 7).standard_normal((n_fill, enc.dim)).astype(np.float32),
        enc.embed_batch([q for q, _ in cached]).astype(np.float32),
    ])
    queries = [f"filler {i}" for i in range(n_fill)] + [q for q, _ in cached]
    answers = [f"filler answer {i}" for i in range(n_fill)] + [a for _, a in cached]
    return rows, queries, answers


def sharded_hierarchy(enc, knobs, fill, l2_store, l1_dev, l1_cap=L1_CAP, l2_cap=L2_CAP):
    """HierarchicalCache(L1 GenerativeCache on ``l1_dev``, L2 GenerativeCache
    on ``l2_store``), L2 holding ``fill`` and L1 the first 64 cached
    paraphrases (so both levels hit)."""
    from repro_torch.core import GenerativeCache, HierarchicalCache

    t_s, t_single, t_comb = knobs

    def level(**kw):
        return GenerativeCache(enc, threshold=t_s, t_single=t_single, t_combined=t_comb,
                               max_sources=TOPK, use_pallas=True, **kw)

    l1 = level(capacity=l1_cap, device=l1_dev)
    l2 = level(store=l2_store) if l2_store is not None else level(capacity=l2_cap, device=l1_dev)
    rows, queries, answers = fill
    l2.insert_batch(queries, answers, vecs=rows)
    l1.insert_batch(queries[-64:], answers[-64:], vecs=rows[-64:])
    return HierarchicalCache(l1, l2)


def sharded_phase(dev, gpu, enc, engine, n_shards=SHARDS, l1_cap=L1_CAP, l2_cap=L2_CAP):
    """The sharded read path (``sharded:`` lines): L1 a GenerativeCache on
    one InMemoryVectorStore(16384), L2 a GenerativeCache on
    ShardedVectorStore(make_cache_mesh(8, device="cuda"), 768, 131072) —
    8 positions on the one card, 16384 rows each — filled like the main
    path's L2 and read on the kernel route (B1 over the hot lanes, B2 at
    each position). One read at B = 8 is held against the single-device
    fused read over the same entries (decisions, and the candidates'
    payloads, since slot ids differ; scores within 2e-5), then against the
    same read on a CPU copy of the sharded hierarchy (decisions, global
    ids, counter deltas), with one position dead (``shard_mask``), and with
    TTLs and a staleness weight set on L2 (L2 on the lifecycle route, the
    plain version; L1 has none and keeps B1). The
    one-card deployment (``make_cache_mesh()``) reads once against its
    numpy mirror. Then the sharded read's p50 per batch bucket, its
    launches, device ms and busy share at B = 8, and 64 requests through
    CacheService(max_batch=8) over a fresh sharded hierarchy with the
    qwen1.5-0.5b engine behind ModelBackend answering the misses. Smaller
    caps (and a CPU device, whose reads launch no kernel) rehearse it."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import CacheRequest, EnhancedClient, read_path
    from repro_torch.core.store_bank import StoreBank
    from repro_torch.distributed.sharded_store import ShardedVectorStore
    from repro_torch.kernels.similarity_topk import kernel as kern
    from repro_torch.kernels.similarity_topk import ops
    from repro_torch.launch.mesh import make_cache_mesh
    from repro_torch.serving.engine import ModelBackend
    from repro_torch.serving.service import CacheService

    cpu = torch.device("cpu")
    on_card = dev.type == "cuda"
    per = 1 if on_card else 0  # the CPU runs the plain versions: no launch there
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    cached, probes, traffic, knobs = traffic_setup(enc)
    fill = sharded_fill(enc, cached, l2_cap)

    def sharded(d):
        return ShardedVectorStore(make_cache_mesh(n_shards, device=d), enc.dim, l2_cap, k=TOPK,
                                  use_pallas=True)

    h = sharded_hierarchy(enc, knobs, fill, sharded(dev), dev, l1_cap, l2_cap)
    srb = h.ensure_sharded_bank()
    l2s = h.l2.store
    if srb is None or l2s.n_shards != n_shards or l2s.cap_local != l2_cap // n_shards:
        raise AssertionError("expected one sharded read over 8 positions")
    hs = sharded_hierarchy(enc, knobs, fill, None, dev, l1_cap, l2_cap)  # the single-device twin
    hc = sharded_hierarchy(enc, knobs, fill, sharded(cpu), cpu, l1_cap, l2_cap)  # the CPU copy
    sync()
    mb = sum(p.buf.numel() * 4 for p in l2s.bank.parts) / 1e6
    print(f"sharded: L2 positions={n_shards} cap_local={l2s.cap_local} dim={enc.dim} "
          f"L2_MB={mb:.1f} L2_live={len(l2s)} L1_live={len(h.l1.store)} "
          f"devices={sorted({str(d) for d in l2s.mesh.devices.flat})} "
          f"setup_s={time.perf_counter() - t0:.1f} [{gpu}]")

    def thresholds(hier, tb):
        return np.asarray([[c.effective_threshold(t, None) for _, c in hier._levels()]
                           for t in tb])

    specs = tuple(read_path.level_spec(c, TOPK) for _, c in h._levels())
    unseen = [p for p in probes if p not in traffic]
    texts = [q for q, _ in traffic[:4] + unseen[:4]]
    thr = thresholds(h, texts)

    # 1. against the single-device fused read over the same entries
    l0 = (kern.launches, ops.single_store_launches)
    dec = srb.fused_read(enc, texts, thr, specs)
    spent = (kern.launches - l0[0], ops.single_store_launches - l0[1])
    one = read_path.fused_read(hs.ensure_bank(), enc, texts, thr, specs)

    def payloads(hier, d):
        out = []
        for li, (_, c) in enumerate(hier._levels()):
            joined = c.store.join_candidates(d.scores[:, li], d.idx[:, li], touch=False)
            out.append([[(e.query, e.response) for _, e in row] for row in joined])
        return out

    live = np.isfinite(one.scores)
    s_err = float(np.abs(dec.scores[live] - one.scores[live]).max())
    same = (_decisions_equal(dec, one) and payloads(h, dec) == payloads(hs, one)
            and np.array_equal(np.isfinite(dec.scores), live) and s_err <= TOL)
    print(f"sharded: vs single-device fused_read B={len(texts)} decisions+payloads "
          f"identical={same} winner={dec.winner.tolist()} score_max_abs_err={s_err:.3e} "
          f"launches B1+B2={spent[0]} of which B2={spent[1]}")
    if not same or spent != (per * (1 + n_shards), per * n_shards):
        raise AssertionError("the sharded read differs from the single-device read, "
                             f"or launched {spent} != ({1 + n_shards}, {n_shards})")
    del hs
    free_card()

    # 2-4. the same read on the card and on the CPU copy: decisions, global
    # ids, counter deltas; then with a dead position; then the lifecycle route
    def pair_read(label, **kw):
        res = []
        for hier in (h, hc):
            b = hier.ensure_sharded_bank()
            before = [x.counters_host()[:2] for x in b.banks()]
            k0 = kern.launches
            d = b.fused_read(enc, texts, thr, specs, vecs=dec.vecs, **kw)
            # the count deltas, and which slots got a new recency stamp (the
            # stamps' values follow each bank's own tick clock)
            deltas = [[x.counters_host()[0] != y[0], x.counters_host()[1] - y[1]]
                      for x, y in zip(b.banks(), before)]
            res.append((d, deltas, kern.launches - k0, b))
        (dk, ck, nk, bk), (dp, cp, _, bp) = res
        live = np.isfinite(dp.scores)
        err = float(np.abs(dk.scores[live] - dp.scores[live]).max())
        ok = (_decisions_equal(dk, dp) and np.array_equal(np.isfinite(dk.scores), live)
              and np.array_equal(dk.idx[live], dp.idx[live]) and err <= TOL
              and all(np.array_equal(x, y) for a, b in zip(ck, cp) for x, y in zip(a, b)))
        print(f"sharded: card vs cpu {label} decisions+global_ids+counter_deltas identical={ok} "
              f"winner={dk.winner.tolist()} score_max_abs_err={err:.3e} launches={nk} "
              f"degraded_reads={bk.degraded_reads}/{bp.degraded_reads}")
        if not ok:
            raise AssertionError(f"the sharded read on the card differs from the CPU's ({label})")
        return dk, nk

    _, nk = pair_read("kernel-route")
    if nk != per * (1 + n_shards):
        raise AssertionError(f"kernel route launched {nk}")
    dead = int(dec.idx[0, 1, 0]) // l2s.cap_local  # the position of row 0's best L2 entry
    mask = np.arange(n_shards) != dead
    dm, nk = pair_read(f"shard_mask(dead={dead})", shard_mask=mask)
    owners = dm.idx[:, 1][np.isfinite(dm.scores[:, 1])] // l2s.cap_local
    if nk != per * n_shards or (owners == dead).any() or srb.degraded_reads != 1:
        raise AssertionError(f"a dead position served or launched ({nk} launches)")
    clock = StoreBank.rel_now()
    saved = StoreBank.__dict__["rel_now"]
    StoreBank.rel_now = staticmethod(lambda: clock)
    try:
        for hier in (h, hc):  # TTL'd copies of 8 entries, and a staleness weight
            st = hier.l2.store
            st.add_batch(dec.vecs, [f"ttl {i}" for i in range(8)], [f"ttl answer {i}" for i in range(8)],
                         ttls=[3600.0] * 8)
            for lane in range(st.n_shards):
                st.bank.set_staleness(lane, 0.05)
        clock += 900.0
        _, nk = pair_read("lifecycle-route(ttl=3600 s, staleness=0.05, age=900 s)")
    finally:
        StoreBank.rel_now = saved
    # L2's lifecycle is active and L1's is not: B1 over L1, no B2
    if (not l2s.bank.lifecycle_active() or srb.rep_bank.lifecycle_active()
            or nk != per):
        raise AssertionError(f"the lifecycle route launched {nk} kernels, not {per}")
    del h, hc, srb, l2s
    free_card()

    # 5. the one-card deployment: make_cache_mesh() (one position per card)
    mesh1 = make_cache_mesh() if on_card else make_cache_mesh(device=dev)
    st1 = ShardedVectorStore(mesh1, enc.dim, l1_cap, k=TOPK, use_pallas=True)
    m = int(0.85 * l1_cap)
    d1 = sharded_hierarchy(enc, knobs, tuple(x[-m:] for x in fill), st1, dev, l1_cap, l2_cap)
    b1 = d1.ensure_sharded_bank()
    k0 = kern.launches
    got = b1.fused_read(enc, texts, thr, specs, touch=False)
    nk = kern.launches - k0
    st1.use_pallas = b1.rep_bank.use_pallas = False  # the same read, plain route
    ref = b1.fused_read(enc, texts, thr, specs, touch=False)
    st1.use_pallas = b1.rep_bank.use_pallas = True
    live = np.isfinite(ref.scores)
    err = float(np.abs(got.scores[live] - ref.scores[live]).max())
    ok = (_decisions_equal(got, ref) and np.array_equal(got.idx[live], ref.idx[live])
          and err <= TOL and nk == per * (1 + b1.n_shards))
    print(f"sharded: make_cache_mesh() positions={b1.n_shards} devices="
          f"{[str(d) for d in mesh1.devices.flat]} kernel-vs-plain route identical={ok} "
          f"winner={got.winner.tolist()} score_max_abs_err={err:.3e} launches={nk}")
    if not ok:
        raise AssertionError("the one-card deployment's kernel read differs from its plain read")
    del d1, b1, st1
    free_card()

    # 6. a fresh sharded hierarchy: read p50 per bucket, launches, device
    # time and busy share, then the replay through CacheService
    h = sharded_hierarchy(enc, knobs, fill, sharded(dev), dev, l1_cap, l2_cap)
    srb = h.ensure_sharded_bank()
    parts = []
    for B in (1, 2, 4, 8):
        tb = [q for q, _ in (traffic * 2)[:B]]
        thr_b = thresholds(h, tb)
        ts = []
        for _ in range(7):
            t1 = time.perf_counter()
            srb.fused_read(enc, tb, thr_b, specs)
            ts.append((time.perf_counter() - t1) * 1e3)
        parts.append(f"B{B}={statistics.median(ts[2:]):.3f}")
    print(f"sharded: fused_read p50_ms {' '.join(parts)} positions={n_shards} [{gpu}]")
    tb = [q for q, _ in traffic[:8]]
    thr_b = thresholds(h, tb)
    reads = 10
    sync()
    l0 = (kern.launches, ops.single_store_launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(reads):
            srb.fused_read(enc, tb, thr_b, specs)
        sync()
        wall_ms = (time.perf_counter() - t1) * 1e3 / reads
    b1_n = (kern.launches - l0[0] - (ops.single_store_launches - l0[1])) / reads
    b2_n = (ops.single_store_launches - l0[1]) / reads
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time_total for e in events) / 1e3 / reads
    topk_ms = sum(e.device_time_total for e in events
                  if any(t in e.name for t in ("topk_stream", "topk_tiles", "merge_lanes"))) / 1e3 / reads
    busy = f"{device_ms / wall_ms:.3f}" if device_ms > 0 else "not measured (empty trace)"
    print(f"sharded: profile fused_read B=8 wall_ms={wall_ms:.3f} device_ms={device_ms:.3f} "
          f"similarity_topk_ms={topk_ms:.3f} busy_share={busy} "
          f"kernels_per_read={sum(1 for e in events if not e.name.startswith(('Memcpy', 'Memset'))) / reads:.1f} "
          f"launches_per_read B1={b1_n:g} B2={b2_n:g} [{gpu}]")
    if (b1_n, b2_n) != (per, per * n_shards):
        raise AssertionError(f"launches per read B1={b1_n} B2={b2_n}")
    if on_card:  # B2 at one position's shape in this read
        b2_times(kern, dev, gpu, Q=len(tb), N=l2_cap // n_shards)

    llm = ModelBackend(LLM, engine)
    client = EnhancedClient(cache=h.l1, hierarchy=h)
    client.register_backend(llm)
    service = CacheService(client, max_batch=8, max_wait_ms=2.0)
    service.submit(CacheRequest("warm-up question about nothing",
                                max_tokens=NEW_TOKENS)).result(timeout=300)
    kern.reset_launches()
    ops.reset_single_store_launches()
    reset_engine_launches()
    d0 = srb.dispatches
    m0 = dict(engine.metrics)
    futs = [service.submit(CacheRequest(q, max_tokens=NEW_TOKENS)) for q, _ in traffic]
    resps = [f.result(timeout=600) for f in futs]
    launches = {"similarity_topk_lanes": kern.launches, "similarity_topk": ops.single_store_launches,
                **engine_launches()}
    reads = srb.dispatches - d0
    service.close()
    client.close()
    if h._sharded_bank is not srb:
        raise AssertionError("the hierarchy left its sharded read during the traffic")
    hits = [r for r in resps if r.from_cache and not r.cache_result.generative]
    gen = [r for r in resps if r.from_cache and r.cache_result.generative]
    miss = [r for r in resps if r.status == "generated"]
    if len(hits) + len(gen) + len(miss) != len(resps) or not all(r.text for r in resps):
        raise AssertionError(f"unexpected statuses: {[r.status for r in resps]}")
    if not (hits and gen and miss):
        raise AssertionError("the sharded traffic must show semantic hits, generative hits and misses")
    prefills = (engine.metrics["prefill_tokens"] - m0["prefill_tokens"]) // PROMPT
    steps = engine.metrics["decode_steps"] - m0["decode_steps"]
    expect = {"similarity_topk_lanes": per * (1 + n_shards) * reads,
              "similarity_topk": per * n_shards * reads,
              **expected_launches(engine.cfg, prefills, steps, on_card)}
    p50 = lambda rs: statistics.median(r.latency_s for r in rs) * 1e3  # noqa: E731
    ratio = p50(miss) / p50(hits + gen)
    print(f"sharded: traffic llm={llm.name} requests={len(resps)} hits={len(hits)} "
          f"generative_hits={len(gen)} misses={len(miss)} hit_p50_ms={p50(hits + gen):.3f} "
          f"miss_p50_ms={p50(miss):.3f} miss_over_hit_p50={ratio:.2f} "
          f"gate_5x={'pass' if ratio >= 5 else 'FAIL'} sharded_reads={reads} "
          f"engine_prefills={prefills} engine_decode_steps={steps} launches={launches} "
          f"service={service.stats} [{gpu}]")
    if launches != expect or reads == 0 or prefills == 0:
        raise AssertionError(f"sharded traffic launches {launches} != {expect}")
    if ratio < 5 and on_card:
        raise AssertionError(f"the sharded replay's hit p50 is not 5x below its miss p50 ({ratio:.2f})")
    del h, srb, service, client
    free_card()


def profile_read(read, prepare, gpu, reads=10):
    """Where one fused read's time goes at the service's batch of 8:
    device time per kernel from a torch.profiler trace, the device's busy
    share of the wall clock, and the host's tokenize/bucket time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        read()
    prep = []
    for _ in range(reads):
        t1 = time.perf_counter()
        prepare()
        prep.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(reads):
            read()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3 / reads
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.device_time_total / 1e3 / reads, n + 1)
    groups = {"similarity_topk": 0.0, "matmul": 0.0, "other": 0.0}
    for name, (ms, _) in by_name.items():
        if any(t in name for t in ("topk_stream", "topk_tiles", "merge_lanes")):
            groups["similarity_topk"] += ms
        elif any(t in name.lower() for t in ("gemm", "xmma", "cutlass", "sm90")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    device_ms = sum(groups.values())
    if device_ms == 0.0:
        print(f"profile: the trace holds no device time; busy share not measured [{gpu}]")
        return
    print(f"profile: fused_read B=8 wall_ms={wall_ms:.3f} device_ms={device_ms:.3f} "
          f"busy_share={device_ms / wall_ms:.3f} host_prepare_ms="
          f"{statistics.median(prep):.3f} kernels_per_read={sum(n for _, n in by_name.values()) / reads:.1f} "
          + " ".join(f"{g}_ms={v:.3f}" for g, v in groups.items()) + f" [{gpu}]")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (ms, n) in top:
        print(f"profile:   {ms:.4f} ms/read  x{n / reads:g}  {name[:100]}")


# this slice's engines (full depth, bfloat16), in the order they run; the
# first is kept for its traffic replay with the last, which is loaded then
ARCH_ENGINES = ("gemma2-27b", "gemma3-4b", "llava-next-mistral-7b")
LONG_ARCHS = ("gemma3-4b", "zamba2-7b")  # with an ``engine: ... long`` line
TRAFFIC_ARCHS = ("qwen3-8b", "zamba2-7b")  # with a ``traffic:`` replay
AUDIO_LLM = "musicgen-large"


def free_card():
    """Drop what nothing references any more and hand its device memory
    back, so the next full-width model fits (gemma2-27b holds ~60 GB)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def arch_engine(dev, gpu, name):
    """``engine_phase`` for one of this slice's text models at full depth
    and width in bfloat16, then its long line where it has one; returns the
    engine."""
    engine = engine_phase(dev, gpu, name)
    if name in LONG_ARCHS:
        engine_long_phase(dev, gpu, engine.params, engine.cfg, name)
        free_card()
    return engine


def arch_backend(dev, gpu, name):
    """A ``ModelBackend`` over ``arch_engine``'s engine, for a replay."""
    from repro_torch.serving.engine import ModelBackend

    return ModelBackend(name, arch_engine(dev, gpu, name))


def audio_phase(dev, gpu, name=AUDIO_LLM):
    """The audio model at full depth and width in bfloat16 through its own
    calls, since ``ModelBackend`` refuses audio (checked here): a B = 4
    prefill of [4, K, 32] codebook tokens and a B = 4 decode step, their
    launches (flash == layers per prefill, decode == layers per step,
    counted before the timing), [B, K, V] float32 logits, then both p50s."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ModelBackend, ServingEngine

    cfg = get_config(name)
    params = T.init_params(cfg, SEED, device=dev)
    cache = T.init_cache(cfg, ENGINE_BATCH, ENGINE_SEQ, device=dev)
    rng = np.random.default_rng(SEED + 12)
    K, V = cfg.num_codebooks, cfg.vocab_size
    toks = torch.as_tensor(rng.integers(0, V, (ENGINE_BATCH, K, PROMPT)), device=dev)
    step_toks = torch.as_tensor(rng.integers(0, V, (ENGINE_BATCH, K, 1)), device=dev)
    pos = torch.tensor([48, 40, 33, PROMPT], device=dev)

    def prefill():
        return T.prefill(params, cfg, {"tokens": toks}, cache)[0]

    def decode():
        return T.decode_step(params, cfg, step_toks, pos, cache)[0]

    torch.cuda.synchronize()
    reset_engine_launches()
    outs = [prefill(), decode()]
    torch.cuda.synchronize()
    got, want = engine_launches(), expected_launches(cfg, 1, 1)
    if got != want:
        raise AssertionError(f"{name} kernel launches {got} != {want}")
    if any(tuple(o.shape) != (ENGINE_BATCH, K, V) or not bool(torch.isfinite(o).all())
           for o in outs):
        raise AssertionError(f"{name} logits are not finite [{ENGINE_BATCH}, {K}, {V}]")
    backend = ModelBackend(name, ServingEngine(cfg, params, max_batch=1, max_seq=16, device=dev))
    try:
        backend.generate("a text prompt", max_tokens=2)
        raise AssertionError("ModelBackend served an audio model a text prompt")
    except NotImplementedError:
        pass
    pre_ms, dec_ms = p50_ms(prefill), p50_ms(decode)
    print(f"engine: {name} model-level (ModelBackend refuses audio: ok) bfloat16 "
          f"params={sum(x.numel() for x in _leaves(params))} layers={cfg.num_layers} "
          f"codebooks={K} logits={[ENGINE_BATCH, K, V]} launches={got} for 1 prefill + 1 step "
          f"prefill_B{ENGINE_BATCH}_S{PROMPT}_p50_ms={pre_ms:.3f} "
          f"decode_step_B{ENGINE_BATCH}_p50_ms={dec_ms:.3f} [{gpu}]")
    del params, cache, backend, outs


def arch_models(dev):
    """The six architectures' ``model:`` lines (float32, layer-cut, card vs
    CPU)."""
    for name, layers, patches in ARCH_MODEL_CHECKS:
        model_check(dev, name, layers=layers, patches=patches)
        free_card()


def moe_checks(dev, gpu):
    """One full-width MoE layer of each MoE model (``moe.init_moe`` at
    d_model 5120 with 16 experts top-1 softmax, or 7168 with 256 experts
    top-8 sigmoid_bias and a nonzero bias) in float32, TF32 off, on the card
    and on the CPU, over the same seeded activations (``MOE_TOKENS``):
    expert ids equal wherever the CPU's gap between the k-th and the
    (k+1)-th routing score exceeds 1e-4 (flips counted, limit 0), the drop
    fraction equal, outputs within ``MODEL_TOL``. Weights are drawn on the
    card and copied to the CPU."""
    import numpy as np
    import torch

    from repro_torch.models import moe

    for name in MOE_ARCHS:
        t0 = time.perf_counter()
        cfg = cut_config(name, dtype="float32")
        mo = cfg.moe
        gen = torch.Generator(device=dev).manual_seed(SEED)
        p_dev = moe.init_moe(gen, cfg, device=dev)
        if "router_bias" in p_dev:  # the trainer's balancing bias, nonzero
            p_dev["router_bias"] = 0.05 * torch.randn(mo.num_experts, generator=gen, device=dev)
        p_cpu = _tree_to(p_dev, torch.device("cpu"))
        rng = np.random.default_rng(SEED + 13)
        for T in MOE_TOKENS:
            x = rng.standard_normal((1, T, cfg.d_model)).astype(np.float32)
            runs = []
            for p, d in ((p_dev, dev), (p_cpu, torch.device("cpu"))):
                xd = torch.as_tensor(x, device=d)
                y, m = moe.moe_ffn(p, cfg, xd)
                idx, _ = moe._route(p, cfg, xd[0])
                runs.append((y.cpu(), float(m["moe_drop_fraction"]), idx.cpu()))
            (y1, drop1, idx1), (y2, drop2, idx2) = runs
            logits = torch.as_tensor(x[0]) @ p_cpu["router"]
            scores = (torch.sigmoid(logits) + p_cpu["router_bias"] if "router_bias" in p_cpu
                      else torch.softmax(logits, -1))
            top = torch.sort(scores, -1, descending=True).values
            decided = (top[:, mo.top_k - 1] - top[:, mo.top_k]) > 1e-4
            flips = int((decided & (idx1 != idx2).any(-1)).sum())
            err = float((y1 - y2).abs().max())
            ok = flips == 0 and drop1 == drop2 and err <= MODEL_TOL and bool(
                torch.isfinite(y1).all())
            print(f"moe: {name} float32 one layer d_model={cfg.d_model} experts={mo.num_experts} "
                  f"top_k={mo.top_k} router={mo.router} T={T} "
                  f"capacity={moe.capacity_of(cfg, T)} expert_flips={flips} (CPU gap > 1e-4; "
                  f"limit 0; {int((~decided).sum())} tokens within 1e-4) "
                  f"drop_fraction card={drop1:.6f} cpu={drop2:.6f} max_abs_err={err:.3e} "
                  f"tol={MODEL_TOL} {time.perf_counter() - t0:.1f} s -> "
                  f"{'ok' if ok else 'FAIL'} [{gpu}]")
            if not ok:
                raise AssertionError(f"the MoE layer on the card disagrees with the CPU: {name}")
        del p_dev, p_cpu
        free_card()


def moe_models(dev):
    """The MoE models' ``model:`` lines (float32, full width, layer-cut by
    ``MOE_MODEL_CUTS``, card vs CPU; 2 decode steps, each of which reads
    every expert's weights on the CPU)."""
    for name in MOE_ARCHS:
        layers, dense = MOE_MODEL_CUTS[name]
        model_check(dev, name, steps=2, layers=layers, dense=dense)
        free_card()


def moe_engines(dev, gpu):
    """Each MoE model alone at full width in bfloat16, cut by
    ``MOE_ENGINE_CUTS``, behind ``ModelBackend`` -> ``ServingEngine``: the
    ``engine:`` and ``profile: decode step`` lines, then one batch of
    ``ModelBackend`` prompts with its launches against the engine's counts
    (flash per layer and prefill; decode per layer and step for llama4, none
    for deepseek's absorbed MLA decode)."""
    import torch

    from repro_torch.serving.engine import ModelBackend

    for name in MOE_ARCHS:
        cfg = cut_config(name, *MOE_ENGINE_CUTS[name])
        engine = engine_phase(dev, gpu, name, cfg=cfg)
        backend = ModelBackend(name, engine)
        prompts = [f"question {i} about which expert serves the token" for i in range(6)]
        torch.cuda.synchronize()
        reset_engine_launches()
        m0 = dict(engine.metrics)
        t0 = time.perf_counter()
        resps = backend.generate_batch(prompts, max_tokens=NEW_TOKENS)
        wall = time.perf_counter() - t0
        steps = engine.metrics["decode_steps"] - m0["decode_steps"]
        got, want = engine_launches(), expected_launches(cfg, len(prompts), steps)
        print(f"engine: {name} ModelBackend prompts={len(prompts)} "
              f"tokens_out={[r.tokens_out for r in resps]} decode_steps={steps} "
              f"wall_s={wall:.3f} launches={got} [{gpu}]")
        if got != want or any(r.tokens_out != NEW_TOKENS or not r.text for r in resps):
            raise AssertionError(f"{name} behind ModelBackend: launches {got} != {want} or "
                                 f"short answers")
        del engine, backend, resps
        free_card()


def moe_slice(dev, gpu, checks=False):
    """The MoE models' lines: with ``checks`` (``--moe-only``) first B4 at
    (192, 128) and B3/B4 at llama4's shapes against their plain versions and
    timed (the default run has them among its own checks and times), then
    ``moe:``, ``model:``, ``engine:`` and ``profile:``."""
    if checks:
        attention_checks(dev, MOE_FLASH_CASES, MOE_DECODE_CASES, FLASH_PAIR_CASES, split=False)
        attention_times(dev, gpu, [t for t in FLASH_TIMES if t[0].split()[0] in MOE_ARCHS],
                        [t for t in DECODE_TIMES if t[0].split()[0] in MOE_ARCHS], PAIR_TIMES)
    moe_checks(dev, gpu)
    moe_models(dev)
    moe_engines(dev, gpu)


def arch_rest(dev, gpu):
    """This slice's engines without a replay, one at a time, then the audio
    model's line."""
    for name in ARCH_ENGINES:
        arch_engine(dev, gpu, name)
        free_card()
    audio_phase(dev, gpu)
    free_card()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one fused read and print where its time goes")
    ap.add_argument("--attention-only", action="store_true",
                    help="only B3 and B4: build them, hold them against their plain "
                         "versions, time them and the long-engine line, then stop")
    ap.add_argument("--topk-only", action="store_true",
                    help="only B1 and B2: build them, hold them against their plain "
                         "versions, time them, then stop")
    ap.add_argument("--ssd-only", action="store_true",
                    help="only B5: build it, hold it against its plain version, time it "
                         "and the long mamba2 prefill line, then stop")
    ap.add_argument("--arch-only", action="store_true",
                    help="only the qwen3-8b, gemma2-27b, gemma3-4b, llava, musicgen and "
                         "zamba2-7b phases: B3/B4 checks and times, their model:, engine:, "
                         "long and traffic: lines, then stop")
    ap.add_argument("--moe-only", action="store_true",
                    help="only the llama4-scout and deepseek-v3 phases: B4 at (192, 128) and "
                         "B3/B4 at llama4's shapes (checks and times), their moe:, model:, "
                         "engine: and profile: lines, then stop")
    ap.add_argument("--sharded-only", action="store_true",
                    help="only the sharded read path: B1/B2 and B3/B4 built, the sharded: "
                         "lines (checks, read p50, profile, the qwen1.5-0.5b replay), then stop")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the directory holding the repro_torch package to drive (default: "
                         "this checkout's src; another tree's, e.g. a parent commit "
                         "unpacked beside it, to compare both in one run)")
    args = ap.parse_args()
    if not (args.src / "repro_torch").is_dir():
        print(f"chip_smoke: {args.src}/repro_torch is not there", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels.backend import full_fp32
    from repro_torch.kernels.similarity_topk import kernel as kern
    from repro_torch.kernels.similarity_topk import ops
    from repro_torch.serving.engine import ModelBackend

    full_fp32()  # reference comparisons run in full float32 (no TF32)
    dev = torch.device("cuda")
    gpu = smi()
    print(f"gpu: {gpu} torch={torch.__version__} cuda={torch.version.cuda} "
          f"capability={torch.cuda.get_device_capability(0)} src={args.src}")
    build_all("attention" if args.attention_only or args.moe_only else "topk" if args.topk_only
              else "ssd" if args.ssd_only else "sharded" if args.sharded_only else None)
    if args.sharded_only:
        from repro_torch.configs import get_config
        from repro_torch.configs.contriever import CONTRIEVER_MSMARCO
        from repro_torch.core import ContrieverEncoder
        from repro_torch.serving.engine import ServingEngine

        enc = ContrieverEncoder(CONTRIEVER_MSMARCO, seed=SEED, device=dev)
        engine = ServingEngine(get_config(LLM), max_batch=ENGINE_BATCH, max_seq=ENGINE_SEQ,
                               seed=SEED, device=dev)
        engine.generate([list(range(1, 9))], max_new_tokens=2)  # warm-up
        sharded_phase(dev, gpu, enc, engine)
        print(f"sharded-only: done [{gpu}]")
        return 0
    if args.moe_only:
        moe_slice(dev, gpu, checks=True)
        print(f"moe-only: done [{gpu}]")
        return 0
    if args.ssd_only:
        from repro_torch.configs import get_config
        from repro_torch.models import transformer as T

        ssd_checks(dev)
        ssd_times(dev, gpu)
        cfg = get_config(SSM_LLM)
        ssm_long_phase(dev, gpu, T.init_params(cfg, SEED, device=dev), cfg)
        print(f"ssd-only: done [{gpu}]")
        return 0
    if args.attention_only:
        from repro_torch.configs import get_config
        from repro_torch.models import transformer as T

        attention_checks(dev)
        attention_times(dev, gpu)
        cfg = get_config(LLM)
        engine_long_phase(dev, gpu, T.init_params(cfg, SEED, device=dev), cfg)
        print(f"attention-only: done [{gpu}]")
        return 0
    print(f"build: similarity_topk_lanes tile_rows={kern.tile_rows()} "
          f"default_block_n={ops.default_block_n()}")
    if kern.tile_rows() != ops.default_block_n():
        raise AssertionError("the built kernel's tile differs from its source")
    if has_lane_rows(kern):
        lib = kern.LIB.load()
        for Q, D, k, ns in ((1, DIM, TOPK, 4), (8, DIM, 32, 2), (16, DIM, 4, 3), (3, 68, 8, 2)):
            if lib.similarity_topk_lanes_stream_smem(Q, D, k, ns) != kern.stream_smem(Q, D, k, ns):
                raise AssertionError("kernel.stream_smem differs from the CUDA source's layout")
        plan = kern.split_plan((L1_CAP, L2_CAP))
        print(f"build: similarity_topk_lanes stream route Q<={kern.SMALL_Q} k<={kern.KMAX}, "
              f"main-path grid={plan[1][-1]} blocks (lane rows per block {plan[0]}), "
              f"ring stages at Q=1/8/16: {[kern.stream_stages(Q, DIM, TOPK) for Q in (1, 8, 16)]}")

    if args.arch_only:
        attention_checks(dev)
        attention_times(dev, gpu)
        arch_models(dev)
        main_path(dev, gpu, [lambda n=n: arch_backend(dev, gpu, n) for n in TRAFFIC_ARCHS])
        free_card()
        arch_rest(dev, gpu)
        print(f"arch-only: done [{gpu}]")
        return 0
    errs = {"similarity_topk_lanes": kernel_checks(kern, dev),
            "similarity_topk": b2_checks(kern, dev)}
    if args.topk_only:
        kernel_times(kern, dev, gpu)
        b2_times(kern, dev, gpu)
        print(f"topk-only: done [{gpu}]")
        return 0
    attn_errs = attention_checks(dev)
    errs["flash_attention"], errs["decode_attention"] = attn_errs["flash"], attn_errs["decode"]
    errs["ssd_scan"] = ssd_checks(dev)
    b1_times = kernel_times(kern, dev, gpu)
    times = {"similarity_topk_lanes": b1_times["main-path", 8],  # the fused read at max_batch 8
             "similarity_topk": b2_times(kern, dev, gpu)}
    attn_times = attention_times(dev, gpu)
    times["flash_attention"] = attn_times["flash", PROMPT]  # the engine's prefill
    times["decode_attention"] = attn_times["decode", ENGINE_SEQ]  # the engine's decode step
    times["ssd_scan"] = ssd_times(dev, gpu)[PROMPT]  # the SSM engine's prefill
    torch.cuda.empty_cache()
    model_check(dev)
    model_check(dev, SSM_LLM)
    arch_models(dev)
    free_card()
    engine = engine_phase(dev, gpu)
    engine_long_phase(dev, gpu, engine.params, engine.cfg)
    torch.cuda.empty_cache()
    # one prompt shorter than d_conv - 1: its conv tail is left-padded
    ssm_engine = engine_phase(dev, gpu, SSM_LLM, lengths=(2, 32, 12, 27, 9, 20))
    ssm_long_phase(dev, gpu, ssm_engine.params, ssm_engine.cfg)
    torch.cuda.empty_cache()
    # the main path: the qwen1.5-0.5b and mamba2-1.3b engines' replays (the
    # JSON line's launches), then qwen3-8b's and zamba2-7b's, each engine
    # built (with its engine: lines) when its replay starts
    backends = [lambda: ModelBackend(LLM, engine), lambda: ModelBackend(SSM_LLM, ssm_engine)]
    backends += [lambda n=n: arch_backend(dev, gpu, n) for n in TRAFFIC_ARCHS]
    launches, enc, queries = main_path(dev, gpu, backends, profile=args.profile)
    del backends
    torch.cuda.empty_cache()
    launches["similarity_topk"] = store_phase(enc, dev, gpu, queries)
    # the sharded read path, with the qwen engine behind its replay, before
    # the MoE phases' host copies
    sharded_phase(dev, gpu, enc, engine)
    del engine, ssm_engine, enc
    free_card()
    arch_rest(dev, gpu)
    # the MoE models last: their float32 lines copy up to 56 GB to the host,
    # and the host-bound lines above (engine:, traffic:, read:) run before
    # that, in the same order and state as before these phases were added
    moe_slice(dev, gpu)
    print("kernels: " + " ".join(f"{k} launches={v}" for k, v in launches.items()))
    figures = []
    for name, source, replaces in (
        ("similarity_topk_lanes", "similarity_topk/csrc/similarity_topk_lanes.cu",
         "similarity_topk/kernel.py:84"),
        ("similarity_topk", "similarity_topk/csrc/similarity_topk_lanes.cu",
         "similarity_topk/kernel.py:141"),
        ("decode_attention", "decode_attention/csrc/decode_attention.cu",
         "decode_attention/kernel.py:78"),
        ("flash_attention", "flash_attention/csrc/flash_attention.cu",
         "flash_attention/kernel.py:98"),
        ("ssd_scan", "ssd_scan/csrc/ssd_scan.cu", "ssd_scan/kernel.py:75"),
    ):
        t = times[name]
        figures.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": figures}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
