#!/usr/bin/env python3
"""Drive the PyTorch port's cache read path on one CUDA card (an H100).

    python3 chip_smoke.py [--profile]

It builds the read path's kernel from the sources in this checkout, holds
the kernel against its plain PyTorch version on the card, then serves a
burst of requests through the port's real entry points at full width:

    CacheService -> EnhancedClient (+ MockLLM on a miss)
      -> HierarchicalCache(L1 GenerativeCache 16384, L2 GenerativeCache 131072)
      -> one [2, 131072, 768] float32 bank (805 MB) searched by the
         similarity_topk lanes kernel, Contriever-msmarco (12 x 768, random
         init from a seed) embedding the queries on the card

Lines it prints, in order: ``gpu:`` (card, power limit, torch/CUDA), ``build:``
(kernel build seconds), one ``check:`` per kernel-vs-plain case, ``time:``
lines (kernel / plain / library / bound at the main-path shapes, each with
the card and its power limit), ``fill:``, ``traffic:`` (hits, generative
hits, misses, latency p50s), ``read:`` (p50 of one fused read per batch
bucket), ``decide:`` (one read's decisions recomputed with the plain
version), ``kernels:`` (launches during the traffic), then a JSON line of
kernel figures, the ``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``. ``--profile`` adds ``profile:`` lines
after ``read:``: one fused read's device time by kernel from a
``torch.profiler`` trace, and the device's busy share. Any failure raises,
and the exit code is then non-zero. It exits non-zero without a CUDA device, and when the
``src/repro_torch`` package is not beside it.
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
TOL = 2e-5  # the reference kernel tests' tolerance (float32 sums in another order)
L1_CAP, L2_CAP, DIM, TOPK = 16384, 131072, 768, 4


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_case(name, db, valid, q, k, kern, ops_kw=None):
    """Kernel vs plain on the same card tensors; raises on disagreement.
    Returns the max abs score error."""
    import torch

    if ops_kw is None:
        s1, i1 = kern.similarity_topk_lanes_cuda(db, valid, q, k)
        s2, i2 = kern.similarity_topk_lanes_plain(db, valid, q, k)
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
    return worst


def kernel_times(kern, dev, gpu):
    """Kernel, plain and library times at the main-path shape per batch
    bucket, beside the card's bound for the same work."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    db = torch.randn((2, L2_CAP, DIM), generator=g, device=dev)
    db /= torch.linalg.vector_norm(db, dim=-1, keepdim=True)
    valid = torch.rand((2, L2_CAP), generator=g, device=dev) < 0.9
    out = {}
    for Q in (1, 8, 64):
        q = torch.randn((Q, DIM), generator=g, device=dev)
        k_ms = cuda_ms(lambda: kern.similarity_topk_lanes_cuda(db, valid, q, TOPK))
        p_ms = cuda_ms(lambda: kern.similarity_topk_lanes_plain(db, valid, q, TOPK), iters=5)

        def library():
            s = torch.matmul(q.unsqueeze(0), db.transpose(1, 2))
            return torch.topk(s.masked_fill(~valid[:, None, :], float("-inf")), TOPK, dim=-1)

        l_ms = cuda_ms(library, iters=10)
        L, N, D = db.shape
        nbytes = db.numel() * 4 + valid.numel() + q.numel() * 4 + 2 * L * Q * TOPK * 4
        flops = 2 * Q * L * N * D
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        out[Q] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound, bound_by=by)
        print(f"time: similarity_topk_lanes L=2 N={N} D={D} Q={Q} k={TOPK} "
              f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
              f"bound_ms={bound:.4f} ({by}) share_of_bound={bound / k_ms:.3f} [{gpu}]")
    return out


def main_path(dev, gpu, cfg=None, l1_cap=L1_CAP, l2_cap=L2_CAP, profile=False):
    """The port's read path end to end through its user entry points.
    ``cfg``/caps default to the full-width configuration; smaller ones
    rehearse the same path on the CPU. ``profile`` adds a traced
    breakdown of one fused read (``profile_read``)."""
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
    from repro_torch.data.synthetic import squad_like_qa
    from repro_torch.kernels.similarity_topk import kernel as kern
    from repro_torch.kernels.similarity_topk import ops
    from repro_torch.serving.service import CacheService

    t0 = time.perf_counter()
    cfg = CONTRIEVER_MSMARCO if cfg is None else cfg
    dim = cfg.d_model
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    enc = ContrieverEncoder(cfg, seed=SEED, device=dev)
    n_params = sum(p.numel() for p in enc.parameters())
    data = squad_like_qa(100, 4, seed=SEED, with_aspects=True)
    by_cluster = {}
    for qtext, ans, cid in data:
        by_cluster.setdefault(cid, []).append((qtext, ans))
    cached = [v[0] for v in by_cluster.values()]  # one paraphrase per cluster is cached
    probes = [p for v in by_cluster.values() for p in v[1:]]
    rng = np.random.default_rng(SEED)
    traffic = [probes[i] for i in rng.permutation(len(probes))[:64]]

    # thresholds from this run's similarity quantiles, so the random-init
    # encoder's traffic shows every class (semantic hit, generative hit, miss)
    ce = enc.embed_batch([q for q, _ in cached])
    pe = enc.embed_batch([q for q, _ in traffic])
    S = np.sort(pe @ ce.T, axis=1)[:, ::-1]
    t_s = float(np.quantile(S[:, 0], 0.75))
    t_single = float(np.quantile(S[:, 0], 0.25))
    below = S[S[:, 0] <= t_s][:, :TOPK]
    sums = np.where(below > t_single, below, 0.0).sum(1)
    t_comb = float(np.quantile(sums[sums > 0], 0.5)) if (sums > 0).any() else 2 * t_s

    def level(cap):
        return GenerativeCache(enc, threshold=t_s, t_single=t_single, t_combined=t_comb,
                               capacity=cap, max_sources=TOPK, use_pallas=True, device=dev)

    l1, l2 = level(l1_cap), level(l2_cap)
    n_fill = int(0.9 * l2_cap) - len(cached)
    filler = rng.standard_normal((n_fill, dim)).astype(np.float32)
    l2.insert_batch([f"filler {i}" for i in range(n_fill)],
                    [f"filler answer {i}" for i in range(n_fill)], vecs=filler)
    l2.insert_batch([q for q, _ in cached], [a for _, a in cached])  # through the encoder
    h = HierarchicalCache(l1, l2)
    client = EnhancedClient(cache=l1, hierarchy=h)
    client.register_backend(MockLLM("mock-llm", latency_s=0.02))
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
    service.submit(CacheRequest("warm-up question about nothing")).result(timeout=120)
    kern.reset_launches()
    ops.reset_dispatch_count()
    d0 = bank.dispatches
    futs = [service.submit(CacheRequest(q)) for q, _ in traffic]
    resps = [f.result(timeout=300) for f in futs]
    launches = kern.launches
    reads = bank.dispatches - d0
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
    p50 = lambda rs: statistics.median(r.latency_s for r in rs) * 1e3 if rs else float("nan")  # noqa: E731
    print(f"traffic: requests={len(resps)} hits={len(hits)} generative_hits={len(gen)} "
          f"misses={len(miss)} hit_p50_ms={p50(hits + gen):.3f} miss_p50_ms={p50(miss):.3f} "
          f"fused_reads={reads} kernel_launches={launches} "
          f"service={service.stats} [{gpu}]")
    if not (hits and gen and miss):
        raise AssertionError("the traffic must show semantic hits, generative hits and misses")
    # a CPU rehearsal runs the plain version: no launch is counted there
    if (launches != (reads if on_card else 0) or reads == 0
            or ops.dispatch_count() != reads):
        raise AssertionError(
            f"kernel launches {launches} != fused reads + lane searches {reads}"
        )
    service.close()
    client.close()

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
                                      topk=kern.similarity_topk_lanes_plain)
    qmask = torch.ones(len(texts), dtype=torch.bool, device=dev)
    thr_d = torch.as_tensor(thr, dtype=torch.float32, device=dev)
    winner, hit, gen_m, _ = read_path.make_decide(specs, TOPK, bank.device)(s, thr_d, qmask)
    same = (np.array_equal(dec.winner, winner.cpu().numpy())
            and np.array_equal(dec.hit, hit.cpu().numpy())
            and np.array_equal(dec.generative, gen_m.cpu().numpy()))
    s_err = float(np.abs(dec.scores - s.cpu().numpy()).max())
    print(f"decide: kernel-vs-plain decisions identical={same} "
          f"winner={dec.winner.tolist()} score_max_abs_err={s_err:.3e}")
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
    return launches


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
        if "topk_tiles" in name or "merge_lanes" in name:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one fused read and print where its time goes")
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels.backend import full_fp32
    from repro_torch.kernels.similarity_topk import kernel as kern
    from repro_torch.kernels.similarity_topk import ops

    full_fp32()  # reference comparisons run in full float32 (no TF32)
    dev = torch.device("cuda")
    gpu = smi()
    print(f"gpu: {gpu} torch={torch.__version__} cuda={torch.version.cuda} "
          f"capability={torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    kern.build()
    print(f"build: similarity_topk_lanes nvcc sm_90a {time.perf_counter() - t0:.2f} s; "
          f"tile_rows={kern.tile_rows()} default_block_n={ops.default_block_n()}")
    if kern.tile_rows() != ops.default_block_n():
        raise AssertionError("the built kernel's tile differs from its source")

    max_err = kernel_checks(kern, dev)
    times = kernel_times(kern, dev, gpu)
    torch.cuda.empty_cache()
    launches = main_path(dev, gpu, profile=args.profile)
    print(f"kernels: similarity_topk_lanes launches={launches}")
    main_q = times[8]  # the service's max_batch of 8 is the main path's bucket
    print(json.dumps({"kernels": [{
        "name": "similarity_topk_lanes",
        "route": "cuda",
        "source": "src/repro_torch/kernels/similarity_topk/csrc/similarity_topk_lanes.cu",
        "replaces": "src/repro/kernels/similarity_topk/kernel.py:84",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_q["ms"],
        "plain_ms": main_q["plain_ms"],
        "bound_ms": main_q["bound_ms"],
        "bound_by": main_q["bound_by"],
        "library_ms": main_q["library_ms"],
    }]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
