"""One run of one cell: set-up (raw inputs, the reference's decisions that
choose the traffic, the system and its warm-up), the measured window, the
comparison with the reference, and the metrics.

Everything a cell needs is found by name: the workload's entry in
``BENCHMARK.json``, its configuration file, its mix
``bench/traffic/<traffic>.json`` and each per-layer metric's reader
``bench/metrics/<metric>.py``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from harness import traffic, weights
from harness.window import drive
from reference import decide as ref_decide
from reference import lm as ref_lm
from reference import textenc

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


@dataclass
class Spec:
    workload: dict
    conf: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load(name: str) -> Spec:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(work)}")
    w = work[name]
    conf_file = {c["name"]: c["file"] for c in bench["configs"]}[w["config"]]
    conf = json.loads((ROOT / conf_file).read_text())
    mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())

    def mine(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    per = [m for m in bench["per_layer"] if mine(m)]
    return Spec(w, conf, mix, e2e, per)


def metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


# -- set-up: the reference's view of the cache, which chooses the traffic ----


@dataclass
class Reference:
    knobs: tuple
    decisions: Dict[str, ref_decide.Decision]
    eligible: Dict[int, List[str]]
    cached: List[tuple]
    cand_emb: Optional[torch.Tensor] = None  # the candidates' embeddings, in ``cand_row`` order
    cand_row: Optional[Dict[str, int]] = None
    level_rows: Optional[List[torch.Tensor]] = None  # each level's unit rows at set-up


def similarity_knobs(pe: torch.Tensor, ce: torch.Tensor, k: int) -> tuple:
    """(t_s, t_single, t_combined) from the similarity quantiles of the
    probes ``pe`` against the cached ``ce``: t_s at the 75th percentile of
    each probe's best score, t_single at the 25th, t_combined at the
    median sum of the top-k scores above t_single of the probes whose best
    is at most t_s."""
    tops = torch.cat([torch.topk(pe[b:b + 1024] @ ce.T, k, dim=1).values.cpu()
                      for b in range(0, pe.shape[0], 1024)]).numpy()
    best = tops[:, 0]
    t_s = float(np.quantile(best, 0.75))
    t_single = float(np.quantile(best, 0.25))
    below = tops[best <= t_s]
    sums = np.where(below > t_single, below, 0.0).sum(1)
    t_comb = float(np.quantile(sums[sums > 0], 0.5)) if (sums > 0).any() else 2 * t_s
    return t_s, t_single, t_comb


def reference_setup(conf: dict, clusters, enc_w: dict, fill_l1: torch.Tensor,
                    fill_l2: torch.Tensor, knobs: Optional[tuple] = None,
                    tf32: bool = False) -> Reference:
    """Embed the cached and the candidate paraphrases with the reference
    encoder, derive the thresholds, decide every candidate against every
    row of both levels, and keep as requests only the hits whose deciding
    quantities all lie at least ``decision_margin`` from their edges. The
    filler tensors are normalised in place. The control passes the
    thresholds the program was given (``knobs``) and sets ``tf32``: every
    product's operands rounded to TF32."""
    enc, cache, lim = conf["encoder"], conf["cache"], conf["limits"]
    rnd = textenc.tf32 if tf32 else None
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cached = [(c.inserted, c.answer) for c in clusters]
        cands = [t for c in clusters for t in c.candidates]
        kw = dict(vocab=enc["vocab_size"], max_len=enc["max_seq_len"], heads=enc["num_heads"],
                  eps=enc["norm_eps"], rnd=rnd or textenc._exact)
        ce = textenc.embed_texts(enc_w, [q for q, _ in cached], **kw)
        pe = textenc.embed_texts(enc_w, cands, **kw)
        knobs = knobs or similarity_knobs(pe, ce, cache["max_sources"])
        t_s, t_single, t_comb = knobs
        for rows in (fill_l1, fill_l2):
            rows /= rows.norm(dim=-1, keepdim=True).clamp(min=1e-9)
        levels = [
            ref_decide.Level("L1", fill_l1, [(f"filler l1 {i}", f"filler answer l1 {i}")
                                             for i in range(len(fill_l1))]),
            ref_decide.Level("L2", torch.cat([fill_l2, ce]),
                             [(f"filler l2 {i}", f"filler answer l2 {i}")
                              for i in range(len(fill_l2))] + cached),
        ]
        thr = [[ref_decide.policy_threshold(t, t_s, cache["policy"], conf["max_tokens"]), t_s]
               for t in cands]
        dec = ref_decide.decide_all(cands, pe, levels, thr, t_single, t_comb,
                                    cache["max_sources"], rnd=rnd)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    decisions = dict(zip(cands, dec))
    eligible: Dict[int, List[str]] = {}
    for c in clusters:
        ok = [t for t in c.candidates
              if decisions[t].status == "hit" and decisions[t].margin >= lim["decision_margin"]]
        if ok:
            eligible[c.cid] = ok
    return Reference(knobs, decisions, eligible, cached, pe, {t: i for i, t in enumerate(cands)},
                     [lv.rows for lv in levels])


def admit_documents(conf: dict, ref: Reference, enc_w: dict, docs: Sequence[str],
                    asked: Sequence[str]) -> float:
    """The fresh documents have to be misses that the cache stores and
    leaves apart: each one's best score against every set-up row of both
    levels, against every other document and against every paraphrase
    ``asked`` lies at least ``decision_margin`` below ``t_single`` (and so
    below every hit threshold). Then every decision the reference made at
    set-up stands whichever documents the cache holds when a request is
    read. Returns the highest such score; raises where one is too high."""
    enc, lim = conf["encoder"], conf["limits"]
    t_s, t_single, _ = ref.knobs
    thr = [ref_decide.policy_threshold(t, t_s, conf["cache"]["policy"], conf["max_tokens"])
           for t in docs]
    edge = min([t_single] + thr) - lim["decision_margin"]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        de = textenc.embed_texts(enc_w, docs, vocab=enc["vocab_size"], max_len=enc["max_seq_len"],
                                 heads=enc["num_heads"], eps=enc["norm_eps"])
        dd = de @ de.T
        dd.fill_diagonal_(-1.0)
        rows = [dd.max(1).values]
        rows += [torch.cat([(de @ r[b:b + 65536].T).max(1).values[None]
                            for b in range(0, len(r), 65536)]).max(0).values
                 for r in ref.level_rows]
        pe = ref.cand_emb[torch.tensor(sorted({ref.cand_row[t] for t in asked}),
                                       device=de.device)]
        rows.append((de @ pe.T).max(1).values)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    worst = float(torch.stack(rows).max())
    if worst >= edge:
        raise RuntimeError(f"a fresh document scores {worst:.4f} against the cache, at or above "
                           f"{edge:.4f}: the documents are not kept apart")
    return worst


# -- the run ---------------------------------------------------------------


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(spec: Spec, seed: int, seconds: float, trace: bool, device="cuda",
        control: bool = False, t_start: Optional[float] = None,
        rates: Sequence[float] = ()) -> dict:
    """One run; with ``rates`` a knee sweep instead: one window at each
    offered rate on the same built system, each reported on standard
    error, and no result. With ``control`` the control's answers (the
    reference in the next lower precision) stand in the comparison where
    the program's served ones would, so the run should come out not
    correct. Every object that set-up made goes into the collector's
    permanent generation before the window, as a server with a large
    loaded heap deploys: the collector's full passes over the ~1M cached
    entries otherwise stall the service (see PERF.md)."""
    from harness import stack as stack_mod

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    conf, mix = spec.conf, spec.mix
    seed = int(seed) % (1 << 63)
    cache, enc_conf, served = conf["cache"], conf["encoder"], conf["served"]
    lap = [time.perf_counter()]

    def phase(name):
        _sync(device)
        now = time.perf_counter()
        _log(f"setup: {name} {now - lap[0]:.2f} s")
        lap[0] = now

    # raw inputs, made once and handed to both sides
    enc_w = weights.encoder(enc_conf, seed, device)
    n1 = int(cache["fill"] * cache["l1_slots"])
    n2 = int(cache["fill"] * cache["l2_slots"]) - mix["clusters"]
    fill_l1 = weights.filler(n1, enc_conf["d_model"], seed, "filler-l1", device)
    fill_l2 = weights.filler(n2, enc_conf["d_model"], seed, "filler-l2", device)
    fill_l1_np, fill_l2_np = fill_l1.cpu().numpy(), fill_l2.cpu().numpy()
    clusters = traffic.corpus(mix, seed)
    phase("raw inputs")
    ref = reference_setup(conf, clusters, enc_w, fill_l1, fill_l2)
    del fill_l1, fill_l2
    sched = traffic.schedule(mix, seed, seconds, ref.eligible)
    docs = [r.text for r in sched if r.kind == "rag"]
    warm_doc = traffic.warm_up_document(mix, seed) if docs else None
    doc_best = None
    if docs:
        doc_best = admit_documents(conf, ref, enc_w, docs + [warm_doc],
                                   [r.text for r in sched if r.kind == "hit"])
    ref.level_rows = ref.cand_emb = None
    phase("reference decisions and schedule")
    lm_params = weights.lm(served, seed, device)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    phase("LLM weights")

    st = stack_mod.build(conf, weights.to_numpy(enc_w), fill_l1_np, fill_l2_np, ref.cached,
                         ref.knobs, lm_params, device)
    del fill_l1_np, fill_l2_np
    phase("system built and filled")
    make_request = _request_maker(mix)
    _warm_up(st, sched, make_request, warm_doc, device)
    gc.collect()
    gc.freeze()
    phase("warm-up")
    setup_s = time.perf_counter() - t_start

    if rates:
        _sweep(st, mix, seed, seconds, ref, rates, make_request)
        st.service.close()
        return {}

    # the window
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.similarity_topk import kernel as tk
    from repro_torch.kernels.ssd_scan import kernel as sk

    launch_mods = {"b1": tk, "b3": dk, "b4": fk, "b5": sk}
    look0, disp0 = _sched_stats(st.service)
    m0 = dict(st.engine.metrics)
    prof, sub, closing = None, {}, {}
    timer = None
    if trace:
        prof, sub, timer = _tracer(st, mix, seconds, launch_mods)

    def tick_close(offset):
        if offset >= seconds and not closing:
            closing["engine"] = dict(st.engine.metrics)
            closing["look"], closing["disp"] = _sched_stats(st.service)

    pauses = []

    def on_gc(phase_, info, t=[0.0]):
        if phase_ == "start":
            t[0] = time.perf_counter()
        else:
            pauses.append((info["generation"], time.perf_counter() - t[0], t[0]))

    gc.callbacks.append(on_gc)
    if timer is not None:
        timer.start()
    win = drive(st.service, sched, seconds, make_request, tick_close)
    if timer is not None:
        timer.join()
    gc.callbacks.remove(on_gc)
    gc.unfreeze()
    _sync(device)
    look1, disp1 = closing["look"], closing["disp"]
    m1 = closing["engine"]
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    live_rows = len(st.hierarchy.l1.store) + len(st.hierarchy.l2.store)
    read_back = _read_back(st.service, [o for o in win.outcomes if o.kind == "rag"], mix)
    tr, retraced = None, 0
    profiled = (sub.get("t_on"), sub.get("t_off"))
    if trace:
        tr = prof.reduce()
        if _trace_lost(tr, sub):
            # now and then CUPTI hands back a trace without the kernels'
            # records: trace a short segment of the same load once more
            # (its requests are not judged)
            _log("trace: the kernels' records are missing; tracing a second segment")
            retraced = 1
            seg = min(seconds, 2 * mix["trace_seconds"] + 5)
            prof, sub, timer = _tracer(st, mix, seg, launch_mods)
            timer.start()
            drive(st.service, traffic.schedule(mix, seed + 1, seg, ref.eligible), seg,
                  make_request)
            timer.join()
            tr = prof.reduce()
    st.service.close()
    st.client.close()
    del st
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # end-to-end metrics
    in_win = [o for o in win.outcomes if o.due < win.t0 + seconds]
    ok = win.resolved_in_window()
    lat = lambda os_: [(o.done - o.due) * 1e3 for o in os_]  # noqa: E731
    hits = [o for o in in_win if o.error is None and getattr(o.response, "status", "") == "hit"]
    gens = [o for o in in_win if o.error is None
            and getattr(o.response, "status", "") == "generated"]
    values = {"setup_s": setup_s, "served_rps": len(ok) / seconds}

    # the comparison with the reference
    checks, extra = _check(spec, seed, in_win, ref, lm_params, device, control, enc_w, clusters,
                           read_back)
    phase("the comparison")
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(in_win),
        "failed": checks["failed"]["value"],
        "metrics": {},
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if not trace:
        for m in spec.end_to_end:
            if m["name"] in values:
                result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                               "idle_gaps": [list(x) for x in tr.idle_gaps]}
        reads = [o for o in in_win if o.done is not None and o.error is None]
        ctx = dict(conf=conf, mix=mix, window_s=seconds, trace=tr, sub=sub, reads=reads,
                   lookup=(look1.batches - look0.batches, look1.batched_items - look0.batched_items),
                   dispatch=(disp1.batches - disp0.batches, disp1.batched_items - disp0.batched_items),
                   engine={k: m1[k] - m0.get(k, 0) for k in m1}, live_rows=live_rows,
                   hits=hits, gens=gens, win=win, profiled=profiled)
        for m in spec.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    full = [d for g, d, _ in pauses if g == 2]
    hit_ms = lat(hits)
    result["extra"] = dict(extra, late_max_s=win.late_max_s, late_spells=win.late_spells[:20],
                           offered=len(in_win),
                           gc_collections=len(pauses), retraced=retraced,
                           gc_max_s=max((d for _, d, _ in pauses), default=0.0),
                           gc_over_50ms=[(round(t - win.t0, 2), round(d, 3))
                                         for _, d, t in pauses if d > 0.05],
                           hit_pct_ms={q: float(np.percentile(hit_ms, q)) for q in
                                       (50, 75, 90, 95, 99)} if hit_ms else None,
                           gc_full=len(full), gc_full_max_s=max(full, default=0.0),
                           doc_best_score=doc_best,
                           miss_latency_s=[round(v / 1e3, 3) for v in lat(gens)],
                           hits=len(hits), misses=len(gens),
                           lookup_batches=look1.batches - look0.batches,
                           eligible_clusters=len(ref.eligible), knobs=list(ref.knobs))
    result["checks"] = checks
    return result


def _tracer(st, mix, seconds, launch_mods):
    """The profiler over a sub-window of a window of ``seconds``: (profiler,
    the sub-window's counters, the timer thread that runs it). Its own
    thread, so the driver keeps submitting on schedule; a mix with misses
    starts at the next miss batch handed to the engine, so that the
    sub-window holds a pass's prefills."""
    from harness.trace import Profiler

    prof, sub = Profiler(), {}
    t_on = min(mix["trace_start"], max(0.0, seconds - mix["trace_seconds"]))

    def profile_sub_window():
        if mix.get("trace_on_dispatch"):
            n0 = _sched_stats(st.service)[1].batches
            t_give_up = time.perf_counter() + seconds
            while (_sched_stats(st.service)[1].batches == n0
                   and time.perf_counter() < t_give_up):
                time.sleep(0.005)
        sub["look"] = _sched_stats(st.service)[0]
        sub["launch"] = {k: m.launches for k, m in launch_mods.items()}
        sub["t_on"] = time.perf_counter()
        prof.start()
        time.sleep(mix["trace_seconds"])
        prof.stop()
        sub["t_off"] = time.perf_counter()
        look = _sched_stats(st.service)[0]
        sub["batches"] = look.batch_sizes[len(sub["look"].batch_sizes):]
        sub["launch"] = {k: m.launches - sub["launch"][k] for k, m in launch_mods.items()}
        _log(f"trace: sub-window lookup batches {len(sub['batches'])}, launches {sub['launch']}")

    return prof, sub, threading.Timer(t_on, profile_sub_window)


def _trace_lost(tr, sub) -> bool:
    """A kernel family launched in the sub-window that the trace holds no
    kernel of."""
    return any(n > 0 and not tr.family_kernels.get(f) for f, n in sub.get("launch", {}).items())


def _sweep(st, mix, seed, seconds, ref, rates, make_request):
    """The knee sweep: one window at each offered rate on the built system,
    a ``sweep:`` line each on standard error."""
    for r in rates:
        sw = traffic.schedule(mix, seed, seconds, ref.eligible, r)
        look0, disp0 = _sched_stats(st.service)
        win = drive(st.service, sw, seconds, make_request)
        look1, disp1 = _sched_stats(st.service)
        in_win = [o for o in win.outcomes if o.due < win.t0 + seconds]
        done = [o for o in in_win if o.error is None]
        by = {k: [(o.done - o.due) * 1e3 for o in done if o.response.status == k]
              for k in ("hit", "generated")}
        _log(f"sweep: rate={r} offered={len(in_win)} served_rps={len(win.resolved_in_window()) / seconds:.1f} "
             f"failed={len(in_win) - len(done)} late_max_s={win.late_max_s:.3f} "
             + " ".join(f"{k}_p50_ms={np.percentile(v, 50):.1f} {k}_p95_ms={np.percentile(v, 95):.1f} "
                        f"{k}_n={len(v)}" for k, v in by.items() if v)
             + f" lookup_batches={look1.batches - look0.batches} "
             f"lookup_batch_mean={(look1.batched_items - look0.batched_items) / max(1, look1.batches - look0.batches):.1f}"
             f" dispatch_batches={disp1.batch_sizes[len(disp0.batch_sizes):]}"
             f" miss_due_done_s={[(round(o.due - win.t0, 1), round(o.done - win.t0, 1)) for o in done if o.kind == 'rag']}")


def _request_maker(mix: dict):
    from repro_torch.core.request import CacheRequest

    def make(req):
        return CacheRequest(req.text, max_tokens=mix["max_tokens"])

    return make


def _read_back(service, rags, mix) -> List[Optional[object]]:
    """Each fresh document that the engine answered, asked again once the
    window has drained: the entry its miss stored should answer it. The
    responses, in ``rags``' order (None where the first ask failed)."""
    from repro_torch.core.request import CacheRequest

    futs = [service.submit(CacheRequest(o.text, max_tokens=mix["max_tokens"]))
            if o.error is None and getattr(o.response, "status", "") == "generated" else None
            for o in rags]
    out = []
    for f in futs:
        try:
            out.append(f.result(timeout=600) if f is not None else None)
        except Exception as e:  # noqa: BLE001 — judged as a wrong read-back
            out.append(e)
    return out


def _sched_stats(service):
    """Copies of the (lookup, dispatch) schedulers' counters now."""
    from repro_torch.serving.coalescer import CoalescerStats

    return tuple(dataclasses.replace(s, batch_sizes=list(s.batch_sizes)) if s else CoalescerStats()
                 for s in service.scheduler_stats)


def _warm_up(st, sched, make_request, warm_doc, device):
    """Every read shape this traffic uses: each batch bucket up to the
    service's largest batch at each token-length bucket its paraphrases
    fall in, through ``submit``; and, where the mix sends documents, one
    document's whole miss path (lookup, engine, store) through ``submit``
    and reads at the documents' length for the batch buckets they share
    with hits. The warm-up's paraphrases are ones the window also asks;
    its document is its own (``traffic.warm_up_document``)."""
    from repro_torch.core.request import CacheRequest

    enc = st.encoder.cfg
    by_len = {}
    for t in dict.fromkeys(r.text for r in sched if r.kind == "hit"):
        n = len(textenc.token_ids(t, enc.vocab_size, enc.max_seq_len))
        by_len.setdefault(max(8, 1 << (n - 1).bit_length()), []).append(t)
    B = 1
    while by_len and B <= st.service.max_batch:
        for texts in by_len.values():
            futs = [st.service.submit(make_request(traffic.Request(0.0, "hit", t)))
                    for t in (texts * (B // len(texts) + 1))[:B]]
            for f in futs:
                f.result(timeout=600)
        B *= 2
    if warm_doc is not None:
        r = st.service.submit(CacheRequest(warm_doc, max_tokens=2)).result(timeout=600)
        if r.status != "generated":
            raise RuntimeError(f"the warm-up document was not generated: {r.status}")
        hits = [r.text for r in sched if r.kind == "hit"]
        for B in (1, 2, 4, 8):  # lookups only: a miss stores nothing until it is generated
            st.hierarchy.lookup_batch([warm_doc] + hits[:B - 1])
    _sync(device)


def _check(spec, seed, outcomes, ref: Reference, lm_params, device, control, enc_w, clusters,
           read_back):
    """Every request due in the window: each hit against the reference's
    decision, a seeded sample of the engine's answers against the
    reference model, each document's stored answer read back, and every
    failure: (checks, extra). With ``control`` the control's answers stand
    where the program's served ones would."""
    conf, mix, lim = spec.conf, spec.mix, spec.conf["limits"]
    failed = [o for o in outcomes if o.error is not None]
    hits = [o for o in outcomes if o.kind == "hit" and o.error is None]
    if control:
        served = _control_hits(conf, ref, hits, enc_w, clusters, seed, device)
    else:
        served = [_served_hit(o.response) for o in hits]
    wrong, gap = 0, 0.0
    examples = []
    for o, (status, got_level, text, sim) in zip(hits, served):
        d = ref.decisions[o.text]
        same = status == "hit" and got_level == d.level
        if same:
            got_text, got_sims = ref_decide.mask_sims(text or "")
            want_text, _ = ref_decide.mask_sims(d.text)
            want_sims = [s for s, _ in d.sources] if "generative" in d.level else []
            same = got_text == want_text and len(got_sims) == len(want_sims) and all(
                abs(a - b) <= 5e-4 + lim["hit_score_gap"] for a, b in zip(got_sims, want_sims))
            gap = max(gap, abs(sim - d.best))
        if not same:
            wrong += 1
            if len(examples) < 3:
                examples.append({"text": o.text, "want": d.level, "got": got_level})
    checks = {"hit_wrong": {"value": wrong, "limit": 0},
              "hit_score_gap": {"value": gap, "limit": lim["hit_score_gap"]},
              "failed": {"value": len(failed), "limit": 0}}
    extra = {"wrong_examples": examples,
             "failed_examples": [o.error[:200] for o in failed[:3]]}
    rags = [o for o in outcomes if o.kind == "rag"]
    if rags:
        ok = [o for o in rags if o.error is None]
        checks["miss_wrong"] = {"value": sum(o.response.status != "generated" for o in ok),
                                "limit": 0}
        back = dict(zip((id(o) for o in rags), read_back))
        checks["backfill_wrong"] = {
            "value": sum(not (getattr(back[id(o)], "status", "") == "hit"
                              and back[id(o)].text == o.response.text)
                         for o in ok if o.response.status == "generated"),
            "limit": 0}
        done = [o for o in ok if o.response.status == "generated"]
        rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 77])
        pick = sorted(rng.permutation(len(done))[: mix["check_misses"]].tolist())
        tok_gap, n_tok = _token_gap(conf, [done[i] for i in pick], lm_params, device, control)
        checks["miss_token_gap"] = {"value": tok_gap, "limit": lim["miss_token_gap"]}
        extra.update(checked_tokens=n_tok)
    return checks, extra


def _served_hit(r):
    """(status, level, answer, similarity) of a served response."""
    cr = r.cache_result
    hit = r.status == "hit" and cr is not None
    return (r.status, cr.level if hit else r.status, r.text,
            float(cr.similarity) if hit else float("nan"))


def _served_tokens(text: str) -> List[int]:
    return [int(w[1:]) for w in (text or "").split()]


def _token_gap(conf, sample, lm_params, device, control):
    """The widest gap, over every served token of ``sample``, by which its
    reference logit lies below the reference's best at that position; with
    ``control``, of the token that the control (fp8 weights) puts first at
    each of those positions instead. (gap, tokens compared)."""
    served, eng = conf["served"], conf["engine"]
    S = eng["max_prompt_tokens"]
    gap = 0.0
    n_tok = 0
    block = conf["limits"].get("reference_batch", 4)
    for b in range(0, len(sample), block):
        part = sample[b:b + block]
        toks = [_served_tokens(o.response.text) for o in part]
        n = min(len(t) for t in toks)
        seqs = [ref_lm.prompt_ids(o.text, served["vocab_size"], S) + t[:n]
                for o, t in zip(part, toks)]
        x = torch.tensor(seqs, dtype=torch.int64, device=device)
        pos = list(range(S - 1, S - 1 + n))
        logits = ref_lm.logits_at(lm_params, served, x, pos)
        if control:
            got = ref_lm.logits_at(lm_params, served, x, pos, cast=ref_lm.fp8_rounded).argmax(-1)
        else:
            got = torch.tensor([t[:n] for t in toks], device=device)
        best = logits.max(-1).values
        gap = max(gap, float((best - logits.gather(-1, got[..., None])[..., 0]).max()))
        n_tok += got.numel()
        del logits
    return gap, n_tok


def _control_hits(conf, ref: Reference, hits, enc_w, clusters, seed, device):
    """The control of the read path: the reference computed with TF32
    products, and what it would serve each of ``hits``."""
    cache = conf["cache"]
    n1 = int(cache["fill"] * cache["l1_slots"])
    n2 = int(cache["fill"] * cache["l2_slots"]) - len(clusters)
    f1 = weights.filler(n1, conf["encoder"]["d_model"], seed, "filler-l1", device)
    f2 = weights.filler(n2, conf["encoder"]["d_model"], seed, "filler-l2", device)
    ctrl = reference_setup(conf, clusters, enc_w, f1, f2, knobs=ref.knobs, tf32=True)
    ctrl.level_rows = ctrl.cand_emb = None
    del f1, f2
    return [(c.status, c.level, c.text, c.best) for c in (ctrl.decisions[o.text] for o in hits)]
