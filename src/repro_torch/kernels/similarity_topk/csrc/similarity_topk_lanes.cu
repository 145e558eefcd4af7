// Fused similarity scoring + per-lane top-k over a [L, N, D] store bank.
//
// Replaces the Pallas TPU kernels src/repro/kernels/similarity_topk/kernel.py
// :: similarity_topk_lanes_blocks (B1, body _topk_lanes_kernel) together with
// the per-lane candidate merge of src/repro/kernels/similarity_topk/ops.py
// :: _similarity_topk_lanes, and :: similarity_topk_blocks (B2, the
// single-store form: this kernel at L = 1). For every (lane, query) it
// returns the k best float32 dot scores over the lane's rows and their
// lane-local indices. Invalid rows score NEG_SENTINEL (-3e38), exactly as on
// the TPU; the Python wrapper maps that sentinel to -inf.
//
// lane_rows. Each lane l holds rows [0, lane_rows[l]) (a store's capacity;
// N, the padded bank width, by default). Rows at or past lane_rows[l] count
// as invalid and are never loaded: they take part only as NEG candidates at
// their own indices, so the result is the plain version's with those rows
// masked. The counts travel by value in the launch (struct Plan), with no
// host-to-device copy.
//
// Order. Candidates compare lexicographically on (score desc, index asc).
// That is a total order (indices are unique within a lane), so the top-k is
// the same whatever order blocks run in, and every merge below picks "the
// best candidate strictly after the previous pick" each round -- no
// taken-marks, no sort. Every score returned is ONE fmaf chain over
// d = 0 .. D-1 in order, as a GEMM sums it: it depends only on the row and
// the query, and equals torch.matmul's (the plain version's) at the service's
// batch sizes, so the read path decides on the card exactly as the plain
// version does even where a score lies within an ulp of a threshold.
//
// Bound on an H100. One read streams the live rows once: sum(lane_rows)*D*4
// bytes (805 MB for L=2 N=131072 D=768, about 0.24 ms at 3.35 TB/s; 453 MB
// at the main path's lane_rows (16384, 131072), 0.135 ms) against
// 2*Q*rows*D FP32 FLOP (no TF32: TF32 moves cosine scores by ~1e-3 and flips
// cache hits near a threshold). Memory-bound while Q is small; on the
// 67 TFLOP/s FP32 cores it turns compute-bound above Q ~ 40.
//
// Routes (kernel.py :: route picks one from the shapes; the launcher takes it):
//   stream (Q <= SMALL_Q, k <= KMAX, shared memory permitting): topk_stream,
//     ONE launch. Rows split into contiguous ranges over about 132 blocks,
//     one per SM (kernel.py :: split_plan, each lane's share weighed by its
//     lane_rows): a block's rings fill most of an SM's shared memory, so a
//     second wave of blocks would only refill its pipeline (measured slower).
//     A block is SW = 8 warps; each warp streams its own contiguous rows
//     through its own ring of `ns` (2-4) stages of R rows in dynamic shared
//     memory. A stage is one contiguous span of the bank, so lane 0 fills it
//     with ONE 1-D bulk copy (cp.async.bulk into an mbarrier) while the warp
//     computes the stages before it. The Q queries ([Q, D] f32) load once per
//     block. Streaming scores: lane j reads float4s at d = 4j + 128m from
//     the R rows and from each query (conflict-free), each query float4
//     serving R rows (R = 4 at Q <= 8, 2 above), and the R*Q partial sums are
//     reduced across the warp by a fixed butterfly reduce-scatter. Q is a
//     template parameter (1..16): no query slot is padded. Each warp keeps,
//     per query, a sorted list of kl = k + MARGIN (score, idx) in shared
//     memory, one entry per lane; a row enters only if it beats the last.
//     At block end the warp lists merge into the block's kl per (lane,
//     query), written to a cached workspace; the block that arrives last at
//     its lane's counter merges the lane's candidates (and the NEG rows past
//     lane_rows) a warp per query, fetches the kl picks' rows by bulk copies,
//     scores each again as one in-order fmaf chain (a streaming score differs
//     from it by float32 rounding; the MARGIN extra picks cover near-ties at
//     the k-th place), writes the k best by that score and resets the counter
//     to 0.
//   tile (Q > SMALL_Q, or k > KMAX, or a row too wide for the stream ring):
//     topk_tiles + merge_lanes, two launches. Pass 1: one 256-thread block
//     per (query chunk of QC, row tile of TN, lane) streams its [TN, D] tile
//     through shared memory in DK-wide slabs and accumulates a 2 x 8
//     (query x row) register tile per thread in a fixed d order; the
//     masked [QC, TN] score tile then goes to shared memory and one warp per
//     query extracts the tile's top-k by k rounds of warp-wide (score, idx)
//     max. A tile wholly past lane_rows loads nothing. Pass 2: one block per
//     (query, lane) merges the tile candidates. QC = 32 is Q's bucket for
//     every Q this route takes (Q > 16 pads at most to the next power of two).
//     It also takes every k up to TN; the stream route's lists hold at most
//     KMAX = 32 entries, so a larger k goes here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 128;       // bank rows per tile (tile route)
constexpr int QC = 32;        // queries per block (tile route)
constexpr int DK = 32;        // d-slab width staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 thread grid over (rows, queries)
constexpr int QT = QC / 16;   // queries per thread
constexpr int RT = TN / 16;   // rows per thread
constexpr float NEG_SENTINEL = -3.0e38f;
constexpr int NO_INDEX = 0x7fffffff;

constexpr int SW = 8;              // warps per stream block (kernel.STREAM_WARPS)
constexpr int ST = SW * 32;        // threads per stream block
constexpr int MARGIN = 2;          // candidates kept past k, for the exact re-scoring
constexpr int SMALL_Q = 16;        // most queries the stream route takes (kernel.SMALL_Q)
constexpr int KMAX = 32;           // largest k the stream route takes (kernel.KMAX)
constexpr int MAX_LANES = 64;      // lanes a launch takes (kernel.MAX_LANES)
constexpr int SMEM_LIMIT = 231424; // dynamic shared memory of a stream block: 227 KB less
                                   // 1 KB for its static shared memory (kernel.SMEM_LIMIT)

struct Plan {
  int L;
  int rows[MAX_LANES];       // lane_rows
  int per[MAX_LANES];        // rows per stream block of each lane
  int first[MAX_LANES + 1];  // first stream block of each lane; first[L] = grid
};

// Candidates a stream list keeps: k and a margin of MARGIN (up to KMAX), so
// that the k best by exact score are among the kl best by streamed score
// (kernel.list_len).
__host__ __device__ inline int list_len(int k) { return k + MARGIN < KMAX ? k + MARGIN : KMAX; }

// a is strictly better than b in (score desc, index asc) order
__device__ __forceinline__ bool better(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

__device__ __forceinline__ void warp_argmax(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float os = __shfl_xor_sync(0xffffffffu, s, off);
    int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(os, oi, s, i)) {
      s = os;
      i = oi;
    }
  }
}

// ---------------------------------------------------------------- stream route

__host__ __device__ constexpr int stream_rows(int Q) { return Q <= 8 ? 4 : 2; }

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~(size_t)127; }

// Dynamic shared memory of one stream block: the warps' mbarriers, their
// (score, idx) lists, the queries and the warps' rings (kernel.stream_smem).
struct Layout {
  size_t ls, li, qs, ring, total;
};

__host__ __device__ inline Layout stream_layout(int Q, int D, int kl, int ns) {
  Layout a;
  a.ls = align128((size_t)SW * ns * 8);
  a.li = align128(a.ls + (size_t)SW * Q * kl * 4);
  a.qs = align128(a.li + (size_t)SW * Q * kl * 4);
  a.ring = align128(a.qs + (size_t)Q * D * 4);
  a.total = a.ring + (size_t)SW * ns * stream_rows(Q) * D * 4;
  return a;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// The arrival that completes a phase of `bar` once `bytes` have landed.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to shared memory, completing that many transaction bytes on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // earlier reads of dst
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A single copy that is a phase of `bar` on its own.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  mbar_expect_tx(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

// Wait for the phase of `bar` with this parity; a copy that never lands
// traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1 << 22)) __trap();
  }
}

__host__ __device__ constexpr int pow2ceil(int x) { return x <= 1 ? 1 : 2 * pow2ceil((x + 1) / 2); }
__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }

// Butterfly reduce-scatter of VP per-lane partial sums over the warp: at
// offset o a lane keeps half of its values and adds its partner's half, so
// every value is summed by the same tree (bit 4 of the lane first, bit 0
// last). Afterwards lane t holds values (t >> (5 - SH)) * NF + i, i < NF.
template <int VP, int S = 0>
__device__ __forceinline__ void reduce_scatter(float (&v)[VP], int t) {
  if constexpr (S < 5) {  // one step per offset, unrolled at compile time
    constexpr int o = 16 >> S;
    constexpr int n = VP >> S;
    if constexpr (n >= 2) {
      const bool up = (t & o) != 0;
#pragma unroll
      for (int i = 0; i < n / 2; ++i) {
        const float lo = v[i], hi = v[i + n / 2];
        const float send = up ? lo : hi;
        const float keep = up ? hi : lo;
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
    reduce_scatter<VP, S + 1>(v, t);
  }
}

// Insert (s, idx) into a sorted k-entry list in shared memory, entry e held
// by lane e; warp-uniform call. Does nothing unless (s, idx) beats the k-th.
__device__ __forceinline__ void list_insert(float* ls, int* li, int k, float s, int idx, int t) {
  if (!better(s, idx, ls[k - 1], li[k - 1])) return;
  const float es = t < k ? ls[t] : 0.f;
  const int ei = t < k ? li[t] : 0;
  const int pos = __popc(__ballot_sync(0xffffffffu, t < k && better(es, ei, s, idx)));
  const float us = __shfl_up_sync(0xffffffffu, es, 1);
  const int ui = __shfl_up_sync(0xffffffffu, ei, 1);
  __syncwarp();
  if (t < k && t >= pos) {
    ls[t] = t == pos ? s : us;
    li[t] = t == pos ? idx : ui;
  }
  __syncwarp();
}

constexpr int MR = 32;  // candidates a lane holds in registers in the lane merge

// The exact score of lane t's pick (t < kl; row `i` of the lane `dbl`,
// streamed score `s`) against query `c`: ONE fmaf chain over d = 0 .. D-1
// in order, as a GEMM sums it, so the scores a read returns do not depend on
// the order the streaming pass summed in. NEG and -inf picks (invalid rows,
// rows past lane_rows, empty slots) keep their score. The picks' rows land
// in `slab` (slab_rows at a time) by one bulk copy each, issued by the
// pick's lane, on the warp's (idle, re-initialised) mbarrier `bar`; each
// lane then runs its chain there.
__device__ __forceinline__ float exact_scores(const float* dbl, const float* c, int D, int kl,
                                              float s, int i, float* slab, int slab_rows,
                                              uint32_t bar, int t) {
  const bool live = t < kl && s > NEG_SENTINEL;
  if (t == 0) {
    asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  float exact = s;
  uint32_t phase = 0;
  for (int p0 = 0; p0 < kl; p0 += slab_rows) {
    const bool mine = live && t >= p0 && t < p0 + slab_rows;
    const int nlive = __popc(__ballot_sync(0xffffffffu, mine));
    if (nlive == 0) continue;
    if (t == 0) mbar_expect_tx(bar, (uint32_t)(nlive * D * 4));
    __syncwarp();
    if (mine) bulk_copy(smem_u32(slab + (size_t)(t - p0) * D), dbl + (size_t)i * D, D * 4, bar);
    mbar_wait(bar, phase);
    phase ^= 1;
    if (mine) {
      const float* x = slab + (size_t)(t - p0) * D;
      float acc = 0.f;
      int d = 0;
      for (; d + 32 <= D; d += 32) {  // eight float4 pairs loaded ahead of their FMAs
        float4 xv[8], cv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          xv[u] = *reinterpret_cast<const float4*>(x + d + 4 * u);
          cv[u] = *reinterpret_cast<const float4*>(c + d + 4 * u);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          acc = fmaf(cv[u].x, xv[u].x, acc);
          acc = fmaf(cv[u].y, xv[u].y, acc);
          acc = fmaf(cv[u].z, xv[u].z, acc);
          acc = fmaf(cv[u].w, xv[u].w, acc);
        }
      }
      for (; d < D; d += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(x + d);
        const float4 cv = *reinterpret_cast<const float4*>(c + d);
        acc = fmaf(cv.x, xv.x, acc);
        acc = fmaf(cv.y, xv.y, acc);
        acc = fmaf(cv.z, xv.z, acc);
        acc = fmaf(cv.w, xv.w, acc);
      }
      exact = acc;
    }
    __syncwarp();  // the chains have read the slab before the next chunk lands
  }
  return exact;
}

template <int Q>
__global__ void __launch_bounds__(ST, 1)
topk_stream(const float* __restrict__ db, const uint8_t* __restrict__ valid,
            const float* __restrict__ q, float* __restrict__ ws_s, int* __restrict__ ws_i,
            int* __restrict__ counters, float* __restrict__ out_s, int* __restrict__ out_i,
            const Plan plan, int N, int D, int k, int kl, int ns) {
  constexpr int R = stream_rows(Q);
  constexpr int VP = pow2ceil(R * Q);
  constexpr int SH = log2i(VP) < 5 ? log2i(VP) : 5;
  constexpr int NF = VP >> SH;  // reduced values per lane
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_last;

  const int tid = threadIdx.x, w = tid >> 5, t = tid & 31;
  int l = 0;
  while (l + 1 < plan.L && (int)blockIdx.x >= plan.first[l + 1]) ++l;
  const int rows_l = plan.rows[l];
  const int r0 = ((int)blockIdx.x - plan.first[l]) * plan.per[l];
  const int r1 = min(rows_l, r0 + plan.per[l]);

  const Layout lay = stream_layout(Q, D, kl, ns);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* Ls = reinterpret_cast<float*>(smem + lay.ls);
  int* Li = reinterpret_cast<int*>(smem + lay.li);
  float* qs = reinterpret_cast<float*>(smem + lay.qs);

  // this warp's contiguous rows [w0, w0 + nw) of the block's range, R a stage
  const int per_w = (((r1 - r0) + SW - 1) / SW + R - 1) / R * R;
  const int w0 = r0 + w * per_w;
  const int nw = max(0, min(r1, w0 + per_w) - w0);
  const int nst = (nw + R - 1) / R;
  float* ring = reinterpret_cast<float*>(smem + lay.ring) + (size_t)w * ns * R * D;
  const float* src = db + ((size_t)l * N + w0) * D;
  const uint8_t* vrow = valid + (size_t)l * N + w0;
  float* wls = Ls + (size_t)w * Q * kl;
  int* wli = Li + (size_t)w * Q * kl;

  // the warp's barriers and first stages go first, so the ring fills while
  // the block loads its queries
  if (t == 0) {
    for (int s = 0; s < ns; ++s) mbar_init(smem_u32(&bars[w * ns + s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < min(ns - 1, nst); ++s)
      bulk_load(smem_u32(ring + (size_t)s * R * D), src + (size_t)s * R * D,
                (uint32_t)(min(R, nw - s * R) * D * 4), smem_u32(&bars[w * ns + s]));
  }
  for (int e = tid; e < Q * D / 4; e += ST)
    reinterpret_cast<float4*>(qs)[e] = reinterpret_cast<const float4*>(q)[e];
  for (int e = tid; e < SW * Q * kl; e += ST) {
    Ls[e] = -__int_as_float(0x7f800000);
    Li[e] = NO_INDEX;
  }
  __syncthreads();

  for (int it = 0; it < nst; ++it) {
    const int nxt = it + ns - 1;  // refills the buffer read in iteration it - 1
    if (t == 0 && nxt < nst)
      bulk_load(smem_u32(ring + (size_t)(nxt % ns) * R * D), src + (size_t)nxt * R * D,
                (uint32_t)(min(R, nw - nxt * R) * D * 4), smem_u32(&bars[w * ns + nxt % ns]));
    const int nr = min(R, nw - it * R);
    int vmask = 0;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < nr && vrow[it * R + r]) vmask |= 1 << r;
    mbar_wait(smem_u32(&bars[w * ns + it % ns]), (uint32_t)((it / ns) & 1));

    const float* rb = ring + (size_t)(it % ns) * R * D;
    float v[VP];
#pragma unroll
    for (int j = 0; j < VP; ++j) v[j] = 0.f;
    for (int d = 4 * t; d < D; d += 128) {
      float4 x[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        x[r] = r < nr ? *reinterpret_cast<const float4*>(rb + (size_t)r * D + d)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int qi = 0; qi < Q; ++qi) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (size_t)qi * D + d);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float a = v[r * Q + qi];
          a = fmaf(x[r].x, qv.x, a);
          a = fmaf(x[r].y, qv.y, a);
          a = fmaf(x[r].z, qv.z, a);
          a = fmaf(x[r].w, qv.w, a);
          v[r * Q + qi] = a;
        }
      }
    }
    __syncwarp();  // the whole warp has read the stage before lane 0 refills it
    reduce_scatter<VP>(v, t);

    const bool leader = (t & ((1 << (5 - SH)) - 1)) == 0;
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int j = (t >> (5 - SH)) * NF + i;
      const int r = j / Q, qi = j % Q;
      bool cand = false;
      float s = 0.f;
      int idx = 0;
      if (leader && j < R * Q && r < nr) {
        s = (vmask >> r) & 1 ? v[i] : NEG_SENTINEL;
        idx = w0 + it * R + r;
        cand = better(s, idx, wls[qi * kl + kl - 1], wli[qi * kl + kl - 1]);
      }
      unsigned m = __ballot_sync(0xffffffffu, cand);
      while (m) {
        const int from = __ffs(m) - 1;
        m &= m - 1;
        const float cs = __shfl_sync(0xffffffffu, s, from);
        const int ci = __shfl_sync(0xffffffffu, idx, from);
        const int cq = __shfl_sync(0xffffffffu, qi, from);
        list_insert(wls + cq * kl, wli + cq * kl, kl, cs, ci, t);
      }
    }
  }
  __syncthreads();

  // the block's kl per query: merge the SW warp lists
  const int b = blockIdx.x;
  for (int qi = w; qi < Q; qi += SW) {
    float prev_s = __int_as_float(0x7f800000);  // +inf: nothing taken yet
    int prev_i = -1;
    for (int tt = 0; tt < kl; ++tt) {
      float bs = -__int_as_float(0x7f800000);
      int bi = NO_INDEX;
      for (int m = t; m < SW * kl; m += 32) {
        const int e = ((m / kl) * Q + qi) * kl + m % kl;
        const float s = Ls[e];
        const int i = Li[e];
        if (better(prev_s, prev_i, s, i) && better(s, i, bs, bi)) {
          bs = s;
          bi = i;
        }
      }
      warp_argmax(bs, bi);
      if (t == 0) {
        ws_s[((size_t)b * Q + qi) * kl + tt] = bs;
        ws_i[((size_t)b * Q + qi) * kl + tt] = bi;
      }
      prev_s = bs;
      prev_i = bi;
    }
  }
  __threadfence();  // the block's candidates are visible before the counter moves
  __syncthreads();
  const int b0 = plan.first[l], nbl = plan.first[l + 1] - plan.first[l];
  if (tid == 0) s_last = atomicAdd(&counters[l], 1) == nbl - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last block of lane l merges its blocks' candidates and the NEG rows
  // past lane_rows (which no block loaded), a warp per query: kl rounds of
  // "the best candidate strictly after the previous pick"; lane tt keeps
  // pick tt. Up to 32 * MR candidates stay in registers, loaded once; more
  // are read again each round. Then each live pick is scored again exactly
  // (exact_scores) and the k best by that score are written.
  const int M = nbl * kl;
  float* slab = reinterpret_cast<float*>(smem + lay.ring) + (size_t)w * ns * R * D;
  const int slab_rows = ns * R;  // rows of a warp's ring
  for (int qi = w; qi < Q; qi += SW) {
    const float* cand_s = ws_s + (size_t)b0 * Q * kl;
    const int* cand_i = ws_i + (size_t)b0 * Q * kl;
    float cs[MR];
    int ci[MR];
    const bool resident = M <= 32 * MR;
    if (resident) {
#pragma unroll
      for (int u = 0; u < MR; ++u) {
        const int m = 32 * u + t;
        const size_t e = ((size_t)(m / kl) * Q + qi) * kl + m % kl;
        cs[u] = m < M ? __ldcg(cand_s + e) : -__int_as_float(0x7f800000);
        ci[u] = m < M ? __ldcg(cand_i + e) : NO_INDEX;
      }
    }
    float prev_s = __int_as_float(0x7f800000);  // +inf: nothing taken yet
    int prev_i = -1;
    float my_s = -__int_as_float(0x7f800000);
    int my_i = NO_INDEX;
    for (int tt = 0; tt < kl; ++tt) {
      float bs = -__int_as_float(0x7f800000);
      int bi = NO_INDEX;
      if (resident) {
#pragma unroll
        for (int u = 0; u < MR; ++u)
          if (better(prev_s, prev_i, cs[u], ci[u]) && better(cs[u], ci[u], bs, bi)) {
            bs = cs[u];
            bi = ci[u];
          }
      } else {
        for (int m = t; m < M; m += 32) {
          const size_t e = ((size_t)(m / kl) * Q + qi) * kl + m % kl;
          const float s = __ldcg(cand_s + e);
          const int i = __ldcg(cand_i + e);
          if (better(prev_s, prev_i, s, i) && better(s, i, bs, bi)) {
            bs = s;
            bi = i;
          }
        }
      }
      if (t < kl && rows_l + t < N) {
        const int i = rows_l + t;
        if (better(prev_s, prev_i, NEG_SENTINEL, i) && better(NEG_SENTINEL, i, bs, bi)) {
          bs = NEG_SENTINEL;
          bi = i;
        }
      }
      warp_argmax(bs, bi);
      if (t == tt) {
        my_s = bs;
        my_i = bi;
      }
      prev_s = bs;
      prev_i = bi;
    }
    my_s = exact_scores(db + (size_t)l * N * D, qs + (size_t)qi * D, D, kl, my_s, my_i, slab,
                        slab_rows, smem_u32(&bars[w * ns]), t);
    // rank of this lane's pick among the kl by (score desc, index asc)
    int rank = 0;
    for (int u = 0; u < kl; ++u) {
      const float us = __shfl_sync(0xffffffffu, my_s, u);
      const int ui = __shfl_sync(0xffffffffu, my_i, u);
      rank += better(us, ui, my_s, my_i);
    }
    if (t < kl && rank < k) {
      out_s[((size_t)l * Q + qi) * k + rank] = my_s;
      out_i[((size_t)l * Q + qi) * k + rank] = my_i;
    }
  }
  if (tid == 0) counters[l] = 0;  // ready for the next launch
}

// ------------------------------------------------------------------ tile route

__global__ void __launch_bounds__(THREADS)
topk_tiles(const float* __restrict__ db, const uint8_t* __restrict__ valid,
           const float* __restrict__ q, float* __restrict__ cand_s,
           int* __restrict__ cand_i, const Plan plan, int N, int D, int Q, int k, int nb,
           int nqc) {
  __shared__ float dbs[DK][TN + 1];  // +1: conflict-free transposed stores
  __shared__ float qs[DK][QC + 1];
  __shared__ float S[QC][TN + 1];
  __shared__ uint8_t vs[TN];

  const int lane = blockIdx.y;
  const int qc = blockIdx.x % nqc;
  const int tile = blockIdx.x / nqc;
  const int row0 = tile * TN;
  const int q0 = qc * QC;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // row group
  const int ty = tid / 16;  // query group
  const int rows_l = plan.rows[lane];
  const int nrows = min(TN, N - row0);
  const float* dbl = db + (size_t)lane * N * D;

  if (row0 >= rows_l) {
    // wholly past the lane's rows: every row is a NEG candidate, none loaded
    for (int e = tid; e < QC * k; e += THREADS) {
      const int qi = e / k, t = e % k;
      if (q0 + qi >= Q) break;
      const size_t o = (((size_t)lane * Q + q0 + qi) * nb + tile) * k + t;
      cand_s[o] = t < nrows ? NEG_SENTINEL : -__int_as_float(0x7f800000);
      cand_i[o] = t < nrows ? row0 + t : NO_INDEX;
    }
    return;
  }

  if (tid < TN) {
    const int row = row0 + tid;
    vs[tid] = row < rows_l ? valid[(size_t)lane * N + row] : 0;
  }

  float acc[QT][RT];
#pragma unroll
  for (int i = 0; i < QT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) acc[i][j] = 0.0f;

  for (int d0 = 0; d0 < D; d0 += DK) {
    // bank slab: TN rows x DK floats = TN*DK/4 float4, 4 per thread; eight
    // neighbouring threads read one row's 128 contiguous bytes
#pragma unroll
    for (int m = 0; m < (TN * DK / 4) / THREADS; ++m) {
      const int e = tid + m * THREADS;
      const int r = e / (DK / 4);
      const int c = (e % (DK / 4)) * 4;
      const int row = row0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < rows_l && d0 + c < D)
        v = *reinterpret_cast<const float4*>(dbl + (size_t)row * D + d0 + c);
      dbs[c + 0][r] = v.x;
      dbs[c + 1][r] = v.y;
      dbs[c + 2][r] = v.z;
      dbs[c + 3][r] = v.w;
    }
    // query slab: QC x DK floats = one float4 per thread
    {
      const int r = tid / (DK / 4);
      const int c = (tid % (DK / 4)) * 4;
      const int qi = q0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (qi < Q && d0 + c < D)
        v = *reinterpret_cast<const float4*>(q + (size_t)qi * D + d0 + c);
      qs[c + 0][r] = v.x;
      qs[c + 1][r] = v.y;
      qs[c + 2][r] = v.z;
      qs[c + 3][r] = v.w;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < DK; ++kk) {
      float a[QT], b[RT];
#pragma unroll
      for (int i = 0; i < QT; ++i) a[i] = qs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < RT; ++j) b[j] = dbs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < QT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < QT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      const int r = tx + 16 * j;
      S[ty + 16 * i][r] = vs[r] ? acc[i][j] : NEG_SENTINEL;
    }
  __syncthreads();

  // per-tile top-k: one warp per query, each lane owns TN/32 rows
  const int warp = tid / 32;
  const int wl = tid % 32;
  for (int qi = warp; qi < QC; qi += THREADS / 32) {
    if (q0 + qi >= Q) break;
    float prev_s = __int_as_float(0x7f800000);  // +inf: nothing taken yet
    int prev_i = -1;
    float* out_s = cand_s + (((size_t)lane * Q + q0 + qi) * nb + tile) * k;
    int* out_i = cand_i + (((size_t)lane * Q + q0 + qi) * nb + tile) * k;
    for (int t = 0; t < k; ++t) {
      float bs = -__int_as_float(0x7f800000);
      int bi = NO_INDEX;
#pragma unroll
      for (int m = 0; m < TN / 32; ++m) {
        const int r = wl + 32 * m;
        if (r < nrows) {
          const float s = S[qi][r];
          const int idx = row0 + r;
          if (better(prev_s, prev_i, s, idx) && better(s, idx, bs, bi)) {
            bs = s;
            bi = idx;
          }
        }
      }
      warp_argmax(bs, bi);
      if (wl == 0) {
        out_s[t] = bs;
        out_i[t] = bi;
      }
      prev_s = bs;
      prev_i = bi;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
merge_lanes(const float* __restrict__ cand_s, const int* __restrict__ cand_i,
            float* __restrict__ out_s, int* __restrict__ out_i, int Q, int k,
            int M) {
  __shared__ float ws[THREADS / 32];
  __shared__ int wi[THREADS / 32];
  const int qi = blockIdx.x;
  const int lane = blockIdx.y;
  const size_t base = ((size_t)lane * Q + qi) * M;
  const int tid = threadIdx.x;
  float prev_s = __int_as_float(0x7f800000);
  int prev_i = -1;
  for (int t = 0; t < k; ++t) {
    float bs = -__int_as_float(0x7f800000);
    int bi = NO_INDEX;
    for (int m = tid; m < M; m += THREADS) {
      const float s = cand_s[base + m];
      const int idx = cand_i[base + m];
      if (better(prev_s, prev_i, s, idx) && better(s, idx, bs, bi)) {
        bs = s;
        bi = idx;
      }
    }
    warp_argmax(bs, bi);
    if (tid % 32 == 0) {
      ws[tid / 32] = bs;
      wi[tid / 32] = bi;
    }
    __syncthreads();
    if (tid < 32) {
      bs = tid < THREADS / 32 ? ws[tid] : -__int_as_float(0x7f800000);
      bi = tid < THREADS / 32 ? wi[tid] : NO_INDEX;
      warp_argmax(bs, bi);
      if (tid == 0) {
        out_s[((size_t)lane * Q + qi) * k + t] = bs;
        out_i[((size_t)lane * Q + qi) * k + t] = bi;
        ws[0] = bs;
        wi[0] = bi;
      }
    }
    __syncthreads();
    prev_s = ws[0];
    prev_i = wi[0];
    __syncthreads();
  }
}

template <int Q>
int launch_stream(const float* db, const uint8_t* valid, const float* q, float* ws_s, int* ws_i,
                  int* counters, float* out_s, int* out_i, const Plan& plan, int N, int D, int k,
                  int ns, cudaStream_t st) {
  static bool allowed = false;  // opt into the full dynamic shared memory once
  if (!allowed) {
    cudaError_t err = cudaFuncSetAttribute(topk_stream<Q>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const int kl = list_len(k);
  const size_t smem = stream_layout(Q, D, kl, ns).total;
  topk_stream<Q><<<plan.first[plan.L], ST, smem, st>>>(db, valid, q, ws_s, ws_i, counters, out_s,
                                                      out_i, plan, N, D, k, kl, ns);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of one tile of the tile route, for the wrapper's workspace sizing.
int similarity_topk_lanes_tile_rows() { return TN; }

// Dynamic shared memory of one stream block (kernel.stream_smem mirrors it).
int similarity_topk_lanes_stream_smem(int Q, int D, int k, int ns) {
  return (int)stream_layout(Q, D, list_len(k), ns).total;
}

// db [L, N, D] f32, valid [L, N] u8, q [Q, D] f32 (all contiguous, db and q
// 16-byte aligned, D % 4 == 0, 1 <= k <= N), lane_rows [L] host ints in
// [1, N]; outputs out_s/out_i [L, Q, k]. route 0 (stream): per/first [L] and
// [L + 1] host ints from kernel.split_plan, `ns` ring stages, workspace
// ws_s/ws_i of first[L] * Q * k and counters [L] int32 zeroed once (the
// kernel leaves them at 0); Q <= SMALL_Q, k <= KMAX. route 1 (tile):
// workspace [L, Q, ceil(N/TN) * k], k <= TN. Launches on `stream` and returns
// cudaGetLastError(); a refused shape returns cudaErrorInvalidValue and
// launches nothing.
int similarity_topk_lanes_launch(const float* db, const uint8_t* valid, const float* q,
                                 float* ws_s, int* ws_i, int* counters, float* out_s, int* out_i,
                                 int L, int N, int D, int Q, int k, const int* lane_rows,
                                 const int* per, const int* first, int route, int ns,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L < 1 || L > MAX_LANES || Q < 1 || k < 1 || k > N || D % 4) return (int)cudaErrorInvalidValue;
  Plan plan;
  plan.L = L;
  for (int l = 0; l < L; ++l) {
    if (lane_rows[l] < 1 || lane_rows[l] > N) return (int)cudaErrorInvalidValue;
    plan.rows[l] = lane_rows[l];
  }
  if (route == 0) {
    if (Q > SMALL_Q || k > KMAX || ns < 2 || !counters ||
        stream_layout(Q, D, list_len(k), ns).total > (size_t)SMEM_LIMIT)
      return (int)cudaErrorInvalidValue;
    plan.first[0] = 0;
    for (int l = 0; l < L; ++l) {
      const int nb = first[l + 1] - first[l];
      if (nb < 1 || per[l] < 1 || (long long)per[l] * nb < lane_rows[l]) return (int)cudaErrorInvalidValue;
      plan.per[l] = per[l];
      plan.first[l + 1] = first[l + 1];
    }
    switch (Q) {
#define STREAM_CASE(n) \
  case n:              \
    return launch_stream<n>(db, valid, q, ws_s, ws_i, counters, out_s, out_i, plan, N, D, k, ns, st);
      STREAM_CASE(1) STREAM_CASE(2) STREAM_CASE(3) STREAM_CASE(4) STREAM_CASE(5) STREAM_CASE(6)
      STREAM_CASE(7) STREAM_CASE(8) STREAM_CASE(9) STREAM_CASE(10) STREAM_CASE(11)
      STREAM_CASE(12) STREAM_CASE(13) STREAM_CASE(14) STREAM_CASE(15) STREAM_CASE(16)
#undef STREAM_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (k > TN) return (int)cudaErrorInvalidValue;
  const int nb = (N + TN - 1) / TN;
  const int nqc = (Q + QC - 1) / QC;
  dim3 g1((unsigned)nqc * (unsigned)nb, (unsigned)L);
  topk_tiles<<<g1, THREADS, 0, st>>>(db, valid, q, ws_s, ws_i, plan, N, D, Q, k, nb, nqc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 g2((unsigned)Q, (unsigned)L);
  merge_lanes<<<g2, THREADS, 0, st>>>(ws_s, ws_i, out_s, out_i, Q, k, nb * k);
  return (int)cudaGetLastError();
}

}  // extern "C"
