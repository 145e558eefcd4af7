// Backward of the Mamba2 SSD chunked scan (ssd_scan.cu's forward) for one H100.
//
// The TPU kernel src/repro/kernels/ssd_scan/kernel.py :: ssd_scan_kernel has no
// backward: the reference trains through its jnp scan (src/repro/models/ssm.py
// _ssd_chunk_scan, a lax.scan over chunks), which XLA differentiates. The
// port's SSM blocks run the forward kernel for every full-sequence pass, so
// training on the card differentiates through it, and this file is that
// gradient. kernel.py `bwd_phases` is its plain version, phase for phase.
//
// For one (b, chunk c, head h) with L steps, cs = cumsum(dt A), the chunk's
// starting state S_c [P, N], w[s] = exp(cs[last] - cs[s]) dt[s], the masked
// decay exp(cs[l] - cs[s]) (s <= l), and G_{c+1} the gradient of the state
// the chunk leaves (G_nc = dstate, zero in training):
//   (a) ssd_bwd_chunk_sums + ssd_bwd_state_pass: S_c, from each chunk's own
//       contribution sum_s w[s] x[s] (x) B[s] carried across chunks in float32;
//   (b) ssd_bwd_chunk_sums: local_c = sum_l exp(cs[l]) dy[l] (x) C[l]; it also
//       writes each chunk's cs and dt, which every later kernel reads;
//   (c) ssd_bwd_state_pass: G_c = local_c + exp(cs[last]) G_{c+1}, <G_{c+1},
//       S_c> for the last step's d(cs) (per 256 state elements, summed in
//       order by ssd_bwd_dt), and S_c and G_{c+1} as the bf16 parts the tile
//       kernels multiply by;
//   (d) ssd_bwd_tiles<rows>, per 64-row tile: dC[l] = exp(cs[l]) dy[l] S_c
//       + sum_{s<=l} (dy[l].x[s]) decay dt[s] B[s], and the row terms of
//       d(cs); ssd_bwd_tiles<cols>, per 64-column tile: dx[s] = sum_{l>=s}
//       scores[l, s] dy[l] + D dy[s] + w[s] G_{c+1} B[s], dB[s] = sum_{l>=s}
//       (dy[l].x[s]) decay dt[s] C[l] + w[s] x[s] G_{c+1}, the column terms of
//       d(cs) and ddt, and a partial dD; ssd_bwd_dt, per (b, c, h): d(cs)
//       from those terms, its reverse cumsum, ddt = the direct terms + A
//       revcumsum, partial dA;
//   (e) ssd_bwd_reduce: dB and dC summed over a group's head slices in order,
//       dA and dD over (b, chunk) in order.
// A ragged last chunk has Lc < L steps: steps past Lc load as zeros with
// dt = 0, write nothing, and the last step's terms sit at Lc - 1.
//
// Bound on an H100. At mamba2-1.3b's training shape (B 8, S 512, H 64, P 64,
// N 128, chunk 256: two chunks) the work on the causal pairs is 47.5 GFLOP a
// call (chip_smoke.py `ssd_bwd_flops`) against 31 MB of inputs and outputs:
// bound by operations, 0.048 ms at the bf16 tensor-core rate.
//
// What held the first version (FP32 FMAs) at 0.7% of that bound, and
// what this design does about each:
//   - Every product ran as scalar FP32 FMAs. Now every product is mma.sync
//     m16n8k16 bf16 with a float32 accumulator, operands by ldmatrix from
//     rows padded to an odd number of 16-byte units (no bank conflicts), the
//     forward's rule for operands: bf16 inputs enter exact; a float32 operand
//     (the scores and dcb after decay and dt, S_c, G_{c+1}, x w, dy exp(cs))
//     enters as bf16 parts v = hi + lo (+ lo2), two for bf16 inputs, three
//     for float32 inputs (~24 bits: the float32 route keeps 1e-4 on the
//     tensor cores), the products of parts whose indices sum below the
//     larger part count taken. Three parts of every float32 tile do not fit
//     a block at N > 128 (P <= 64) or at P 128 with N 128; there float32
//     keeps the first version's FMA tile kernels (see "for float32 where
//     the tensor-core tiles do not fit" below).
//   - The per-head float32 dB and dC [B, S, H, N] (2 x 134 MB at mamba2's
//     shape) were written and read back. Now a tile block takes a slice of
//     `hb` heads of one group, stages its own B or C tile once, and sums the
//     slice's dC (or dB) in registers in head order; only [B, S, G, H / G /
//     hb, N] partial sums reach the reduction (hb = 8 at mamba2's shape:
//     8 x smaller). hb is the largest divisor of H / G that still leaves
//     two blocks for each of the card's 132 SMs.
//   - 119-137 KB of float32 tiles left one 256-thread block an SM, and every
//     tile was loaded, waited on, then computed. Now a 128-thread block holds
//     bf16 tiles: its own group tile, its own head tile (two, one per head
//     parity), and a ring of two stages, each a partner (group tile, head
//     tile) pair or a head's state parts, filled by cp.async one iteration
//     ahead: 107 KB at P 64, N 128, two blocks an SM. The per-head cs and dt
//     come from the chunk sums' workspace by cp.async too. The block's work
//     is one flat sequence over (head, partner tile, then the head's state
//     term), so the next head's first tiles load during this head's last.
//   - C B^T and dy x^T are still computed by both tile kernels (the fused
//     alternative would carry the row terms of every column tile to a second
//     pass through a [tiles, L, N] workspace per head, the traffic this
//     design removes). The tile kernels skip the tiles above the diagonal and
//     the 8-column strips above it in the diagonal tile, where alone the mask
//     is applied; the decay is one SFU op (2^x) and the mask a select after
//     it (cs[l] - cs[s] > 0 above the diagonal may overflow to inf, which the
//     select drops): an accurate expf under a branch cost as much as the
//     products.
//   - The chunk sums take all of N up to 128 in one block (half the blocks,
//     each scaled x or dy tile staged once), and every cumsum loads its
//     strided dt with all of the block's threads at once, then scans.
// Determinism: every output element is written by one block, every sum runs
// in one fixed order, and there are no atomics, so two calls give the same
// bits (a checkpoint restart on the card resumes exactly).
// Measured (chip_smoke.py --bwd-only, NVIDIA H100 80GB HBM3, 700.00 W; the
// first version on the same host): at mamba2-1.3b's train shape 1.2740 ms a
// call (the first version 6.6093 ms; 3.8% of the bound), its six kernels
// 0.169 / 0.086 / 0.430 / 0.546 / 0.020 / 0.024 ms; zamba2-7b's (H 112, G 2,
// N 64) 0.2728 ms (0.7963). PERF.md keeps the rest.
//
// Takes P in {16, 32, 64, 128} (tiles 64 or 128 wide), N <= 256 (tiles 64,
// 128 or 256 wide), H % G == 0; returns cudaErrorInvalidValue on anything
// else and ERR_SHARED_MEMORY where one block's tiles do not fit the device's
// shared memory (float32 at P 128 with N > 128, as the first version),
// launching nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;      // steps of a row or column tile
constexpr int THREADS = 256;  // the state pass, dt and reduction blocks
constexpr int TC = 128;       // the tensor-core blocks: four warps of 16 rows
constexpr unsigned FULL = 0xffffffffu;
constexpr int ERR_SHARED_MEMORY = -1;
constexpr int MIN_TILE_BLOCKS = 264;  // two tile blocks for each of the card's 132 SMs
constexpr int MAX_PARTS = 3;          // the workspace's state parts are sized for float32

template <typename T> struct Parts;  // bf16 parts of an input and of a float32 operand
template <> struct Parts<float> { static constexpr int IN = 3, F = 3; };
template <> struct Parts<bf16> { static constexpr int IN = 1, F = 2; };

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

struct Dims {
  int B, S, H, G, P, N, L, nc, nt;  // nt: 64-step tiles a chunk
  int npad;                         // N rounded up to 16
  int hb, nsl;                      // heads a tile block, head slices a group
  int neb;                          // 256-element blocks of one [P, N] state
};

__host__ __device__ inline int lpad_of(const Dims& d) { return d.nt * TILE; }

// One (b, chunk, head) position.
struct Chunk {
  int b, c, h, g, t0, Lc;  // t0: the chunk's first step; Lc: its live steps
};

__device__ __forceinline__ Chunk chunk_of(int bch, const Dims& d) {
  Chunk k;
  k.h = bch % d.H;
  k.c = (bch / d.H) % d.nc;
  k.b = bch / (d.H * d.nc);
  k.g = k.h / (d.H / d.G);
  k.t0 = k.c * d.L;
  k.Lc = min(d.L, d.S - k.t0);
  return k;
}

// cs[l] = A (dt[0] + ... + dt[l]) and dts[l] = dt[l] for l < Lc: the block
// loads dt, then warp 0 scans it, each lane a run of consecutive steps, then
// the runs' prefix across the lanes,
// the same code and order in every kernel that runs it. Steps Lc .. lpad - 1
// get dt = 0 and the last cs. Ends with the block synchronised.
__device__ void chunk_cumsum(const float* __restrict__ dtp, int H, float A, int Lc, int lpad,
                             float* cs, float* dts) {
  for (int l = threadIdx.x; l < Lc; l += blockDim.x) dts[l] = dtp[(size_t)l * H];  // all at once
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (Lc + 31) / 32;
    const int lo = min(lane * per, Lc), hi = min(lo + per, Lc);
    float run = 0.f;
    for (int l = lo; l < hi; ++l) {
      run += dts[l] * A;
      cs[l] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += o;
    }
    float excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = 0.f;
    for (int l = lo; l < hi; ++l) cs[l] += excl;
  }
  __syncthreads();
  const float tail = cs[Lc - 1];
  for (int l = Lc + threadIdx.x; l < lpad; l += blockDim.x) {
    cs[l] = tail;
    dts[l] = 0.f;
  }
  __syncthreads();
}

// Lane 0's sum of v over a warp, broadcast (one order for every lane).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return __shfl_sync(FULL, v, 0);
}

// The block's sum of v, in one fixed order, returned to every thread; `red`
// holds blockDim.x / 32 floats of shared memory.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) t += red[w];
  return t;
}

constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float ex2(float x) {  // 2^x on the SFU
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The sum of v over the 4 lanes of an accumulator row (the same bits in each)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  v += __shfl_xor_sync(FULL, v, 2);
  return v;
}

// ---- tensor-core building blocks (ssd_scan.cu's) ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(const bf16* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(const bf16* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) as one bf16 pair, lo in the low 16 bits; r0/r1 keep the remainders
__device__ __forceinline__ uint32_t split_pair(float& r0, float& r1) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(r0, r1);
  r0 -= __low2float(p);  // exact: a float minus its bf16 rounding
  r1 -= __high2float(p);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 8 float32 values as NP bf16 parts, 16 bytes per part, parts `pstride` apart
template <int NP>
__device__ __forceinline__ void split_store(bf16* dst, size_t pstride, float (&v)[8]) {
#pragma unroll
  for (int part = 0; part < NP; ++part) {
    uint4 w;
    w.x = split_pair(v[0], v[1]);
    w.y = split_pair(v[2], v[3]);
    w.z = split_pair(v[4], v[5]);
    w.w = split_pair(v[6], v[7]);
    *reinterpret_cast<uint4*>(dst + part * pstride) = w;
  }
}

// Two n8 accumulator tiles (columns k..k+7, k+8..k+15 of a warp's 16 rows) as
// the A operand of one k16 step, in NP bf16 parts.
template <int NP>
__device__ __forceinline__ void split_frag(const float (&c0)[4], const float (&c1)[4],
                                           uint32_t (&pa)[NP][4]) {
  float r[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int part = 0; part < NP; ++part)
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[part][i] = split_pair(r[2 * i], r[2 * i + 1]);
}

// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Rows [0, rows) and columns [0, cols) of a row-major source (row r at
// src + r * stride) into NP bf16 parts at dst[part * pstride + r * ld + col]:
// live where r < r_live and col < c_live, zero elsewhere; each row times
// rscale[r] when given. `vec`: the rows are 16-byte aligned. A bf16 source
// taken as it is (one part, no scale) is copied by cp.async (the caller
// commits and waits); else each thread has 4 loads of 8 elements in flight,
// then splits them.
template <int NP, typename T>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, size_t pstride, const T* src,
                                          size_t stride, int rows, int r_live, int cols,
                                          int c_live, bool vec, const float* rscale) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int cpr = cols / 8;
  const int total = rows * cpr;
  if constexpr (NP == 1 && sizeof(T) == 2) {
    if (vec && rscale == nullptr) {
      for (int e = tid; e < total; e += nt) {
        const int r = e / cpr;
        const int c8 = (e - r * cpr) * 8;
        const bool in = r < r_live && c8 < c_live;
        cp_async16(dst + (size_t)r * ld + c8, in ? src + (size_t)r * stride + c8 : src,
                   in ? 2 * min(8, c_live - c8) : 0);
      }
      return;
    }
  }
  constexpr int U = 4;
  for (int e0 = tid; e0 < total; e0 += U * nt) {
    float v[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * nt;
      const int r = e / cpr;
      const int c8 = (e - r * cpr) * 8;
      if (e < total && r < r_live && c8 < c_live) {
        const T* p = src + (size_t)r * stride + c8;
        if (vec && c8 + 8 <= c_live) {
          load8(p, v[u]);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) v[u][i] = c8 + i < c_live ? to_f(p[i]) : 0.f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * nt;
      if (e >= total) break;
      const int r = e / cpr;
      const int c8 = (e - r * cpr) * 8;
      if (rscale != nullptr) {
        const float sc = r < r_live ? rscale[r] : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) v[u][i] *= sc;
      }
      split_store<NP>(dst + (size_t)r * ld + c8, pstride, v[u]);
    }
  }
}

// n floats (a multiple of 4, 16-byte aligned at both ends) by cp.async
__device__ __forceinline__ void load_floats(float* dst, const float* src, int n) {
  for (int e = threadIdx.x; e < n / 4; e += blockDim.x) cp_async16(dst + 4 * e, src + 4 * e, 16);
}

// The A fragment of rows r0 .. r0 + 15 at k16 step kk of a [row][k] tile
__device__ __forceinline__ void frag_a(const bf16* t, int ld, int r0, int kk, uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(t + (r0 + (lane & 15)) * ld + kk * 16 + (lane >> 4) * 8, a);
}
// The B fragments of n-tiles n0 / 8 and n0 / 8 + 1 at k16 step kk: b[0..1]
// and b[2..3], from a [n][k] tile (TRANS false) or a [k][n] tile (TRANS true)
template <bool TRANS>
__device__ __forceinline__ void frag_b(const bf16* t, int ld, int n0, int kk, uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  if constexpr (TRANS)
    ldsm_x4_t(t + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8, b);
  else
    ldsm_x4(t + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + kk * 16 + ((lane >> 3) & 1) * 8, b);
}

// acc[j] (n-tiles jlo <= j < jhi, both even) += A . B over the k16 steps
// kk < nk: A is rows r0 .. r0 + 15 of a [row][k] tile in NA parts `pa`
// apart, B a tile in NB parts `pb` apart ([k][n] when BT, else [n][k]); the
// products of parts whose indices sum below NM are taken
template <int NA, int NB, int NM, bool BT, int NJ>
__device__ __forceinline__ void prod_ss(float (&acc)[NJ][4], const bf16* a, size_t pa, int lda,
                                        int r0, const bf16* b, size_t pb, int ldb, int nk,
                                        int jlo, int jhi) {
  for (int kk = 0; kk < nk; ++kk) {
    uint32_t af[NA][4];
#pragma unroll
    for (int ia = 0; ia < NA; ++ia) frag_a(a + ia * pa, lda, r0, kk, af[ia]);
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      if (j < jlo || j >= jhi) continue;
#pragma unroll
      for (int ib = 0; ib < NB; ++ib) {
        uint32_t bfr[4];
        frag_b<BT>(b + ib * pb, ldb, j * 8, kk, bfr);
#pragma unroll
        for (int ia = 0; ia < NA; ++ia)
          if (ia + ib < NM) {
            mma(acc[j], af[ia], bfr[0], bfr[1]);
            mma(acc[j + 1], af[ia], bfr[2], bfr[3]);
          }
      }
    }
  }
}

// acc[j] (n-tiles j < nn) += t . B over the k16 steps klo <= kk < khi: t is a
// warp's [16 x 64] float32 accumulator taken as the A operand in NA bf16
// parts, B the [64][n] tile (k = its rows) in NB parts `pb` apart
template <int NA, int NB, int NM, int NJ>
__device__ __forceinline__ void prod_rs(float (&acc)[NJ][4], const float (&t)[8][4], int klo,
                                        int khi, const bf16* b, size_t pb, int ldb, int nn) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk < klo || kk >= khi) continue;
    uint32_t af[NA][4];
    split_frag<NA>(t[2 * kk], t[2 * kk + 1], af);
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      if (j >= nn) break;
#pragma unroll
      for (int ib = 0; ib < NB; ++ib) {
        uint32_t bfr[4];
        frag_b<true>(b + ib * pb, ldb, j * 8, kk, bfr);
#pragma unroll
        for (int ia = 0; ia < NA; ++ia)
          if (ia + ib < NM) {
            mma(acc[j], af[ia], bfr[0], bfr[1]);
            mma(acc[j + 1], af[ia], bfr[2], bfr[3]);
          }
      }
    }
  }
}

// The float32 value of elements (r, c), (r, c + 1) of a tile of NP parts
template <int NP>
__device__ __forceinline__ float2 tile_pair(const bf16* t, size_t pst, int ld, int r, int c) {
  float2 v = make_float2(0.f, 0.f);
#pragma unroll
  for (int ip = 0; ip < NP; ++ip) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(t + ip * pst + r * ld + c));
    v.x += f.x;
    v.y += f.y;
  }
  return v;
}

// ---- (a), (b): the chunks' own state sums ----

// state columns a chunk-sum block: N up to 128 in one block, else 128 a block
__host__ __device__ constexpr int sums_cols(int nw) { return nw < 128 ? nw : 128; }

__host__ __device__ inline size_t sums_smem(const Dims& d, int npi, int npf, int ncs) {
  return (size_t)3 * lpad_of(d) * sizeof(float) +
         (size_t)TILE * (npf * (TILE + 8) + npi * (ncs + 8)) * sizeof(bf16);
}

// One block per (b, chunk, head) x (own or loc, NCS state columns: N up to
// 128 in one block) x 64-row slice of P: own[p, n] = sum_s (x[s, p] w[s])
// B[s, n], or loc[p, n] = sum_l (dy[l, p] exp(cs[l])) C[l, n], on the tensor
// cores (A = the scaled rows transposed, in bf16 parts; warp w owns columns
// n0 + NCS / 4 w ..). Block (y, z) = (0, 0) also writes the chunk's cs, dt
// and exp(cs[last]).
template <typename T, int NCS>
__global__ void __launch_bounds__(TC)
ssd_bwd_chunk_sums(const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
                   const T* __restrict__ dy, const float* __restrict__ dt,
                   const float* __restrict__ A, float* __restrict__ own, float* __restrict__ loc,
                   float* __restrict__ dec, float* __restrict__ csw, float* __restrict__ dtw,
                   Dims d, int vec_x, int vec_bc) {
  constexpr int NPI = Parts<T>::IN, NPF = Parts<T>::F, NPM = cmax(NPI, NPF);
  constexpr int LD = TILE + 8, LDB = NCS + 8, WJ = NCS / 64;  // 16-column pairs a warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int lp = lpad_of(d);
  float* cs = reinterpret_cast<float*>(smem);
  float* dts = cs + lp;
  float* sc = dts + lp;  // the A rows' scale: w, or exp(cs)
  bf16* at = reinterpret_cast<bf16*>(sc + lp);  // [NPF][TILE steps][LD]
  bf16* bt = at + NPF * TILE * LD;               // [NPI][TILE steps][LDB]
  const size_t pst = (size_t)TILE * LD, pbt = (size_t)TILE * LDB;

  const int bch = blockIdx.x;
  const Chunk k = chunk_of(bch, d);
  const int which = blockIdx.y & 1;  // 0: own, 1: loc
  const int n0 = (blockIdx.y >> 1) * NCS, p0 = blockIdx.z * TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const size_t xs = (size_t)d.H * d.P, bs = (size_t)d.G * d.N;
  const size_t row0 = (size_t)k.b * d.S + k.t0;
  const T* asrc = (which ? dy : x) + row0 * xs + (size_t)k.h * d.P + p0;
  const T* bsrc = (which ? Cm : Bm) + row0 * bs + (size_t)k.g * d.N + n0;
  // the first B / C tile needs no cs: it is in flight during the cumsum
  load_tile<NPI>(bt, LDB, pbt, bsrc, bs, TILE, k.Lc, NCS, d.N - n0, vec_bc, nullptr);
  cp_async_commit();
  chunk_cumsum(dt + row0 * d.H + k.h, d.H, A[k.h], k.Lc, lp, cs, dts);
  const float last = cs[k.Lc - 1];
  for (int l = tid; l < lp; l += TC) sc[l] = which ? expf(cs[l]) : expf(last - cs[l]) * dts[l];
  if (blockIdx.y == 0 && blockIdx.z == 0) {
    if (tid == 0) dec[bch] = expf(last);
    for (int l = tid; l < lp; l += TC) {
      csw[(size_t)bch * lp + l] = cs[l];
      dtw[(size_t)bch * lp + l] = dts[l];
    }
  }

  float acc[4][2 * WJ][4];  // p rows 16 mt + .., columns n0 + 16 WJ warp + 8 j + ..
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < 2 * WJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  const int mts = min(4, (d.P - p0 + 15) / 16);  // m-tiles holding rows of P

  for (int s0 = 0; s0 < k.Lc; s0 += TILE) {
    __syncthreads();  // sc is in; the previous tile's readers are done
    load_tile<NPF>(at, LD, pst, asrc + (size_t)s0 * xs, xs, TILE, k.Lc - s0, TILE, d.P - p0,
                   vec_x, sc + s0);
    if (s0 > 0)
      load_tile<NPI>(bt, LDB, pbt, bsrc + (size_t)s0 * bs, bs, TILE, k.Lc - s0, NCS, d.N - n0,
                     vec_bc, nullptr);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      uint32_t xa[4][NPF][4];  // A = the scaled rows transposed: rows p, k = steps
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int ip = 0; ip < NPF; ++ip)
          if (mt < mts)
            ldsm_x4_t(at + ip * pst + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * LD + mt * 16 +
                          ((lane >> 3) & 1) * 8,
                      xa[mt][ip]);
#pragma unroll
      for (int wj = 0; wj < WJ; ++wj)
#pragma unroll
        for (int jp = 0; jp < NPI; ++jp) {
          uint32_t bfr[4];  // B: k = steps, columns n
          frag_b<true>(bt + jp * pbt, LDB, warp * 16 * WJ + 16 * wj, kk, bfr);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int ip = 0; ip < NPF; ++ip)
              if (mt < mts && ip + jp < NPM) {
                mma(acc[mt][2 * wj], xa[mt][ip], bfr[0], bfr[1]);
                mma(acc[mt][2 * wj + 1], xa[mt][ip], bfr[2], bfr[3]);
              }
        }
    }
  }
  float* out = (which ? loc : own) + (size_t)bch * d.P * d.N;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < 2 * WJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + mt * 16 + gr + 8 * (e >> 1);
        const int n = n0 + warp * 16 * WJ + j * 8 + 2 * tq + (e & 1);
        if (p < d.P && n < d.N) out[(size_t)p * d.N + n] = acc[mt][j][e];
      }
}

// (a), (c): one block per (b, head) and 256 elements of its [P, N] state, a
// thread per element. Forward over the chunks: S_c (S_0 = 0) to `st` and, as
// NPF bf16 parts, to `sp`; backward: G_{c+1} (G_nc = dstate or 0) as parts
// to `gp`, and the block's share of <G_{c+1}, S_c> to gpart[bch][eb].
template <int NPF>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_state_pass(const float* __restrict__ own, const float* __restrict__ loc,
                   const float* __restrict__ dec, const float* __restrict__ dstate,
                   float* __restrict__ st, bf16* __restrict__ sp, bf16* __restrict__ gp,
                   float* __restrict__ gpart, Dims d) {
  __shared__ float red[THREADS / 32];
  const int bh = blockIdx.x / d.neb, eb = blockIdx.x % d.neb;
  const int b = bh / d.H, h = bh % d.H;
  const size_t pn = (size_t)d.P * d.N;
  const size_t e = (size_t)eb * THREADS + threadIdx.x;
  const bool in = e < pn;
  auto bch = [&](int c) { return ((size_t)b * d.nc + c) * d.H + h; };
  auto parts = [&](bf16* dst, float v) {
#pragma unroll
    for (int part = 0; part < NPF; ++part) {
      const bf16 q = __float2bfloat16_rn(v);
      dst[part * pn] = q;
      v -= __bfloat162float(q);
    }
  };
  float s = 0.f;
  for (int c = 0; c < d.nc; ++c) {
    if (!in) break;
    st[bch(c) * pn + e] = s;
    if (c > 0) parts(sp + bch(c) * NPF * pn + e, s);  // S_0 = 0 is never read
    s = fmaf(dec[bch(c)], s, own[bch(c) * pn + e]);
  }
  float g = in && dstate != nullptr ? dstate[(size_t)bh * pn + e] : 0.f;
  for (int c = d.nc - 1; c >= 0; --c) {
    float part = 0.f;
    if (in) {
      if (c < d.nc - 1 || dstate != nullptr) parts(gp + bch(c) * NPF * pn + e, g);
      part = g * st[bch(c) * pn + e];
      g = fmaf(dec[bch(c)], g, loc[bch(c) * pn + e]);
    }
    const float tot = block_sum(part, red);
    if (threadIdx.x == 0) gpart[bch(c) * d.neb + eb] = tot;
  }
}

// ---- (d): the [L, L] tile kernels ----

// Shared memory of one tile block (bytes from its start): the per-head cs
// and dt (two heads), 32 floats of scratch, then the bf16 tiles: the own
// group tile, two own head tiles (one per head parity), and the ring's
// stages, each a partner (group tile, head tile) pair or a head's state
// parts [PW][NW + 8].
struct TileLayout {
  size_t o1, o2, ring, entry;  // element offsets of the bf16 tiles; a stage's elements
  size_t tiles;                // byte offset of the bf16 tiles
  size_t bytes;                // at `stages` stages
};

__host__ __device__ inline TileLayout tile_layout(int npi, int npf, int pw, int nw, int lp,
                                                  int stages) {
  const size_t ldn = (size_t)nw + 8, ldp = (size_t)pw + 8;
  TileLayout t;
  t.tiles = ((size_t)4 * lp + 32) * sizeof(float);
  t.o1 = 0;
  t.o2 = (size_t)npi * TILE * ldn;
  t.ring = t.o2 + (size_t)2 * npi * TILE * ldp;
  const size_t pair = (size_t)npi * TILE * (ldn + ldp), state = (size_t)npf * pw * ldn;
  t.entry = pair > state ? pair : state;
  t.bytes = t.tiles + (t.ring + (size_t)stages * t.entry) * sizeof(bf16);
  return t;
}

// Blocks an SM holds at least, for the register budget: two where two fit
// the shared memory (bf16 up to 128 state columns), else one.
template <typename T, int NW>
constexpr int tile_min_blocks() { return sizeof(T) == 2 && NW <= 128 ? 2 : 1; }

struct TileArgs {
  const void *x, *Bm, *Cm, *dy;
  const float *Dp, *csw, *dtw;
  const bf16 *sp, *gp;     // S_c, G_{c+1} in NPF parts [bch][NPF][P][N]
  const float* dstate;     // only whether there is one
  float* gsum_part;        // [B][S][G][nsl][N]: the head slices' dC (rows) or dB (cols)
  float *rs, *cm, *qv;     // [B][S][H]
  float* ddp;              // [bch][nt]
  void* dx;
  int vec_x, vec_bc, vec_st, stages;
};

// One block per (b, chunk, group, slice of hb heads, own 64-step tile): warp
// w owns the tile's steps own0 + 16 w ... The rows kernel (COLS false) owns
// steps l and walks the partner tiles s0 <= l0 (C and dy own, B and x
// partner); the columns kernel owns steps s and walks l0 >= s0 (B and x own,
// C and dy partner). For each head of the slice in order, and each partner
// tile: C B^T over N and dy x^T over P, both [16 x 64] a warp; the decay,
// dt and (on the diagonal tile only) the causal mask; rows: dcb = (dy x)
// decay dt[s] summed into the slice's dC with B, the row terms of d(cs);
// columns: scores^T dy into the head's dx, dcb^T C into the slice's dB, the
// column terms. Then the head's state term (rows: exp(cs) dy S_c into dC and
// d(cs); columns: w G_{c+1} B into dx, w x G_{c+1} into dB, x . G B) and its
// outputs.
template <typename T, int PW, int NW, bool COLS>
__global__ void __launch_bounds__(TC, (tile_min_blocks<T, NW>()))
ssd_bwd_tiles(const TileArgs a, Dims d) {
  constexpr int NPI = Parts<T>::IN, NPF = Parts<T>::F, NPM = cmax(NPI, NPF);
  constexpr int LDN = NW + 8, LDP = PW + 8;
  constexpr int NJ = NW / 8, PJ = PW / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lp = lpad_of(d);
  const TileLayout lay = tile_layout(NPI, NPF, PW, NW, lp, a.stages);
  float* csb = reinterpret_cast<float*>(smem);  // [2][lp]
  float* dtb = csb + 2 * lp;                     // [2][lp]
  float* red = dtb + 2 * lp;                     // 32 floats
  bf16* tiles = reinterpret_cast<bf16*>(smem + lay.tiles);
  bf16* o1 = tiles + lay.o1;
  bf16* o2 = tiles + lay.o2;
  bf16* ring = tiles + lay.ring;
  const size_t po1 = (size_t)TILE * LDN, po2 = (size_t)TILE * LDP, pst = (size_t)PW * LDN;

  // the block's place; rows: the longest (last) tiles first
  int r = blockIdx.x;
  const int tq_ = r % d.nt;
  r /= d.nt;
  const int sl = r % d.nsl;
  r /= d.nsl;
  const int g = r % d.G;
  r /= d.G;
  const int c = r % d.nc;
  const int b = r / d.nc;
  const int tile = COLS ? tq_ : d.nt - 1 - tq_;
  const int rep = d.H / d.G;
  const int h0 = g * rep + sl * d.hb;
  const int t0 = c * d.L, Lc = min(d.L, d.S - t0);
  const int own0 = tile * TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  auto bch_of = [&](int h) { return ((size_t)b * d.nc + c) * d.H + h; };
  if (own0 >= Lc) {  // a tile past the ragged chunk's end
    if (COLS)
      for (int i = tid; i < d.hb; i += TC) a.ddp[bch_of(h0 + i) * d.nt + tile] = 0.f;
    return;
  }
  const int ntl = (Lc + TILE - 1) / TILE;
  const int np = COLS ? ntl - tile : tile + 1;  // partner tiles
  const bool has_state = COLS ? (c < d.nc - 1 || a.dstate != nullptr) : c > 0;
  const int ni = np + (has_state ? 1 : 0);  // iterations a head
  const int total = d.hb * ni;

  const T* xg = static_cast<const T*>(a.x);
  const T* dyg = static_cast<const T*>(a.dy);
  const size_t xs = (size_t)d.H * d.P, bs = (size_t)d.G * d.N;
  const size_t row0 = (size_t)b * d.S + t0;
  const T* grp_own = static_cast<const T*>(COLS ? a.Bm : a.Cm) + row0 * bs + (size_t)g * d.N;
  const T* grp_par = static_cast<const T*>(COLS ? a.Cm : a.Bm) + row0 * bs + (size_t)g * d.N;
  const T* head_own = (COLS ? xg : dyg) + row0 * xs;
  const T* head_par = (COLS ? dyg : xg) + row0 * xs;
  const bf16* stp = COLS ? a.gp : a.sp;
  const size_t pn = (size_t)d.P * d.N;

  // iteration it's loads: the head's own tile, cs and dt at its first
  // iteration; a partner pair or the head's state parts into stage it % stages
  auto issue = [&](int it) {
    const int hi = it / ni, kq = it % ni, h = h0 + hi;
    if (kq == 0) {
      load_floats(csb + (hi & 1) * lp, a.csw + bch_of(h) * lp, lp);
      load_floats(dtb + (hi & 1) * lp, a.dtw + bch_of(h) * lp, lp);
      load_tile<NPI>(o2 + (hi & 1) * NPI * po2, LDP, po2, head_own + (size_t)own0 * xs + h * d.P,
                     xs, TILE, Lc - own0, PW, d.P, a.vec_x, nullptr);
    }
    bf16* slot = ring + (size_t)(it % a.stages) * lay.entry;
    if (kq < np) {
      const int p0 = (COLS ? tile + kq : kq) * TILE;
      load_tile<NPI>(slot, LDN, po1, grp_par + (size_t)p0 * bs, bs, TILE, Lc - p0, NW, d.N,
                     a.vec_bc, nullptr);
      load_tile<NPI>(slot + NPI * po1, LDP, po2, head_par + (size_t)p0 * xs + h * d.P, xs, TILE,
                     Lc - p0, PW, d.P, a.vec_x, nullptr);
    } else {
      for (int ip = 0; ip < NPF; ++ip)
        load_tile<1>(slot + ip * pst, LDN, pst, stp + (bch_of(h) * NPF + ip) * pn, (size_t)d.N,
                     PW, d.P, NW, d.N, a.vec_st, nullptr);
    }
    cp_async_commit();
  };

  // the own group tile needs nothing else: it goes with the first iteration
  load_tile<NPI>(o1, LDN, po1, grp_own + (size_t)own0 * bs, bs, TILE, Lc - own0, NW, d.N,
                 a.vec_bc, nullptr);
  if (a.stages > 1) issue(0);

  const bool live = own0 + 16 * warp < Lc;  // this warp has a live step
  const int wr = 16 * warp;                 // its first row in the own tiles
  const int nkn = d.npad / 16, nnn = d.npad / 8, nkp = d.P / 16, nnp = d.P / 8;
  float gacc[NJ][4];  // the slice's dC (rows) or dB (cols) over its heads
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gacc[j][e] = 0.f;
  float hacc[PJ][4];   // cols: the head's dx
  float rsum[2], qsum[2], dd = 0.f;  // the head's row (or column) terms and q, dD's share

  for (int it = 0; it < total; ++it) {
    if (a.stages > 1) {
      if (it + 1 < total) {
        issue(it + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      issue(it);
      cp_async_wait<0>();
    }
    __syncthreads();
    const int hi = it / ni, kq = it % ni, h = h0 + hi;
    const float* cs = csb + (hi & 1) * lp;
    const float* dts = dtb + (hi & 1) * lp;
    const bf16* own2 = o2 + (hi & 1) * NPI * po2;
    const bf16* slot = ring + (size_t)(it % a.stages) * lay.entry;
    if (kq == 0) {
      rsum[0] = rsum[1] = qsum[0] = qsum[1] = 0.f;
      dd = 0.f;
#pragma unroll
      for (int j = 0; j < PJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[j][e] = 0.f;
    }
    if (kq < np && live) {  // a partner tile
      const int tp = COLS ? tile + kq : kq;
      const int par0 = tp * TILE;
      const bool diag = tp == tile;
      // the 8-column strips (and 16-column k-steps) a warp's rows can meet
      const int jlo = COLS && diag ? 2 * warp : 0, jhi = !COLS && diag ? 2 * warp + 2 : 8;
      const int klo = COLS && diag ? warp : 0, khi = !COLS && diag ? warp + 1 : 4;
      const bf16* q1 = slot;
      const bf16* q2 = slot + NPI * po1;
      float t1[8][4], t2[8][4];  // C B^T and dy x^T: own rows, partner columns
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) t1[j][e] = t2[j][e] = 0.f;
      prod_ss<NPI, NPI, NPI, false, 8>(t1, o1, po1, LDN, wr, q1, po1, LDN, nkn, jlo, jhi);
      prod_ss<NPI, NPI, NPI, false, 8>(t2, own2, po2, LDP, wr, q2, po2, LDP, nkp, jlo, jhi);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < jlo || j >= jhi) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = own0 + wr + gr + 8 * (e >> 1);    // own step
          const int pj = par0 + 8 * j + 2 * tq + (e & 1);  // partner step
          const int l = COLS ? pj : i, s = COLS ? i : pj;
          // the decay as one SFU op and the mask as a select: an accurate
          // expf under a branch cost as much as the products
          const float dec = !diag || s <= l ? ex2((cs[l] - cs[s]) * LOG2E) : 0.f;
          if constexpr (COLS) {
            const float ds = dec * dts[s];
            rsum[e >> 1] = fmaf(t2[j][e] * t1[j][e], dec, rsum[e >> 1]);  // cm
            t1[j][e] *= ds;  // the scores
            t2[j][e] *= ds;  // dcb
          } else {
            t2[j][e] *= dec * dts[s];  // dcb
            rsum[e >> 1] = fmaf(t2[j][e], t1[j][e], rsum[e >> 1]);
          }
        }
      }
      prod_rs<NPF, NPI, NPM, NJ>(gacc, t2, klo, khi, q1, po1, LDN, nnn);
      if constexpr (COLS) {
        prod_rs<NPF, NPI, NPM, PJ>(hacc, t1, klo, khi, q2, po2, LDP, nnp);
        if (diag) {  // the partner tile is the own steps: D dy and dD's share
          const float Dh = a.Dp[h];
#pragma unroll
          for (int j = 0; j < PJ; ++j) {
            if (j >= nnp) break;
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int row = wr + gr + 8 * rr, col = 8 * j + 2 * tq;
              const float2 dv = tile_pair<NPI>(q2, po2, LDP, row, col);
              const float2 xv = tile_pair<NPI>(own2, po2, LDP, row, col);
              hacc[j][2 * rr] = fmaf(Dh, dv.x, hacc[j][2 * rr]);
              hacc[j][2 * rr + 1] = fmaf(Dh, dv.y, hacc[j][2 * rr + 1]);
              dd = fmaf(dv.x, xv.x, dd);
              dd = fmaf(dv.y, xv.y, dd);
            }
          }
        }
      }
    } else if (kq == np && live) {  // the head's state term
      const float last = cs[Lc - 1];
      if constexpr (COLS) {
        float u[PJ][4];  // G_{c+1} B[s]: [16 s x P]
#pragma unroll
        for (int j = 0; j < PJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) u[j][e] = 0.f;
        prod_ss<NPI, NPF, NPM, false, PJ>(u, o1, po1, LDN, wr, slot, pst, LDN, nkn, 0, nnp);
        float w[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int s = own0 + wr + gr + 8 * rr;
          w[rr] = expf(last - cs[s]) * dts[s];
        }
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          if (j >= nnp) break;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const float2 xv = tile_pair<NPI>(own2, po2, LDP, wr + gr + 8 * rr, 8 * j + 2 * tq);
            qsum[rr] = fmaf(xv.x, u[j][2 * rr], qsum[rr]);
            qsum[rr] = fmaf(xv.y, u[j][2 * rr + 1], qsum[rr]);
            hacc[j][2 * rr] = fmaf(w[rr], u[j][2 * rr], hacc[j][2 * rr]);
            hacc[j][2 * rr + 1] = fmaf(w[rr], u[j][2 * rr + 1], hacc[j][2 * rr + 1]);
          }
        }
        float xgm[NJ][4];  // x[s] G_{c+1}: [16 s x N]
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) xgm[j][e] = 0.f;
        prod_ss<NPI, NPF, NPM, true, NJ>(xgm, own2, po2, LDP, wr, slot, pst, LDN, nkp, 0, nnn);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) gacc[j][e] = fmaf(w[e >> 1], xgm[j][e], gacc[j][e]);
      } else {
        float v[NJ][4];  // dy[l] S_c: [16 l x N]
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) v[j][e] = 0.f;
        prod_ss<NPI, NPF, NPM, true, NJ>(v, own2, po2, LDP, wr, slot, pst, LDN, nkp, 0, nnn);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float ecs = expf(cs[own0 + wr + gr + 8 * rr]);
          float cv = 0.f;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            if (j >= nnn) break;
            const float2 cc = tile_pair<NPI>(o1, po1, LDN, wr + gr + 8 * rr, 8 * j + 2 * tq);
            cv = fmaf(cc.x, v[j][2 * rr], cv);
            cv = fmaf(cc.y, v[j][2 * rr + 1], cv);
            gacc[j][2 * rr] = fmaf(ecs, v[j][2 * rr], gacc[j][2 * rr]);
            gacc[j][2 * rr + 1] = fmaf(ecs, v[j][2 * rr + 1], gacc[j][2 * rr + 1]);
          }
          rsum[rr] = fmaf(ecs, cv, rsum[rr]);
        }
      }
    }
    if (kq == ni - 1) {  // the head's outputs
      const size_t hrow = (size_t)d.H;
      if (live) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = own0 + wr + gr + 8 * rr;
          const float rsv = quad_sum(rsum[rr]);
          const float qv = quad_sum(qsum[rr]);
          if (i >= Lc) continue;
          const size_t t = (row0 + i) * hrow + h;
          if (tq == 0) {
            if constexpr (COLS) {
              a.cm[t] = rsv;
              a.qv[t] = qv;
            } else {
              a.rs[t] = rsv;
            }
          }
          if constexpr (COLS) {
            T* dxr = static_cast<T*>(a.dx) + (row0 + i) * xs + (size_t)h * d.P;
#pragma unroll
            for (int j = 0; j < PJ; ++j) {
              if (j >= nnp) break;
              store2(dxr + 8 * j + 2 * tq, hacc[j][2 * rr], hacc[j][2 * rr + 1]);
            }
          }
        }
      }
      if constexpr (COLS) {
        const float tot = block_sum(dd, red);
        if (tid == 0) a.ddp[bch_of(h) * d.nt + tile] = tot;
      }
    }
    __syncthreads();  // this stage, and this head's buffers, are free again
  }

  if (live) {  // the slice's dC (rows) or dB (cols), its partial sum over heads
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = own0 + wr + gr + 8 * rr;
      if (i >= Lc) continue;
      float* out = a.gsum_part + (((row0 + i) * d.G + g) * d.nsl + sl) * (size_t)d.N;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = 8 * j + 2 * tq;
        if (n >= d.N) break;
        out[n] = gacc[j][2 * rr];
        if (n + 1 < d.N) out[n + 1] = gacc[j][2 * rr + 1];
      }
    }
  }
}

// ---- (d) for float32 where the tensor-core tiles do not fit ----
// Three bf16 parts of every float32 tile need more than a block's shared
// memory at N > 128 (P <= 64) and at P 128 with N 128: there the two tile
// kernels are the first version's, float32 FMAs on the CUDA cores over
// float32 tiles, a 256-thread block per (b, chunk, head, 64-step tile) with
// a 4 x 4 register tile of a [64 x 64] score tile (rows tr + 16 i, columns
// tc + 16 j, tr = tid / 16, tc = tid % 16) and 4 rows x P / 16 or N / 16
// columns of its gradient accumulators; rows padded to an odd width, so
// that 16 rows read at one column fall in 16 banks. Each head writes its
// own dC and dB rows (one head a slice: hb = 1), which ssd_bwd_reduce sums
// in head order. The other four kernels are the tensor-core route's.
constexpr int LDT = TILE + 1;  // padded row of a [64 x 64] score tile

// Stage rows t0 + r0 .. + 63 of one head's (or group's) [.., width] rows
// (src at step t0, rows `stride` elements apart) into a [64][ld] float tile;
// rows at or past Lc and columns past `width` are zeros, up to `cols`.
template <typename T>
__device__ __forceinline__ void stage_f32(float* dst, int ld, const T* __restrict__ src,
                                          size_t stride, int r0, int Lc, int width, int cols) {
  for (int e = threadIdx.x; e < TILE * cols; e += blockDim.x) {
    const int r = e / cols, col = e % cols;
    const bool in = r0 + r < Lc && col < width;
    dst[r * ld + col] = in ? to_f(src[(size_t)(r0 + r) * stride + col]) : 0.f;
  }
}

// The 4 x 4 register tile of a[r] . b[col] over `len`: rows tr + 16 i of a,
// rows tc + 16 j of b, both [64][ld] tiles.
__device__ __forceinline__ void tile_dots(float (&out)[4][4], const float* a, const float* b,
                                          int ld, int len, int tr, int tc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int e = 0; e < len; ++e) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(tr + 16 * i) * ld + e];
      bv[i] = b[(tc + 16 * i) * ld + e];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(av[i], bv[j], out[i][j]);
  }
}

// Sum v over the 16 threads of a tile row (lanes tc of one half-warp).
__device__ __forceinline__ float row16_sum(float v) {
#pragma unroll
  for (int off = 8; off; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

template <int NJ>
__host__ __device__ constexpr int ld_n() { return 16 * NJ + 1; }

__host__ __device__ inline size_t rows_smem(const Dims& d, int ldn) {
  return ((size_t)3 * lpad_of(d) + 2 * TILE * ldn + 2 * TILE * (d.P + 1) + TILE * LDT) *
         sizeof(float);
}

// Rows: one block per (b, chunk, head, 64-row tile l0..). dCh[l] (per
// head, float32) = exp(cs[l]) dy[l] S_c + sum_{s <= l} dcb[l, s] B[s] with
// dcb = (dy[l] . x[s]) decay dt[s]; rs[l] = exp(cs[l]) C[l] . (dy[l] S_c)
// + sum_s dcb[l, s] (C[l] . B[s]), the row terms of d(cs[l]).
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_rows_fma(const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
                 const T* __restrict__ dy, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ st,
                 float* __restrict__ dCh, float* __restrict__ rs, Dims d) {
  constexpr int LDN = ld_n<NJ>();
  const int LDP = d.P + 1;
  extern __shared__ float smem_f[];
  const int lp = lpad_of(d);
  float* cs = smem_f;
  float* dts = cs + lp;
  float* ecs = dts + lp;
  float* ct = ecs + lp;          // [TILE][LDN] own rows
  float* bt = ct + TILE * LDN;   // [TILE][LDN] key tile
  float* dyt = bt + TILE * LDN;  // [TILE][LDP] own rows
  float* xt = dyt + TILE * LDP;  // [TILE][LDP] key tile
  float* t1 = xt + TILE * LDP;   // [TILE][LDT] dcb

  const int bch = blockIdx.x / d.nt, l0 = (blockIdx.x % d.nt) * TILE;
  const Chunk k = chunk_of(bch, d);
  if (l0 >= k.Lc) return;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const size_t xrow = (size_t)d.H * d.P, brow = (size_t)d.G * d.N;
  const size_t xoff = ((size_t)k.b * d.S + k.t0) * xrow + (size_t)k.h * d.P;
  const size_t boff = ((size_t)k.b * d.S + k.t0) * brow + (size_t)k.g * d.N;
  chunk_cumsum(dt + ((size_t)k.b * d.S + k.t0) * d.H + k.h, d.H, A[k.h], k.Lc, lp, cs, dts);
  for (int l = tid; l < lp; l += THREADS) ecs[l] = expf(cs[l]);
  stage_f32(ct, LDN, Cm + boff, brow, l0, k.Lc, d.N, 16 * NJ);
  stage_f32(dyt, LDP, dy + xoff, xrow, l0, k.Lc, d.P, d.P);
  __syncthreads();

  // exp(cs[l]) dy[l] S_c, the state's S_c [P, N] read from the workspace
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  const float* sc = st + (size_t)bch * d.P * d.N;
  for (int p = 0; p < d.P; ++p) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = dyt[(tr + 16 * i) * LDP + p];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = tc + 16 * j;
      const float sv = n < d.N ? sc[(size_t)p * d.N + n] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], sv, acc[i][j]);
    }
  }
  float rowt[4];  // this thread's share of the row terms
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float e = ecs[l0 + tr + 16 * i];
    rowt[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc[i][j] *= e;
      rowt[i] = fmaf(ct[(tr + 16 * i) * LDN + tc + 16 * j], acc[i][j], rowt[i]);
    }
  }

  for (int s0 = 0; s0 <= l0; s0 += TILE) {
    __syncthreads();  // the previous tile's readers are done
    stage_f32(bt, LDN, Bm + boff, brow, s0, k.Lc, d.N, 16 * NJ);
    stage_f32(xt, LDP, x + xoff, xrow, s0, k.Lc, d.P, d.P);
    __syncthreads();
    float cb[4][4], dx[4][4];
    tile_dots(cb, ct, bt, LDN, d.N, tr, tc);
    tile_dots(dx, dyt, xt, LDP, d.P, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = l0 + tr + 16 * i, s = s0 + tc + 16 * j;
        const float dcb = (s <= l && l < k.Lc) ? dx[i][j] * expf(cs[l] - cs[s]) * dts[s] : 0.f;
        rowt[i] = fmaf(dcb, cb[i][j], rowt[i]);
        t1[(tr + 16 * i) * LDT + tc + 16 * j] = dcb;
      }
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < TILE; ++s) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = t1[(tr + 16 * i) * LDT + s];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float bv = bt[s * LDN + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], bv, acc[i][j]);
      }
    }
  }

  const size_t hrow = (size_t)d.H * d.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + tr + 16 * i;
    const float r = row16_sum(rowt[i]);
    if (l >= k.Lc) continue;
    const size_t t = (size_t)k.b * d.S + k.t0 + l;
    if (tc == 0) rs[t * d.H + k.h] = r;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = tc + 16 * j;
      if (n < d.N) dCh[t * hrow + (size_t)k.h * d.N + n] = acc[i][j];
    }
  }
}

__host__ __device__ inline size_t cols_smem(const Dims& d, int ldn, int pw) {
  const size_t lt = (size_t)TILE * ldn + (size_t)TILE * (pw + 1);
  const size_t gs = (size_t)pw * ldn;
  return ((size_t)3 * lpad_of(d) + lt + (lt > gs ? lt : gs) + 2 * TILE * LDT +
          (THREADS / 32) * TILE) * sizeof(float);
}

// Columns: one block per (b, chunk, head, 64-column tile s0..). With
// scores = (C[l] . B[s]) decay dt[s] and dcb = (dy[l] . x[s]) decay dt[s]
// over l >= s: dx[s] = sum_l scores dy[l] + D dy[s] + w[s] G_{c+1} B[s];
// dBh[s] (per head, float32) = sum_l dcb C[l] + w[s] x[s] G_{c+1};
// cm[s] = sum_l (dy[l] . x[s]) (C[l] . B[s]) decay (ddt's direct term, and
// dt[s] cm[s] is d(cs)'s column term); qv[s] = x[s] . G_{c+1} B[s]; the
// tile's partial dD = sum dy . x. P is padded with zeros to 16 PJ columns.
template <typename T, int PJ, int NJ>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_cols_fma(const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
                 const T* __restrict__ dy, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Dp,
                 const bf16* __restrict__ gp, const float* __restrict__ dstate,
                 T* __restrict__ dx, float* __restrict__ dBh,
                 float* __restrict__ cm, float* __restrict__ qv, float* __restrict__ ddp, Dims d) {
  constexpr int LDN = ld_n<NJ>();
  constexpr int LDP = 16 * PJ + 1;
  extern __shared__ float smem_f[];
  const int lp = lpad_of(d);
  float* cs = smem_f;
  float* dts = cs + lp;
  float* wgt = dts + lp;
  float* bt = wgt + lp;          // [TILE][LDN] own columns' B
  float* xt = bt + TILE * LDN;   // [TILE][LDP] own columns' x
  float* ct = xt + TILE * LDP;   // [TILE][LDN] row tile's C; then G_{c+1} [P][LDN]
  float* dyt = ct + TILE * LDN;  // [TILE][LDP] row tile's dy
  float* gs = ct;
  const size_t lt = (size_t)TILE * LDN + TILE * LDP, gsz = (size_t)16 * PJ * LDN;
  float* t1 = ct + (lt > gsz ? lt : gsz);  // [TILE][LDT] scores
  float* t2 = t1 + TILE * LDT;              // [TILE][LDT] dcb
  float* cmp = t2 + TILE * LDT;             // [8][TILE] the warps' column sums

  const int bch = blockIdx.x / d.nt, tile = blockIdx.x % d.nt, s0 = tile * TILE;
  const Chunk k = chunk_of(bch, d);
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16, warp = tid / 32, lane = tid % 32;
  float* ddp_at = ddp + ((size_t)bch * d.nt + tile);
  if (s0 >= k.Lc) {
    if (tid == 0) *ddp_at = 0.f;
    return;
  }
  const size_t xrow = (size_t)d.H * d.P, brow = (size_t)d.G * d.N;
  const size_t xoff = ((size_t)k.b * d.S + k.t0) * xrow + (size_t)k.h * d.P;
  const size_t boff = ((size_t)k.b * d.S + k.t0) * brow + (size_t)k.g * d.N;
  chunk_cumsum(dt + ((size_t)k.b * d.S + k.t0) * d.H + k.h, d.H, A[k.h], k.Lc, lp, cs, dts);
  const float last = cs[k.Lc - 1], Dh = Dp[k.h];
  for (int l = tid; l < lp; l += THREADS) wgt[l] = expf(last - cs[l]) * dts[l];
  stage_f32(bt, LDN, Bm + boff, brow, s0, k.Lc, d.N, 16 * NJ);
  stage_f32(xt, LDP, x + xoff, xrow, s0, k.Lc, d.P, 16 * PJ);

  float adx[4][PJ], adb[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < PJ; ++j) adx[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) adb[i][j] = 0.f;
  }
  float colm = 0.f, dd = 0.f;

  for (int l0 = s0; l0 < k.Lc; l0 += TILE) {
    __syncthreads();  // the previous tile's readers are done
    stage_f32(ct, LDN, Cm + boff, brow, l0, k.Lc, d.N, 16 * NJ);
    stage_f32(dyt, LDP, dy + xoff, xrow, l0, k.Lc, d.P, 16 * PJ);
    __syncthreads();
    float cb[4][4], dxy[4][4];  // rows l = l0 + tr + 16 i, columns s = s0 + tc + 16 j
    tile_dots(cb, ct, bt, LDN, d.N, tr, tc);
    tile_dots(dxy, dyt, xt, LDP, d.P, tr, tc);
    float mpart[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = l0 + tr + 16 * i, s = s0 + tc + 16 * j;
        const float dec = (s <= l && l < k.Lc) ? expf(cs[l] - cs[s]) : 0.f;
        t1[(tr + 16 * i) * LDT + tc + 16 * j] = cb[i][j] * dec * dts[s];
        t2[(tr + 16 * i) * LDT + tc + 16 * j] = dxy[i][j] * dec * dts[s];
        mpart[j] = fmaf(dxy[i][j] * cb[i][j], dec, mpart[j]);
      }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mpart[j] += __shfl_xor_sync(FULL, mpart[j], 16);
      if (lane < 16) cmp[warp * TILE + tc + 16 * j] = mpart[j];
    }
    if (l0 == s0) {  // the row tile is the block's own steps: D dy and dD
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const float dv = dyt[(tr + 16 * i) * LDP + tc + 16 * j];
          adx[i][j] = fmaf(Dh, dv, adx[i][j]);
          dd = fmaf(dv, xt[(tr + 16 * i) * LDP + tc + 16 * j], dd);
        }
    }
    __syncthreads();
#pragma unroll 2
    for (int l = 0; l < TILE; ++l) {
      float sa[4], da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sa[i] = t1[l * LDT + tr + 16 * i];
        da[i] = t2[l * LDT + tr + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        const float v = dyt[l * LDP + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) adx[i][j] = fmaf(sa[i], v, adx[i][j]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float v = ct[l * LDN + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) adb[i][j] = fmaf(da[i], v, adb[i][j]);
      }
    }
    if (tid < TILE)
      for (int w = 0; w < THREADS / 32; ++w) colm += cmp[w * TILE + tid];
  }

  // the state terms: G_{c+1} [P, N] (the sum of its parts) staged over the row tiles
  __syncthreads();
  const size_t pn = (size_t)d.P * d.N;
  const bf16* g = gp + (size_t)bch * 3 * pn;
  const bool has_state = k.c < d.nc - 1 || dstate != nullptr;
  for (int e = tid; e < 16 * PJ * 16 * NJ; e += THREADS) {
    const int p = e / (16 * NJ), n = e % (16 * NJ);
    const size_t at = (size_t)p * d.N + n;
    gs[p * LDN + n] = has_state && p < d.P && n < d.N
                          ? (to_f(g[at]) + to_f(g[pn + at])) + to_f(g[2 * pn + at])
                          : 0.f;
  }
  __syncthreads();
  float qpart[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float w = wgt[s0 + tr + 16 * i];
    qpart[i] = 0.f;
#pragma unroll
    for (int j = 0; j < PJ; ++j) {  // u[s, p] = G_{c+1}[p] . B[s]
      const int p = tc + 16 * j;
      float u = 0.f;
      for (int n = 0; n < d.N; ++n) u = fmaf(bt[(tr + 16 * i) * LDN + n], gs[p * LDN + n], u);
      qpart[i] = fmaf(xt[(tr + 16 * i) * LDP + p], u, qpart[i]);
      adx[i][j] = fmaf(w, u, adx[i][j]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {  // (x[s] G_{c+1})[n]
      const int n = tc + 16 * j;
      float xg = 0.f;
      for (int p = 0; p < d.P; ++p) xg = fmaf(xt[(tr + 16 * i) * LDP + p], gs[p * LDN + n], xg);
      adb[i][j] = fmaf(w, xg, adb[i][j]);
    }
  }

  const float dsum = block_sum(dd, cmp);
  if (tid == 0) *ddp_at = dsum;
  if (tid < TILE && s0 + tid < k.Lc)
    cm[((size_t)k.b * d.S + k.t0 + s0 + tid) * d.H + k.h] = colm;
  const size_t hrow = (size_t)d.H * d.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + tr + 16 * i;
    const float q = row16_sum(qpart[i]);
    if (s >= k.Lc) continue;
    const size_t t = (size_t)k.b * d.S + k.t0 + s;
    if (tc == 0) qv[t * d.H + k.h] = q;
#pragma unroll
    for (int j = 0; j < PJ; ++j)
      if (tc + 16 * j < d.P) dx[t * xrow + (size_t)k.h * d.P + tc + 16 * j] = from_f<T>(adx[i][j]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = tc + 16 * j;
      if (n < d.N) dBh[t * hrow + (size_t)k.h * d.N + n] = adb[i][j];
    }
  }
}

// (d), dt: one warp per (b, chunk, head). d(cs[l]) = rs[l] - dt[l] cm[l]
// - w[l] qv[l], plus at the last step exp(cs[last]) <G_{c+1}, S_c>
// + sum_s w[s] qv[s]; ddt[l] = cm[l] + exp(cs[last] - cs[l]) qv[l]
// + A sum_{l' >= l} d(cs[l']); the chunk's partial dA = sum_l dt[l] revcum[l].
__global__ void __launch_bounds__(32)
ssd_bwd_dt(const float* __restrict__ dt, const float* __restrict__ A,
           const float* __restrict__ rs, const float* __restrict__ cm,
           const float* __restrict__ qv, const float* __restrict__ gpart,
           float* __restrict__ ddt, float* __restrict__ dap, Dims d) {
  extern __shared__ float smem_dt[];
  const int lp = lpad_of(d);
  float* cs = smem_dt;
  float* dts = cs + lp;
  float* dcs = dts + lp;
  const int bch = blockIdx.x;
  const Chunk k = chunk_of(bch, d);
  const float a = A[k.h];
  const size_t t0 = (size_t)k.b * d.S + k.t0;
  chunk_cumsum(dt + t0 * d.H + k.h, d.H, a, k.Lc, lp, cs, dts);
  const float last = cs[k.Lc - 1];
  const int lane = threadIdx.x;
  const int per = (k.Lc + 31) / 32;
  const int lo = min(lane * per, k.Lc), hi = min(lo + per, k.Lc);
  float wq = 0.f, tot = 0.f;
  for (int l = lo; l < hi; ++l) {
    const size_t t = (t0 + l) * d.H + k.h;
    const float w = expf(last - cs[l]) * dts[l];
    dcs[l] = rs[t] - dts[l] * cm[t] - w * qv[t];
    wq = fmaf(w, qv[t], wq);
  }
  wq = warp_sum(wq);
  if (lo < hi && hi == k.Lc) {
    float gsum = 0.f;  // <G_{c+1}, S_c>, the state pass's shares in order
    for (int e = 0; e < d.neb; ++e) gsum += gpart[(size_t)bch * d.neb + e];
    dcs[k.Lc - 1] += expf(last) * gsum + wq;
  }
  for (int l = hi - 1; l >= lo; --l) tot += dcs[l];
  // the lanes to the right's totals: a suffix scan across the warp
  float incl = tot;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(FULL, incl, off);
    if (lane + off < 32) incl += o;
  }
  float rev = __shfl_down_sync(FULL, incl, 1);
  if (lane == 31) rev = 0.f;
  float part = 0.f;
  for (int l = hi - 1; l >= lo; --l) {
    const size_t t = (t0 + l) * d.H + k.h;
    rev += dcs[l];
    ddt[t] = cm[t] + expf(last - cs[l]) * qv[t] + a * rev;
    part = fmaf(dts[l], rev, part);
  }
  part = warp_sum(part);
  if (lane == 0) dap[bch] = part;
}

// (e): blocks below nblk sum dB and dC over a group's head slices (a thread
// per [B, S, G, N] element, slices in order); the last block sums dA and dD
// over (b, chunk) in order, a thread per head.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce(const float* __restrict__ dBp, const float* __restrict__ dCp,
               const float* __restrict__ dap, const float* __restrict__ ddp,
               T* __restrict__ dB, T* __restrict__ dC, float* __restrict__ dA,
               float* __restrict__ dD, Dims d, int nblk) {
  if ((int)blockIdx.x < nblk) {
    const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
    if (e >= (size_t)d.B * d.S * d.G * d.N) return;
    const int n = (int)(e % d.N);
    const size_t row = e / d.N;  // (b * S + t) * G + g
    float sb = 0.f, sc = 0.f;
    for (int s = 0; s < d.nsl; ++s) {
      const size_t at = (row * d.nsl + s) * d.N + n;
      sb += dBp[at];
      sc += dCp[at];
    }
    dB[e] = from_f<T>(sb);
    dC[e] = from_f<T>(sc);
    return;
  }
  for (int h = threadIdx.x; h < d.H; h += THREADS) {
    float a = 0.f, dd = 0.f;
    for (int bc = 0; bc < d.B * d.nc; ++bc) {
      const int bch = bc * d.H + h;
      a += dap[bch];
      for (int t = 0; t < d.nt; ++t) dd += ddp[(size_t)bch * d.nt + t];
    }
    dA[h] = a;
    dD[h] = dd;
  }
}

// The workspace, carved in this order, every array 16-byte aligned.
struct Work {
  float *own, *loc, *st;   // [B][nc][H][P][N] float32
  bf16 *sp, *gp;           // [B][nc][H][MAX_PARTS][P][N] bf16 parts of S_c and G_{c+1}
  float *csw, *dtw;        // [B][nc][H][lpad]
  float *dec, *dap;        // [B][nc][H]
  float *gpart;            // [B][nc][H][neb]
  float *ddp;              // [B][nc][H][nt]
  float *dBp, *dCp;        // [B][S][G][nsl][N]
  float *rs, *cm, *qv;     // [B][S][H]
  size_t bytes;
};

Work carve(unsigned char* base, const Dims& d) {
  Work w;
  const size_t bch = (size_t)d.B * d.nc * d.H, pn = (size_t)d.P * d.N;
  const size_t bsh = (size_t)d.B * d.S * d.H;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* q = base ? base + off : nullptr;
    off += (bytes + 15) / 16 * 16;
    return q;
  };
  w.own = reinterpret_cast<float*>(take(bch * pn * 4));
  w.loc = reinterpret_cast<float*>(take(bch * pn * 4));
  w.st = reinterpret_cast<float*>(take(bch * pn * 4));
  w.sp = reinterpret_cast<bf16*>(take(bch * MAX_PARTS * pn * 2));
  w.gp = reinterpret_cast<bf16*>(take(bch * MAX_PARTS * pn * 2));
  w.csw = reinterpret_cast<float*>(take(bch * lpad_of(d) * 4));
  w.dtw = reinterpret_cast<float*>(take(bch * lpad_of(d) * 4));
  w.dec = reinterpret_cast<float*>(take(bch * 4));
  w.dap = reinterpret_cast<float*>(take(bch * 4));
  w.gpart = reinterpret_cast<float*>(take(bch * d.neb * 4));
  w.ddp = reinterpret_cast<float*>(take(bch * d.nt * 4));
  w.dBp = reinterpret_cast<float*>(take((size_t)d.B * d.S * d.G * d.nsl * d.N * 4));
  w.dCp = reinterpret_cast<float*>(take((size_t)d.B * d.S * d.G * d.nsl * d.N * 4));
  w.rs = reinterpret_cast<float*>(take(bsh * 4));
  w.cm = reinterpret_cast<float*>(take(bsh * 4));
  w.qv = reinterpret_cast<float*>(take(bsh * 4));
  w.bytes = off;
  return w;
}

// The shapes and the plan: hb is the largest divisor of H / G that leaves at
// least MIN_TILE_BLOCKS tile blocks (1 where none does)
Dims dims_of(int B, int S, int H, int G, int P, int N, int L) {
  Dims d{B, S, H, G, P, N, L, (S + L - 1) / L, (L + TILE - 1) / TILE, (N + 15) / 16 * 16,
         1, 1, (P * N + THREADS - 1) / THREADS};
  const int rep = H / G;
  for (int q = rep; q >= 1; --q) {
    if (rep % q) continue;
    if ((long long)B * d.nc * G * (rep / q) * d.nt >= MIN_TILE_BLOCKS || q == 1) {
      d.hb = q;
      break;
    }
  }
  d.nsl = rep / d.hb;
  return d;
}

// The tiles' widths: P to 64 or 128, N to 64, 128 or 256
int p_width(int P) { return P <= 64 ? 64 : 128; }
int n_width(int N) { return N <= 64 ? 64 : N <= 128 ? 128 : 256; }

// Stages of the tile kernels' ring at the device's shared-memory limit: 2,
// 1 where two do not fit, 0 where one does not
int tile_stages(int npi, int npf, const Dims& d, int limit) {
  const int pw = p_width(d.P), nw = n_width(d.N);
  if (npi == 3 && nw > 128) return 0;  // not built: float32 at N > 128 never fits
  for (int s = 2; s >= 1; --s)
    if (tile_layout(npi, npf, pw, nw, lpad_of(d), s).bytes <= (size_t)limit) return s;
  return 0;
}

int smem_limit(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

template <typename F>
int allow_smem(F* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

struct Args {
  const void *x, *Bm, *Cm, *dy;
  const float *dt, *A, *D, *dstate;
  void *dx, *dB, *dC;
  float *ddt, *dA, *dD;
  Work w;
  int vec_x, vec_bc, vec_st;
};

template <typename T, int PW, int NW>
int run(const Args& a, const Dims& d, cudaStream_t st) {
  constexpr int NPI = Parts<T>::IN, NPF = Parts<T>::F;
  const int lp = lpad_of(d);
  int limit = 0;
  if (int err = smem_limit(&limit)) return err;
  const int stages = tile_stages(NPI, NPF, d, limit);
  constexpr int NCS = sums_cols(NW);
  const size_t sums = sums_smem(d, NPI, NPF, NCS);
  const size_t dts = (size_t)3 * lp * sizeof(float);
  if (stages == 0 || sums > (size_t)limit || dts > (size_t)limit) return ERR_SHARED_MEMORY;
  const size_t tiles = tile_layout(NPI, NPF, PW, NW, lp, stages).bytes;
  if (int err = allow_smem(ssd_bwd_chunk_sums<T, NCS>, sums)) return err;
  if (int err = allow_smem(ssd_bwd_tiles<T, PW, NW, false>, tiles)) return err;
  if (int err = allow_smem(ssd_bwd_tiles<T, PW, NW, true>, tiles)) return err;
  if (int err = allow_smem(ssd_bwd_dt, dts)) return err;

  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.Bm);
  const T* Cm = static_cast<const T*>(a.Cm);
  const T* dy = static_cast<const T*>(a.dy);
  const Work& w = a.w;
  const unsigned bch = (unsigned)(d.B * d.nc * d.H);
  ssd_bwd_chunk_sums<T, NCS><<<dim3(bch, 2 * ((d.npad + NCS - 1) / NCS), PW / TILE), TC, sums,
                               st>>>(x, Bm, Cm, dy, a.dt, a.A, w.own, w.loc, w.dec, w.csw, w.dtw, d,
                                a.vec_x, a.vec_bc);
  if (int err = (int)cudaGetLastError()) return err;
  ssd_bwd_state_pass<NPF><<<(unsigned)(d.B * d.H * d.neb), THREADS, 0, st>>>(
      w.own, w.loc, w.dec, a.dstate, w.st, w.sp, w.gp, w.gpart, d);
  if (int err = (int)cudaGetLastError()) return err;
  TileArgs ta{a.x, a.Bm, a.Cm, a.dy, a.D, w.csw, w.dtw, w.sp, w.gp, a.dstate, w.dCp,
              w.rs, w.cm, w.qv, w.ddp, a.dx, a.vec_x, a.vec_bc, a.vec_st, stages};
  const unsigned tblocks = (unsigned)(d.B * d.nc * d.G * d.nsl * d.nt);
  ssd_bwd_tiles<T, PW, NW, false><<<tblocks, TC, tiles, st>>>(ta, d);
  if (int err = (int)cudaGetLastError()) return err;
  ta.gsum_part = w.dBp;
  ssd_bwd_tiles<T, PW, NW, true><<<tblocks, TC, tiles, st>>>(ta, d);
  if (int err = (int)cudaGetLastError()) return err;
  ssd_bwd_dt<<<bch, 32, dts, st>>>(a.dt, a.A, w.rs, w.cm, w.qv, w.gpart, a.ddt, w.dap, d);
  if (int err = (int)cudaGetLastError()) return err;
  const size_t elems = (size_t)d.B * d.S * d.G * d.N;
  const int nblk = (int)((elems + THREADS - 1) / THREADS);
  ssd_bwd_reduce<T><<<(unsigned)nblk + 1, THREADS, 0, st>>>(
      w.dBp, w.dCp, w.dap, w.ddp, static_cast<T*>(a.dB), static_cast<T*>(a.dC), a.dA, a.dD, d,
      nblk);
  return (int)cudaGetLastError();
}

// float32 where its tensor-core tiles do not fit: the FMA tile kernels
// between the same four others, one head a slice (d.hb = 1)
template <int PJ, int NJ>
int run_fma(const Args& a, const Dims& d, cudaStream_t st) {
  constexpr int LDN = ld_n<NJ>(), NCS = sums_cols(16 * NJ);
  const int lp = lpad_of(d);
  int limit = 0;
  if (int err = smem_limit(&limit)) return err;
  const size_t sums = sums_smem(d, 3, 3, NCS);
  const size_t rows = rows_smem(d, LDN), cols = cols_smem(d, LDN, 16 * PJ);
  const size_t dts = (size_t)3 * lp * sizeof(float);
  if (sums > (size_t)limit || rows > (size_t)limit || cols > (size_t)limit || dts > (size_t)limit)
    return ERR_SHARED_MEMORY;
  if (int err = allow_smem(ssd_bwd_chunk_sums<float, NCS>, sums)) return err;
  if (int err = allow_smem(ssd_bwd_rows_fma<float, NJ>, rows)) return err;
  if (int err = allow_smem(ssd_bwd_cols_fma<float, PJ, NJ>, cols)) return err;
  if (int err = allow_smem(ssd_bwd_dt, dts)) return err;

  const float* x = static_cast<const float*>(a.x);
  const float* Bm = static_cast<const float*>(a.Bm);
  const float* Cm = static_cast<const float*>(a.Cm);
  const float* dy = static_cast<const float*>(a.dy);
  const Work& w = a.w;
  const unsigned bch = (unsigned)(d.B * d.nc * d.H);
  ssd_bwd_chunk_sums<float, NCS><<<dim3(bch, 2 * ((d.npad + NCS - 1) / NCS), PJ / 4), TC, sums,
                                   st>>>(x, Bm, Cm, dy, a.dt, a.A, w.own, w.loc, w.dec, w.csw,
                                         w.dtw, d, a.vec_x, a.vec_bc);
  if (int err = (int)cudaGetLastError()) return err;
  ssd_bwd_state_pass<3><<<(unsigned)(d.B * d.H * d.neb), THREADS, 0, st>>>(
      w.own, w.loc, w.dec, a.dstate, w.st, w.sp, w.gp, w.gpart, d);
  if (int err = (int)cudaGetLastError()) return err;
  ssd_bwd_rows_fma<float, NJ><<<bch * d.nt, THREADS, rows, st>>>(x, Bm, Cm, dy, a.dt, a.A, w.st,
                                                                 w.dCp, w.rs, d);
  if (int err = (int)cudaGetLastError()) return err;
  ssd_bwd_cols_fma<float, PJ, NJ><<<bch * d.nt, THREADS, cols, st>>>(
      x, Bm, Cm, dy, a.dt, a.A, a.D, w.gp, a.dstate, static_cast<float*>(a.dx), w.dBp, w.cm,
      w.qv, w.ddp, d);
  if (int err = (int)cudaGetLastError()) return err;
  ssd_bwd_dt<<<bch, 32, dts, st>>>(a.dt, a.A, w.rs, w.cm, w.qv, w.gpart, a.ddt, w.dap, d);
  if (int err = (int)cudaGetLastError()) return err;
  const size_t elems = (size_t)d.B * d.S * d.G * d.N;
  const int nblk = (int)((elems + THREADS - 1) / THREADS);
  ssd_bwd_reduce<float><<<(unsigned)nblk + 1, THREADS, 0, st>>>(
      w.dBp, w.dCp, w.dap, w.ddp, static_cast<float*>(a.dB), static_cast<float*>(a.dC), a.dA,
      a.dD, d, nblk);
  return (int)cudaGetLastError();
}

// the instantiations: bf16 at every tile width; float32 on the tensor cores
// where its tiles fit, else (N 129-256 at P <= 64, N 65-128 at P 128) on
// FMAs; float32 at P 128 with N > 128 fits neither
template <typename T>
int dispatch(const Args& a, const Dims& d, bool fma, cudaStream_t st) {
  const int pw = p_width(d.P), nw = n_width(d.N);
  if constexpr (sizeof(T) == 4) {
    if (fma) {
      if (pw == 64 && nw == 256) return run_fma<4, 16>(a, d, st);
      if (pw == 128 && nw == 128) return run_fma<8, 8>(a, d, st);
      return ERR_SHARED_MEMORY;
    }
  }
  if (pw == 64 && nw == 64) return run<T, 64, 64>(a, d, st);
  if (pw == 64 && nw == 128) return run<T, 64, 128>(a, d, st);
  if (pw == 128 && nw == 64) return run<T, 128, 64>(a, d, st);
  if (pw == 128 && nw == 128) return run<T, 128, 128>(a, d, st);
  if constexpr (sizeof(T) == 2) {
    if (pw == 64) return run<T, 64, 256>(a, d, st);
    return run<T, 128, 256>(a, d, st);
  }
  return ERR_SHARED_MEMORY;
}

// Whether a float32 call runs the FMA tile kernels (its three-part tiles do
// not fit), and then its shapes with one head a slice
bool fma_route(const Dims& d, int limit) { return tile_stages(3, 3, d, limit) == 0; }
Dims per_head(Dims d) {
  d.hb = 1;
  d.nsl = d.H / d.G;
  return d;
}

bool valid(int B, int S, int H, int G, int P, int N, int L) {
  return B > 0 && S > 0 && H > 0 && G > 0 && H % G == 0 && N > 0 && N <= 256 && L > 0 &&
         L <= S && (P == 16 || P == 32 || P == 64 || P == 128);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// Bytes of the workspace ssd_scan_bwd_launch takes, at either dtype (0 if
// the shapes are not taken).
long long ssd_scan_bwd_workspace_bytes(int B, int S, int H, int G, int P, int N, int L) {
  if (!valid(B, S, H, G, P, N, L)) return 0;
  Dims d = dims_of(B, S, H, G, P, N, L);
  int limit = 0;
  if (smem_limit(&limit)) return 0;
  if (fma_route(d, limit)) d = per_head(d);  // float32 takes one head a slice there
  return (long long)carve(nullptr, d).bytes;
}

// The launch plan of a call (dtype 0 = float32, 1 = bfloat16) on the
// current device: out[0..6] = heads a tile block, head slices a group, ring
// stages (0 off the tensor cores), the tile kernels' and the chunk sums'
// shared-memory bytes, the workspace bytes, and the tile kernels' route (1:
// tensor cores, 2: float32 FMAs, 0: refused, their tiles do not fit).
// Returns 0, or cudaErrorInvalidValue on shapes the kernels do not take.
int ssd_scan_bwd_plan(int B, int S, int H, int G, int P, int N, int L, int dtype,
                      long long* out) {
  if (!valid(B, S, H, G, P, N, L) || (dtype != 0 && dtype != 1) || out == nullptr)
    return (int)cudaErrorInvalidValue;
  Dims d = dims_of(B, S, H, G, P, N, L);
  const int npi = dtype == 0 ? 3 : 1, npf = dtype == 0 ? 3 : 2;
  int limit = 0;
  if (int err = smem_limit(&limit)) return err;
  const int stages = tile_stages(npi, npf, d, limit);
  long long tiles = stages ? (long long)tile_layout(npi, npf, p_width(P), n_width(N),
                                                    lpad_of(d), stages).bytes
                           : 0;
  int route = stages ? 1 : 0;
  if (dtype == 0 && !stages) {
    d = per_head(d);
    const int ldn = n_width(N) + 1;
    const size_t rows = rows_smem(d, ldn), cols = cols_smem(d, ldn, p_width(P));
    tiles = (long long)(rows > cols ? rows : cols);
    route = (p_width(P) == 64 || n_width(N) == 128) && tiles <= limit ? 2 : 0;
  }
  out[0] = d.hb;
  out[1] = d.nsl;
  out[2] = stages;
  out[3] = tiles;
  out[4] = (long long)sums_smem(d, npi, npf, sums_cols(n_width(N)));
  out[5] = (long long)carve(nullptr, d).bytes;
  out[6] = route;
  return 0;
}

// x, dy [B, S, H, P], Bm, Cm [B, S, G, N] of one dtype (0 = float32, 1 =
// bfloat16), dt [B, S, H], A, D [H] float32, dstate [B, H, P, N] float32 or
// null (zero), all contiguous; L = min(chunk, S). Writes dx [B, S, H, P] and
// dB, dC [B, S, G, N] in the inputs' dtype, ddt [B, S, H], dA, dD [H] float32;
// ws holds ssd_scan_bwd_workspace_bytes (16-byte aligned). Six launches on
// `stream`. Returns 0, ERR_SHARED_MEMORY (-1) or a cudaError_t; on a refusal
// before the first launch nothing is launched.
int ssd_scan_bwd_launch(const void* x, const void* Bm, const void* Cm, const void* dt,
                        const void* A, const void* D, const void* dy, const void* dstate,
                        void* dx, void* dB, void* dC, void* ddt, void* dA, void* dD, void* ws,
                        int B, int S, int H, int G, int P, int N, int L, int dtype,
                        void* stream) {
  if (!valid(B, S, H, G, P, N, L) || ws == nullptr || !aligned16(ws))
    return (int)cudaErrorInvalidValue;
  Dims d = dims_of(B, S, H, G, P, N, L);
  int limit = 0;
  if (int err = smem_limit(&limit)) return err;
  const bool fma = dtype == 0 && fma_route(d, limit);
  if (fma) d = per_head(d);
  const int esize = dtype == 0 ? 4 : 2;
  Args a{x, Bm, Cm, dy,
         static_cast<const float*>(dt), static_cast<const float*>(A),
         static_cast<const float*>(D), static_cast<const float*>(dstate),
         dx, dB, dC,
         static_cast<float*>(ddt), static_cast<float*>(dA), static_cast<float*>(dD),
         carve(static_cast<unsigned char*>(ws), d),
         aligned16(x) && aligned16(dy) && ((size_t)H * P * esize) % 16 == 0,
         aligned16(Bm) && aligned16(Cm) && ((size_t)G * N * esize) % 16 == 0 &&
             ((size_t)N * esize) % 16 == 0,
         N % 8 == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, d, fma, st);
  if (dtype == 1) return dispatch<bf16>(a, d, false, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
