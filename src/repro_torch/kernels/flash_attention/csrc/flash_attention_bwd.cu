// Backward of prefill attention (flash_attention.cu's forward) for one H100.
//
// The TPU kernel src/repro/kernels/flash_attention/kernel.py ::
// flash_attention_kernel has no backward: the reference trains through
// chunked jnp attention (src/repro/models/attention.py), which XLA
// differentiates. The port's attention runs the forward kernel for every
// full-sequence pass, so training on the card differentiates through it, and
// this file is that gradient, FlashAttention-2's algorithm: P is recomputed
// from Q, K and the row log-sum-exp `lse` the forward wrote, never stored.
//
// For o = softmax(x) v with x = scale q.k^T (or softcap * tanh(scale q.k^T /
// softcap)), masked causally, by the window (key > query - window) and past S,
// and the output's gradient dO:
//   (a) flash_bwd_dot:  D[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d]
//   (b) flash_bwd_dkdv: P = exp(x - lse), dP = dO V^T, dS = P (dP - D) dx/ds,
//       dV = sum over the group's heads of P^T dO, dK = the same of dS^T Q
//   (c) flash_bwd_dq:   dQ = dS K
// dx/ds is scale, times (1 - tanh^2) under a softcap. GQA: KV head kh serves
// the query heads kh * G .. kh * G + G - 1, and (b) sums over them.
//
// Determinism. (b) owns one (b, KV head, 64-key tile) and (c) one (b, head,
// 64-row query tile); each sums its tiles in one fixed order in registers
// and writes its rows once. There are no atomics, so a gradient is the same
// bits every run (checkpoint restart resumes identically on the card).
//
// Routes.
//   - bfloat16 (training's dtype) -> flash_bwd_dkdv_mma and flash_bwd_dq_mma,
//     on mma.sync m16n8k16 (bf16 in, float32 accumulate) with the forward
//     mma kernel's fragment layouts: a 128-thread block, four warps of 16
//     rows. In (b) a warp owns 16 keys and computes S^T = K Q^T and
//     dP^T = V dO^T for the 64 queries of a tile (K and V as A, Q and dO as B
//     from shared memory by ldmatrix), then dV += P^T dO and dK += dS^T Q
//     with P^T and dS^T rounded to bf16 in registers as A (the score
//     accumulator's layout is the A fragment's) and dO and Q read
//     transposed (ldmatrix.trans); in (c) a warp owns 16 queries:
//     S = Q K^T, dP = dO V^T, dQ += dS K. Tiles are staged by 16-byte
//     cp.async copies (zero-filled past S) into rows padded by 16 bytes, an
//     odd number of 16-byte units, so ldmatrix is free of bank conflicts;
//     one stage, the copies of a tile waited on before it is computed. The
//     dK, dV and dQ accumulators stay in float32 registers. P and dS in bf16
//     for the products is FlashAttention's rounding; the plain version keeps
//     them in float32 (bf16 tolerance 1e-2 of the largest value).
//   - float32 -> flash_bwd_dkdv and flash_bwd_dq, float32 FMAs on the CUDA
//     cores (the tensor cores would round float32 inputs to TF32, and the
//     float32 callers are the card-vs-CPU checks): a 256-thread block stages
//     its tiles as float32 rows padded to an odd width (DH + 1, so that 16
//     rows read at one column fall in 16 banks); in the two score products a
//     thread holds a 4 x 4 register tile (rows tr + 16 i, keys tc + 16 j,
//     tr = tid / 16, tc = tid % 16), in the gradient products 4 rows (or
//     keys) x DH / 16 columns of accumulators; P and dS go through shared
//     memory between the two. At DH = 128 (b) takes 162 KB of shared memory
//     and (c) 146 KB: one block an SM.
//
// Bound on an H100. The work is five [64 x 64 x DH] products per visible
// tile pair (QK^T recomputed, dP, dV, dK, dQ), about 2.5 times the forward's
// operations, and bytes of q, k, v, o, dO, lse and the three gradients once.
// At training shapes (S = 512, Dh = 64) it is bound by operations. Both
// routes compute S and dP twice (in (b) and in (c)): seven products against
// the bound's five, the price of keeping dQ apart from dK/dV without atomics.
// Later work: wgmma and a K/V ring of several stages, as the forward has.
//
// Head widths 16, 32, 64 and 128 (q/k and v of one width), float32 and
// bfloat16. The entry points return cudaErrorInvalidValue, launching
// nothing, on anything else.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;         // query rows of a query tile, keys of a key tile
constexpr int THREADS = 256;
constexpr int LDP = BT + 1;    // padded row of the [64 x 64] P and dS tiles

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

struct Mask {
  int S, causal, window;
  float softcap, scale;
};

__device__ __forceinline__ bool visible(const Mask& mk, int qi, int kj) {
  bool v = qi < mk.S && kj < mk.S;
  if (mk.causal) v = v && kj <= qi;
  if (mk.window > 0) v = v && kj > qi - mk.window;
  return v;
}

// P and dS (the gradient of the raw product q.k) of one score s = q.k (the
// inputs are taken by value, so p and ds may be the registers s and dp held)
__device__ __forceinline__ void p_ds(float s, float dp, float lse, float dr, bool vis,
                                     const Mask& mk, float& p, float& ds) {
  float x = s * mk.scale, dx = mk.scale;
  if (mk.softcap > 0.f) {
    const float t = tanhf(x / mk.softcap);
    x = mk.softcap * t;
    dx *= 1.f - t * t;
  }
  p = vis ? expf(x - lse) : 0.f;
  ds = p * (dp - dr) * dx;
}

// Stage the 64-row tile of [.., S, N, DH] float32 rows starting at row0 (src
// at row 0 of the head, rows `stride` elements apart) as rows of DH + 1;
// rows past S are zeros.
template <int DH>
__device__ __forceinline__ void stage(float* dst, const float* src, size_t stride, int row0,
                                      int S, int tid) {
  for (int e = tid; e < BT * DH; e += THREADS) {
    const int r = e / DH, d = e % DH;
    dst[r * (DH + 1) + d] = row0 + r < S ? src[(size_t)(row0 + r) * stride + d] : 0.f;
  }
}

// The 4 x 4 register tiles of S = Q K^T and dP = dO V^T: rows tr + 16 i of
// qs / dos, keys tc + 16 j of ks / vs
template <int DH>
__device__ __forceinline__ void score_tiles(const float* qs, const float* dos, const float* ks,
                                            const float* vs, int tr, int tc, float (&s)[4][4],
                                            float (&dp)[4][4]) {
  constexpr int LD = DH + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float qa[4], da[4], ka[4], va[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = qs[(tr + 16 * i) * LD + d];
      da[i] = dos[(tr + 16 * i) * LD + d];
      ka[i] = ks[(tc + 16 * i) * LD + d];
      va[i] = vs[(tc + 16 * i) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
        dp[i][j] = fmaf(da[i], va[j], dp[i][j]);
      }
  }
}

// (a) one warp per (b, i, h) row of o / dO, in their [B, S, H, DH] order
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dot(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dd,
              int S, int H, int DH, int rows) {
  const int row = (int)((blockIdx.x * (size_t)THREADS + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + (size_t)row * DH;
  const T* drow = dout + (size_t)row * DH;
  float acc = 0.f;
  for (int d = lane; d < DH; d += 32) acc = fmaf(to_f(drow[d]), to_f(orow[d]), acc);
#pragma unroll
  for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H, bs = row / H;
    dd[((size_t)(bs / S) * H + h) * S + bs % S] = acc;
  }
}

template <int DH>
constexpr size_t dkdv_smem() {  // K, V, Q, dO tiles; P, dS; lse, D
  return (size_t)(4 * BT * (DH + 1) + 2 * BT * LDP + 2 * BT) * sizeof(float);
}

// (b) one block per (b, KV head, 64-key tile): every query tile of every
// head of the group that can see a key of the tile, in order
template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dd,
               float* __restrict__ dk, float* __restrict__ dv, int H, int KH, int nk, Mask mk) {
  constexpr int LD = DH + 1;
  constexpr int DJ = DH / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* ks = smem;             // [BT][LD]
  float* vs = ks + BT * LD;     // [BT][LD]
  float* qs = vs + BT * LD;     // [BT][LD]
  float* dos = qs + BT * LD;    // [BT][LD]
  float* ps = dos + BT * LD;    // [BT rows][LDP keys]
  float* dss = ps + BT * LDP;   // [BT rows][LDP keys]
  float* lse_s = dss + BT * LDP;
  float* d_s = lse_s + BT;

  const int S = mk.S;
  const int kt = blockIdx.x % nk;
  const int bkh = blockIdx.x / nk;
  const int kh = bkh % KH;
  const int b = bkh / KH;
  const int G = H / KH;
  const int k0 = kt * BT;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const size_t qrow = (size_t)H * DH, krow = (size_t)KH * DH;
  stage<DH>(ks, k + (size_t)b * S * krow + (size_t)kh * DH, krow, k0, S, tid);
  stage<DH>(vs, v + (size_t)b * S * krow + (size_t)kh * DH, krow, k0, S, tid);

  // the query rows that can see a key of this tile
  const int k_last = min(k0 + BT, S) - 1;
  const int q_lo = mk.causal ? k0 : 0;
  const int q_hi = mk.window > 0 ? min(S - 1, k_last + mk.window - 1) : S - 1;

  float dka[4][DJ], dva[4][DJ];  // keys tr + 16 i, columns tc + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const float* qb = q + (size_t)b * S * qrow + (size_t)h * DH;
    const float* db = dout + (size_t)b * S * qrow + (size_t)h * DH;
    const float* lb = lse + ((size_t)b * H + h) * S;
    const float* dr = dd + ((size_t)b * H + h) * S;
    for (int q0 = (q_lo / BT) * BT; q0 <= q_hi; q0 += BT) {
      __syncthreads();  // the previous tile's readers are done
      stage<DH>(qs, qb, qrow, q0, S, tid);
      stage<DH>(dos, db, qrow, q0, S, tid);
      if (tid < BT) {
        const bool in = q0 + tid < S;
        lse_s[tid] = in ? lb[q0 + tid] : 0.f;
        d_s[tid] = in ? dr[q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      score_tiles<DH>(qs, dos, ks, vs, tr, tc, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tr + 16 * i, c = tc + 16 * j;
          float p, ds;
          p_ds(s[i][j], dp[i][j], lse_s[r], d_s[r], visible(mk, q0 + r, k0 + c), mk, p, ds);
          ps[r * LDP + c] = p;
          dss[r * LDP + c] = ds;
        }
      __syncthreads();

      // dV[key] += P[r, key] dO[r], dK[key] += dS[r, key] Q[r]
#pragma unroll 4
      for (int r = 0; r < BT; ++r) {
        float pa[4], sa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = ps[r * LDP + tr + 16 * i];
          sa[i] = dss[r * LDP + tr + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float dov = dos[r * LD + tc + 16 * j], qv = qs[r * LD + tc + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dva[i][j] = fmaf(pa[i], dov, dva[i][j]);
            dka[i][j] = fmaf(sa[i], qv, dka[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + tr + 16 * i;
    if (kj >= S) continue;
    const size_t at = ((size_t)b * S + kj) * krow + (size_t)kh * DH + tc;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[at + 16 * j] = dka[i][j];
      dv[at + 16 * j] = dva[i][j];
    }
  }
}

template <int DH>
constexpr size_t dq_smem() {  // Q, dO, K, V tiles; dS; lse, D
  return (size_t)(4 * BT * (DH + 1) + BT * LDP + 2 * BT) * sizeof(float);
}

// (c) one block per (b, head, 64-row query tile): the key tiles its rows can
// reach, in order (the forward's walk)
template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dd,
             float* __restrict__ dq, int H, int KH, int nq, Mask mk) {
  constexpr int LD = DH + 1;
  constexpr int DJ = DH / 16;
  extern __shared__ float smem[];
  float* qs = smem;             // [BT][LD]
  float* dos = qs + BT * LD;    // [BT][LD]
  float* ks = dos + BT * LD;    // [BT][LD]
  float* vs = ks + BT * LD;     // [BT][LD]
  float* dss = vs + BT * LD;    // [BT rows][LDP keys]
  float* lse_s = dss + BT * LDP;
  float* d_s = lse_s + BT;

  const int S = mk.S;
  const int qt = blockIdx.x % nq;
  const int bh = blockIdx.x / nq;
  const int h = bh % H;
  const int b = bh / H;
  const int kh = h / (H / KH);
  const int q0 = qt * BT;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const size_t qrow = (size_t)H * DH, krow = (size_t)KH * DH;
  const float* kb = k + (size_t)b * S * krow + (size_t)kh * DH;
  const float* vb = v + (size_t)b * S * krow + (size_t)kh * DH;
  stage<DH>(qs, q + (size_t)b * S * qrow + (size_t)h * DH, qrow, q0, S, tid);
  stage<DH>(dos, dout + (size_t)b * S * qrow + (size_t)h * DH, qrow, q0, S, tid);
  if (tid < BT) {
    const bool in = q0 + tid < S;
    lse_s[tid] = in ? lse[((size_t)b * H + h) * S + q0 + tid] : 0.f;
    d_s[tid] = in ? dd[((size_t)b * H + h) * S + q0 + tid] : 0.f;
  }

  // the keys any row of this tile can reach
  const int q_last = min(q0 + BT, S) - 1;
  const int k_hi = mk.causal ? q_last : S - 1;
  const int k_lo = mk.window > 0 ? max(0, q0 - mk.window + 1) : 0;

  float dqa[4][DJ];  // rows tr + 16 i, columns tc + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqa[i][j] = 0.f;

  for (int k0 = (k_lo / BT) * BT; k0 <= k_hi; k0 += BT) {
    __syncthreads();  // Q / dO are in; the previous tile's readers are done
    stage<DH>(ks, kb, krow, k0, S, tid);
    stage<DH>(vs, vb, krow, k0, S, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tiles<DH>(qs, dos, ks, vs, tr, tc, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tr + 16 * i, c = tc + 16 * j;
        float p, ds;
        p_ds(s[i][j], dp[i][j], lse_s[r], d_s[r], visible(mk, q0 + r, k0 + c), mk, p, ds);
        dss[r * LDP + c] = ds;
      }
    __syncthreads();

    // dQ[r] += dS[r, key] K[key]
#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float sa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = dss[(tr + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = ks[c * LD + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dqa[i][j] = fmaf(sa[i], kv, dqa[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi >= S) continue;
    const size_t at = ((size_t)b * S + qi) * qrow + (size_t)h * DH + tc;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[at + 16 * j] = dqa[i][j];
  }
}

// ---- bf16: mma.sync m16n8k16 ----

constexpr int TC_THREADS = 128;  // four warps, 16 rows (or keys) each
__host__ __device__ constexpr int tc_ld(int dh) { return dh + 8; }  // padded bf16 row

template <int DH>
constexpr size_t tc_smem() {  // four [64][DH + 8] bf16 tiles; lse, D
  return (size_t)4 * BT * tc_ld(DH) * sizeof(bf16) + 2 * BT * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; with valid == false the destination is zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
// d += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&p);
}

// Stage a 64-row tile of [.., S, N, DH] bf16 rows (src at row 0 of the head,
// rows `stride` elements apart) into a [64][DH + 8] tile by 16-byte copies;
// rows past S are zeros. Waited on by the caller.
template <int DH>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src, size_t stride, int row0,
                                           int S, int tid) {
  constexpr int CPR = DH / 8;  // 16-byte chunks a row
  for (int e = tid; e < BT * CPR; e += TC_THREADS) {
    const int r = e / CPR, ch = e % CPR;
    const bool in = row0 + r < S;
    cp_async16(smem_u32(dst + r * tc_ld(DH) + ch * 8),
               src + (size_t)(in ? row0 + r : 0) * stride + ch * 8, in);
  }
}

// acc[16 x 64] = A (16 rows of `a`, from row a_row) . B^T (the 64 rows of `b`):
// a and b are [64][DH + 8] tiles, the product over DH; acc is the m16n8
// accumulator over 8 n-tiles, acc[4 j + e] at row a_row + lane / 4 + 8 (e / 2),
// column 8 j + 2 (lane % 4) + e % 2
template <int DH>
__device__ __forceinline__ void rows_by_rows(float (&acc)[32], const bf16* a, int a_row,
                                             const bf16* b, int lane) {
  constexpr int LD = tc_ld(DH);
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(smem_u32(a + (a_row + lane % 16) * LD + kk * 16 + (lane / 16) * 8), af[0], af[1],
            af[2], af[3]);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(smem_u32(b + (j * 8 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 +
                       ((lane / 8) % 2) * 8),
              b0, b1, b2, b3);
      mma_bf16(acc + 4 * j, af, b0, b1);
      mma_bf16(acc + 4 * j + 4, af, b2, b3);
    }
  }
}

// out[16 x DH] += p (16 x 64, the accumulator layout of rows_by_rows, rounded
// to bf16 as the A operand) . the [64][DH + 8] tile t (k = its rows, read
// transposed); out[dt][4] over DH / 8 n-tiles, the same layout
template <int DH>
__device__ __forceinline__ void acc_by_tile(float (&out)[DH / 8][4], const float (&p)[32],
                                            const bf16* t, int lane) {
  constexpr int LD = tc_ld(DH);
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[8 * kk + 0], p[8 * kk + 1]),
                            pack_bf16(p[8 * kk + 2], p[8 * kk + 3]),
                            pack_bf16(p[8 * kk + 4], p[8 * kk + 5]),
                            pack_bf16(p[8 * kk + 6], p[8 * kk + 7])};
#pragma unroll
    for (int dt = 0; dt < DH / 8; dt += 2) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(smem_u32(t + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + dt * 8 +
                         (lane / 16) * 8),
                b0, b1, b2, b3);
      mma_bf16(out[dt], pa, b0, b1);
      mma_bf16(out[dt + 1], pa, b2, b3);
    }
  }
}

// Store a warp's [16 x DH] float32 accumulator as bf16 rows row0 (+ 8) of a
// [.., S, N, DH] tensor (dst at row 0 of the head); rows past S are not written.
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, size_t stride, int row0, int S,
                                           const float (&acc)[DH / 8][4], int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    if (row >= S) continue;
    bf16* o = dst + (size_t)row * stride + (lane % 4) * 2;
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(o + dt * 8) =
          __floats2bfloat162_rn(acc[dt][2 * r], acc[dt][2 * r + 1]);
  }
}

// (b) on the tensor cores: one block per (b, KV head, 64-key tile), warp w
// owns keys k0 + 16 w .. + 15; every query tile of every head of the group
// that can see a key of the tile, in order
template <int DH>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ dd,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KH, int nk,
                   Mask mk) {
  constexpr int LD = tc_ld(DH);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BT][LD]
  bf16* vs = ks + BT * LD;
  bf16* qs = vs + BT * LD;
  bf16* dos = qs + BT * LD;
  float* lse_s = reinterpret_cast<float*>(dos + BT * LD);
  float* d_s = lse_s + BT;

  const int S = mk.S;
  const int kt = blockIdx.x % nk;
  const int bkh = blockIdx.x / nk;
  const int kh = bkh % KH;
  const int b = bkh / KH;
  const int G = H / KH;
  const int k0 = kt * BT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t qrow = (size_t)H * DH, krow = (size_t)KH * DH;
  const size_t kv_off = (size_t)b * S * krow + (size_t)kh * DH;
  stage_bf16<DH>(ks, k + kv_off, krow, k0, S, tid);
  stage_bf16<DH>(vs, v + kv_off, krow, k0, S, tid);

  const int k_last = min(k0 + BT, S) - 1;
  const int q_lo = mk.causal ? k0 : 0;
  const int q_hi = mk.window > 0 ? min(S - 1, k_last + mk.window - 1) : S - 1;
  const int kw = k0 + warp * 16;  // this warp's first key

  float dka[DH / 8][4], dva[DH / 8][4];
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t q_off = (size_t)b * S * qrow + (size_t)h * DH;
    const float* lb = lse + ((size_t)b * H + h) * S;
    const float* dr = dd + ((size_t)b * H + h) * S;
    for (int q0 = (q_lo / BT) * BT; q0 <= q_hi; q0 += BT) {
      __syncthreads();  // the previous tile's readers are done
      stage_bf16<DH>(qs, q + q_off, qrow, q0, S, tid);
      stage_bf16<DH>(dos, dout + q_off, qrow, q0, S, tid);
      if (tid < BT) {
        const bool in = q0 + tid < S;
        lse_s[tid] = in ? lb[q0 + tid] : 0.f;
        d_s[tid] = in ? dr[q0 + tid] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();
      // a warp whose keys are all past S, or all after this tile's queries
      // (causal), has nothing here
      if (kw >= S || (mk.causal && kw > q0 + BT - 1)) continue;

      float pt[32], dst[32];  // S^T then P^T; dP^T then dS^T: [16 keys x 64 queries]
      rows_by_rows<DH>(dst, vs, warp * 16, dos, lane);
      rows_by_rows<DH>(pt, ks, warp * 16, qs, lane);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int kj = kw + lane / 4 + 8 * ((j >> 1) & 1);
        const int c = (j / 4) * 8 + (lane % 4) * 2 + (j & 1);
        p_ds(pt[j], dst[j], lse_s[c], d_s[c], visible(mk, q0 + c, kj), mk, pt[j], dst[j]);
      }
      acc_by_tile<DH>(dva, pt, dos, lane);
      acc_by_tile<DH>(dka, dst, qs, lane);
    }
  }
  store_rows<DH>(dk + kv_off, krow, kw, S, dka, lane);
  store_rows<DH>(dv + kv_off, krow, kw, S, dva, lane);
}

// (c) on the tensor cores: one block per (b, head, 64-row query tile), warp w
// owns queries q0 + 16 w .. + 15; the key tiles its rows can reach, in order
template <int DH>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dd,
                 bf16* __restrict__ dq, int H, int KH, int nq, Mask mk) {
  constexpr int LD = tc_ld(DH);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BT][LD]
  bf16* dos = qs + BT * LD;
  bf16* ks = dos + BT * LD;
  bf16* vs = ks + BT * LD;

  const int S = mk.S;
  const int qt = blockIdx.x % nq;
  const int bh = blockIdx.x / nq;
  const int h = bh % H;
  const int b = bh / H;
  const int kh = h / (H / KH);
  const int q0 = qt * BT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t qrow = (size_t)H * DH, krow = (size_t)KH * DH;
  const size_t q_off = (size_t)b * S * qrow + (size_t)h * DH;
  const size_t kv_off = (size_t)b * S * krow + (size_t)kh * DH;
  stage_bf16<DH>(qs, q + q_off, qrow, q0, S, tid);
  stage_bf16<DH>(dos, dout + q_off, qrow, q0, S, tid);

  const int w0 = q0 + warp * 16;  // this warp's first query
  float lse_r[2], d_r[2];         // this thread's rows: w0 + lane / 4 (+ 8)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = w0 + lane / 4 + 8 * r;
    lse_r[r] = qi < S ? lse[((size_t)b * H + h) * S + qi] : 0.f;
    d_r[r] = qi < S ? dd[((size_t)b * H + h) * S + qi] : 0.f;
  }
  const int q_last = min(q0 + BT, S) - 1;
  const int k_hi = mk.causal ? q_last : S - 1;
  const int k_lo = mk.window > 0 ? max(0, q0 - mk.window + 1) : 0;

  float dqa[DH / 8][4];
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[dt][e] = 0.f;

  for (int k0 = (k_lo / BT) * BT; k0 <= k_hi; k0 += BT) {
    __syncthreads();  // the previous tile's readers are done
    stage_bf16<DH>(ks, k + kv_off, krow, k0, S, tid);
    stage_bf16<DH>(vs, v + kv_off, krow, k0, S, tid);
    cp_async_wait_all();  // this tile (and, the first time, Q and dO)
    __syncthreads();
    if (w0 >= S || (mk.causal && k0 > w0 + 15)) continue;

    float ds[32], dp[32];  // S then dS; dP: [16 queries x 64 keys]
    rows_by_rows<DH>(dp, dos, warp * 16, vs, lane);
    rows_by_rows<DH>(ds, qs, warp * 16, ks, lane);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = (j >> 1) & 1;
      const int qi = w0 + lane / 4 + 8 * r;
      const int kj = k0 + (j / 4) * 8 + (lane % 4) * 2 + (j & 1);
      float p;
      p_ds(ds[j], dp[j], lse_r[r], d_r[r], visible(mk, qi, kj), mk, p, ds[j]);
    }
    acc_by_tile<DH>(dqa, ds, ks, lane);
  }
  store_rows<DH>(dq + q_off, qrow, w0, S, dqa, lane);
}

// Opt a kernel into the dynamic shared memory it needs, once per process.
template <typename F>
int allow_smem(F* kernel, size_t smem, bool& done) {
  if (done) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  done = true;
  return 0;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *dd;
  void *dq, *dk, *dv;
  int B, H, KH;
  Mask mk;
};

template <typename T, int DH>
int launch_dkdv(const Args& a, cudaStream_t st) {
  static bool done = false;
  const int nk = (a.mk.S + BT - 1) / BT;
  const unsigned grid = (unsigned)a.B * (unsigned)a.KH * (unsigned)nk;
  if constexpr (sizeof(T) == 2) {
    const size_t smem = tc_smem<DH>();
    if (int err = allow_smem(flash_bwd_dkdv_mma<DH>, smem, done)) return err;
    flash_bwd_dkdv_mma<DH><<<grid, TC_THREADS, smem, st>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.dd,
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H, a.KH, nk, a.mk);
  } else {
    const size_t smem = dkdv_smem<DH>();
    if (int err = allow_smem(flash_bwd_dkdv<DH>, smem, done)) return err;
    flash_bwd_dkdv<DH><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.dd,
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.H, a.KH, nk, a.mk);
  }
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_dq(const Args& a, cudaStream_t st) {
  static bool done = false;
  const int nq = (a.mk.S + BT - 1) / BT;
  const unsigned grid = (unsigned)a.B * (unsigned)a.H * (unsigned)nq;
  if constexpr (sizeof(T) == 2) {
    const size_t smem = tc_smem<DH>();
    if (int err = allow_smem(flash_bwd_dq_mma<DH>, smem, done)) return err;
    flash_bwd_dq_mma<DH><<<grid, TC_THREADS, smem, st>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.dd,
        static_cast<bf16*>(a.dq), a.H, a.KH, nq, a.mk);
  } else {
    const size_t smem = dq_smem<DH>();
    if (int err = allow_smem(flash_bwd_dq<DH>, smem, done)) return err;
    flash_bwd_dq<DH><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.dd,
        static_cast<float*>(a.dq), a.H, a.KH, nq, a.mk);
  }
  return (int)cudaGetLastError();
}

// which = 0: dK/dV, 1: dQ
template <typename T>
int dispatch(const Args& a, int Dh, int which, cudaStream_t st) {
  switch (Dh) {
    case 16: return which ? launch_dq<T, 16>(a, st) : launch_dkdv<T, 16>(a, st);
    case 32: return which ? launch_dq<T, 32>(a, st) : launch_dkdv<T, 32>(a, st);
    case 64: return which ? launch_dq<T, 64>(a, st) : launch_dkdv<T, 64>(a, st);
    case 128: return which ? launch_dq<T, 128>(a, st) : launch_dkdv<T, 128>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int run(const Args& a, int Dh, int dtype, int which, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.B <= 0 || a.mk.S <= 0 || a.KH <= 0 || a.H % a.KH) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(a, Dh, which, st);
  if (dtype == 1) return dispatch<bf16>(a, Dh, which, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// o, dout [B, S, H, Dh] of one dtype (0 = float32, 1 = bfloat16), contiguous;
// dd [B, H, S] float32 receives rowsum(dO * O). Returns cudaGetLastError().
int flash_attention_bwd_dot(const void* o, const void* dout, void* dd, int B, int S, int H,
                            int Dh, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || Dh <= 0) return (int)cudaErrorInvalidValue;
  const int rows = B * S * H;
  const unsigned grid = (unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32));
  if (dtype == 0)
    flash_bwd_dot<float><<<grid, THREADS, 0, st>>>(static_cast<const float*>(o),
                                                   static_cast<const float*>(dout),
                                                   static_cast<float*>(dd), S, H, Dh, rows);
  else if (dtype == 1)
    flash_bwd_dot<bf16><<<grid, THREADS, 0, st>>>(static_cast<const bf16*>(o),
                                                  static_cast<const bf16*>(dout),
                                                  static_cast<float*>(dd), S, H, Dh, rows);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// q, dout [B, S, H, Dh], k, v [B, S, KH, Dh] of one dtype, contiguous; lse,
// dd [B, H, S] float32 (the forward's log-sum-exp, flash_attention_bwd_dot's
// output). dk, dv [B, S, KH, Dh] in the inputs' dtype. Dh in {16, 32, 64, 128}.
int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* dd, void* dk, void* dv, int B, int S,
                             int H, int KH, int Dh, int dtype, int causal, int window,
                             float softcap, float scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(dd),
               nullptr, dk, dv, B, H, KH, Mask{S, causal, window, softcap, scale}};
  return run(a, Dh, dtype, 0, stream);
}

// The same inputs; dq [B, S, H, Dh] in the inputs' dtype.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* dd, void* dq, int B, int S, int H,
                           int KH, int Dh, int dtype, int causal, int window, float softcap,
                           float scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(dd),
               dq, nullptr, nullptr, B, H, KH, Mask{S, causal, window, softcap, scale}};
  return run(a, Dh, dtype, 1, stream);
}

}  // extern "C"
