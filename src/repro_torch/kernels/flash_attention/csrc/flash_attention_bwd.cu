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
// the query heads kh * G .. kh * G + G - 1, and (b) sums over them. Widths:
// q and k are DK wide, v, o and dO DV wide (DV = DK, or MLA's (192, 128)):
// S = Q K^T runs over DK, dP = dO V^T and D over DV.
//
// Determinism. (b) owns one (b, KV head, key tile) and (c) one (b, head,
// query tile), each for one slice of its output columns; each sums its tiles
// in one fixed order in registers and writes its rows once. There are no
// atomics, so a gradient is the same bits every run (checkpoint restart
// resumes identically on the card).
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
//     dK, dV and dQ accumulators stay in float32 registers: [16 x DK] and
//     [16 x DV] a warp, which above 128 + 128 columns (Dh 224 and 256, and
//     (192, 128)) would take more registers than a thread has. There the
//     output columns are cut in NS = 2 slices, one block each: every slice's
//     block recomputes S and dP over the full widths and accumulates its own
//     half of dK and dV (or dQ). P and dS in bf16 for the products is
//     FlashAttention's rounding; the plain version keeps them in float32
//     (bf16 tolerance 1e-2 of the largest value).
//   - float32 -> flash_bwd_dkdv and flash_bwd_dq, float32 FMAs on the CUDA
//     cores (the tensor cores would round float32 inputs to TF32, and the
//     float32 callers are the card-vs-CPU checks): a 256-thread block stages
//     its tiles as float32 rows padded to an odd width (D + 1, so that 16
//     rows read at one column fall in 16 banks); in the two score products a
//     thread holds an RI x RI register tile (rows tr + 16 i, keys tc + 16 j,
//     tr = tid / 16, tc = tid % 16), in the gradient products RI rows (or
//     keys) x D / 16 columns of accumulators; P and dS go through shared
//     memory between the two. Tiles are BR = 64 rows (RI = 4) up to width
//     128, where (b) takes 162 KB of shared memory; above it, where four
//     64-row tiles of 257 floats would not fit an SM's 227 KB, BR = 32
//     (RI = 2): 140 KB at 256.
//
// Bound on an H100. The work is five [BR x BR x D] products per visible
// tile pair (QK^T recomputed, dP, dV, dK, dQ), about 2.5 times the forward's
// operations, and bytes of q, k, v, o, dO, lse and the three gradients once.
// At training shapes (S = 512, Dh = 64) it is bound by operations. Both
// routes compute S and dP twice (in (b) and in (c)), and once more per
// extra column slice: seven products against the bound's five at NS = 1,
// the price of keeping dQ apart from dK/dV without atomics.
// Later work: wgmma and a K/V ring of several stages, as the forward has.
//
// Widths: (DK, DV) = (D, D) for D in 16, 32, 64, 128, 224 and 256, and
// (192, 128); float32 and bfloat16. The entry points return
// cudaErrorInvalidValue, launching nothing, on anything else.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;         // query rows of a query tile, keys of a key tile (bf16)
constexpr int THREADS = 256;

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

// float32 tiles: BR rows (64 up to width 128, else 32)
template <int DK, int DV>
__host__ __device__ constexpr int f32_rows() { return DK <= 128 && DV <= 128 ? 64 : 32; }

// Stage the BR-row tile of [.., S, N, D] float32 rows starting at row0 (src
// at row 0 of the head, rows `stride` elements apart) as rows of D + 1;
// rows past S are zeros.
template <int D, int BR>
__device__ __forceinline__ void stage(float* dst, const float* src, size_t stride, int row0,
                                      int S, int tid) {
  for (int e = tid; e < BR * D; e += THREADS) {
    const int r = e / D, d = e % D;
    dst[r * (D + 1) + d] = row0 + r < S ? src[(size_t)(row0 + r) * stride + d] : 0.f;
  }
}

// The RI x RI register tiles of S = Q K^T (over DK) and dP = dO V^T (over
// DV): rows tr + 16 i of qs / dos, keys tc + 16 j of ks / vs
template <int DK, int DV, int RI>
__device__ __forceinline__ void score_tiles(const float* qs, const float* dos, const float* ks,
                                            const float* vs, int tr, int tc, float (&s)[RI][RI],
                                            float (&dp)[RI][RI]) {
  constexpr int LK = DK + 1, LV = DV + 1;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RI; ++j) s[i][j] = dp[i][j] = 0.f;
  if constexpr (DK == DV) {
#pragma unroll 4
    for (int d = 0; d < DK; ++d) {
      float qa[RI], da[RI], ka[RI], va[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qa[i] = qs[(tr + 16 * i) * LK + d];
        da[i] = dos[(tr + 16 * i) * LV + d];
        ka[i] = ks[(tc + 16 * i) * LK + d];
        va[i] = vs[(tc + 16 * i) * LV + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
          dp[i][j] = fmaf(da[i], va[j], dp[i][j]);
        }
    }
  } else {
#pragma unroll 4
    for (int d = 0; d < DK; ++d) {
      float qa[RI], ka[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qa[i] = qs[(tr + 16 * i) * LK + d];
        ka[i] = ks[(tc + 16 * i) * LK + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }
#pragma unroll 4
    for (int d = 0; d < DV; ++d) {
      float da[RI], va[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        da[i] = dos[(tr + 16 * i) * LV + d];
        va[i] = vs[(tc + 16 * i) * LV + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) dp[i][j] = fmaf(da[i], va[j], dp[i][j]);
    }
  }
}

// (a) one warp per (b, i, h) row of o / dO, in their [B, S, H, DV] order
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dot(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dd,
              int S, int H, int DV, int rows) {
  const int row = (int)((blockIdx.x * (size_t)THREADS + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + (size_t)row * DV;
  const T* drow = dout + (size_t)row * DV;
  float acc = 0.f;
  for (int d = lane; d < DV; d += 32) acc = fmaf(to_f(drow[d]), to_f(orow[d]), acc);
#pragma unroll
  for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H, bs = row / H;
    dd[((size_t)(bs / S) * H + h) * S + bs % S] = acc;
  }
}

template <int DK, int DV>
constexpr size_t dkdv_smem() {  // K, Q tiles; V, dO tiles; P, dS; lse, D
  constexpr int BR = f32_rows<DK, DV>();
  return (size_t)(2 * BR * (DK + 1) + 2 * BR * (DV + 1) + 2 * BR * (BR + 1) + 2 * BR) *
         sizeof(float);
}

// (b) one block per (b, KV head, BR-key tile): every query tile of every head
// of the group that can see a key of the tile, in order
template <int DK, int DV>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dd,
               float* __restrict__ dk, float* __restrict__ dv, int H, int KH, int nk, Mask mk) {
  constexpr int BR = f32_rows<DK, DV>(), RI = BR / 16, LP = BR + 1;
  constexpr int LK = DK + 1, LV = DV + 1;
  constexpr int JK = DK / 16, JV = DV / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* ks = smem;             // [BR][LK]
  float* vs = ks + BR * LK;     // [BR][LV]
  float* qs = vs + BR * LV;     // [BR][LK]
  float* dos = qs + BR * LK;    // [BR][LV]
  float* ps = dos + BR * LV;    // [BR rows][LP keys]
  float* dss = ps + BR * LP;    // [BR rows][LP keys]
  float* lse_s = dss + BR * LP;
  float* d_s = lse_s + BR;

  const int S = mk.S;
  const int kt = blockIdx.x % nk;
  const int bkh = blockIdx.x / nk;
  const int kh = bkh % KH;
  const int b = bkh / KH;
  const int G = H / KH;
  const int k0 = kt * BR;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const size_t qrow = (size_t)H * DK, orow = (size_t)H * DV;
  const size_t krow = (size_t)KH * DK, vrow = (size_t)KH * DV;
  stage<DK, BR>(ks, k + (size_t)b * S * krow + (size_t)kh * DK, krow, k0, S, tid);
  stage<DV, BR>(vs, v + (size_t)b * S * vrow + (size_t)kh * DV, vrow, k0, S, tid);

  // the query rows that can see a key of this tile
  const int k_last = min(k0 + BR, S) - 1;
  const int q_lo = mk.causal ? k0 : 0;
  const int q_hi = mk.window > 0 ? min(S - 1, k_last + mk.window - 1) : S - 1;

  float dka[RI][JK], dva[RI][JV];  // keys tr + 16 i, columns tc + 16 j
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int j = 0; j < JK; ++j) dka[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < JV; ++j) dva[i][j] = 0.f;
  }

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const float* qb = q + (size_t)b * S * qrow + (size_t)h * DK;
    const float* db = dout + (size_t)b * S * orow + (size_t)h * DV;
    const float* lb = lse + ((size_t)b * H + h) * S;
    const float* dr = dd + ((size_t)b * H + h) * S;
    for (int q0 = (q_lo / BR) * BR; q0 <= q_hi; q0 += BR) {
      __syncthreads();  // the previous tile's readers are done
      stage<DK, BR>(qs, qb, qrow, q0, S, tid);
      stage<DV, BR>(dos, db, orow, q0, S, tid);
      if (tid < BR) {
        const bool in = q0 + tid < S;
        lse_s[tid] = in ? lb[q0 + tid] : 0.f;
        d_s[tid] = in ? dr[q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[RI][RI], dp[RI][RI];
      score_tiles<DK, DV, RI>(qs, dos, ks, vs, tr, tc, s, dp);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          const int r = tr + 16 * i, c = tc + 16 * j;
          float p, ds;
          p_ds(s[i][j], dp[i][j], lse_s[r], d_s[r], visible(mk, q0 + r, k0 + c), mk, p, ds);
          ps[r * LP + c] = p;
          dss[r * LP + c] = ds;
        }
      __syncthreads();

      // dV[key] += P[r, key] dO[r], dK[key] += dS[r, key] Q[r]
#pragma unroll 4
      for (int r = 0; r < BR; ++r) {
        float pa[RI], sa[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pa[i] = ps[r * LP + tr + 16 * i];
          sa[i] = dss[r * LP + tr + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < JV; ++j) {
          const float dov = dos[r * LV + tc + 16 * j];
#pragma unroll
          for (int i = 0; i < RI; ++i) dva[i][j] = fmaf(pa[i], dov, dva[i][j]);
        }
#pragma unroll
        for (int j = 0; j < JK; ++j) {
          const float qv = qs[r * LK + tc + 16 * j];
#pragma unroll
          for (int i = 0; i < RI; ++i) dka[i][j] = fmaf(sa[i], qv, dka[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kj = k0 + tr + 16 * i;
    if (kj >= S) continue;
    const size_t ka = ((size_t)b * S + kj) * krow + (size_t)kh * DK + tc;
    const size_t va = ((size_t)b * S + kj) * vrow + (size_t)kh * DV + tc;
#pragma unroll
    for (int j = 0; j < JK; ++j) dk[ka + 16 * j] = dka[i][j];
#pragma unroll
    for (int j = 0; j < JV; ++j) dv[va + 16 * j] = dva[i][j];
  }
}

template <int DK, int DV>
constexpr size_t dq_smem() {  // Q, K tiles; dO, V tiles; dS; lse, D
  constexpr int BR = f32_rows<DK, DV>();
  return (size_t)(2 * BR * (DK + 1) + 2 * BR * (DV + 1) + BR * (BR + 1) + 2 * BR) *
         sizeof(float);
}

// (c) one block per (b, head, BR-row query tile): the key tiles its rows can
// reach, in order (the forward's walk)
template <int DK, int DV>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dd,
             float* __restrict__ dq, int H, int KH, int nq, Mask mk) {
  constexpr int BR = f32_rows<DK, DV>(), RI = BR / 16, LP = BR + 1;
  constexpr int LK = DK + 1;
  constexpr int JK = DK / 16;
  extern __shared__ float smem[];
  float* qs = smem;                   // [BR][LK]
  float* dos = qs + BR * LK;          // [BR][DV + 1]
  float* ks = dos + BR * (DV + 1);    // [BR][LK]
  float* vs = ks + BR * LK;           // [BR][DV + 1]
  float* dss = vs + BR * (DV + 1);    // [BR rows][LP keys]
  float* lse_s = dss + BR * LP;
  float* d_s = lse_s + BR;

  const int S = mk.S;
  const int qt = blockIdx.x % nq;
  const int bh = blockIdx.x / nq;
  const int h = bh % H;
  const int b = bh / H;
  const int kh = h / (H / KH);
  const int q0 = qt * BR;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const size_t qrow = (size_t)H * DK, orow = (size_t)H * DV;
  const size_t krow = (size_t)KH * DK, vrow = (size_t)KH * DV;
  const float* kb = k + (size_t)b * S * krow + (size_t)kh * DK;
  const float* vb = v + (size_t)b * S * vrow + (size_t)kh * DV;
  stage<DK, BR>(qs, q + (size_t)b * S * qrow + (size_t)h * DK, qrow, q0, S, tid);
  stage<DV, BR>(dos, dout + (size_t)b * S * orow + (size_t)h * DV, orow, q0, S, tid);
  if (tid < BR) {
    const bool in = q0 + tid < S;
    lse_s[tid] = in ? lse[((size_t)b * H + h) * S + q0 + tid] : 0.f;
    d_s[tid] = in ? dd[((size_t)b * H + h) * S + q0 + tid] : 0.f;
  }

  // the keys any row of this tile can reach
  const int q_last = min(q0 + BR, S) - 1;
  const int k_hi = mk.causal ? q_last : S - 1;
  const int k_lo = mk.window > 0 ? max(0, q0 - mk.window + 1) : 0;

  float dqa[RI][JK];  // rows tr + 16 i, columns tc + 16 j
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < JK; ++j) dqa[i][j] = 0.f;

  for (int k0 = (k_lo / BR) * BR; k0 <= k_hi; k0 += BR) {
    __syncthreads();  // Q / dO are in; the previous tile's readers are done
    stage<DK, BR>(ks, kb, krow, k0, S, tid);
    stage<DV, BR>(vs, vb, vrow, k0, S, tid);
    __syncthreads();

    float s[RI][RI], dp[RI][RI];
    score_tiles<DK, DV, RI>(qs, dos, ks, vs, tr, tc, s, dp);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int r = tr + 16 * i, c = tc + 16 * j;
        float p, ds;
        p_ds(s[i][j], dp[i][j], lse_s[r], d_s[r], visible(mk, q0 + r, k0 + c), mk, p, ds);
        dss[r * LP + c] = ds;
      }
    __syncthreads();

    // dQ[r] += dS[r, key] K[key]
#pragma unroll 4
    for (int c = 0; c < BR; ++c) {
      float sa[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) sa[i] = dss[(tr + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        const float kv = ks[c * LK + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) dqa[i][j] = fmaf(sa[i], kv, dqa[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi >= S) continue;
    const size_t at = ((size_t)b * S + qi) * qrow + (size_t)h * DK + tc;
#pragma unroll
    for (int j = 0; j < JK; ++j) dq[at + 16 * j] = dqa[i][j];
  }
}

// ---- bf16: mma.sync m16n8k16 ----

constexpr int TC_THREADS = 128;  // four warps, 16 rows (or keys) each
__host__ __device__ constexpr int tc_ld(int dh) { return dh + 8; }  // padded bf16 row

// output column slices a block takes: 2 above 128 + 128 accumulator columns
template <int DK, int DV>
__host__ __device__ constexpr int col_slices() { return DK + DV > 256 ? 2 : 1; }

template <int DK, int DV>
constexpr size_t tc_smem() {  // [64][DK + 8] and [64][DV + 8] bf16 tiles, two each; lse, D
  return (size_t)2 * BT * (tc_ld(DK) + tc_ld(DV)) * sizeof(bf16) + 2 * BT * sizeof(float);
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

// Stage a 64-row tile of [.., S, N, D] bf16 rows (src at row 0 of the head,
// rows `stride` elements apart) into a [64][D + 8] tile by 16-byte copies;
// rows past S are zeros. Waited on by the caller.
template <int D>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src, size_t stride, int row0,
                                           int S, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  for (int e = tid; e < BT * CPR; e += TC_THREADS) {
    const int r = e / CPR, ch = e % CPR;
    const bool in = row0 + r < S;
    cp_async16(smem_u32(dst + r * tc_ld(D) + ch * 8),
               src + (size_t)(in ? row0 + r : 0) * stride + ch * 8, in);
  }
}

// acc[16 x 64] = A (16 rows of `a`, from row a_row) . B^T (the 64 rows of `b`):
// a and b are [64][D + 8] tiles, the product over D; acc is the m16n8
// accumulator over 8 n-tiles, acc[4 j + e] at row a_row + lane / 4 + 8 (e / 2),
// column 8 j + 2 (lane % 4) + e % 2
template <int D>
__device__ __forceinline__ void rows_by_rows(float (&acc)[32], const bf16* a, int a_row,
                                             const bf16* b, int lane) {
  constexpr int LD = tc_ld(D);
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
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

// out[16 x W] += p (16 x 64, the accumulator layout of rows_by_rows, rounded
// to bf16 as the A operand) . columns c0 .. c0 + W of the [64][D + 8] tile t
// (k = its rows, read transposed); out[dt][4] over W / 8 n-tiles, the same
// layout
template <int D, int W>
__device__ __forceinline__ void acc_by_tile(float (&out)[W / 8][4], const float (&p)[32],
                                            const bf16* t, int c0, int lane) {
  constexpr int LD = tc_ld(D);
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[8 * kk + 0], p[8 * kk + 1]),
                            pack_bf16(p[8 * kk + 2], p[8 * kk + 3]),
                            pack_bf16(p[8 * kk + 4], p[8 * kk + 5]),
                            pack_bf16(p[8 * kk + 6], p[8 * kk + 7])};
#pragma unroll
    for (int dt = 0; dt < W / 8; dt += 2) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(smem_u32(t + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + c0 + dt * 8 +
                         (lane / 16) * 8),
                b0, b1, b2, b3);
      mma_bf16(out[dt], pa, b0, b1);
      mma_bf16(out[dt + 1], pa, b2, b3);
    }
  }
}

// Store a warp's [16 x W] float32 accumulator as bf16 rows row0 (+ 8) of a
// [.., S, N, D] tensor (dst at row 0 of the head and the slice's first
// column); rows past S are not written.
template <int W>
__device__ __forceinline__ void store_rows(bf16* dst, size_t stride, int row0, int S,
                                           const float (&acc)[W / 8][4], int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    if (row >= S) continue;
    bf16* o = dst + (size_t)row * stride + (lane % 4) * 2;
#pragma unroll
    for (int dt = 0; dt < W / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(o + dt * 8) =
          __floats2bfloat162_rn(acc[dt][2 * r], acc[dt][2 * r + 1]);
  }
}

// (b) on the tensor cores: one block per (b, KV head, 64-key tile, column
// slice), warp w owns keys k0 + 16 w .. + 15; every query tile of every head
// of the group that can see a key of the tile, in order
template <int DK, int DV>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ dd,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KH, int nk,
                   Mask mk) {
  constexpr int NS = col_slices<DK, DV>(), WK = DK / NS, WV = DV / NS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BT][DK + 8]
  bf16* vs = ks + BT * tc_ld(DK);                 // [BT][DV + 8]
  bf16* qs = vs + BT * tc_ld(DV);                 // [BT][DK + 8]
  bf16* dos = qs + BT * tc_ld(DK);                // [BT][DV + 8]
  float* lse_s = reinterpret_cast<float*>(dos + BT * tc_ld(DV));
  float* d_s = lse_s + BT;

  const int S = mk.S;
  const int sl = blockIdx.x % NS;
  const int kt = (blockIdx.x / NS) % nk;
  const int bkh = blockIdx.x / NS / nk;
  const int kh = bkh % KH;
  const int b = bkh / KH;
  const int G = H / KH;
  const int k0 = kt * BT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t qrow = (size_t)H * DK, orow = (size_t)H * DV;
  const size_t krow = (size_t)KH * DK, vrow = (size_t)KH * DV;
  const size_t k_off = (size_t)b * S * krow + (size_t)kh * DK;
  const size_t v_off = (size_t)b * S * vrow + (size_t)kh * DV;
  stage_bf16<DK>(ks, k + k_off, krow, k0, S, tid);
  stage_bf16<DV>(vs, v + v_off, vrow, k0, S, tid);

  const int k_last = min(k0 + BT, S) - 1;
  const int q_lo = mk.causal ? k0 : 0;
  const int q_hi = mk.window > 0 ? min(S - 1, k_last + mk.window - 1) : S - 1;
  const int kw = k0 + warp * 16;  // this warp's first key

  float dka[WK / 8][4], dva[WV / 8][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int dt = 0; dt < WK / 8; ++dt) dka[dt][e] = 0.f;
#pragma unroll
    for (int dt = 0; dt < WV / 8; ++dt) dva[dt][e] = 0.f;
  }

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t q_off = (size_t)b * S * qrow + (size_t)h * DK;
    const size_t o_off = (size_t)b * S * orow + (size_t)h * DV;
    const float* lb = lse + ((size_t)b * H + h) * S;
    const float* dr = dd + ((size_t)b * H + h) * S;
    for (int q0 = (q_lo / BT) * BT; q0 <= q_hi; q0 += BT) {
      __syncthreads();  // the previous tile's readers are done
      stage_bf16<DK>(qs, q + q_off, qrow, q0, S, tid);
      stage_bf16<DV>(dos, dout + o_off, orow, q0, S, tid);
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
      rows_by_rows<DV>(dst, vs, warp * 16, dos, lane);
      rows_by_rows<DK>(pt, ks, warp * 16, qs, lane);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int kj = kw + lane / 4 + 8 * ((j >> 1) & 1);
        const int c = (j / 4) * 8 + (lane % 4) * 2 + (j & 1);
        p_ds(pt[j], dst[j], lse_s[c], d_s[c], visible(mk, q0 + c, kj), mk, pt[j], dst[j]);
      }
      acc_by_tile<DV, WV>(dva, pt, dos, sl * WV, lane);
      acc_by_tile<DK, WK>(dka, dst, qs, sl * WK, lane);
    }
  }
  store_rows<WK>(dk + k_off + sl * WK, krow, kw, S, dka, lane);
  store_rows<WV>(dv + v_off + sl * WV, vrow, kw, S, dva, lane);
}

// (c) on the tensor cores: one block per (b, head, 64-row query tile, column
// slice), warp w owns queries q0 + 16 w .. + 15; the key tiles its rows can
// reach, in order
template <int DK, int DV>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dd,
                 bf16* __restrict__ dq, int H, int KH, int nq, Mask mk) {
  constexpr int NS = col_slices<DK, DV>(), WK = DK / NS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BT][DK + 8]
  bf16* dos = qs + BT * tc_ld(DK);                // [BT][DV + 8]
  bf16* ks = dos + BT * tc_ld(DV);                // [BT][DK + 8]
  bf16* vs = ks + BT * tc_ld(DK);                 // [BT][DV + 8]

  const int S = mk.S;
  const int sl = blockIdx.x % NS;
  const int qt = (blockIdx.x / NS) % nq;
  const int bh = blockIdx.x / NS / nq;
  const int h = bh % H;
  const int b = bh / H;
  const int kh = h / (H / KH);
  const int q0 = qt * BT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t qrow = (size_t)H * DK, orow = (size_t)H * DV;
  const size_t krow = (size_t)KH * DK, vrow = (size_t)KH * DV;
  const size_t q_off = (size_t)b * S * qrow + (size_t)h * DK;
  const size_t o_off = (size_t)b * S * orow + (size_t)h * DV;
  const size_t k_off = (size_t)b * S * krow + (size_t)kh * DK;
  const size_t v_off = (size_t)b * S * vrow + (size_t)kh * DV;
  stage_bf16<DK>(qs, q + q_off, qrow, q0, S, tid);
  stage_bf16<DV>(dos, dout + o_off, orow, q0, S, tid);

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

  float dqa[WK / 8][4];
#pragma unroll
  for (int dt = 0; dt < WK / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[dt][e] = 0.f;

  for (int k0 = (k_lo / BT) * BT; k0 <= k_hi; k0 += BT) {
    __syncthreads();  // the previous tile's readers are done
    stage_bf16<DK>(ks, k + k_off, krow, k0, S, tid);
    stage_bf16<DV>(vs, v + v_off, vrow, k0, S, tid);
    cp_async_wait_all();  // this tile (and, the first time, Q and dO)
    __syncthreads();
    if (w0 >= S || (mk.causal && k0 > w0 + 15)) continue;

    float ds[32], dp[32];  // S then dS; dP: [16 queries x 64 keys]
    rows_by_rows<DV>(dp, dos, warp * 16, vs, lane);
    rows_by_rows<DK>(ds, qs, warp * 16, ks, lane);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = (j >> 1) & 1;
      const int qi = w0 + lane / 4 + 8 * r;
      const int kj = k0 + (j / 4) * 8 + (lane % 4) * 2 + (j & 1);
      float p;
      p_ds(ds[j], dp[j], lse_r[r], d_r[r], visible(mk, qi, kj), mk, p, ds[j]);
    }
    acc_by_tile<DK, WK>(dqa, ds, ks, sl * WK, lane);
  }
  store_rows<WK>(dq + q_off + sl * WK, qrow, w0, S, dqa, lane);
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

template <typename T, int DK, int DV>
int launch_dkdv(const Args& a, cudaStream_t st) {
  static bool done = false;
  if constexpr (sizeof(T) == 2) {
    const int nk = (a.mk.S + BT - 1) / BT;
    const unsigned grid =
        (unsigned)a.B * (unsigned)a.KH * (unsigned)nk * (unsigned)col_slices<DK, DV>();
    const size_t smem = tc_smem<DK, DV>();
    if (int err = allow_smem(flash_bwd_dkdv_mma<DK, DV>, smem, done)) return err;
    flash_bwd_dkdv_mma<DK, DV><<<grid, TC_THREADS, smem, st>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.dd,
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H, a.KH, nk, a.mk);
  } else {
    constexpr int BR = f32_rows<DK, DV>();
    const int nk = (a.mk.S + BR - 1) / BR;
    const unsigned grid = (unsigned)a.B * (unsigned)a.KH * (unsigned)nk;
    const size_t smem = dkdv_smem<DK, DV>();
    if (int err = allow_smem(flash_bwd_dkdv<DK, DV>, smem, done)) return err;
    flash_bwd_dkdv<DK, DV><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.dd,
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.H, a.KH, nk, a.mk);
  }
  return (int)cudaGetLastError();
}

template <typename T, int DK, int DV>
int launch_dq(const Args& a, cudaStream_t st) {
  static bool done = false;
  if constexpr (sizeof(T) == 2) {
    const int nq = (a.mk.S + BT - 1) / BT;
    const unsigned grid =
        (unsigned)a.B * (unsigned)a.H * (unsigned)nq * (unsigned)col_slices<DK, DV>();
    const size_t smem = tc_smem<DK, DV>();
    if (int err = allow_smem(flash_bwd_dq_mma<DK, DV>, smem, done)) return err;
    flash_bwd_dq_mma<DK, DV><<<grid, TC_THREADS, smem, st>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.dd,
        static_cast<bf16*>(a.dq), a.H, a.KH, nq, a.mk);
  } else {
    constexpr int BR = f32_rows<DK, DV>();
    const int nq = (a.mk.S + BR - 1) / BR;
    const unsigned grid = (unsigned)a.B * (unsigned)a.H * (unsigned)nq;
    const size_t smem = dq_smem<DK, DV>();
    if (int err = allow_smem(flash_bwd_dq<DK, DV>, smem, done)) return err;
    flash_bwd_dq<DK, DV><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.dd,
        static_cast<float*>(a.dq), a.H, a.KH, nq, a.mk);
  }
  return (int)cudaGetLastError();
}

// which = 0: dK/dV, 1: dQ
template <typename T, int DK, int DV>
int launch(const Args& a, int which, cudaStream_t st) {
  return which ? launch_dq<T, DK, DV>(a, st) : launch_dkdv<T, DK, DV>(a, st);
}

template <typename T>
int dispatch(const Args& a, int Dh, int Dv, int which, cudaStream_t st) {
  if (Dh == 192 && Dv == 128) return launch<T, 192, 128>(a, which, st);
  if (Dh != Dv) return (int)cudaErrorInvalidValue;
  switch (Dh) {
    case 16: return launch<T, 16, 16>(a, which, st);
    case 32: return launch<T, 32, 32>(a, which, st);
    case 64: return launch<T, 64, 64>(a, which, st);
    case 128: return launch<T, 128, 128>(a, which, st);
    case 224: return launch<T, 224, 224>(a, which, st);
    case 256: return launch<T, 256, 256>(a, which, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int run(const Args& a, int Dh, int Dv, int dtype, int which, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.B <= 0 || a.mk.S <= 0 || a.KH <= 0 || a.H % a.KH) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(a, Dh, Dv, which, st);
  if (dtype == 1) return dispatch<bf16>(a, Dh, Dv, which, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// o, dout [B, S, H, Dv] of one dtype (0 = float32, 1 = bfloat16), contiguous;
// dd [B, H, S] float32 receives rowsum(dO * O). Returns cudaGetLastError().
int flash_attention_bwd_dot(const void* o, const void* dout, void* dd, int B, int S, int H,
                            int Dv, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || Dv <= 0) return (int)cudaErrorInvalidValue;
  const int rows = B * S * H;
  const unsigned grid = (unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32));
  if (dtype == 0)
    flash_bwd_dot<float><<<grid, THREADS, 0, st>>>(static_cast<const float*>(o),
                                                   static_cast<const float*>(dout),
                                                   static_cast<float*>(dd), S, H, Dv, rows);
  else if (dtype == 1)
    flash_bwd_dot<bf16><<<grid, THREADS, 0, st>>>(static_cast<const bf16*>(o),
                                                  static_cast<const bf16*>(dout),
                                                  static_cast<float*>(dd), S, H, Dv, rows);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// q [B, S, H, Dh], dout [B, S, H, Dv], k [B, S, KH, Dh], v [B, S, KH, Dv] of one
// dtype, contiguous; lse, dd [B, H, S] float32 (the forward's log-sum-exp,
// flash_attention_bwd_dot's output). dk [B, S, KH, Dh], dv [B, S, KH, Dv] in
// the inputs' dtype. (Dh, Dv): (D, D) for D in {16, 32, 64, 128, 224, 256},
// or (192, 128).
int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* dd, void* dk, void* dv, int B, int S,
                             int H, int KH, int Dh, int Dv, int dtype, int causal, int window,
                             float softcap, float scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(dd),
               nullptr, dk, dv, B, H, KH, Mask{S, causal, window, softcap, scale}};
  return run(a, Dh, Dv, dtype, 0, stream);
}

// The same inputs; dq [B, S, H, Dh] in the inputs' dtype.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* dd, void* dq, int B, int S, int H,
                           int KH, int Dh, int Dv, int dtype, int causal, int window,
                           float softcap, float scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(dd),
               dq, nullptr, nullptr, B, H, KH, Mask{S, causal, window, softcap, scale}};
  return run(a, Dh, Dv, dtype, 1, stream);
}

}  // extern "C"
