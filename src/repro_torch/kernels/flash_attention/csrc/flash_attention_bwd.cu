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
// query tile); each sums its tiles in one fixed order in registers and
// writes its rows once. There are no
// atomics, so a gradient is the same bits every run (checkpoint restart
// resumes identically on the card).
//
// Routes.
//   - bfloat16 (training's dtype) at widths 64, 128, 224 (tiles padded to
//     256, as the forward's), 256 and (192, 128) -> flash_bwd_dkdv_wg1 (W =
//     64 and 128) or flash_bwd_dkdv_wg (W = 192 and 256), and
//     flash_bwd_dq_wg, on Hopper's warpgroup products (wgmma) over the
//     forward's 128-byte-swizzled tiles, W the wider input's width (MLA's V
//     and dO zero-filled from 128 to 192):
//       (b) dK/dV, a block per (b, KV head, 64-key tile): S^T = K Q^T and
//       dP^T = V dO^T (K and V the 64-row A, Q and dO the B, all K-major),
//       then dV += P^T dO and dK += dS^T Q with P^T and dS^T rounded to bf16
//       in registers as A and dO, Q read MN-major. Up to W = 128 one
//       warpgroup holds both [64 x W] float32 accumulators (three blocks an
//       SM at 64, two at 128); at 192 and 256 two warpgroups hold one each
//       (128 floats a thread at 256, as the forward's output), each computes
//       S^T and dP^T over half of the tile's queries, and they trade the
//       halves of P^T and dS^T through shared memory, so each product is
//       computed once. The first version recomputed S and dP per column
//       slice above 128 + 128 accumulator columns. Under GQA, where
//       the grid would give fewer than 264 blocks, a cluster of up to
//       min(G, 8) blocks shares a (b, KV head, key tile), each taking a share
//       of the query heads, and the cluster's first block adds the others'
//       dK and dV, read from their shared memory, in rank order
//       (dkdv_splits).
//       (c) dQ, one 128-thread block per (b, head, 64-row query tile), the
//       causal grid's longest tiles first (the forward's order): S = Q K^T
//       and dP = dO V^T, P while dP is still on the tensor cores, dS,
//       dQ += dS K (K MN-major).
//     Both stream their tiles through a ring in shared memory filled by
//     16-byte cp.async copies (zero-fill past S; lse and D by 4-byte ones)
//     STAGES - 1 tiles ahead of the one computed: Q, dO, lse and D for
//     dK/dV (2 stages, 3 at W = 192), K and V for dQ (3 at width 64, else
//     2). The first version waited for each tile's copies before computing
//     it.
//     P = 2^(x log2 e - lse log2 e) is one SFU op and the mask a select,
//     computed only on tiles that cross S, the causal diagonal or the
//     window: an accurate expf under a per-element branch took half of the
//     dK/dV kernel's time. The two warpgroups of flash_bwd_dkdv_wg run one
//     instruction stream around the products, their operands chosen by
//     address: a branch around a wgmma made the compiler serialize every
//     product.
//   - bfloat16 at widths 16 and 32 -> flash_bwd_dkdv_mma and
//     flash_bwd_dq_mma, on mma.sync m16n8k16 (a 16- or 32-wide row is
//     narrower than the 128-byte swizzle atom, as in the forward; only the
//     smoke configurations have it): a 128-thread block, four warps of 16
//     rows; S^T = K Q^T and dP^T = V dO^T by ldmatrix from rows padded by 16
//     bytes, dV += P^T dO and dK += dS^T Q with P^T and dS^T in registers
//     as A; dQ's causal grid longest first.
//     P and dS in bf16 for the products is FlashAttention's rounding; the
//     plain version keeps them in float32 (bf16 tolerance 1e-2 of the
//     largest value).
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
// Bound on an H100. The work is five [64 x 64 x D] products per visible
// tile pair (QK^T recomputed, dP, dV, dK, dQ), about 2.5 times the forward's
// operations, and bytes of q, k, v, o, dO, lse and the three gradients once.
// Every route computes S and dP twice (in (b) and in (c)): seven products
// against the bound's five, the price of keeping dQ apart from dK/dV without
// atomics. Measured (chip_smoke.py --bwd-only, NVIDIA H100 80GB HBM3,
// 700.00 W; SDPA's fastest backend and the first version on the same host):
// at qwen1.5-0.5b's train shape (B 8, S 512, H 16, Dh 64) 0.0886 ms, 1.08x
// SDPA's backward (the first version 0.1869 ms); Dh 128 under GQA 0.0583
// (1.36x), Dh 224 0.1004 (1.15x), gemma3-4b's Dh 256 0.4886 (1.38x),
// (192, 128) 0.2696 (1.33x); faster than SDPA's masked backward on windowed
// layers. Late in the full chip_smoke.py run SDPA's backward reads up to
// 1.6x faster while this one does not move. PERF.md keeps the rest.
//
// Widths: (DK, DV) = (D, D) for D in 16, 32, 64, 128, 224 and 256, and
// (192, 128); float32 and bfloat16. The entry points return
// cudaErrorInvalidValue, launching nothing, on anything else.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;         // query rows of a query tile, keys of a key tile (bf16)
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int THREADS = 256;

using bf16 = __nv_bfloat16;


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

// (a), bfloat16: 16 bytes (8 values) a lane, GW lanes a row (DV / 8
// rounded up to a power of two), 32 / GW rows a warp, in their [B, S, H, DV]
// order; each row's sum in one fixed shuffle order
template <int DV>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dot_vec(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                  float* __restrict__ dd, int S, int H, int rows) {
  constexpr int CPR = DV / 8;
  constexpr int GW = CPR <= 2 ? 2 : CPR <= 4 ? 4 : CPR <= 8 ? 8 : CPR <= 16 ? 16 : 32;
  const int lane = threadIdx.x % 32;
  const int row = (int)((blockIdx.x * (size_t)THREADS + threadIdx.x) / 32) * (32 / GW) + lane / GW;
  const int c = lane % GW;
  float acc = 0.f;
  if (row < rows && c < CPR) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + (size_t)row * DV + c * 8);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + (size_t)row * DV + c * 8);
    const __nv_bfloat162* ah = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* gh = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 af = __bfloat1622float2(ah[i]), gf = __bfloat1622float2(gh[i]);
      acc = fmaf(gf.x, af.x, acc);
      acc = fmaf(gf.y, af.y, acc);
    }
  }
#pragma unroll
  for (int off = GW / 2; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (c == 0 && row < rows) {
    const int h = row % H, bs = row / H;
    dd[((size_t)(bs / S) * H + h) * S + bs % S] = acc;
  }
}

template <int DV>
int launch_dot_vec(const bf16* o, const bf16* dout, float* dd, int S, int H, int rows,
                   cudaStream_t st) {
  constexpr int GW = DV / 8 <= 2 ? 2 : DV / 8 <= 4 ? 4 : DV / 8 <= 8 ? 8 : DV / 8 <= 16 ? 16 : 32;
  const int per_block = THREADS / 32 * (32 / GW);
  flash_bwd_dot_vec<DV><<<(unsigned)((rows + per_block - 1) / per_block), THREADS, 0, st>>>(
      o, dout, dd, S, H, rows);
  return (int)cudaGetLastError();
}

// (a), float32: one warp per (b, i, h) row of o / dO, in their [B, S, H, DV] order
__global__ void __launch_bounds__(THREADS)
flash_bwd_dot(const float* __restrict__ o, const float* __restrict__ dout, float* __restrict__ dd,
              int S, int H, int DV, int rows) {
  const int row = (int)((blockIdx.x * (size_t)THREADS + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* orow = o + (size_t)row * DV;
  const float* drow = dout + (size_t)row * DV;
  float acc = 0.f;
  for (int d = lane; d < DV; d += 32) acc = fmaf(drow[d], orow[d], acc);
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

// ---- bf16 at widths 16 and 32: mma.sync m16n8k16 ----

constexpr int TC_THREADS = 128;  // four warps, 16 rows (or keys) each
__host__ __device__ constexpr int tc_ld(int dh) { return dh + 8; }  // padded bf16 row

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
// 4 bytes global -> shared; with valid == false the destination is zero-filled
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
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

// out[16 x D] += p (16 x 64, the accumulator layout of rows_by_rows, rounded
// to bf16 as the A operand) . the [64][D + 8] tile t (k = its rows, read
// transposed); out[dt][4] over D / 8 n-tiles, the same layout
template <int D>
__device__ __forceinline__ void acc_by_tile(float (&out)[D / 8][4], const float (&p)[32],
                                            const bf16* t, int lane) {
  constexpr int LD = tc_ld(D);
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[8 * kk + 0], p[8 * kk + 1]),
                            pack_bf16(p[8 * kk + 2], p[8 * kk + 3]),
                            pack_bf16(p[8 * kk + 4], p[8 * kk + 5]),
                            pack_bf16(p[8 * kk + 6], p[8 * kk + 7])};
#pragma unroll
    for (int dt = 0; dt < D / 8; dt += 2) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(smem_u32(t + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + dt * 8 +
                         (lane / 16) * 8),
                b0, b1, b2, b3);
      mma_bf16(out[dt], pa, b0, b1);
      mma_bf16(out[dt + 1], pa, b2, b3);
    }
  }
}

// Store a warp's [16 x W] float32 accumulator as bf16 rows row0 (+ 8) of a
// [.., S, N, D] tensor (dst at row 0 of the head); rows past S are not written.
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

// (b) at widths 16 and 32: one block per (b, KV head, 64-key tile), warp w
// owns keys k0 + 16 w .. + 15; every query tile of every head of the group
// that can see a key of the tile, in order
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ dd,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KH, int nk,
                   Mask mk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BT][D + 8]
  bf16* vs = ks + BT * tc_ld(D);                  // [BT][D + 8]
  bf16* qs = vs + BT * tc_ld(D);                  // [BT][D + 8]
  bf16* dos = qs + BT * tc_ld(D);                 // [BT][D + 8]
  float* lse_s = reinterpret_cast<float*>(dos + BT * tc_ld(D));
  float* d_s = lse_s + BT;

  const int S = mk.S;
  const int kt = blockIdx.x % nk;
  const int bkh = blockIdx.x / nk;
  const int kh = bkh % KH;
  const int b = bkh / KH;
  const int G = H / KH;
  const int k0 = kt * BT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t qrow = (size_t)H * D, krow = (size_t)KH * D;
  const size_t k_off = (size_t)b * S * krow + (size_t)kh * D;
  stage_bf16<D>(ks, k + k_off, krow, k0, S, tid);
  stage_bf16<D>(vs, v + k_off, krow, k0, S, tid);

  const int k_last = min(k0 + BT, S) - 1;
  const int q_lo = mk.causal ? k0 : 0;
  const int q_hi = mk.window > 0 ? min(S - 1, k_last + mk.window - 1) : S - 1;
  const int kw = k0 + warp * 16;  // this warp's first key

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) dka[dt][e] = dva[dt][e] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t q_off = (size_t)b * S * qrow + (size_t)h * D;
    const float* lb = lse + ((size_t)b * H + h) * S;
    const float* dr = dd + ((size_t)b * H + h) * S;
    for (int q0 = (q_lo / BT) * BT; q0 <= q_hi; q0 += BT) {
      __syncthreads();  // the previous tile's readers are done
      stage_bf16<D>(qs, q + q_off, qrow, q0, S, tid);
      stage_bf16<D>(dos, dout + q_off, qrow, q0, S, tid);
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
      rows_by_rows<D>(dst, vs, warp * 16, dos, lane);
      rows_by_rows<D>(pt, ks, warp * 16, qs, lane);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int kj = kw + lane / 4 + 8 * ((j >> 1) & 1);
        const int c = (j / 4) * 8 + (lane % 4) * 2 + (j & 1);
        p_ds(pt[j], dst[j], lse_s[c], d_s[c], visible(mk, q0 + c, kj), mk, pt[j], dst[j]);
      }
      acc_by_tile<D>(dva, pt, dos, lane);
      acc_by_tile<D>(dka, dst, qs, lane);
    }
  }
  store_rows<D>(dk + k_off, krow, kw, S, dka, lane);
  store_rows<D>(dv + k_off, krow, kw, S, dva, lane);
}

// (c) at widths 16 and 32: one block per (b, head, 64-row query tile), the
// causal grid's longest query tiles first, warp w owns queries q0 + 16 w ..
// + 15; the key tiles its rows can reach, in order
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dd,
                 bf16* __restrict__ dq, int B, int H, int KH, int nq, Mask mk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BT][D + 8]
  bf16* dos = qs + BT * tc_ld(D);                 // [BT][D + 8]
  bf16* ks = dos + BT * tc_ld(D);                 // [BT][D + 8]
  bf16* vs = ks + BT * tc_ld(D);                  // [BT][D + 8]

  const int S = mk.S;
  const int BH = B * H;
  const int rank = blockIdx.x / BH;
  const int bh = blockIdx.x % BH;
  const int qt = mk.causal ? nq - 1 - rank : rank;
  const int h = bh % H;
  const int b = bh / H;
  const int kh = h / (H / KH);
  const int q0 = qt * BT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t qrow = (size_t)H * D, krow = (size_t)KH * D;
  const size_t q_off = (size_t)b * S * qrow + (size_t)h * D;
  const size_t k_off = (size_t)b * S * krow + (size_t)kh * D;
  stage_bf16<D>(qs, q + q_off, qrow, q0, S, tid);
  stage_bf16<D>(dos, dout + q_off, qrow, q0, S, tid);

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

  float dqa[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[dt][e] = 0.f;

  for (int k0 = (k_lo / BT) * BT; k0 <= k_hi; k0 += BT) {
    __syncthreads();  // the previous tile's readers are done
    stage_bf16<D>(ks, k + k_off, krow, k0, S, tid);
    stage_bf16<D>(vs, v + k_off, krow, k0, S, tid);
    cp_async_wait_all();  // this tile (and, the first time, Q and dO)
    __syncthreads();
    if (w0 >= S || (mk.causal && k0 > w0 + 15)) continue;

    float ds[32], dp[32];  // S then dS; dP: [16 queries x 64 keys]
    rows_by_rows<D>(dp, dos, warp * 16, vs, lane);
    rows_by_rows<D>(ds, qs, warp * 16, ks, lane);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = (j >> 1) & 1;
      const int qi = w0 + lane / 4 + 8 * r;
      const int kj = k0 + (j / 4) * 8 + (lane % 4) * 2 + (j & 1);
      float p;
      p_ds(ds[j], dp[j], lse_r[r], d_r[r], visible(mk, qi, kj), mk, p, ds[j]);
    }
    acc_by_tile<D>(dqa, ds, ks, lane);
  }
  store_rows<D>(dq + q_off, qrow, w0, S, dqa, lane);
}

// ---- bf16 at widths 64, 128, 224 (padded to 256), 256 and (192, 128): wgmma ----

// a wgmma shared-memory operand descriptor for a 128-byte-swizzled tile:
// start address, leading and stride byte offsets (16-byte units), layout B128
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// cp.async's writes to shared memory, seen by wgmma's (async proxy) reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d[64 x 64] (+)= A (shared, K-major) * B (shared, K-major)^T; accumulate == 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 64] += a (registers, 64 x 16) * B (shared, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x 128] += a (registers, 64 x 16) * B (shared, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
      "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x N] += a (registers, 64 x 16) * the [16, N] slice at shared address
// t of a 64-row wgmma tile read MN-major (N runs over 64-column atoms 8 KB
// apart, k over 1 KB row groups); n = 192 and 256 as n = 128 and a rest
template <int N>
__device__ __forceinline__ void wgmma_by_tile(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint32_t t) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, wg_desc(t, 64 * 128, 1024));
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, wg_desc(t, 64 * 128, 1024));
  } else {
    static_assert(N == 192 || N == 256, "tile width");
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(d), a, wg_desc(t, 64 * 128, 1024));
    wgmma_by_tile<N - 128>(*reinterpret_cast<float(*)[N / 2 - 64]>(d + 64), a,
                           t + 2 * 64 * 128);
  }
}

// dst[64 x 64] = A (a [64][.] tile, K-major) . B (a [64][.] tile, K-major)^T
// over the first KSTEPS k16 steps of both tiles
template <int KSTEPS>
__device__ __forceinline__ void wgmma_rows_by_rows(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint32_t off = (kk % 4) * 32 + (kk / 4) * 64 * 128;  // 32 B per k16 in an atom
    wgmma_ss_n64(d, wg_desc(a + off, 16, 1024), wg_desc(b + off, 16, 1024), kk > 0);
  }
}

// d[64 x 32] (+)= A (shared, K-major) * B (shared, K-major, 32 rows)^T
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// dst[64 x 32] = A (a [64][.] tile) . B (32 rows of a [64][.] tile, from
// row a multiple of 8)^T over the first KSTEPS k16 steps, both K-major
template <int KSTEPS>
__device__ __forceinline__ void wgmma_rows_by_rows32(float (&d)[16], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint32_t off = (kk % 4) * 32 + (kk / 4) * 64 * 128;
    wgmma_ss_n32(d, wg_desc(a + off, 16, 1024), wg_desc(b + off, 16, 1024), kk > 0);
  }
}

// Byte offset of the 16-byte chunk c of row r in a 64-row tile stored for
// wgmma: rows of 128 bytes (64 bf16) in 128-byte-swizzled atoms of 8 KB, the
// row's 16-byte chunks XOR-ed with r % 8 (what the B128 layout reads); a
// row wider than 64 elements continues in the next atom.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)((c / 8) * 64 * 128 + r * 128 + (((c % 8) ^ (r % 8)) * 16));
}

// Copy rows r0 .. r0 + 63 of a [.., S, N, width] tensor (src at row 0 of the
// head, rows `row` elements apart) into a wgmma tile at dst: CP 16-byte
// chunks a row, of which the first CW hold data and the rest are zero-filled;
// rows past S load zeros. NT threads share the copies.
template <int CP, int CW, int NT>
__device__ __forceinline__ void load_wg_tile(uint32_t dst, const bf16* src, size_t row, int r0,
                                             int S, int tid) {
#pragma unroll 4
  for (int e = tid; e < 64 * CP; e += NT) {
    const int r = e / CP, c = e % CP;
    const bool in = r0 + r < S && c < CW;
    cp_async16(dst + sw128(r, c), src + (in ? (size_t)(r0 + r) * row + c * 8 : 0), in);
  }
}

constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float ex2(float x) {  // 2^x on the SFU
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P and P dx/ds of one score s = q.k (dS = (P dx/ds) (dP - D)), the
// tensor-core kernels' form: P = 2^(x log2 e - lse log2 e), one SFU op,
// and the mask a select, not a branch (an accurate expf under a branch took
// half of the dK/dV kernel's time)
__device__ __forceinline__ void p_pd(float s, float lse, bool vis, const Mask& mk, float& p,
                                     float& pd) {
  float x = s * mk.scale, dx = mk.scale;
  if (mk.softcap > 0.f) {
    const float t = tanhf(x / mk.softcap);
    x = mk.softcap * t;
    dx *= 1.f - t * t;
  }
  const float e = ex2(fmaf(x, LOG2E, -lse * LOG2E));
  p = vis ? e : 0.f;
  pd = p * dx;
}

// Ring stages of the two-warpgroup dK/dV kernel's Q, dO (and lse, D) tiles,
// all W wide: 3 at W = 192, 2 at 256, where K, V and two stages take 194 KB
template <int W>
__host__ __device__ constexpr int dkdv_stages() { return W == 256 ? 2 : 3; }
template <int W>
__host__ __device__ constexpr size_t dkdv_wg_smem() {  // K, V, the ring, lse/D, exchange, alignment
  return (size_t)2 * 64 * W * sizeof(bf16) * (1 + dkdv_stages<W>()) +
         (size_t)2 * 64 * sizeof(float) * dkdv_stages<W>() + (size_t)16 * 128 * sizeof(uint32_t) +
         1024;
}

// (b) on the wgmma route at W = 192 and 256: one 256-thread block per (b,
// KV head, 64-key tile, share of the group's heads), two warpgroups over the
// same 64 keys (warp w of either owns keys k0 + 16 w ..), where one
// warpgroup could not hold both [64 x W] accumulators. Every query tile of
// every head of the share that can see a key of the tile streams through a
// ring of Q, dO, lse and D, filled by cp.async STAGES - 1 tiles ahead. Per
// tile warpgroup w computes S^T = K Q^T and dP^T = V dO^T over its half of
// the tile's queries (32 w ..; m64n32 products), and P^T and dS^T there;
// warpgroup 0, which holds dV, takes the other half's P^T, and warpgroup 1,
// which holds dK, the other half's dS^T, through 8 KB of shared memory in
// bf16 (thread t of either holds the same keys and query offsets). Then
// warpgroup 0 accumulates dV += P^T dO and warpgroup 1 dK += dS^T Q over
// all 64 queries (P^T and dS^T from registers, dO and Q MN-major): each
// product is computed once, and both warpgroups do the same work. Both run
// one instruction stream around the products, their operands chosen by
// address: a branch around a wgmma made the compiler serialize every
// product. So every tile is W wide (256 for 224, and 192 for MLA's q/k 192
// and v 128, V and dO zero-filled past 128) and both score products run
// the k-steps of the wider input. With shares (nsplit > 1, a cluster), the
// first block adds the others' accumulators.
template <int DK, int DV, int W>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkdv_wg(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ dd,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KH, int nk,
                  int nsplit, Mask mk) {
  constexpr int STAGES = dkdv_stages<W>(), AHEAD = STAGES - 1;
  constexpr int TT = 64 * W * (int)sizeof(bf16);  // bytes of one tile
  constexpr int KSTEPS = (DK > DV ? DK : DV) / 16;
  extern __shared__ __align__(16) unsigned char smem_wg[];
  // the B128 swizzle is read from address bits, so tiles start on 1 KB
  const uint32_t raw = smem_u32(smem_wg);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t ks = base, vs = base + TT, ring = base + 2 * TT;  // a stage: Q, then dO
  float* lse_s = reinterpret_cast<float*>(smem_wg + (ring + STAGES * 2 * TT - raw));  // [STAGES][64]
  float* d_s = lse_s + STAGES * 64;  // [STAGES][64]
  uint32_t* xch = reinterpret_cast<uint32_t*>(d_s + STAGES * 64);  // [2][2][4][128]

  const int S = mk.S;
  const int sp = blockIdx.x % nsplit;  // this block's share of the group's heads
  const int kt = blockIdx.x / nsplit % nk;
  const int bkh = blockIdx.x / nsplit / nk;
  const int kh = bkh % KH;
  const int b = bkh / KH;
  const int G = H / KH;
  const int g_lo = sp * G / nsplit, g_hi = (sp + 1) * G / nsplit;
  const int k0 = kt * BT;
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128, warp = t / 32, lane = t % 32;
  const size_t qrow = (size_t)H * DK, orow = (size_t)H * DV;
  const size_t krow = (size_t)KH * DK, vrow = (size_t)KH * DV;
  const size_t k_off = (size_t)b * S * krow + (size_t)kh * DK;
  const size_t v_off = (size_t)b * S * vrow + (size_t)kh * DV;

  // the query tiles of one head that can see a key of this tile
  const int k_last = min(k0 + BT, S) - 1;
  const int q_lo = mk.causal ? k0 : 0;
  const int q_hi = mk.window > 0 ? min(S - 1, k_last + mk.window - 1) : S - 1;
  const int qt_lo = q_lo / BT, nqt = q_hi / BT - qt_lo + 1;
  const int total = (g_hi - g_lo) * nqt;

  // tile i: head kh * G + g_lo + i / nqt, query tile qt_lo + i % nqt, into stage i % STAGES
  auto issue = [&](int i) {
    if (i < total) {
      const int h = kh * G + g_lo + i / nqt, q0 = (qt_lo + i % nqt) * BT;
      const uint32_t st = ring + (uint32_t)(i % STAGES) * 2 * TT;
      load_wg_tile<W / 8, DK / 8, 256>(st, q + (size_t)b * S * qrow + (size_t)h * DK, qrow, q0,
                                       S, tid);
      load_wg_tile<W / 8, DV / 8, 256>(st + TT, dout + (size_t)b * S * orow + (size_t)h * DV,
                                       orow, q0, S, tid);
      const size_t row = ((size_t)b * H + h) * S;
      if (tid < 128) {
        const int r = tid % 64;
        const bool in = q0 + r < S;
        const float* src = (tid < 64 ? lse : dd) + row + (in ? q0 + r : 0);
        float* dst = (tid < 64 ? lse_s : d_s) + (i % STAGES) * 64 + r;
        cp_async4(smem_u32(dst), src, in);
      }
    }
    cp_async_commit();
  };
  load_wg_tile<W / 8, DK / 8, 256>(ks, k + k_off, krow, k0, S, tid);  // with tile 0's group
  load_wg_tile<W / 8, DV / 8, 256>(vs, v + v_off, vrow, k0, S, tid);
#pragma unroll
  for (int i = 0; i < AHEAD; ++i) issue(i);

  float acc[W / 2];  // warpgroup 0: dV; 1: dK, [64 x W]
#pragma unroll
  for (int j = 0; j < W / 2; ++j) acc[j] = 0.f;
  const int key0 = 16 * warp + lane / 4;  // this thread's keys: key0 and key0 + 8 of the tile

  for (int i = 0; i < total; ++i) {
    cp_async_wait<AHEAD - 1>();
    fence_async_shared();  // copies -> wgmma
    __syncthreads();  // tile i is in; tile i - 1's readers are done
    issue(i + AHEAD);  // into tile i - 1's stage
    const int st = i % STAGES;
    const uint32_t qst = ring + (uint32_t)st * 2 * TT, dost = qst + TT;
    const int q0 = (qt_lo + i % nqt) * BT;
    // warpgroup w: S^T and dP^T over its half of the tile's queries, q0 +
    // 32 w .. + 31, then P^T and dS^T there
    float sc[16], dp[16];
    const uint32_t half = (uint32_t)wg * 32 * 128;  // query row 32 w of the Q and dO tiles
    wg_fence();
    wgmma_rows_by_rows32<KSTEPS>(sc, ks, qst + half);
    wgmma_rows_by_rows32<KSTEPS>(dp, vs, dost + half);
    wg_commit();
    wg_wait<0>();
    const bool edge = q0 + BT > S || k0 + BT > S || (mk.causal && k0 + BT - 1 > q0) ||
                      !mk.causal || mk.window > 0;
    if (edge) {
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int r = key0 + 8 * ((x >> 1) & 1);
        const int c = 32 * wg + (x / 4) * 8 + (lane % 4) * 2 + (x & 1);
        float pd;
        p_pd(sc[x], lse_s[st * 64 + c], visible(mk, q0 + c, k0 + r), mk, sc[x], pd);
        dp[x] = pd * (dp[x] - d_s[st * 64 + c]);
      }
    } else {
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int c = 32 * wg + (x / 4) * 8 + (lane % 4) * 2 + (x & 1);
        float pd;
        p_pd(sc[x], lse_s[st * 64 + c], true, mk, sc[x], pd);
        dp[x] = pd * (dp[x] - d_s[st * 64 + c]);
      }
    }
    // P^T and dS^T in bf16, the A operand of 16 queries a k-step; warpgroup
    // 0 (dV) takes the other half's P^T, 1 (dK) the other half's dS^T,
    // through shared memory (thread t of either holds the same keys and
    // query offsets)
    uint32_t own[2][4], give[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const uint32_t pp = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
        const uint32_t pds = pack_bf16(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
        own[kk][x] = wg ? pds : pp;
        give[kk][x] = wg ? pp : pds;
        xch[((wg * 2 + kk) * 4 + x) * 128 + t] = give[kk][x];
      }
    __syncthreads();
    uint32_t pk[BT / 16][4];  // queries 0-31 in k-steps 0, 1; 32-63 in 2, 3
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const uint32_t other = xch[(((1 - wg) * 2 + kk) * 4 + x) * 128 + t];
        pk[kk][x] = wg ? other : own[kk][x];
        pk[2 + kk][x] = wg ? own[kk][x] : other;
      }
    const uint32_t b_acc = wg ? qst : dost;  // dV += P^T dO, dK += dS^T Q
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) wgmma_by_tile<W>(acc, pk[kk], b_acc + kk * 16 * 128);
    wg_commit();
    wg_wait<0>();
  }

  if (nsplit > 1) {
    // the cluster's blocks hold shares of the same rows: the first block adds
    // the others' accumulators, read from their shared memory, in rank order
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    float* xs = reinterpret_cast<float*>(smem_wg + (ring - raw));  // the ring is free now
    __syncthreads();
#pragma unroll
    for (int j = 0; j < W / 2; ++j) xs[j * 256 + tid] = acc[j];
    cluster.sync();
    if (sp == 0)
      for (int rk = 1; rk < nsplit; ++rk) {
        const float* other = cluster.map_shared_rank(xs, rk);
#pragma unroll
        for (int j = 0; j < W / 2; ++j) acc[j] += other[j * 256 + tid];
      }
    cluster.sync();  // the others' shares stay until they are read
    if (sp != 0) return;
  }

  // warpgroup 0 writes dV, 1 dK: rows k0 + key0 (+ 8), the stored columns
  const int DW = wg == 0 ? DV : DK;
  bf16* out = wg == 0 ? dv + v_off : dk + k_off;
  const size_t orow_out = wg == 0 ? vrow : krow;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + key0 + 8 * r;
    if (kj >= S) continue;
    bf16* o = out + (size_t)kj * orow_out + (lane % 4) * 2;
#pragma unroll
    for (int dt = 0; dt < W / 8; ++dt)
      if (dt * 8 < DW)
        *reinterpret_cast<__nv_bfloat162*>(o + dt * 8) =
            __floats2bfloat162_rn(acc[4 * dt + 2 * r], acc[4 * dt + 2 * r + 1]);
  }
}

// The single-warpgroup dK/dV kernel's shared memory: K, V, two ring stages of
// Q and dO (and lse, D), alignment
template <int W>
__host__ __device__ constexpr size_t dkdv1_smem() {
  return (size_t)2 * 64 * W * sizeof(bf16) * 3 + (size_t)2 * 2 * 64 * sizeof(float) + 1024;
}

// (b) on the wgmma route at W = 64 and 128: one 128-thread block (one
// warpgroup) per (b, KV head, 64-key tile, share of the group's heads),
// holding both dV and dK [64 x W] in registers (144 registers a thread at
// W = 64, three blocks an SM; 224 at 128, two): more independent chains a
// card than two warpgroups in step, and no barrier inside a tile. Per tile:
// S^T = K Q^T and dP^T = V dO^T, P^T and dS^T, dV += P^T dO, dK += dS^T Q.
// The ring, the mask, GQA's cluster shares and the order of every sum are
// those of flash_bwd_dkdv_wg.
template <int DK, int DV, int W>
__global__ void __launch_bounds__(128, W == 64 ? 3 : 2)
flash_bwd_dkdv_wg1(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ dd,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KH, int nk,
                   int nsplit, Mask mk) {
  constexpr int STAGES = 2, AHEAD = 1;
  constexpr int TT = 64 * W * (int)sizeof(bf16);  // bytes of one tile
  constexpr int KSTEPS = (DK > DV ? DK : DV) / 16;
  extern __shared__ __align__(16) unsigned char smem_wg[];
  const uint32_t raw = smem_u32(smem_wg);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t ks = base, vs = base + TT, ring = base + 2 * TT;  // a stage: Q, then dO
  float* lse_s = reinterpret_cast<float*>(smem_wg + (ring + STAGES * 2 * TT - raw));
  float* d_s = lse_s + STAGES * 64;

  const int S = mk.S;
  const int sp = blockIdx.x % nsplit;
  const int kt = blockIdx.x / nsplit % nk;
  const int bkh = blockIdx.x / nsplit / nk;
  const int kh = bkh % KH;
  const int b = bkh / KH;
  const int G = H / KH;
  const int g_lo = sp * G / nsplit, g_hi = (sp + 1) * G / nsplit;
  const int k0 = kt * BT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t qrow = (size_t)H * DK, orow = (size_t)H * DV;
  const size_t krow = (size_t)KH * DK, vrow = (size_t)KH * DV;
  const size_t k_off = (size_t)b * S * krow + (size_t)kh * DK;
  const size_t v_off = (size_t)b * S * vrow + (size_t)kh * DV;

  const int k_last = min(k0 + BT, S) - 1;
  const int q_lo = mk.causal ? k0 : 0;
  const int q_hi = mk.window > 0 ? min(S - 1, k_last + mk.window - 1) : S - 1;
  const int qt_lo = q_lo / BT, nqt = q_hi / BT - qt_lo + 1;
  const int total = (g_hi - g_lo) * nqt;

  auto issue = [&](int i) {
    if (i < total) {
      const int h = kh * G + g_lo + i / nqt, q0 = (qt_lo + i % nqt) * BT;
      const uint32_t st = ring + (uint32_t)(i % STAGES) * 2 * TT;
      load_wg_tile<W / 8, DK / 8, 128>(st, q + (size_t)b * S * qrow + (size_t)h * DK, qrow, q0,
                                       S, tid);
      load_wg_tile<W / 8, DV / 8, 128>(st + TT, dout + (size_t)b * S * orow + (size_t)h * DV,
                                       orow, q0, S, tid);
      const int r = tid % 64;
      const bool in = q0 + r < S;
      const float* src = (tid < 64 ? lse : dd) + ((size_t)b * H + h) * S + (in ? q0 + r : 0);
      cp_async4(smem_u32((tid < 64 ? lse_s : d_s) + (i % STAGES) * 64 + r), src, in);
    }
    cp_async_commit();
  };
  load_wg_tile<W / 8, DK / 8, 128>(ks, k + k_off, krow, k0, S, tid);  // with tile 0's group
  load_wg_tile<W / 8, DV / 8, 128>(vs, v + v_off, vrow, k0, S, tid);
  issue(0);

  float dva[W / 2], dka[W / 2];
#pragma unroll
  for (int j = 0; j < W / 2; ++j) dva[j] = dka[j] = 0.f;
  const int key0 = 16 * warp + lane / 4;  // this thread's keys: key0 and key0 + 8 of the tile

  for (int i = 0; i < total; ++i) {
    cp_async_wait<AHEAD - 1>();
    fence_async_shared();
    __syncthreads();  // tile i is in; tile i - 1's readers are done
    issue(i + AHEAD);
    const int st = i % STAGES;
    const uint32_t qst = ring + (uint32_t)st * 2 * TT, dost = qst + TT;
    const int q0 = (qt_lo + i % nqt) * BT;
    float sc[32], dp[32];  // S^T then P^T; dP^T then dS^T
    wg_fence();
    wgmma_rows_by_rows<KSTEPS>(sc, ks, qst);
    wgmma_rows_by_rows<KSTEPS>(dp, vs, dost);
    wg_commit();
    wg_wait<0>();
    const bool edge = q0 + BT > S || k0 + BT > S || (mk.causal && k0 + BT - 1 > q0) ||
                      !mk.causal || mk.window > 0;
    if (edge) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int r = key0 + 8 * ((x >> 1) & 1), c = (x / 4) * 8 + (lane % 4) * 2 + (x & 1);
        float p, pd;
        p_pd(sc[x], lse_s[st * 64 + c], visible(mk, q0 + c, k0 + r), mk, p, pd);
        dp[x] = pd * (dp[x] - d_s[st * 64 + c]);
        sc[x] = p;
      }
    } else {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int c = (x / 4) * 8 + (lane % 4) * 2 + (x & 1);
        float p, pd;
        p_pd(sc[x], lse_s[st * 64 + c], true, mk, p, pd);
        dp[x] = pd * (dp[x] - d_s[st * 64 + c]);
        sc[x] = p;
      }
    }
    uint32_t pk[BT / 16][4], dk_a[BT / 16][4];  // P^T and dS^T in bf16: the A operands
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        pk[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
        dk_a[kk][x] = pack_bf16(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
      }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) wgmma_by_tile<W>(dva, pk[kk], dost + kk * 16 * 128);
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) wgmma_by_tile<W>(dka, dk_a[kk], qst + kk * 16 * 128);
    wg_commit();
    wg_wait<0>();
  }

  if (nsplit > 1) {  // the cluster's first block adds the others' shares in rank order
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    float* xs = reinterpret_cast<float*>(smem_wg + (ring - raw));  // the ring is free now
    __syncthreads();
#pragma unroll
    for (int j = 0; j < W / 2; ++j) {
      xs[j * 128 + tid] = dva[j];
      xs[(W / 2 + j) * 128 + tid] = dka[j];
    }
    cluster.sync();
    if (sp == 0)
      for (int rk = 1; rk < nsplit; ++rk) {
        const float* other = cluster.map_shared_rank(xs, rk);
#pragma unroll
        for (int j = 0; j < W / 2; ++j) {
          dva[j] += other[j * 128 + tid];
          dka[j] += other[(W / 2 + j) * 128 + tid];
        }
      }
    cluster.sync();
    if (sp != 0) return;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + key0 + 8 * r;
    if (kj >= S) continue;
    bf16* ov = dv + v_off + (size_t)kj * vrow + (lane % 4) * 2;
    bf16* ok = dk + k_off + (size_t)kj * krow + (lane % 4) * 2;
#pragma unroll
    for (int dt = 0; dt < W / 8; ++dt) {
      if (dt * 8 < DV)
        *reinterpret_cast<__nv_bfloat162*>(ov + dt * 8) =
            __floats2bfloat162_rn(dva[4 * dt + 2 * r], dva[4 * dt + 2 * r + 1]);
      if (dt * 8 < DK)
        *reinterpret_cast<__nv_bfloat162*>(ok + dt * 8) =
            __floats2bfloat162_rn(dka[4 * dt + 2 * r], dka[4 * dt + 2 * r + 1]);
    }
  }
}

// Ring stages of the dQ kernel's K and V tiles: 3 at 64 + 64 columns, else 2
template <int DKP, int DVP>
__host__ __device__ constexpr int dq_stages() { return DKP + DVP <= 128 ? 3 : 2; }
template <int DKP, int DVP>
__host__ __device__ constexpr size_t dq_wg_smem() {  // Q, dO, the K/V ring, alignment
  return (size_t)64 * (DKP + DVP) * sizeof(bf16) * (1 + dq_stages<DKP, DVP>()) + 1024;
}

// (c) on the wgmma route: one 128-thread block (a warpgroup) per (b, head,
// 64-row query tile), the causal grid's longest query tiles first; warp w
// owns queries q0 + 16 w ... The key tiles its rows can reach stream through
// a ring of K and V filled by cp.async STAGES - 1 tiles ahead. Per tile:
// S = Q K^T and dP = dO V^T (wgmma, all four tiles K-major), dS = P dx/ds
// (dP - D), dQ += dS K (dS from registers, K MN-major).
template <int DK, int DKP, int DV, int DVP>
__global__ void __launch_bounds__(128)
flash_bwd_dq_wg(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dd,
                bf16* __restrict__ dq, int B, int H, int KH, int nq, Mask mk) {
  constexpr int STAGES = dq_stages<DKP, DVP>(), AHEAD = STAGES - 1;
  constexpr int TK = 64 * DKP * (int)sizeof(bf16), TV = 64 * DVP * (int)sizeof(bf16);
  extern __shared__ __align__(16) unsigned char smem_wg[];
  const uint32_t base = (smem_u32(smem_wg) + 1023u) & ~1023u;
  const uint32_t qs = base, dos = base + TK, ring = base + TK + TV;  // a stage: K, then V

  const int S = mk.S;
  const int BH = B * H;
  const int rank = blockIdx.x / BH;  // causal: the longest query tiles first
  const int bh = blockIdx.x % BH;
  const int qt = mk.causal ? nq - 1 - rank : rank;
  const int h = bh % H;
  const int b = bh / H;
  const int kh = h / (H / KH);
  const int q0 = qt * BT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t qrow = (size_t)H * DK, orow = (size_t)H * DV;
  const size_t krow = (size_t)KH * DK, vrow = (size_t)KH * DV;
  const bf16* kb = k + (size_t)b * S * krow + (size_t)kh * DK;
  const bf16* vb = v + (size_t)b * S * vrow + (size_t)kh * DV;

  const int q_last = min(q0 + BT, S) - 1;
  const int k_hi = mk.causal ? q_last : S - 1;
  const int k_lo = mk.window > 0 ? max(0, q0 - mk.window + 1) : 0;
  const int t_lo = k_lo / BT, ntiles = k_hi / BT - t_lo + 1;

  auto issue = [&](int i) {  // key tile t_lo + i into stage i % STAGES
    if (i < ntiles) {
      const uint32_t st = ring + (uint32_t)(i % STAGES) * (TK + TV);
      load_wg_tile<DKP / 8, DK / 8, 128>(st, kb, krow, (t_lo + i) * BT, S, tid);
      load_wg_tile<DVP / 8, DV / 8, 128>(st + TK, vb, vrow, (t_lo + i) * BT, S, tid);
    }
    cp_async_commit();
  };
  load_wg_tile<DKP / 8, DK / 8, 128>(qs, q + (size_t)b * S * qrow + (size_t)h * DK, qrow, q0,
                                     S, tid);  // with the first K/V tile's group
  load_wg_tile<DVP / 8, DV / 8, 128>(dos, dout + (size_t)b * S * orow + (size_t)h * DV, orow, q0,
                                     S, tid);
#pragma unroll
  for (int i = 0; i < AHEAD; ++i) issue(i);

  const int w0 = q0 + warp * 16;  // this warp's first query
  float lse_r[2], d_r[2];         // this thread's rows: w0 + lane / 4 (+ 8)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = w0 + lane / 4 + 8 * r;
    lse_r[r] = qi < S ? lse[((size_t)b * H + h) * S + qi] : 0.f;
    d_r[r] = qi < S ? dd[((size_t)b * H + h) * S + qi] : 0.f;
  }
  float dqa[DKP / 2];
#pragma unroll
  for (int j = 0; j < DKP / 2; ++j) dqa[j] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<AHEAD - 1>();
    fence_async_shared();
    __syncthreads();  // tile i is in; tile i - 1's readers are done
    issue(i + AHEAD);
    const uint32_t kst = ring + (uint32_t)(i % STAGES) * (TK + TV), vst = kst + TK;
    const int k0 = (t_lo + i) * BT;
    float sc[32], dp[32];  // S, then P dx/ds, then dS; dP: [16 queries x 64 keys] a warp
    wg_fence();
    wgmma_rows_by_rows<DK / 16>(sc, qs, kst);
    wg_commit();
    wgmma_rows_by_rows<DV / 16>(dp, dos, vst);
    wg_commit();
    wg_wait<1>();  // S is in: P while dP is on the tensor cores
    // the mask only where the tile crosses S, the causal diagonal or the window
    const bool edge = q0 + BT > S || k0 + BT > S || (mk.causal && k0 + BT - 1 > q0) ||
                      !mk.causal || mk.window > 0;
    if (edge) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int r = (x >> 1) & 1;
        const int qi = w0 + lane / 4 + 8 * r;
        const int kj = k0 + (x / 4) * 8 + (lane % 4) * 2 + (x & 1);
        float p;
        p_pd(sc[x], lse_r[r], visible(mk, qi, kj), mk, p, sc[x]);
      }
    } else {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        float p;
        p_pd(sc[x], lse_r[(x >> 1) & 1], true, mk, p, sc[x]);
      }
    }
    wg_wait<0>();
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] *= dp[x] - d_r[(x >> 1) & 1];
    uint32_t dsk[BT / 16][4];
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        dsk[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) wgmma_by_tile<DKP>(dqa, dsk[kk], kst + kk * 16 * 128);
    wg_commit();
    wg_wait<0>();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = w0 + lane / 4 + 8 * r;
    if (qi >= S) continue;
    bf16* o = dq + ((size_t)b * S + qi) * qrow + (size_t)h * DK + (lane % 4) * 2;
#pragma unroll
    for (int dt = 0; dt < DK / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(o + dt * 8) =
          __floats2bfloat162_rn(dqa[4 * dt + 2 * r], dqa[4 * dt + 2 * r + 1]);
  }
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

// Blocks the dK/dV kernel should give at least: two for each of the card's 132 SMs
constexpr int MIN_DKDV_BLOCKS = 264;

// Blocks (a cluster) that share one (b, KV head, key tile) on the wgmma
// route: where the grid is short of MIN_DKDV_BLOCKS and a KV head serves
// G > 1 query heads (GQA), the heads are split over up to min(G, 8) blocks
int dkdv_splits(int B, int S, int H, int KH) {
  const int G = H / KH, blocks = B * KH * ((S + BT - 1) / BT);
  const int want = (MIN_DKDV_BLOCKS + blocks - 1) / blocks;
  return G < 2 ? 1 : want < G ? (want < 8 ? want : 8) : (G < 8 ? G : 8);
}

// Launch a wgmma dK/dV kernel over grid x nsplit blocks of `threads`, each
// cluster of nsplit blocks sharing a (b, KV head, key tile)
template <typename F>
int launch_cluster(F* kern, size_t smem, int threads, unsigned grid, int nsplit, const Args& a,
                   int nk, cudaStream_t st, bool& done) {
  if (int err = allow_smem(kern, smem, done)) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid * (unsigned)nsplit);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, static_cast<const bf16*>(a.q),
                                 static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
                                 static_cast<const bf16*>(a.dout), a.lse, a.dd,
                                 static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H, a.KH,
                                 nk, nsplit, a.mk);
}

template <typename T, int DK, int DV>
int launch_dkdv(const Args& a, cudaStream_t st) {
  static bool done = false;
  if constexpr (sizeof(T) == 2) {
    const int nk = (a.mk.S + BT - 1) / BT;
    const unsigned grid = (unsigned)a.B * (unsigned)a.KH * (unsigned)nk;
    if constexpr (DK >= 64) {
      constexpr int W = (cmax(DK, DV) + 63) / 64 * 64;  // 224 -> 256; (192, 128) -> 192
      const int nsplit = dkdv_splits(a.B, a.mk.S, a.H, a.KH);
      if constexpr (W <= 128)
        return launch_cluster(flash_bwd_dkdv_wg1<DK, DV, W>, dkdv1_smem<W>(), 128, grid, nsplit,
                              a, nk, st, done);
      else
        return launch_cluster(flash_bwd_dkdv_wg<DK, DV, W>, dkdv_wg_smem<W>(), 256, grid, nsplit,
                              a, nk, st, done);
    } else {
      static_assert(DK == DV, "mma.sync takes one head width");
      const size_t smem = tc_smem<DK, DV>();
      if (int err = allow_smem(flash_bwd_dkdv_mma<DK>, smem, done)) return err;
      flash_bwd_dkdv_mma<DK><<<grid, TC_THREADS, smem, st>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
          static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.dd,
          static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H, a.KH, nk, a.mk);
    }
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
    const unsigned grid = (unsigned)a.B * (unsigned)a.H * (unsigned)nq;
    if constexpr (DK >= 64) {
      constexpr int DKP = (DK + 63) / 64 * 64, DVP = (DV + 63) / 64 * 64;
      const size_t smem = dq_wg_smem<DKP, DVP>();
      if (int err = allow_smem(flash_bwd_dq_wg<DK, DKP, DV, DVP>, smem, done)) return err;
      flash_bwd_dq_wg<DK, DKP, DV, DVP><<<grid, 128, smem, st>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
          static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.dd,
          static_cast<bf16*>(a.dq), a.B, a.H, a.KH, nq, a.mk);
    } else {
      const size_t smem = tc_smem<DK, DV>();
      if (int err = allow_smem(flash_bwd_dq_mma<DK>, smem, done)) return err;
      flash_bwd_dq_mma<DK><<<grid, TC_THREADS, smem, st>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
          static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.dd,
          static_cast<bf16*>(a.dq), a.B, a.H, a.KH, nq, a.mk);
    }
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
  if (dtype == 0) {
    const unsigned grid = (unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32));
    flash_bwd_dot<<<grid, THREADS, 0, st>>>(static_cast<const float*>(o),
                                            static_cast<const float*>(dout),
                                            static_cast<float*>(dd), S, H, Dv, rows);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const bf16* ob = static_cast<const bf16*>(o);
  const bf16* db = static_cast<const bf16*>(dout);
  float* d = static_cast<float*>(dd);
  switch (Dv) {  // the value widths the kernels take
    case 16: return launch_dot_vec<16>(ob, db, d, S, H, rows, st);
    case 32: return launch_dot_vec<32>(ob, db, d, S, H, rows, st);
    case 64: return launch_dot_vec<64>(ob, db, d, S, H, rows, st);
    case 128: return launch_dot_vec<128>(ob, db, d, S, H, rows, st);
    case 224: return launch_dot_vec<224>(ob, db, d, S, H, rows, st);
    case 256: return launch_dot_vec<256>(ob, db, d, S, H, rows, st);
    default: return (int)cudaErrorInvalidValue;
  }
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
