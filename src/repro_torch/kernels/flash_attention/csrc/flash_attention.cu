// Prefill attention (FlashAttention-style online softmax) for one H100.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// :: flash_attention_kernel (body _flash_kernel). q [B, S, H, Dh] attends to
// k [B, S, KH, Dh] and v [B, S, KH, Dv] (query head h reads KV head h / G,
// G = H / KH) under an optional causal mask, an optional sliding window (key >
// query - window) and an optional tanh logit softcap; o [B, S, H, Dv] has q's
// dtype. Dv = Dh at every head width, or (Dh, Dv) = (192, 128): DeepSeek-V3's
// MLA prefill, whose keys are 128 latent-expanded columns and 64 rope columns
// and whose values are 128 wide (the reference's mha takes v's width apart
// from q's). Scores,
// the running max m, the running sum l and the output accumulator are
// float32. The sentinel is NEG = -2.3e38 and the output is
// acc / max(l, 1e-30), so a row with no valid key gives zeros, as on the TPU.
// The ragged edge is masked here: rows and keys past S load as zeros, keys
// past S score NEG and rows past S are not written, so S need not be a
// multiple of the tile (the TPU wrapper asserts it is). Only the K/V tiles
// that a row of the query tile can reach are loaded: up to the causal bound
// and from the window's lower bound (the TPU kernel skips only their compute).
//
// Which kernel serves which dtype, and why:
//   - bfloat16 (the engines' dtype), Dh = 64, 128 or 256 -> flash_fwd_wgmma,
//     on Hopper's warpgroup tensor-core products.
//   - bfloat16, Dh = 224 (zamba2's shared attention) -> flash_fwd_wgmma with
//     its tiles padded to 256: 224 is 3.5 of the 128-byte swizzle atoms the
//     wgmma tiles are built from, so the last atom's upper half is zero-filled
//     by the cp.async copies (source size 0); QK^T runs the 14 k-steps that
//     hold data, PV writes 256 columns and the 32 past 224 are not stored.
//     Padding was chosen over flash_fwd_mma at this width by timing both
//     (PERF.md, Findings).
//   - bfloat16, Dh = 16 or 32 -> flash_fwd_mma, on mma.sync (a 16- or
//     32-wide row is narrower than the 128-byte swizzle atom the wgmma
//     kernel's tiles are built from; no model on the port's paths has it
//     but the smoke configurations).
//   - bfloat16, (Dh, Dv) = (192, 128) -> flash_fwd_wgmma with 192-wide Q and K
//     tiles (exactly three 64-column swizzle atoms, no padding; QK^T runs 12
//     k-steps) and 128-wide V tiles (PV at n = 128, as at Dh 128): 3 stages
//     of K and V and the Q tile take 145 KB, one block an SM. Its K and V
//     copies are mapped apart, since a 24-chunk row does not divide the 128
//     threads.
//   - float32 -> flash_fwd_f32, scalar FP32 FMAs. Every tensor-core route
//     rounds float32 inputs (TF32 keeps ~3 decimal digits), and the float32
//     callers (the models' parity checks) hold the port to 2e-5 and 1e-3.
//
// Bound on an H100. At long S the work is 4*B*H*S*S*Dh/2 FLOP (causal), far
// above the bytes, so it is bound by operations; at the engine's prompt
// lengths (S = 32, H = 16, Dh = 64) it is a few microseconds of work and the
// launch and the latency of one tile dominate.
//
// The bfloat16 kernels, FlashAttention's design:
//   - One 128-thread block (a warpgroup) per (b, h, 64-row query tile); each
//     warp owns 16 query rows. Causal grids are scheduled longest query
//     tiles first. The query heads of one KV head read the same K/V rows (no
//     copies).
//   - K/V tiles of 64 keys stream through a ring in shared memory, filled by
//     16-byte cp.async copies (the zero-fill form past S) while earlier tiles
//     are computed: 4 stages, two tiles ahead, in flash_fwd_wgmma; 2 stages
//     in flash_fwd_mma.
//   - flash_fwd_wgmma: QK^T is wgmma m64n64k16 with Q and K in 128-byte-
//     swizzled shared memory (K-major), Dh / 16 k-steps; PV is wgmma
//     m64nDhk16 with P from registers and V read MN-major through the
//     transpose bit (m64n256 as two m64n128 halves). Step i issues QK^T of
//     tile i and PV of tile i - 1 together and runs tile i's softmax while PV
//     is on the tensor cores. At Dh 256 a thread holds the 128 floats of the
//     output fragment, 32 scores and 16 words of P: 3 ring stages of 64 KB
//     and the Q tile take 225 KB, one block an SM.
//   - flash_fwd_mma: mma.sync m16n8k16 with Q's fragments in registers, K
//     and V (transposed) read by ldmatrix from rows padded by 16 bytes, an
//     odd number of 16-byte units, so the reads are free of bank conflicts.
//   - Softmax (softmax_step, shared) on the accumulator fragment in
//     registers: a row sits in 4 lanes, so its max takes 2 shuffles (the sum
//     is reduced once, at the end). Scale, then softcap, then the masks,
//     which apply only on tiles that cross the causal, window or S boundary.
//     P is rounded to bf16 in registers and is the A operand of PV directly
//     (the score accumulator's layout is the A fragment's). The [64, Dh]
//     output accumulator stays in float32 registers.
//   - A stated departure from the reference: the Pallas kernel keeps P in
//     float32 for PV (src/repro/kernels/flash_attention/kernel.py:58-60,
//     82-84); these kernels round P to bf16 for the tensor cores, as
//     FlashAttention does. l sums the float32 P. The bf16 tolerance against
//     the plain version stays 2e-2.
//
// flash_fwd_f32: one 256-thread block per (b, h, 64-row query tile) walking
// the K/V tiles staged through shared memory; four threads share a query row
// (keys c, c+4, ...; output dims c, c+4, ...) and reduce by shuffles. At
// Dh 224 and 256 its tiles take 189 and 214 KB of shared memory, at
// (192, 128) 145 KB: one block an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per K/V tile
constexpr int TPR = 4;            // threads per query row
constexpr int THREADS = BQ * TPR;  // 256
constexpr int KPT = BK / TPR;     // keys scored per thread per tile
constexpr float NEG = -2.3e38f;
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <int DH, int DV>
constexpr size_t smem_bytes() {
  return (size_t)((BQ + BK) * (DH + 1) + BK * (DV + 1) + BQ * (BK + 1)) * sizeof(float);
}

// DH is q's and k's head width, DV v's and o's
template <int DH, int DV>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int S, int H, int KH, int nq, int causal, int window, float softcap,
              float scale) {
  constexpr int LD = DH + 1;
  constexpr int LDV = DV + 1;
  constexpr int DPT = DV / TPR;  // output dims per thread
  extern __shared__ float smem[];
  float* qs = smem;              // [BQ][LD]
  float* ks = qs + BQ * LD;      // [BK][LD]
  float* vs = ks + BK * LD;      // [BK][LDV]
  float* ps = vs + BK * LDV;     // [BQ][BK + 1]

  const int qt = blockIdx.x % nq;
  const int bh = blockIdx.x / nq;
  const int h = bh % H;
  const int b = bh / H;
  const int kh = h / (H / KH);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int c = tid % TPR;
  const int qi = q0 + r;
  const size_t qrow = (size_t)H * DH;
  const size_t krow = (size_t)KH * DH;
  const size_t vrow = (size_t)KH * DV;
  const size_t orow = (size_t)H * DV;
  const float* qb = q + (size_t)b * S * qrow + (size_t)h * DH;
  const float* kb = k + (size_t)b * S * krow + (size_t)kh * DH;
  const float* vb = v + (size_t)b * S * vrow + (size_t)kh * DV;

  for (int e = tid; e < BQ * DH; e += THREADS) {
    const int rr = e / DH, d = e % DH;
    qs[rr * LD + d] = q0 + rr < S ? qb[(size_t)(q0 + rr) * qrow + d] : 0.f;
  }

  // the keys any row of this tile can reach
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_hi = causal ? q_last : S - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  float m = NEG, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int k0 = (k_lo / BK) * BK; k0 <= k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * DH; e += THREADS) {
      const int rr = e / DH, d = e % DH;
      ks[rr * LD + d] = k0 + rr < S ? kb[(size_t)(k0 + rr) * krow + d] : 0.f;
    }
    for (int e = tid; e < BK * DV; e += THREADS) {
      const int rr = e / DV, d = e % DV;
      vs[rr * LDV + d] = k0 + rr < S ? vb[(size_t)(k0 + rr) * vrow + d] : 0.f;
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float qd = qs[r * LD + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[j] = fmaf(qd, ks[(c + TPR * j) * LD + d], s[j]);
    }

    float mt = NEG;
    unsigned ok = 0;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kj = k0 + c + TPR * j;
      float x = s[j] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      bool valid = kj < S;
      if (causal) valid = valid && kj <= qi;
      if (window > 0) valid = valid && kj > qi - window;
      s[j] = valid ? x : NEG;
      ok |= (valid ? 1u : 0u) << j;
      mt = fmaxf(mt, s[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float p = (ok >> j) & 1u ? expf(s[j] - m_new) : 0.f;
      ps[r * (BK + 1) + c + TPR * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m - m_new);
    l = alpha * l + psum;
    m = m_new;
    __syncwarp();  // a row's four threads (one warp) wrote its p
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float p = ps[r * (BK + 1) + j];
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, vs[j * LDV + c + TPR * i], acc[i]);
    }
  }

  if (qi < S) {
    const float denom = fmaxf(l, 1e-30f);
    float* ob = o + (size_t)b * S * orow + (size_t)qi * orow + (size_t)h * DV;
#pragma unroll
    for (int i = 0; i < DPT; ++i) ob[c + TPR * i] = acc[i] / denom;
    if (lse != nullptr && c == 0)
      lse[((size_t)b * H + h) * S + qi] = l > 0.f ? m + logf(l) : neg_inf();
  }
}

// ---- bf16: the tensor-core kernels' common parts, and mma.sync at Dh = 16 and 32 ----

constexpr int TC_BK = 64;        // keys per K/V tile
constexpr int TC_THREADS = 128;  // four warps
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

constexpr int TC_BQ = 64;        // query rows per block, 16 per warp
// padded row (bf16): an odd number of 16-byte units
__host__ __device__ constexpr int tc_ld(int dh) { return dh + 8; }

template <int DH>
constexpr size_t tc_smem_bytes() {  // Q tile + two stages of K and V
  return (size_t)(TC_BQ + 4 * TC_BK) * tc_ld(DH) * sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid == false the destination is zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

__device__ __forceinline__ float ex2(float x) {  // 2^x on the SFU
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// What masks a score tile: the sequence length, causality, the window; and
// the scales, in log2 units (scores are kept as x * log2 e, so that 2^x is
// one SFU op).
struct Mask {
  int S, causal, window;
  float softcap, qk_scale, cap_scale;
};

// One online-softmax step on a warp's 16 x 64 score fragment, the layout of
// both mma.sync's and wgmma's accumulators: s[4 j + e] holds row
// w0 + lane / 4 + 8 (e / 2), key k0 + 8 j + 2 (lane % 4) + e % 2; a row sits
// in 4 lanes, so its max takes 2 shuffles. Scale, then softcap, then the
// masks, which apply only on tiles that cross S, the causal diagonal or the
// window; a plain tile (no mask, no softcap) takes the max of the raw scores
// and scales them inside the exponent. Leaves p in s, updates m and this
// thread's share of l (the row sum is reduced once, at the end), and returns
// each row's rescale of the output in alpha.
__device__ __forceinline__ void softmax_step(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, int w0, int lane,
                                             const Mask& mk) {
  const bool edge = k0 + TC_BK > mk.S || (mk.causal && k0 + TC_BK - 1 > w0) ||
                    (mk.window > 0 && k0 <= w0 + 15 - mk.window);
  const bool plain = !edge && mk.softcap == 0.f;
  float mx[2] = {NEG, NEG};
  if (plain) {  // qk_scale > 0 keeps the raw scores' order
#pragma unroll
    for (int j = 0; j < 32; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
    mx[0] *= mk.qk_scale;
    mx[1] *= mk.qk_scale;
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float x = s[j] * mk.qk_scale;
      if (mk.softcap > 0.f) x = mk.cap_scale * tanhf(x / mk.softcap);
      if (edge) {
        const int kj = k0 + (j / 4) * 8 + (lane % 4) * 2 + (j & 1);
        const int qi = w0 + lane / 4 + ((j >> 1) & 1) * 8;
        bool valid = kj < mk.S;
        if (mk.causal) valid = valid && kj <= qi;
        if (mk.window > 0) valid = valid && kj > qi - mk.window;
        x = valid ? x : NEG;
      }
      s[j] = x;
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], x);
    }
  }
  float mref[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = ex2(m[r] - m_new);
    // a row with no valid key yet keeps m = NEG; 2^(NEG - 0) = 0 for its p
    mref[r] = m_new == NEG ? 0.f : m_new;
    m[r] = m_new;
    l[r] *= alpha[r];
  }
  const float sc = plain ? mk.qk_scale : 1.f;  // raw scores get their scale here
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float p = ex2(fmaf(s[j], sc, -mref[(j >> 1) & 1]));
    s[j] = p;
    l[(j >> 1) & 1] += p;
  }
}

// The row's log-sum-exp of its (scaled, softcapped) scores in natural units,
// from the tensor-core kernels' log2-unit max m and the row sum l: what the
// backward kernels recompute P from. A row with no valid key (l = 0) gets -inf.
__device__ __forceinline__ void write_lse(float* lse, size_t at, float m, float l) {
  lse[at] = l > 0.f ? (m + log2f(l)) * 0.6931471805599453f : neg_inf();
}

template <int DH>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse, int B,
             int S, int H, int KH, int nq, int causal, int window, float softcap,
             float scale) {
  constexpr int LD = tc_ld(DH);
  constexpr int KSTEPS = DH / 16;  // k-steps of QK^T
  constexpr int NT = TC_BK / 8;    // 8-key n-tiles of a score tile
  constexpr int DT = DH / 8;       // 8-dim n-tiles of the output
  constexpr int CPR = DH / 8;      // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [TC_BQ][LD]
  bf16* ks = qs + TC_BQ * LD;                     // [2][TC_BK][LD]
  bf16* vs = ks + 2 * TC_BK * LD;                 // [2][TC_BK][LD]

  const int BH = B * H;
  const int rank = blockIdx.x / BH;  // causal: the longest query tiles first
  const int bh = blockIdx.x % BH;
  const int qt = causal ? nq - 1 - rank : rank;
  const int h = bh % H;
  const int b = bh / H;
  const int kh = h / (H / KH);
  const int q0 = qt * TC_BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t qrow = (size_t)H * DH;
  const size_t krow = (size_t)KH * DH;
  const bf16* qb = q + (size_t)b * S * qrow + (size_t)h * DH;
  const bf16* kb = k + (size_t)b * S * krow + (size_t)kh * DH;
  const bf16* vb = v + (size_t)b * S * krow + (size_t)kh * DH;

  // the keys any row of this tile can reach, as whole tiles
  const int q_last = min(q0 + TC_BQ, S) - 1;
  const int k_hi = causal ? q_last : S - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / TC_BK;
  const int ntiles = k_hi / TC_BK - t_lo + 1;

  for (int e = tid; e < TC_BQ * CPR; e += TC_THREADS) {
    const int r = e / CPR, ch = e % CPR;
    const bool in = q0 + r < S;
    cp_async16(smem_u32(qs + r * LD + ch * 8), qb + (size_t)(in ? q0 + r : 0) * qrow + ch * 8,
               in);
  }
  auto load_kv = [&](int t, int stage) {
    const int k0 = t * TC_BK;
    bf16* kd = ks + stage * TC_BK * LD;
    bf16* vd = vs + stage * TC_BK * LD;
    for (int e = tid; e < TC_BK * CPR; e += TC_THREADS) {
      const int r = e / CPR, ch = e % CPR;
      const bool in = k0 + r < S;
      const size_t off = (size_t)(in ? k0 + r : 0) * krow + ch * 8;
      cp_async16(smem_u32(kd + r * LD + ch * 8), kb + off, in);
      cp_async16(smem_u32(vd + r * LD + ch * 8), vb + off, in);
    }
  };
  load_kv(t_lo, 0);
  cp_async_commit();  // group 0: Q and the first K/V tile

  const Mask mk{S, causal, window, softcap, softcap > 0.f ? scale : scale * LOG2E,
                softcap * LOG2E};
  const int w0 = q0 + warp * 16;  // this warp's first row
  const int qi0 = w0 + lane / 4;  // this thread's rows: qi0 and qi0 + 8
  float oacc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dt][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // l: this thread's share of the row sum
  uint32_t qa[KSTEPS][4];

  for (int i = 0; i < ntiles; ++i) {
    const int t = t_lo + i;
    const int stage = i & 1;
    if (i + 1 < ntiles) {
      load_kv(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = t * TC_BK;
    // a warp whose rows all lie past S, or wholly below this causal tile,
    // skips it (at the engine's S = 32 two of the four warps have no row)
    if (w0 < S && !(causal && k0 > w0 + 15)) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          ldsm_x4(smem_u32(qs + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8),
                  qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3]);
      }
      const bf16* kst = ks + stage * TC_BK * LD;
      const bf16* vst = vs + stage * TC_BK * LD;

      float sacc[NT * 4];
#pragma unroll
      for (int j = 0; j < NT * 4; ++j) sacc[j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(smem_u32(kst + (j * 8 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 +
                           ((lane / 8) % 2) * 8),
                  b0, b1, b2, b3);
          mma_bf16(sacc + 4 * j, qa[kk], b0, b1);
          mma_bf16(sacc + 4 * j + 4, qa[kk], b2, b3);
        }
      }
      float alpha[2];
      softmax_step(sacc, m, l, alpha, k0, w0, lane, mk);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[dt][e] *= alpha[e >> 1];

#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]),
            pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]),
            pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]),
            pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]),
        };
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_t(smem_u32(vst + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + dt * 8 +
                             (lane / 16) * 8),
                    b0, b1, b2, b3);
          mma_bf16(oacc[dt], pa, b0, b1);
          mma_bf16(oacc[dt + 1], pa, b2, b3);
        }
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    const int qi = qi0 + 8 * r;
    if (qi >= S) continue;
    if (lse != nullptr && lane % 4 == 0) write_lse(lse, ((size_t)b * H + h) * S + qi, m[r], lr);
    bf16* ob = o + (size_t)b * S * qrow + (size_t)qi * qrow + (size_t)h * DH + (lane % 4) * 2;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(ob + dt * 8) =
          __floats2bfloat162_rn(oacc[dt][2 * r] * inv, oacc[dt][2 * r + 1] * inv);
  }
}

// ---- bf16 at Dh = 64, 128, 224 (padded to 256), 256 and (192, 128): wgmma (Hopper's warpgroup products) ----

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

// d[64 x N] += a (registers, 64 x 16) * the [16, N] V slice at shared address
// vs (MN-major: N runs over 64-column atoms 8 KB apart, k over 1 KB row groups)
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint32_t vs);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint32_t vs) {
  wgmma_rs_n64(d, a, wg_desc(vs, 64 * 128, 1024));
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint32_t vs) {
  wgmma_rs_n128(d, a, wg_desc(vs, 64 * 128, 1024));
}
// n = 256 as two n = 128 halves: the halves' fragments are the n256 fragment's
// first and last 64 floats
template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&d)[128], const uint32_t (&a)[4],
                                              uint32_t vs) {
  wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(d), a, wg_desc(vs, 64 * 128, 1024));
  wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(d + 64), a,
                wg_desc(vs + 2 * 64 * 128, 64 * 128, 1024));
}

// Byte offset of the 16-byte chunk c of row r in a 64-row tile stored for
// wgmma: rows of 128 bytes (64 bf16) in 128-byte-swizzled atoms of 8 KB, the
// row's 16-byte chunks XOR-ed with r % 8 (what the B128 layout reads); a
// row wider than 64 elements continues in the next atom.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)((c / 8) * 64 * 128 + r * 128 + (((c % 8) ^ (r % 8)) * 16));
}

// Copy one 64-row tile of CP 16-byte chunks a row (the first CW hold data, the
// rest are zero-filled) into a wgmma tile at dst: this thread's chunks
// e = tid + j * TC_THREADS, row e / CP, chunk e % CP. Rows past S load zeros.
// Used where K's and V's widths differ: a 24-chunk row (192) does not divide
// the 128 threads, so the equal-width kernels' fixed per-thread chunk does not
// apply.
template <int CP, int CW>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, size_t row, int k0,
                                          int S, int tid) {
  static_assert(TC_BK * CP % TC_THREADS == 0, "chunks per thread");
#pragma unroll
  for (int j = 0; j < TC_BK * CP / TC_THREADS; ++j) {
    const int e = tid + j * TC_THREADS, r = e / CP, c = e % CP;
    const bool in = k0 + r < S && c < CW;
    cp_async16(dst + sw128(r, c), src + (in ? (size_t)(k0 + r) * row + c * 8 : 0), in);
  }
}

// Stages of the wgmma kernel's K/V ring: tiles loading ahead, + K of the
// tile in QK^T, + V of the tile in PV. Two tiles ahead at Dh = 64; one at
// Dh = 128, 192 and 256, where a fourth stage would leave one block per SM
// (at 128) or not fit (at 256: 3 stages and Q take 225 of the 227 KB).
__host__ __device__ constexpr int wg_stages(int dh) { return dh <= 64 ? 4 : 3; }

template <int DHP, int DVP>
__host__ __device__ constexpr size_t wg_smem_bytes() {  // Q, the K/V ring, alignment
  return ((size_t)(1 + wg_stages(DHP)) * DHP + (size_t)wg_stages(DHP) * DVP) * 64 *
             sizeof(bf16) + 1024;
}

// DH is q's and k's head width, DV v's and o's (DV = DH but for the (192, 128)
// pair); DHP and DVP the tiles' (rounded up to whole 64-column atoms: the
// width itself at 64, 128, 192 and 256; 256 at 224).
template <int DH, int DHP, int DV, int DVP>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse, int B,
                int S, int H, int KH, int nq, int causal, int window, float softcap,
                float scale) {
  constexpr int TILE = 64 * DHP * (int)sizeof(bf16);    // bytes of one 64-row Q or K tile
  constexpr int TILE_V = 64 * DVP * (int)sizeof(bf16);  // ... and V tile
  constexpr int KSTEPS = DH / 16;  // k-steps of QK^T (the padded columns are zeros)
  constexpr int NT = TC_BK / 8;    // 8-key n-tiles of a score tile
  constexpr int DT = DV / 8;       // 8-dim n-tiles of the output that are stored
  constexpr int CPR = DH / 8;      // 16-byte chunks per row of the tensors
  constexpr int CPRP = DHP / 8;    // ... and of the tiles (those past CPR zero-filled)
  constexpr int STAGES = wg_stages(DHP);
  constexpr int AHEAD = STAGES - 2;  // tiles in flight ahead of the one in QK^T
  static_assert(DHP % 64 == 0 && DH <= DHP && DHP - DH < 64 && DH % 16 == 0, "head width");
  static_assert(DVP % 64 == 0 && DV <= DVP && DVP - DV < 64 && DV % 16 == 0, "value width");
  extern __shared__ __align__(16) unsigned char smem_wg[];
  // the B128 swizzle is read from address bits, so tiles start on 1 KB
  const uint32_t base = (smem_u32(smem_wg) + 1023u) & ~1023u;
  const uint32_t qs = base;                          // [64][DHP]
  const uint32_t ks = base + TILE;                // [STAGES][64][DHP]
  const uint32_t vs = base + (1 + STAGES) * TILE;  // [STAGES][64][DVP]

  const int BH = B * H;
  const int rank = blockIdx.x / BH;  // causal: the longest query tiles first
  const int bh = blockIdx.x % BH;
  const int qt = causal ? nq - 1 - rank : rank;
  const int h = bh % H;
  const int b = bh / H;
  const int kh = h / (H / KH);
  const int q0 = qt * TC_BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t qrow = (size_t)H * DH;
  const size_t krow = (size_t)KH * DH;
  const size_t vrow = (size_t)KH * DV;
  const size_t orow = (size_t)H * DV;
  const bf16* qb = q + (size_t)b * S * qrow + (size_t)h * DH;
  const bf16* kb = k + (size_t)b * S * krow + (size_t)kh * DH;
  const bf16* vb = v + (size_t)b * S * vrow + (size_t)kh * DV;

  const int q_last = min(q0 + TC_BQ, S) - 1;
  const int k_hi = causal ? q_last : S - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / TC_BK;
  const int ntiles = k_hi / TC_BK - t_lo + 1;

  for (int e = tid; e < TC_BQ * CPRP; e += TC_THREADS) {
    const int r = e / CPRP, ch = e % CPRP;
    const bool in = q0 + r < S && ch < CPR;
    cp_async16(qs + sw128(r, ch), qb + (in ? (size_t)(q0 + r) * qrow + ch * 8 : 0), in);
  }
  // this thread's 16-byte chunks of a K/V tile at equal widths: chunk
  // tid % CPRP of the rows tid / CPRP + j * RPJ, the same in every tile
  constexpr int PER = TC_BK * CPRP / TC_THREADS;
  constexpr int RPJ = TC_THREADS / CPRP;
  const int r0 = tid / CPRP, ch = tid % CPRP;
  const uint32_t g_base = (uint32_t)(r0 * krow + ch * 8);
  auto load_kv = [&](int i) {  // the i-th reachable K/V tile, into stage i % STAGES
    const int k0 = (t_lo + i) * TC_BK;
    const uint32_t st = (uint32_t)(i % STAGES) * TILE;
    if constexpr (DV == DH) {
      const size_t g0 = (size_t)k0 * krow + g_base;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int r = r0 + j * RPJ;
        const bool in = k0 + r < S && ch < CPR;
        const size_t off = in ? g0 + (size_t)j * RPJ * krow : 0;
        cp_async16(ks + st + sw128(r, ch), kb + off, in);
        cp_async16(vs + st + sw128(r, ch), vb + off, in);
      }
    } else {  // K and V apart: their rows differ in width
      load_tile<CPRP, CPR>(ks + st, kb, krow, k0, S, tid);
      load_tile<DVP / 8, DV / 8>(vs + (uint32_t)(i % STAGES) * TILE_V, vb, vrow, k0, S, tid);
    }
    cp_async_commit();
  };
  for (int i = 0; i < AHEAD && i < ntiles; ++i) load_kv(i);  // the first with Q

  const Mask mk{S, causal, window, softcap, softcap > 0.f ? scale : scale * LOG2E,
                softcap * LOG2E};
  const int w0 = q0 + warp * 16;  // this warp's first row
  const int qi0 = w0 + lane / 4;  // this thread's rows: qi0 and qi0 + 8
  float oacc[DVP / 2];            // [DVP / 8][4]: the m64nDVP accumulator fragment
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) oacc[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float sacc[NT * 4];  // the m64n64 score fragment, [NT][4]; then P
  uint32_t pk[TC_BK / 16][4];  // P in bf16: the A operand of PV

  // Step i issues QK^T of tile i and PV of tile i - 1 together, then runs
  // tile i's softmax while PV is still on the tensor cores. The ring holds
  // the AHEAD tiles loading, K of tile i and V of tile i - 1.
  for (int i = 0; i <= ntiles; ++i) {
    if (i < ntiles) {
      if (AHEAD > 1 && i + 1 < ntiles) cp_async_wait<AHEAD - 1>(); else cp_async_wait<0>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // copies -> wgmma
      __syncthreads();  // tile i is in; every warp is done with tile i - 2's stage
      if (i + AHEAD < ntiles) load_kv(i + AHEAD);
    }
    if (i > 0) {
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pk[kk][x] = pack_bf16(sacc[8 * kk + 2 * x], sacc[8 * kk + 2 * x + 1]);
    }
    wg_fence();
    if (i < ntiles) {
      const uint32_t kst = ks + (uint32_t)(i % STAGES) * TILE;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t off = (kk % 4) * 32 + (kk / 4) * 64 * 128;  // 32 B per k16 in an atom
        wgmma_ss_n64(sacc, wg_desc(qs + off, 16, 1024), wg_desc(kst + off, 16, 1024), kk > 0);
      }
      wg_commit();
    }
    if (i > 0) {  // PV: P (registers) x V (MN-major in shared memory)
      const uint32_t vst = vs + (uint32_t)((i - 1) % STAGES) * TILE_V;
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk)
        wgmma_pv<DVP>(oacc, pk[kk], vst + kk * 16 * 128);
      wg_commit();
    }
    if (i == ntiles) {
      wg_wait<0>();
      break;
    }
    if (i > 0) wg_wait<1>(); else wg_wait<0>();  // the scores are in

    float alpha[2];
    softmax_step(sacc, m, l, alpha, (t_lo + i) * TC_BK, w0, lane, mk);
    wg_wait<0>();  // PV of tile i - 1 is in O: rescale it to tile i's max
#pragma unroll
    for (int j = 0; j < DVP / 2; ++j) oacc[j] *= alpha[(j >> 1) & 1];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    const int qi = qi0 + 8 * r;
    if (qi >= S) continue;
    if (lse != nullptr && lane % 4 == 0) write_lse(lse, ((size_t)b * H + h) * S + qi, m[r], lr);
    bf16* ob = o + (size_t)b * S * orow + (size_t)qi * orow + (size_t)h * DV + (lane % 4) * 2;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(ob + dt * 8) =
          __floats2bfloat162_rn(oacc[4 * dt + 2 * r] * inv, oacc[4 * dt + 2 * r + 1] * inv);
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;  // [B, H, S] or null (not written)
  int B, S, H, KH, causal, window;
  float softcap, scale;
};

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

template <int DH, int DV = DH>
int launch_f32(const Args& a, cudaStream_t st) {
  static bool done = false;
  const size_t smem = smem_bytes<DH, DV>();
  if (int err = allow_smem(flash_fwd_f32<DH, DV>, smem, done)) return err;
  const int nq = (a.S + BQ - 1) / BQ;
  const unsigned grid = (unsigned)a.B * (unsigned)a.H * (unsigned)nq;
  flash_fwd_f32<DH, DV><<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.S, a.H, a.KH, nq,
      a.causal, a.window, a.softcap, a.scale);
  return (int)cudaGetLastError();
}

template <int DH, int DV = DH>
int launch_tc(const Args& a, cudaStream_t st) {
  static bool done = false;
  const int nq = (a.S + TC_BQ - 1) / TC_BQ;
  const unsigned grid = (unsigned)a.B * (unsigned)a.H * (unsigned)nq;
  if constexpr (DH >= 64) {
    constexpr int DHP = (DH + 63) / 64 * 64;  // 224 -> 256
    constexpr int DVP = (DV + 63) / 64 * 64;
    const size_t smem = wg_smem_bytes<DHP, DVP>();
    if (int err = allow_smem(flash_fwd_wgmma<DH, DHP, DV, DVP>, smem, done)) return err;
    flash_fwd_wgmma<DH, DHP, DV, DVP><<<grid, TC_THREADS, smem, st>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.B, a.S, a.H, a.KH,
        nq, a.causal, a.window, a.softcap, a.scale);
  } else {
    static_assert(DV == DH, "mma.sync takes one head width");
    const size_t smem = tc_smem_bytes<DH>();
    if (int err = allow_smem(flash_fwd_mma<DH>, smem, done)) return err;
    flash_fwd_mma<DH><<<grid, TC_THREADS, smem, st>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.B, a.S, a.H, a.KH,
        nq, a.causal, a.window, a.softcap, a.scale);
  }
  return (int)cudaGetLastError();
}

template <bool TC>
int dispatch_dh(const Args& a, int Dh, int Dv, cudaStream_t st) {
  if (Dv != Dh) {
    if (Dh == 192 && Dv == 128)
      return TC ? launch_tc<192, 128>(a, st) : launch_f32<192, 128>(a, st);
    return (int)cudaErrorInvalidValue;
  }
  switch (Dh) {
    case 16: return TC ? launch_tc<16>(a, st) : launch_f32<16>(a, st);
    case 32: return TC ? launch_tc<32>(a, st) : launch_f32<32>(a, st);
    case 64: return TC ? launch_tc<64>(a, st) : launch_f32<64>(a, st);
    case 128: return TC ? launch_tc<128>(a, st) : launch_f32<128>(a, st);
    case 224: return TC ? launch_tc<224>(a, st) : launch_f32<224>(a, st);
    case 256: return TC ? launch_tc<256>(a, st) : launch_f32<256>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, S, H, Dh], k [B, S, KH, Dh], v [B, S, KH, Dv], o [B, S, H, Dv], all
// contiguous and of one dtype; lse [B, H, S] float32, or null: each row's
// log-sum-exp of its scaled, softcapped scores (-inf for a row with no valid
// key), which the backward (flash_attention_bwd.cu) recomputes P from (0 = float32: the scalar kernel; 1 = bfloat16:
// the tensor-core kernel, which also needs 16-byte aligned tensors); Dv = Dh
// in {16, 32, 64, 128, 224, 256}, or (Dh, Dv) = (192, 128); H % KH == 0;
// window 0 = none; softcap 0 = none. Launches on `stream` and returns
// cudaGetLastError().
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                           int B, int S, int H, int KH, int Dh, int Dv, int dtype, int causal,
                           int window, float softcap, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, o, static_cast<float*>(lse), B, S, H, KH, causal, window, softcap, scale};
  if (dtype == 0) return dispatch_dh<false>(a, Dh, Dv, st);
  if (dtype == 1) return dispatch_dh<true>(a, Dh, Dv, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
