// Prefill attention (FlashAttention-style online softmax) for one H100.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// :: flash_attention_kernel (body _flash_kernel). q [B, S, H, Dh] attends to
// k/v [B, S, KH, Dh] (query head h reads KV head h / G, G = H / KH) under an
// optional causal mask, an optional sliding window (key > query - window)
// and an optional tanh logit softcap; o [B, S, H, Dh] has q's dtype. Inputs
// are float32 or bfloat16; scores, the running max m, the running sum l and
// the output accumulator are float32. The sentinel is NEG = -2.3e38 and the
// output is acc / max(l, 1e-30), so a row with no valid key gives zeros, as
// on the TPU.
//
// Bound on an H100. Prefill at the engine's prompt lengths (S = 32, H = 16,
// Dh = 64) is a few microseconds of work: the launch dominates. At long S
// the work is 4*B*H*S*S*Dh/2 FLOP (causal), far above the bytes, so it is
// bound by operations; this first kernel runs them as scalar FP32 FMAs out
// of shared memory (no wgmma/TMA yet) and reaches a small share of the
// tensor-core peak.
//
// Design (simple and right first):
//   - One 256-thread block per (b, h, query tile of BQ = 64 rows). A loop
//     inside the block walks the K/V tiles of BK = 64 keys, staged through
//     shared memory as float32; it takes the place of the TPU's sequential
//     nk grid axis. Only the tiles a row of this query tile can reach are
//     loaded: up to the causal bound, and from the window's lower bound
//     (the TPU kernel skips only their compute).
//   - Four threads share a query row: thread c scores keys c, c+4, ..., and
//     owns output dims c, c+4, ...; row max and row sum reduce over the four
//     with warp shuffles. Padded shared-memory rows keep the reads free of
//     bank conflicts.
//   - The ragged edge is masked here: rows and keys past S load as zeros,
//     keys past S score NEG, and rows past S are not written, so S need not
//     be a multiple of the tile (the TPU wrapper asserts it is).
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DH>
constexpr size_t smem_bytes() {
  return (size_t)((BQ + 2 * BK) * (DH + 1) + BQ * (BK + 1)) * sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int S, int H, int KH, int nq, int causal, int window,
          float softcap, float scale) {
  constexpr int LD = DH + 1;
  constexpr int DPT = DH / TPR;  // output dims per thread
  extern __shared__ float smem[];
  float* qs = smem;              // [BQ][LD]
  float* ks = qs + BQ * LD;      // [BK][LD]
  float* vs = ks + BK * LD;      // [BK][LD]
  float* ps = vs + BK * LD;      // [BQ][BK + 1]

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
  const T* qb = q + (size_t)b * S * qrow + (size_t)h * DH;
  const T* kb = k + (size_t)b * S * krow + (size_t)kh * DH;
  const T* vb = v + (size_t)b * S * krow + (size_t)kh * DH;

  for (int e = tid; e < BQ * DH; e += THREADS) {
    const int rr = e / DH, d = e % DH;
    qs[rr * LD + d] = q0 + rr < S ? to_f(qb[(size_t)(q0 + rr) * qrow + d]) : 0.f;
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
      const bool in = k0 + rr < S;
      ks[rr * LD + d] = in ? to_f(kb[(size_t)(k0 + rr) * krow + d]) : 0.f;
      vs[rr * LD + d] = in ? to_f(vb[(size_t)(k0 + rr) * krow + d]) : 0.f;
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
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, vs[j * LD + c + TPR * i], acc[i]);
    }
  }

  if (qi < S) {
    const float denom = fmaxf(l, 1e-30f);
    T* ob = o + (size_t)b * S * qrow + (size_t)qi * qrow + (size_t)h * DH;
#pragma unroll
    for (int i = 0; i < DPT; ++i) ob[c + TPR * i] = from_f<T>(acc[i] / denom);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
           int KH, int causal, int window, float softcap, float scale, cudaStream_t st) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (S + BQ - 1) / BQ;
  const unsigned grid = (unsigned)B * (unsigned)H * (unsigned)nq;
  flash_fwd<T, DH><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, KH, nq, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(const void* q, const void* k, const void* v, void* o, int B, int S,
                int H, int KH, int Dh, int causal, int window, float softcap,
                float scale, cudaStream_t st) {
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, KH, causal, window, softcap, scale, st);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KH, causal, window, softcap, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KH, causal, window, softcap, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KH, causal, window, softcap, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, S, H, Dh], k/v [B, S, KH, Dh], o [B, S, H, Dh], all contiguous and of
// one dtype (0 = float32, 1 = bfloat16); Dh in {16, 32, 64, 128}; H % KH == 0;
// window 0 = none; softcap 0 = none. Launches on `stream` and returns
// cudaGetLastError().
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B,
                           int S, int H, int KH, int Dh, int dtype, int causal,
                           int window, float softcap, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(q, k, v, o, B, S, H, KH, Dh, causal, window, softcap, scale, st);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(q, k, v, o, B, S, H, KH, Dh, causal, window, softcap,
                                      scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
