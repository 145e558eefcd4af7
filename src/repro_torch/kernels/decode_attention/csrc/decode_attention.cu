// Single-token decode attention over a KV cache, for one H100.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/kernel.py
// :: decode_attention_kernel (body _decode_kernel). q [B, H, Dh] (one new
// token per sequence) attends to k/v [B, S, KH, Dh] over the rows
// pos < lengths[b] (lengths count the valid slots, the current one
// included), and with a window only pos >= lengths[b] - window; an optional
// tanh softcap bounds the logits. Query head h reads KV head h / G. Inputs
// are float32 or bfloat16; the online-softmax state (m, l, acc) is float32
// with the TPU kernel's sentinel NEG = -2.3e38, and the output, acc /
// max(l, 1e-30) in q's dtype, is zeros for a sequence with no valid row.
//
// Bound on an H100. Decoding reads every live K/V row once and does about
// 4*G*Dh FLOP per row and KV head: some 2*G FLOP per byte in bf16, far below
// the card's ridge, so it is bound by bytes.
//
// Design (simple and right first; split-K comes later):
//   - One 128-thread block per (b, KV head) serves that head's G query
//     heads, so each K/V row is read from device memory once.
//   - The block walks its rows in tiles of BS = 64, staged through shared
//     memory as float32, from the window's first row (or 0) up to
//     lengths[b] only: rows past the length are never read (the TPU kernel
//     still schedules their DMA).
//   - Scores for the G x BS (head, row) pairs go one per thread; one warp per
//     head then does the online-softmax update with shuffles; the G x Dh
//     accumulator lives in shared memory, each element owned by one thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BS = 64;        // cache rows per tile
constexpr int THREADS = 128;  // four warps
constexpr float NEG = -2.3e38f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DH>
size_t smem_bytes(int G) {
  // qs [G][DH], acc [G][DH], ks/vs [BS][DH+1], ss [G][BS], m/l/alpha [G]
  return (size_t)(2 * G * DH + 2 * BS * (DH + 1) + G * BS + 3 * G) * sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
decode_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const int* __restrict__ lengths, T* __restrict__ o, int S, int H, int KH,
           int window, float softcap, float scale) {
  constexpr int LD = DH + 1;
  const int G = H / KH;
  extern __shared__ float smem[];
  float* qs = smem;              // [G][DH]
  float* acc = qs + G * DH;      // [G][DH]
  float* ks = acc + G * DH;      // [BS][LD]
  float* vs = ks + BS * LD;      // [BS][LD]
  float* ss = vs + BS * LD;      // [G][BS]: scores, then p
  float* ms = ss + G * BS;       // [G]
  float* ls = ms + G;            // [G]
  float* as = ls + G;            // [G]: this tile's rescale

  const int b = blockIdx.x / KH;
  const int kh = blockIdx.x % KH;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int length = lengths[b];
  const int hi = min(length, S);                           // rows [lo, hi) are live
  const int lo = window > 0 ? max(0, length - window) : 0;
  const size_t krow = (size_t)KH * DH;
  const T* qb = q + ((size_t)b * H + (size_t)kh * G) * DH;
  const T* kb = k + (size_t)b * S * krow + (size_t)kh * DH;
  const T* vb = v + (size_t)b * S * krow + (size_t)kh * DH;

  for (int e = tid; e < G * DH; e += THREADS) {
    qs[e] = to_f(qb[e]);
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    ms[g] = NEG;
    ls[g] = 0.f;
  }

  for (int s0 = lo; s0 < hi; s0 += BS) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BS * DH; e += THREADS) {
      const int rr = e / DH, d = e % DH;
      const bool in = s0 + rr < hi;
      ks[rr * LD + d] = in ? to_f(kb[(size_t)(s0 + rr) * krow + d]) : 0.f;
      vs[rr * LD + d] = in ? to_f(vb[(size_t)(s0 + rr) * krow + d]) : 0.f;
    }
    __syncthreads();
    for (int p = tid; p < G * BS; p += THREADS) {
      const int g = p / BS, j = p % BS;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) dot = fmaf(qs[g * DH + d], ks[j * LD + d], dot);
      float x = dot * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      ss[p] = s0 + j < hi ? x : NEG;
    }
    __syncthreads();
    for (int g = warp; g < G; g += THREADS / 32) {
      float mt = NEG;
      for (int j = lane; j < BS; j += 32) mt = fmaxf(mt, ss[g * BS + j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mt);
      float psum = 0.f;
      for (int j = lane; j < BS; j += 32) {
        const float p = s0 + j < hi ? expf(ss[g * BS + j] - m_new) : 0.f;
        ss[g * BS + j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        as[g] = alpha;
        ls[g] = alpha * ls[g] + psum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < G * DH; e += THREADS) {
      const int g = e / DH, d = e % DH;
      float a = acc[e] * as[g];
#pragma unroll 8
      for (int j = 0; j < BS; ++j) a = fmaf(ss[g * BS + j], vs[j * LD + d], a);
      acc[e] = a;
    }
  }
  __syncthreads();
  T* ob = o + ((size_t)b * H + (size_t)kh * G) * DH;
  for (int e = tid; e < G * DH; e += THREADS) ob[e] = from_f<T>(acc[e] / fmaxf(ls[e / DH], 1e-30f));
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* o, int B,
           int S, int H, int KH, int window, float softcap, float scale, cudaStream_t st) {
  const size_t smem = smem_bytes<DH>(H / KH);
  cudaError_t err = cudaFuncSetAttribute(
      decode_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_fwd<T, DH><<<(unsigned)B * (unsigned)KH, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(o), S, H, KH, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(const void* q, const void* k, const void* v, const int* lengths, void* o,
                int B, int S, int H, int KH, int Dh, int window, float softcap, float scale,
                cudaStream_t st) {
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, lengths, o, B, S, H, KH, window, softcap, scale, st);
    case 32: return launch<T, 32>(q, k, v, lengths, o, B, S, H, KH, window, softcap, scale, st);
    case 64: return launch<T, 64>(q, k, v, lengths, o, B, S, H, KH, window, softcap, scale, st);
    case 128: return launch<T, 128>(q, k, v, lengths, o, B, S, H, KH, window, softcap, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, H, Dh], k/v [B, S, KH, Dh], o [B, H, Dh], all contiguous and of one
// dtype (0 = float32, 1 = bfloat16); lengths [B] int32; Dh in {16, 32, 64,
// 128}; H % KH == 0; window 0 = none; softcap 0 = none. Launches on `stream`
// and returns cudaGetLastError().
int decode_attention_launch(const void* q, const void* k, const void* v, const int* lengths,
                            void* o, int B, int S, int H, int KH, int Dh, int dtype,
                            int window, float softcap, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(q, k, v, lengths, o, B, S, H, KH, Dh, window, softcap, scale, st);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(q, k, v, lengths, o, B, S, H, KH, Dh, window, softcap,
                                      scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
