// Mamba2 SSD chunked scan for one H100.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py ::
// ssd_scan_kernel (body _ssd_kernel). x [B, S, H, P], Bm/Cm [B, S, G, N]
// (head h reads group h / (H / G)), dt [B, S, H] (post-softplus, >= 0), A [H]
// (< 0) and D [H] give y [B, S, H, P] in x's dtype and the final state
// [B, H, P, N] in float32. The state starts at zero. For each chunk of
// L = min(chunk, S) steps, with cs = cumsum(dt * A) inside the chunk:
//   y[l]   = exp(cs[l]) * C[l] . state
//          + sum_{s <= l} (C[l] . B[s]) * exp(cs[l] - cs[s]) * dt[s] * x[s]
//          + D * x[l]
//   state <- state * exp(cs[last]) + sum_s (x[s] * exp(cs[last] - cs[s]) * dt[s]) (x) B[s]
// Inputs x/Bm/Cm are float32 or bfloat16; dt, A, D and every sum are float32.
//
// Bound on an H100. At the engine's prefill (B = 1, S = 32, H = 64, P = 64,
// N = 128, one B/C group) one call is ~72 MFLOP over ~2.7 MB: about a
// microsecond of work, so the launch dominates. At long S it is bound by
// operations: per head ~S * L * P for the causal scores times x and
// 4 * S * P * N for the inter-chunk term and the state, plus ~S * L * N for
// the causal C B^T, which depends only on the B/C group. This first kernel
// runs them as scalar FP32 FMAs out of shared memory (no wgmma/TMA yet),
// recomputes C B^T in each of a group's H / G head blocks, and reaches a
// small share of the FP32 peak.
//
// Design (simple and right first):
//   - One 256-thread block per (b, h). A loop inside the block walks the
//     chunks in order and keeps the [P, N] float32 state in shared memory
//     (32 KB at P = 64, N = 128): it takes the place of the TPU's sequential
//     chunk grid axis and its VMEM scratch, since Hopper blocks run in no
//     order.
//   - A chunk of 256 steps does not fit shared memory whole (x, B, C and the
//     [L, L] scores are ~450 KB in float32), so the block steps through it in
//     tiles of 64 steps: for each query tile, the inter-chunk term from the
//     state, then the key tiles up to the diagonal (scores, decay, causal
//     mask, times x), then the skip term. Only after every output row of the
//     chunk has read the old state is the state decayed and updated, one key
//     tile at a time.
//   - Four threads share a row: thread c scores keys c, c+4, ... and owns
//     output dims c, c+4, ...; in the state update each thread owns a strided
//     set of (p, n) entries. Padded shared-memory rows keep reads free of bank
//     conflicts.
//   - The ragged edge is masked here: steps past S load as zeros, the last
//     chunk's cumsum ends at its last live step, and rows past S are not
//     written, so S need not be a multiple of the chunk (the TPU wrapper
//     asserts it is). That equals the reference's zero padding with dt = 0.
//   - Groups are read where they lie (no copy per head): at ngroups = 1 all
//     64 heads read one B/C row per step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;             // query steps per tile
constexpr int TK = 64;             // key steps per tile (== TQ: a query tile's last key tile is its diagonal)
constexpr int TPR = 4;             // threads per row
constexpr int THREADS = TQ * TPR;  // 256
constexpr int KPT = TK / TPR;      // keys scored per thread per tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ssd_scan_launch's return value when one block's state and tiles do not fit
// the device's shared memory (every other non-zero value is a cudaError_t)
constexpr int ERR_SHARED_MEMORY = -1;

// shared memory of one block, in floats
inline size_t smem_floats(int P, int N, int L) {
  return (size_t)P * (N + 1) + 2 * (size_t)TQ * (N + 1) + (size_t)TK * (P + 1) +
         (size_t)TQ * (TK + 1) + 2 * (size_t)L;
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
ssd_fwd(const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
        const float* __restrict__ dt, const float* __restrict__ A,
        const float* __restrict__ D, T* __restrict__ y, float* __restrict__ state_out,
        int S, int H, int G, int N, int L) {
  constexpr int PPT = P / TPR;  // output dims per thread
  constexpr int XP = P + 1;
  const int NP = N + 1;
  extern __shared__ float smem[];
  float* st = smem;               // [P][NP]   the carried state
  float* cs = st + P * NP;        // [TQ][NP]  C rows of the query tile
  float* bs = cs + TQ * NP;       // [TK][NP]  B rows of the key tile
  float* xs = bs + TK * NP;       // [TK][XP]  x rows of the key tile
  float* ps = xs + TK * XP;       // [TQ][TK + 1] decayed, masked scores
  float* cum = ps + TQ * (TK + 1);  // [L] cumsum(dt * A) of the chunk
  float* dts = cum + L;           // [L] dt of the chunk

  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int c = tid % TPR;
  const float a = A[h];
  const float dskip = D[h];
  const size_t xrow = (size_t)H * P;  // stride of one step in x and y
  const size_t brow = (size_t)G * N;  // in Bm and Cm
  const T* xb = x + (size_t)b * S * xrow + (size_t)h * P;
  const T* bb = Bm + (size_t)b * S * brow + (size_t)g * N;
  const T* cb = Cm + (size_t)b * S * brow + (size_t)g * N;
  const float* dtb = dt + (size_t)b * S * H + h;
  T* yb = y + (size_t)b * S * xrow + (size_t)h * P;

  for (int e = tid; e < P * NP; e += THREADS) st[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += L) {
    const int lc = min(L, S - c0);  // live steps of this chunk
    __syncthreads();  // the previous chunk's readers of cum/dts are done
    for (int i = tid; i < lc; i += THREADS) dts[i] = dtb[(size_t)(c0 + i) * H];
    __syncthreads();
    if (tid == 0) {  // sequential, in the reference's order; no FMA contraction
      float run = 0.f;
      for (int i = 0; i < lc; ++i) {
        run = __fadd_rn(run, __fmul_rn(dts[i], a));
        cum[i] = run;
      }
    }

    // -- outputs of the chunk, from the state at its start ----------------
    for (int q0 = 0; q0 < lc; q0 += TQ) {
      const int l = q0 + r;  // this thread's step in the chunk
      const bool live = l < lc;
      __syncthreads();  // cum is written; the previous tile's readers are done
      for (int e = tid; e < TQ * N; e += THREADS) {
        const int rr = e / N, n = e % N;
        cs[rr * NP + n] = q0 + rr < lc ? to_f(cb[(size_t)(c0 + q0 + rr) * brow + n]) : 0.f;
      }
      __syncthreads();

      float acc[PPT];
#pragma unroll
      for (int i = 0; i < PPT; ++i) acc[i] = 0.f;
      for (int n = 0; n < N; ++n) {  // inter-chunk term: C[l] . state[p]
        const float cn = cs[r * NP + n];
#pragma unroll
        for (int i = 0; i < PPT; ++i) acc[i] = fmaf(cn, st[(c + TPR * i) * NP + n], acc[i]);
      }
      const float el = live ? expf(cum[l]) : 0.f;
#pragma unroll
      for (int i = 0; i < PPT; ++i) acc[i] *= el;

      for (int s0 = 0; s0 <= q0; s0 += TK) {  // intra-chunk term, up to the diagonal
        __syncthreads();  // the previous key tile's readers are done
        for (int e = tid; e < TK * N; e += THREADS) {
          const int rr = e / N, n = e % N;
          bs[rr * NP + n] = s0 + rr < lc ? to_f(bb[(size_t)(c0 + s0 + rr) * brow + n]) : 0.f;
        }
        for (int e = tid; e < TK * P; e += THREADS) {
          const int rr = e / P, p = e % P;
          xs[rr * XP + p] = s0 + rr < lc ? to_f(xb[(size_t)(c0 + s0 + rr) * xrow + p]) : 0.f;
        }
        __syncthreads();

        float sc[KPT];
#pragma unroll
        for (int j = 0; j < KPT; ++j) sc[j] = 0.f;
        for (int n = 0; n < N; ++n) {
          const float cn = cs[r * NP + n];
#pragma unroll
          for (int j = 0; j < KPT; ++j) sc[j] = fmaf(cn, bs[(c + TPR * j) * NP + n], sc[j]);
        }
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          const int s = s0 + c + TPR * j;
          const bool ok = live && s <= l;  // s <= l < lc: a live key
          ps[r * (TK + 1) + c + TPR * j] = ok ? sc[j] * expf(cum[l] - cum[s]) * dts[s] : 0.f;
        }
        __syncwarp();  // a row's four threads (one warp) wrote its scores
#pragma unroll 4
        for (int j = 0; j < TK; ++j) {
          const float pj = ps[r * (TK + 1) + j];
#pragma unroll
          for (int i = 0; i < PPT; ++i) acc[i] = fmaf(pj, xs[j * XP + c + TPR * i], acc[i]);
        }
      }

      if (live) {  // skip term: the last key tile was the diagonal, xs holds row l
        T* yl = yb + (size_t)(c0 + l) * xrow;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          const int p = c + TPR * i;
          yl[p] = from_f<T>(acc[i] + dskip * xs[r * XP + p]);
        }
      }
    }

    // -- state update, once every output row has read the old state -------
    __syncthreads();
    const float last = cum[lc - 1];
    const float el = expf(last);
    for (int e = tid; e < P * N; e += THREADS) st[(e / N) * NP + e % N] *= el;
    for (int s0 = 0; s0 < lc; s0 += TK) {
      __syncthreads();  // the previous key tile's readers are done
      for (int e = tid; e < TK * N; e += THREADS) {
        const int rr = e / N, n = e % N;
        bs[rr * NP + n] = s0 + rr < lc ? to_f(bb[(size_t)(c0 + s0 + rr) * brow + n]) : 0.f;
      }
      for (int e = tid; e < TK * P; e += THREADS) {
        const int rr = e / P, p = e % P;
        const int s = s0 + rr;
        xs[rr * XP + p] = s < lc
            ? to_f(xb[(size_t)(c0 + s) * xrow + p]) * (expf(last - cum[s]) * dts[s]) : 0.f;
      }
      __syncthreads();
      const int kn = min(TK, lc - s0);
      for (int e = tid; e < P * N; e += THREADS) {  // each thread owns its (p, n) entries
        const int p = e / N, n = e % N;
        float u = 0.f;
        for (int j = 0; j < kn; ++j) u = fmaf(xs[j * XP + p], bs[j * NP + n], u);
        st[p * NP + n] += u;
      }
    }
  }

  __syncthreads();
  float* so = state_out + ((size_t)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += THREADS) so[e] = st[(e / N) * NP + e % N];
}

template <typename T, int P>
int launch(const void* x, const void* Bm, const void* Cm, const void* dt, const void* A,
           const void* D, void* y, void* state, int B, int S, int H, int G, int N, int L,
           cudaStream_t st) {
  const size_t smem = smem_floats(P, N, L) * sizeof(float);
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)smem_max) return ERR_SHARED_MEMORY;
  err = cudaFuncSetAttribute(
      ssd_fwd<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)B * (unsigned)H;
  ssd_fwd<T, P><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(D), static_cast<T*>(y), static_cast<float*>(state), S, H, G,
      N, L);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_p(const void* x, const void* Bm, const void* Cm, const void* dt, const void* A,
               const void* D, void* y, void* state, int B, int S, int H, int G, int P, int N,
               int L, cudaStream_t st) {
  switch (P) {
    case 16: return launch<T, 16>(x, Bm, Cm, dt, A, D, y, state, B, S, H, G, N, L, st);
    case 32: return launch<T, 32>(x, Bm, Cm, dt, A, D, y, state, B, S, H, G, N, L, st);
    case 64: return launch<T, 64>(x, Bm, Cm, dt, A, D, y, state, B, S, H, G, N, L, st);
    case 128: return launch<T, 128>(x, Bm, Cm, dt, A, D, y, state, B, S, H, G, N, L, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x [B, S, H, P], Bm/Cm [B, S, G, N] of one dtype (0 = float32, 1 = bfloat16);
// dt [B, S, H], A [H], D [H] float32; y [B, S, H, P] in x's dtype; state
// [B, H, P, N] float32; all contiguous. P in {16, 32, 64, 128}; H % G == 0;
// L = min(chunk, S) >= 1. Launches on `stream` and returns cudaGetLastError(),
// or ERR_SHARED_MEMORY (-1), launching nothing, if one block's [P, N] state and
// tiles at this N and L do not fit the device's shared memory.
int ssd_scan_launch(const void* x, const void* Bm, const void* Cm, const void* dt,
                    const void* A, const void* D, void* y, void* state, int B, int S, int H,
                    int G, int P, int N, int L, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || L < 1 || G < 1 || N < 1 || H % G != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_p<float>(x, Bm, Cm, dt, A, D, y, state, B, S, H, G, P, N, L, st);
  if (dtype == 1)
    return dispatch_p<__nv_bfloat16>(x, Bm, Cm, dt, A, D, y, state, B, S, H, G, P, N, L, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
