// Single-token decode attention over a KV cache, split over the cache rows,
// for one H100.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/kernel.py
// :: decode_attention_kernel (body _decode_kernel). q [B, H, Dh] (one new
// token per sequence) attends to k/v [B, S, KH, Dh] over the rows
// pos < lengths[b] (lengths count the valid slots, the current one
// included), and with a window only pos >= lengths[b] - window; an optional
// tanh softcap bounds the logits. Query head h reads KV head h / G. Inputs
// are float32 or bfloat16, and both take this kernel: only the order of the
// float32 sums differs between them. The online-softmax state (m, l, acc) is
// float32 with the TPU kernel's sentinel NEG = -2.3e38, and the output,
// acc / max(l, 1e-30) in q's dtype, is zeros for a sequence with no valid row.
//
// Bound on an H100. Decoding reads every live K/V row once and does about
// 4*G*Dh FLOP per row and KV head: some 2*G FLOP per byte in bf16, far below
// the card's ridge, so it is bound by bytes. The design keeps enough bytes in
// flight on all 132 SMs:
//   - Split-K. The grid is (B * KH * head chunks, NS): the NS blocks of one
//     (b, KV head) each take a contiguous run of whole 64-row tiles
//     (rows_per_split rows, chosen on the host from the shapes alone by
//     kernel.py :: split_plan, so that long caches fill the card about twice
//     over; NS = 1 for short caches, which then stay a single pass). A block
//     reads only the rows of its run that are live: a run wholly past
//     lengths[b], or before the window's first row, loads nothing.
//   - Rows go to warps. A K or V row is read as 16-byte vectors (8 bf16 or
//     4 f32) spread over a power-of-two group of LPR lanes: a bf16 Dh = 64
//     row takes 8 lanes, so one warp load covers 4 rows. A row of more than
//     32 vectors (Dh 224 and 256 in float32: 56 and 64) gives each lane NV =
//     2 vectors, lane c holding vectors c and c + 32. A row whose vector
//     count is not a power of two (Dh 224: 28 in bf16, 56 = 2 x 28 in f32)
//     takes the next power of two of lanes (32), the lanes past the row
//     loading nothing and adding zeros to the shuffle sums. Each warp keeps
//     U such row groups' loads in flight (8 warps a block, 2-3 blocks an SM:
//     32-64 KB an SM). The G query heads served by a block (GM at most,
//     templated: 8 up to Dh 128 and 4 above, where the block's [8][GM][Dh]
//     float32 merge buffer must stay within 48 KB; larger groups take
//     several head chunks) sit in registers; a dot product is reduced by
//     shuffles among the row's lanes. Each lane keeps the online-softmax
//     state of its row group for every head and accumulates its own vectors'
//     worth of output dims.
//   - Merges in the same launch. The row groups of a warp merge by shuffles
//     and the warps of a block through shared memory, by the LSE rule
//     m = max m_i, l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i - m). With
//     NS > 1 each block writes its partial (m, l, acc) to a float32
//     workspace; the block that arrives last at its (b, KV head, head chunk)
//     counter merges the NS partials by the same rule, writes the output and
//     resets the counter to 0 for the next launch. A split with no live row
//     has m = NEG and l = 0 and weighs nothing. The wrapper owns the
//     workspace and the counters (zeroed once); launches that share them run
//     on one stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // eight warps
constexpr int NW = THREADS / 32;
constexpr int TILE = 64;         // rows per split tile (kernel.BLOCK_S)
constexpr int MAX_SPLITS = 64;   // kernel.MAX_SPLITS
constexpr float NEG = -2.3e38f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T as float32: 4 floats or 8 bfloat16s
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    float2 x = __bfloat1622float2(p);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__host__ __device__ constexpr int pow2_ceil(int n) {
  return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2);
}

template <typename T, int DH, int GM>
__global__ void __launch_bounds__(THREADS)
decode_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const int* __restrict__ lengths, T* __restrict__ o, float* __restrict__ ws,
           int* __restrict__ counters, int S, int H, int KH, int HC, int rows_per_split,
           int window, float softcap, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per lane-vector
  constexpr int CH = DH / VEC;         // 16-byte vectors per row
  constexpr int NV = (CH + 31) / 32;   // vectors per lane
  constexpr int LPR = pow2_ceil((CH + NV - 1) / NV);  // lanes per row
  constexpr bool FULL = NV * LPR == CH;  // every lane's vectors lie in the row
  constexpr int DV = NV * VEC;         // dims per lane
  constexpr int RPW = 32 / LPR;        // rows per warp load
  constexpr int U = GM >= 4 ? 2 : 4;   // warp loads in flight per lane
  static_assert(DH % VEC == 0 && LPR >= 1 && LPR <= 32 && NV <= 2, "row width");

  __shared__ float s_acc[NW][GM][DH];
  __shared__ float s_m[NW][GM], s_l[NW][GM];
  __shared__ float s_w[NW][GM];         // weight of each warp's state
  __shared__ float s_M[GM], s_L[GM];    // the block's merged m, l
  __shared__ float s_ws[GM][MAX_SPLITS];  // weight of each split (last block)
  __shared__ int s_last;

  const int NS = gridDim.y;
  const int unit = blockIdx.x;  // (b, kh, head chunk)
  const int hc = unit % HC;
  const int bkh = unit / HC;
  const int kh = bkh % KH;
  const int b = bkh / KH;
  const int G = H / KH;
  const int g0 = hc * GM;
  const int gn = min(GM, G - g0);
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rg = lane / LPR;  // row group within a warp load
  const int c = lane % LPR;   // this lane's vectors of a row: c, c + LPR, ...
  bool has[NV];               // ... which lie in the row
#pragma unroll
  for (int j = 0; j < NV; ++j) has[j] = FULL || c + j * LPR < CH;

  const int length = lengths[b];
  const int hi = min(length, S);
  const int lo = window > 0 ? max(0, length - window) : 0;
  const int s0 = split * rows_per_split;
  const int row_lo = max(lo, s0);
  const int row_hi = min(hi, min(S, s0 + rows_per_split));

  const size_t krow = (size_t)KH * DH;
  const T* kb = k + (size_t)b * S * krow + (size_t)kh * DH + c * VEC;
  const T* vb = v + (size_t)b * S * krow + (size_t)kh * DH + c * VEC;
  const int h0 = kh * G + g0;  // first query head of this block

  float qf[GM][DV], m[GM], l[GM], acc[GM][DV];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float f[VEC];
      if (g < gn && has[j]) {
        unpack(load16(q + ((size_t)b * H + h0 + g) * DH + (c + j * LPR) * VEC), f);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) f[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) qf[g][j * VEC + i] = f[i];
    }
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DV; ++i) acc[g][i] = 0.f;
  }

  // warp-uniform loop: each lane's row is wb + u * NW * RPW + rg
  for (int wb = row_lo + warp * RPW; wb < row_hi; wb += NW * RPW * U) {
    uint4 kr[U][NV], vr[U][NV];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = wb + u * NW * RPW + rg;
      ok[u] = row < row_hi;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (ok[u] && has[j]) {
          kr[u][j] = load16(kb + (size_t)row * krow + j * LPR * VEC);
          vr[u][j] = load16(vb + (size_t)row * krow + j * LPR * VEC);
        } else {
          kr[u][j] = make_uint4(0u, 0u, 0u, 0u);
          vr[u][j] = kr[u][j];
        }
      }
    }
    float s[GM][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[DV];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        float f[VEC];
        unpack(kr[u][j], f);
#pragma unroll
        for (int i = 0; i < VEC; ++i) kf[j * VEC + i] = f[i];
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DV; ++i) dot = fmaf(qf[g][i], kf[i], dot);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        float x = dot * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[g][u] = ok[u] ? x : NEG;
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mt = s[g][0];
#pragma unroll
      for (int u = 1; u < U; ++u) mt = fmaxf(mt, s[g][u]);
      const float m_new = fmaxf(m[g], mt);
      const float alpha = expf(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < DV; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = ok[u] ? expf(s[g][u] - m_new) : 0.f;
        l[g] += p;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          float vf[VEC];
          unpack(vr[u][j], vf);
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            acc[g][j * VEC + i] = fmaf(p, vf[i], acc[g][j * VEC + i]);
        }
      }
      m[g] = m_new;
    }
  }

  // merge the warp's row groups: lanes with the same c
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn), bw = expf(mo - mn);
      l[g] = l[g] * a + lo_ * bw;
#pragma unroll
      for (int i = 0; i < DV; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][i], off);
        acc[g][i] = acc[g][i] * a + ao * bw;
      }
      m[g] = mn;
    }
  }
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (!has[j]) continue;
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          s_acc[warp][g][(c + j * LPR) * VEC + i] = acc[g][j * VEC + i];
      }
      if (c == 0) {
        s_m[warp][g] = m[g];
        s_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  // merge the warps
  if (tid < GM) {
    float M = NEG;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, s_m[w][tid]);
    float L = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float wt = expf(s_m[w][tid] - M);
      s_w[w][tid] = wt;
      L += s_l[w][tid] * wt;
    }
    s_M[tid] = M;
    s_L[tid] = L;
  }
  __syncthreads();

  if (NS == 1) {
    for (int e = tid; e < gn * DH; e += THREADS) {
      const int g = e / DH, d = e % DH;
      float a = 0.f;
      for (int w = 0; w < NW; ++w) a = fmaf(s_acc[w][g][d], s_w[w][g], a);
      o[((size_t)b * H + h0 + g) * DH + d] = from_f<T>(a / fmaxf(s_L[g], 1e-30f));
    }
    return;
  }

  // NS > 1: this block's partial to the workspace, [B*H][NS][DH] accumulators
  // then [B*H][NS][2] (m, l)
  const size_t n_acc = (size_t)gridDim.x / HC * G * NS * DH;  // B*H*NS*DH
  float* ws_acc = ws;
  float* ws_ml = ws + n_acc;
  for (int e = tid; e < gn * DH; e += THREADS) {
    const int g = e / DH, d = e % DH;
    float a = 0.f;
    for (int w = 0; w < NW; ++w) a = fmaf(s_acc[w][g][d], s_w[w][g], a);
    ws_acc[(((size_t)b * H + h0 + g) * NS + split) * DH + d] = a;
  }
  if (tid < gn) {
    float* ml = ws_ml + (((size_t)b * H + h0 + tid) * NS + split) * 2;
    ml[0] = s_M[tid];
    ml[1] = s_L[tid];
  }
  __threadfence();  // the partial is visible before the counter moves
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&counters[unit], 1) == NS - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last block of this unit merges the NS partials
  if (tid < gn) {
    const float* ml = ws_ml + ((size_t)b * H + h0 + tid) * NS * 2;
    float M = NEG;
    for (int sp = 0; sp < NS; ++sp) M = fmaxf(M, __ldcg(ml + 2 * sp));
    float L = 0.f;
    for (int sp = 0; sp < NS; ++sp) {
      const float wt = expf(__ldcg(ml + 2 * sp) - M);
      s_ws[tid][sp] = wt;
      L += __ldcg(ml + 2 * sp + 1) * wt;
    }
    s_L[tid] = L;
  }
  __syncthreads();
  for (int e = tid; e < gn * DH; e += THREADS) {
    const int g = e / DH, d = e % DH;
    const float* pa = ws_acc + ((size_t)b * H + h0 + g) * NS * DH + d;
    float a = 0.f;
    for (int sp = 0; sp < NS; ++sp) a = fmaf(__ldcg(pa + (size_t)sp * DH), s_ws[g][sp], a);
    o[((size_t)b * H + h0 + g) * DH + d] = from_f<T>(a / fmaxf(s_L[g], 1e-30f));
  }
  if (tid == 0) counters[unit] = 0;  // ready for the next launch
}

struct Args {
  const void *q, *k, *v;
  const int* lengths;
  void* o;
  float* ws;
  int* counters;
  int B, S, H, KH, NS, rows_per_split, window;
  float softcap, scale;
};

template <typename T, int DH, int GM>
int launch(const Args& a, cudaStream_t st) {
  const int G = a.H / a.KH;
  const int HC = (G + GM - 1) / GM;
  const dim3 grid((unsigned)a.B * (unsigned)a.KH * (unsigned)HC, (unsigned)a.NS);
  decode_fwd<T, DH, GM><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.lengths, static_cast<T*>(a.o), a.ws, a.counters, a.S, a.H, a.KH, HC,
      a.rows_per_split, a.window, a.softcap, a.scale);
  return (int)cudaGetLastError();
}

// heads per block: the group G rounded up to 1, 2, 4 or 8 (4 above Dh 128,
// kernel.max_heads); larger groups take ceil(G / GM) head chunks of GM
template <typename T, int DH>
int dispatch_g(const Args& a, cudaStream_t st) {
  const int G = a.H / a.KH;
  if (G <= 1) return launch<T, DH, 1>(a, st);
  if (G <= 2) return launch<T, DH, 2>(a, st);
  if constexpr (DH > 128) {
    return launch<T, DH, 4>(a, st);
  } else {
    if (G <= 4) return launch<T, DH, 4>(a, st);
    return launch<T, DH, 8>(a, st);
  }
}

template <typename T>
int dispatch_dh(const Args& a, int Dh, cudaStream_t st) {
  switch (Dh) {
    case 16: return dispatch_g<T, 16>(a, st);
    case 32: return dispatch_g<T, 32>(a, st);
    case 64: return dispatch_g<T, 64>(a, st);
    case 128: return dispatch_g<T, 128>(a, st);
    case 224: return dispatch_g<T, 224>(a, st);
    case 256: return dispatch_g<T, 256>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, H, Dh], k/v [B, S, KH, Dh], o [B, H, Dh], all contiguous, 16-byte
// aligned and of one dtype (0 = float32, 1 = bfloat16); lengths [B] int32;
// Dh in {16, 32, 64, 128, 224, 256}; H % KH == 0; window 0 = none; softcap
// 0 = none.
// ns splits of rows_per_split rows (a multiple of 64, 1 <= ns <= 64,
// ns * rows_per_split >= S). With ns > 1: ws holds B * H * ns * (Dh + 2)
// floats and counters B * H ints (one per (b, KV head, head chunk) is used),
// all 0 on entry and left 0.
// Launches on `stream` and returns cudaGetLastError().
int decode_attention_launch(const void* q, const void* k, const void* v, const int* lengths,
                            void* o, void* ws, void* counters, int B, int S, int H, int KH,
                            int Dh, int dtype, int ns, int rows_per_split, int window,
                            float softcap, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ns < 1 || ns > MAX_SPLITS || rows_per_split % TILE != 0 ||
      (size_t)ns * rows_per_split < (size_t)S || (ns > 1 && (!ws || !counters)))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, lengths, o, static_cast<float*>(ws), static_cast<int*>(counters),
               B, S, H, KH, ns, rows_per_split, window, softcap, scale};
  if (dtype == 0) return dispatch_dh<float>(a, Dh, st);
  if (dtype == 1) return dispatch_dh<__nv_bfloat16>(a, Dh, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
