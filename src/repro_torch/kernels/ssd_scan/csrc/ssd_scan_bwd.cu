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
//   (b) ssd_bwd_chunk_sums: local_c = sum_l exp(cs[l]) dy[l] (x) C[l];
//   (c) ssd_bwd_state_pass: G_c = local_c + exp(cs[last]) G_{c+1}, and
//       <G_{c+1}, S_c> for the last step's d(cs);
//   (d) ssd_bwd_rows, per 64-row tile: dC[l] = exp(cs[l]) dy[l] S_c
//       + sum_{s<=l} (dy[l].x[s]) decay dt[s] B[s], and the row terms of d(cs);
//       ssd_bwd_cols, per 64-column tile: dx[s] = sum_{l>=s} scores[l, s] dy[l]
//       + D dy[s] + w[s] G_{c+1} B[s], dB[s] = sum_{l>=s} (dy[l].x[s]) decay
//       dt[s] C[l] + w[s] x[s] G_{c+1}, the column terms of d(cs) and ddt, and
//       a partial dD; ssd_bwd_dt, per (b, c, h): d(cs) from those terms,
//       its reverse cumsum, ddt = the direct terms + A revcumsum, partial dA;
//   (e) ssd_bwd_reduce: dB and dC summed over a group's heads in head order,
//       dA and dD over (b, chunk) in order.
// The [L, L] tiles are recomputed where they are needed (C B^T over N and
// dy x^T over P, once by the row blocks, once by the column blocks), never
// stored; the row kernel reads them row-major, the column kernel
// column-major. The decay is masked above the diagonal before its exp, where
// cs[l] - cs[s] > 0 could overflow. A ragged last chunk has Lc < L steps:
// steps past Lc load as zeros with dt = 0, write nothing, and the last step's
// terms sit at Lc - 1.
//
// Routes and numbers. Every product is float32 FMAs on the CUDA cores, for
// float32 and bfloat16 inputs alike (bf16 inputs are widened as they are
// staged): a 256-thread block holds a 4 x 4 register tile of a [64 x 64]
// score tile (rows tr + 16 i, columns tc + 16 j, tr = tid / 16, tc = tid % 16)
// and 4 rows x P / 16 or N / 16 columns of its gradient accumulators; tiles
// are float32 rows padded to an odd width, so that 16 rows read at one column
// fall in 16 banks. Determinism: each output element is written by one block,
// every sum runs in one fixed order, and there are no atomics, so two calls
// give the same bits (a checkpoint restart on the card resumes exactly).
//
// Bound on an H100. At mamba2-1.3b's training shape (B 8, S 512, H 64, P 64,
// N 128, chunk 256: two chunks) the work on the causal pairs is 47.5 GFLOP
// a call (chip_smoke.py `ssd_bwd_flops`) against 31 MB of inputs and
// outputs: bound by operations (0.048 ms at the bf16 tensor-core rate, 0.71
// ms at the FP32 rate). These kernels do about twice that work (C B^T and
// dy x^T in both tile kernels, whole 64 x 64 tiles on the diagonal) on the
// FP32 route, which gives float32 callers float32 exactness; tensor cores
// and one fused rows/columns pass are later work.
//
// Takes P in {16, 32, 64, 128} (accumulators 64 or 128 wide), N <= 256
// (accumulators 64, 128 or 256 wide), H % G == 0; returns
// cudaErrorInvalidValue on anything else and ERR_SHARED_MEMORY where one
// block's tiles do not fit the device's shared memory, launching nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;      // steps of a row or column tile
constexpr int THREADS = 256;  // the tile kernels' blocks
constexpr int LDT = TILE + 1; // padded row of a [64 x 64] score tile
constexpr unsigned FULL = 0xffffffffu;
constexpr int ERR_SHARED_MEMORY = -1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

struct Dims {
  int B, S, H, G, P, N, L, nc, nt;  // nt: 64-step tiles a chunk
};

__host__ __device__ inline int lpad_of(const Dims& d) { return d.nt * TILE; }

// One (b, chunk, head) block's position.
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

// cs[l] = A (dt[0] + ... + dt[l]) and dts[l] = dt[l] for l < Lc, by warp 0:
// each lane a run of consecutive steps, then the runs' prefix across the lanes,
// the same code and order in every kernel. Steps Lc .. lpad - 1 get dt = 0 and
// the last cs. Ends with the block synchronised.
__device__ void chunk_cumsum(const float* __restrict__ dtp, int H, float A, int Lc, int lpad,
                             float* cs, float* dts) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (Lc + 31) / 32;
    const int lo = min(lane * per, Lc), hi = min(lo + per, Lc);
    float run = 0.f;
    for (int l = lo; l < hi; ++l) {
      const float d = dtp[(size_t)l * H];
      dts[l] = d;
      run += d * A;
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
// holds THREADS / 32 floats of shared memory.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < THREADS / 32; ++w) t += red[w];
  return t;
}

// Stage rows t0 + r0 .. + 63 of one head's (or group's) [.., width] rows
// (src at step t0, rows `stride` elements apart) into a [64][ld] float tile;
// rows at or past Lc and columns past `width` are zeros, up to `cols`.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* __restrict__ src,
                                      size_t stride, int r0, int Lc, int width, int cols) {
  for (int e = threadIdx.x; e < TILE * cols; e += THREADS) {
    const int r = e / cols, col = e % cols;
    const bool in = r0 + r < Lc && col < width;
    dst[r * ld + col] = in ? to_f(src[(size_t)(r0 + r) * stride + col]) : 0.f;
  }
}

// (a), (b): one block per (b, chunk, head) and 64-wide slice of P. own[p, n] =
// sum_s w[s] x[s, p] B[s, n], loc[p, n] = sum_l exp(cs[l]) dy[l, p] C[l, n];
// dec = exp(cs[last]).
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_chunk_sums(const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
                   const T* __restrict__ dy, const float* __restrict__ dt,
                   const float* __restrict__ A, float* __restrict__ own, float* __restrict__ loc,
                   float* __restrict__ dec, Dims d) {
  constexpr int NP = 16 * NJ;
  extern __shared__ float smem[];
  const int lp = lpad_of(d);
  float* cs = smem;
  float* dts = cs + lp;
  float* wgt = dts + lp;
  float* ecs = wgt + lp;
  float* xw = ecs + lp;        // [TILE][LDT]
  float* dye = xw + TILE * LDT;  // [TILE][LDT]
  float* bt = dye + TILE * LDT;  // [TILE][NP]
  float* ct = bt + TILE * NP;    // [TILE][NP]

  const int bch = blockIdx.x;
  const Chunk k = chunk_of(bch, d);
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int p0 = blockIdx.y * TILE, pw = min(TILE, d.P - p0);
  const size_t xrow = (size_t)d.H * d.P, brow = (size_t)d.G * d.N;
  const size_t xoff = ((size_t)k.b * d.S + k.t0) * xrow + (size_t)k.h * d.P + p0;
  const size_t boff = ((size_t)k.b * d.S + k.t0) * brow + (size_t)k.g * d.N;
  chunk_cumsum(dt + ((size_t)k.b * d.S + k.t0) * d.H + k.h, d.H, A[k.h], k.Lc, lp, cs, dts);
  const float last = cs[k.Lc - 1];
  for (int l = tid; l < lp; l += THREADS) {
    wgt[l] = expf(last - cs[l]) * dts[l];
    ecs[l] = expf(cs[l]);
  }
  if (blockIdx.y == 0 && tid == 0) dec[bch] = expf(last);

  float ax[4][NJ], ay[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) ax[i][j] = ay[i][j] = 0.f;

  for (int s0 = 0; s0 < k.Lc; s0 += TILE) {
    __syncthreads();  // wgt/ecs are in; the previous tile's readers are done
    for (int e = tid; e < TILE * TILE; e += THREADS) {
      const int r = e / TILE, col = e % TILE, s = s0 + r;
      const bool in = s < k.Lc && col < pw;
      const size_t at = xoff + (size_t)s * xrow + col;
      xw[r * LDT + col] = in ? to_f(x[at]) * wgt[s] : 0.f;
      dye[r * LDT + col] = in ? to_f(dy[at]) * ecs[s] : 0.f;
    }
    stage(bt, NP, Bm + boff, brow, s0, k.Lc, d.N, NP);
    stage(ct, NP, Cm + boff, brow, s0, k.Lc, d.N, NP);
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < TILE; ++r) {
      float a[4], e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = xw[r * LDT + tr + 16 * i];
        e[i] = dye[r * LDT + tr + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float bv = bt[r * NP + tc + 16 * j], cv = ct[r * NP + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ax[i][j] = fmaf(a[i], bv, ax[i][j]);
          ay[i][j] = fmaf(e[i], cv, ay[i][j]);
        }
      }
    }
  }
  const size_t base = (size_t)bch * d.P * d.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + tr + 16 * i;
    if (p - p0 >= pw) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = tc + 16 * j;
      if (n >= d.N) continue;
      own[base + (size_t)p * d.N + n] = ax[i][j];
      loc[base + (size_t)p * d.N + n] = ay[i][j];
    }
  }
}

// (a), (c): one block per (b, head), a thread per state element at a time.
// st[c] = S_c (st[0] = 0), gn[c] = G_{c+1} (gn[nc - 1] = dstate or 0),
// gsum[c] = <G_{c+1}, S_c>.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_state_pass(const float* __restrict__ own, const float* __restrict__ loc,
                   const float* __restrict__ dec, const float* __restrict__ dstate,
                   float* __restrict__ st, float* __restrict__ gn, float* __restrict__ gsum,
                   Dims d) {
  __shared__ float red[THREADS / 32];
  const int b = blockIdx.x / d.H, h = blockIdx.x % d.H;
  const size_t pn = (size_t)d.P * d.N;
  auto base = [&](int c) { return ((size_t)(b * d.nc + c) * d.H + h) * pn; };
  auto bch = [&](int c) { return (b * d.nc + c) * d.H + h; };
  for (int c = 0; c < d.nc; ++c) {
    for (size_t e = threadIdx.x; e < pn; e += THREADS)
      st[base(c) + e] = c ? dec[bch(c - 1)] * st[base(c - 1) + e] + own[base(c - 1) + e] : 0.f;
  }
  for (int c = d.nc - 1; c >= 0; --c) {
    float part = 0.f;
    for (size_t e = threadIdx.x; e < pn; e += THREADS) {
      float g;
      if (c == d.nc - 1)
        g = dstate ? dstate[((size_t)b * d.H + h) * pn + e] : 0.f;
      else
        g = loc[base(c + 1) + e] + dec[bch(c + 1)] * gn[base(c + 1) + e];
      gn[base(c) + e] = g;
      part = fmaf(g, st[base(c) + e], part);
    }
    const float tot = block_sum(part, red);
    if (threadIdx.x == 0) gsum[bch(c)] = tot;
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

// (d), rows: one block per (b, chunk, head, 64-row tile l0..). dCh[l] (per
// head, float32) = exp(cs[l]) dy[l] S_c + sum_{s <= l} dcb[l, s] B[s] with
// dcb = (dy[l] . x[s]) decay dt[s]; rs[l] = exp(cs[l]) C[l] . (dy[l] S_c)
// + sum_s dcb[l, s] (C[l] . B[s]), the row terms of d(cs[l]).
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_rows(const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
             const T* __restrict__ dy, const float* __restrict__ dt,
             const float* __restrict__ A, const float* __restrict__ st,
             float* __restrict__ dCh, float* __restrict__ rs, Dims d) {
  constexpr int LDN = ld_n<NJ>();
  const int LDP = d.P + 1;
  extern __shared__ float smem[];
  const int lp = lpad_of(d);
  float* cs = smem;
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
  stage(ct, LDN, Cm + boff, brow, l0, k.Lc, d.N, 16 * NJ);
  stage(dyt, LDP, dy + xoff, xrow, l0, k.Lc, d.P, d.P);
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
    stage(bt, LDN, Bm + boff, brow, s0, k.Lc, d.N, 16 * NJ);
    stage(xt, LDP, x + xoff, xrow, s0, k.Lc, d.P, d.P);
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

// (d), columns: one block per (b, chunk, head, 64-column tile s0..). With
// scores = (C[l] . B[s]) decay dt[s] and dcb = (dy[l] . x[s]) decay dt[s]
// over l >= s: dx[s] = sum_l scores dy[l] + D dy[s] + w[s] G_{c+1} B[s];
// dBh[s] (per head, float32) = sum_l dcb C[l] + w[s] x[s] G_{c+1};
// cm[s] = sum_l (dy[l] . x[s]) (C[l] . B[s]) decay (ddt's direct term, and
// dt[s] cm[s] is d(cs)'s column term); qv[s] = x[s] . G_{c+1} B[s]; the
// tile's partial dD = sum dy . x. P is padded with zeros to 16 PJ columns.
template <typename T, int PJ, int NJ>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_cols(const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
             const T* __restrict__ dy, const float* __restrict__ dt,
             const float* __restrict__ A, const float* __restrict__ Dp,
             const float* __restrict__ gn, T* __restrict__ dx, float* __restrict__ dBh,
             float* __restrict__ cm, float* __restrict__ qv, float* __restrict__ ddp, Dims d) {
  constexpr int LDN = ld_n<NJ>();
  constexpr int LDP = 16 * PJ + 1;
  extern __shared__ float smem[];
  const int lp = lpad_of(d);
  float* cs = smem;
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
  stage(bt, LDN, Bm + boff, brow, s0, k.Lc, d.N, 16 * NJ);
  stage(xt, LDP, x + xoff, xrow, s0, k.Lc, d.P, 16 * PJ);

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
    stage(ct, LDN, Cm + boff, brow, l0, k.Lc, d.N, 16 * NJ);
    stage(dyt, LDP, dy + xoff, xrow, l0, k.Lc, d.P, 16 * PJ);
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

  // the state terms: G_{c+1} [P, N] staged over the row tiles
  __syncthreads();
  const float* g = gn + (size_t)bch * d.P * d.N;
  for (int e = tid; e < 16 * PJ * 16 * NJ; e += THREADS) {
    const int p = e / (16 * NJ), n = e % (16 * NJ);
    gs[p * LDN + n] = p < d.P && n < d.N ? g[(size_t)p * d.N + n] : 0.f;
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
           const float* __restrict__ qv, const float* __restrict__ gsum,
           float* __restrict__ ddt, float* __restrict__ dap, Dims d) {
  extern __shared__ float smem[];
  const int lp = lpad_of(d);
  float* cs = smem;
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
  if (lo < hi && hi == k.Lc) dcs[k.Lc - 1] += expf(last) * gsum[bch] + wq;
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

// (e): blocks below nblk sum dB and dC over a group's heads (a thread per
// [B, S, G, N] element, heads in order); the last block sums dA and dD over
// (b, chunk) in order, a thread per head.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce(const float* __restrict__ dBh, const float* __restrict__ dCh,
               const float* __restrict__ dap, const float* __restrict__ ddp,
               T* __restrict__ dB, T* __restrict__ dC, float* __restrict__ dA,
               float* __restrict__ dD, Dims d, int nblk) {
  if ((int)blockIdx.x < nblk) {
    const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
    if (e >= (size_t)d.B * d.S * d.G * d.N) return;
    const int n = (int)(e % d.N), g = (int)((e / d.N) % d.G);
    const size_t bt = e / ((size_t)d.N * d.G);
    const int rep = d.H / d.G;
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < rep; ++r) {
      const size_t at = (bt * d.H + (size_t)g * rep + r) * d.N + n;
      sb += dBh[at];
      sc += dCh[at];
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

// The float32 workspace, carved in this order.
struct Work {
  float *own, *st, *loc, *gn;  // [B][nc][H][P][N] each
  float *dec, *gsum, *dap;     // [B][nc][H]
  float *ddp;                  // [B][nc][H][nt]
  float *dBh, *dCh;            // [B][S][H][N]
  float *rs, *cm, *qv;         // [B][S][H]
  size_t floats;
};

Work carve(float* base, const Dims& d) {
  Work w;
  const size_t bch = (size_t)d.B * d.nc * d.H, pn = (size_t)d.P * d.N;
  const size_t bsh = (size_t)d.B * d.S * d.H;
  size_t off = 0;
  auto take = [&](size_t n) {
    float* q = base ? base + off : nullptr;
    off += n;
    return q;
  };
  w.own = take(bch * pn);
  w.st = take(bch * pn);
  w.loc = take(bch * pn);
  w.gn = take(bch * pn);
  w.dec = take(bch);
  w.gsum = take(bch);
  w.dap = take(bch);
  w.ddp = take(bch * d.nt);
  w.dBh = take(bsh * d.N);
  w.dCh = take(bsh * d.N);
  w.rs = take(bsh);
  w.cm = take(bsh);
  w.qv = take(bsh);
  w.floats = off;
  return w;
}

Dims dims_of(int B, int S, int H, int G, int P, int N, int L) {
  Dims d{B, S, H, G, P, N, L, (S + L - 1) / L, (L + TILE - 1) / TILE};
  return d;
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
};

template <typename T, int PJ, int NJ>
int run(const Args& a, const Dims& d, cudaStream_t st) {
  constexpr int LDN = ld_n<NJ>();
  const int lp = lpad_of(d);
  const size_t sums = ((size_t)4 * lp + 2 * TILE * LDT + 2 * TILE * 16 * NJ) * sizeof(float);
  const size_t rows = rows_smem(d, LDN), cols = cols_smem(d, LDN, 16 * PJ);
  const size_t dts = (size_t)3 * lp * sizeof(float);
  int limit = 0;
  if (int err = smem_limit(&limit)) return err;
  if (sums > (size_t)limit || rows > (size_t)limit || cols > (size_t)limit || dts > (size_t)limit)
    return ERR_SHARED_MEMORY;
  if (int err = allow_smem(ssd_bwd_chunk_sums<T, NJ>, sums)) return err;
  if (int err = allow_smem(ssd_bwd_rows<T, NJ>, rows)) return err;
  if (int err = allow_smem(ssd_bwd_cols<T, PJ, NJ>, cols)) return err;
  if (int err = allow_smem(ssd_bwd_dt, dts)) return err;

  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.Bm);
  const T* Cm = static_cast<const T*>(a.Cm);
  const T* dy = static_cast<const T*>(a.dy);
  const Work& w = a.w;
  const unsigned bch = (unsigned)(d.B * d.nc * d.H);
  ssd_bwd_chunk_sums<T, NJ><<<dim3(bch, (d.P + TILE - 1) / TILE), THREADS, sums, st>>>(
      x, Bm, Cm, dy, a.dt, a.A, w.own, w.loc, w.dec, d);
  if (int err = (int)cudaGetLastError()) return err;
  ssd_bwd_state_pass<<<(unsigned)(d.B * d.H), THREADS, 0, st>>>(w.own, w.loc, w.dec, a.dstate,
                                                                 w.st, w.gn, w.gsum, d);
  if (int err = (int)cudaGetLastError()) return err;
  ssd_bwd_rows<T, NJ><<<bch * d.nt, THREADS, rows, st>>>(x, Bm, Cm, dy, a.dt, a.A, w.st, w.dCh,
                                                          w.rs, d);
  if (int err = (int)cudaGetLastError()) return err;
  ssd_bwd_cols<T, PJ, NJ><<<bch * d.nt, THREADS, cols, st>>>(
      x, Bm, Cm, dy, a.dt, a.A, a.D, w.gn, static_cast<T*>(a.dx), w.dBh, w.cm, w.qv, w.ddp, d);
  if (int err = (int)cudaGetLastError()) return err;
  ssd_bwd_dt<<<bch, 32, dts, st>>>(a.dt, a.A, w.rs, w.cm, w.qv, w.gsum, a.ddt, w.dap, d);
  if (int err = (int)cudaGetLastError()) return err;
  const size_t elems = (size_t)d.B * d.S * d.G * d.N;
  const int nblk = (int)((elems + THREADS - 1) / THREADS);
  ssd_bwd_reduce<T><<<(unsigned)nblk + 1, THREADS, 0, st>>>(
      w.dBh, w.dCh, w.dap, w.ddp, static_cast<T*>(a.dB), static_cast<T*>(a.dC), a.dA, a.dD, d,
      nblk);
  return (int)cudaGetLastError();
}

// N and P go to the next of a few accumulator widths (N: 64, 128, 256; P: 64,
// 128), padded with zeros: fewer instantiations keep this library's build
// below the forward's
template <typename T, int PJ>
int by_n(const Args& a, const Dims& d, cudaStream_t st) {
  if (d.N <= 64) return run<T, PJ, 4>(a, d, st);
  if (d.N <= 128) return run<T, PJ, 8>(a, d, st);
  return run<T, PJ, 16>(a, d, st);
}

template <typename T>
int by_p(const Args& a, const Dims& d, cudaStream_t st) {
  return d.P <= 64 ? by_n<T, 4>(a, d, st) : by_n<T, 8>(a, d, st);
}

bool valid(int B, int S, int H, int G, int P, int N, int L) {
  return B > 0 && S > 0 && H > 0 && G > 0 && H % G == 0 && N > 0 && N <= 256 && L > 0 &&
         L <= S && (P == 16 || P == 32 || P == 64 || P == 128);
}

}  // namespace

extern "C" {

// Bytes of the float32 workspace ssd_scan_bwd_launch takes (0 if the shapes
// are not taken).
long long ssd_scan_bwd_workspace_bytes(int B, int S, int H, int G, int P, int N, int L) {
  if (!valid(B, S, H, G, P, N, L)) return 0;
  return (long long)(carve(nullptr, dims_of(B, S, H, G, P, N, L)).floats * sizeof(float));
}

// x, dy [B, S, H, P], Bm, Cm [B, S, G, N] of one dtype (0 = float32, 1 =
// bfloat16), dt [B, S, H], A, D [H] float32, dstate [B, H, P, N] float32 or
// null (zero), all contiguous; L = min(chunk, S). Writes dx [B, S, H, P] and
// dB, dC [B, S, G, N] in the inputs' dtype, ddt [B, S, H], dA, dD [H] float32;
// ws holds ssd_scan_bwd_workspace_bytes. Six launches on `stream`. Returns 0,
// ERR_SHARED_MEMORY (-1) or a cudaError_t; on a refusal before the first
// launch nothing is launched.
int ssd_scan_bwd_launch(const void* x, const void* Bm, const void* Cm, const void* dt,
                        const void* A, const void* D, const void* dy, const void* dstate,
                        void* dx, void* dB, void* dC, void* ddt, void* dA, void* dD, void* ws,
                        int B, int S, int H, int G, int P, int N, int L, int dtype,
                        void* stream) {
  if (!valid(B, S, H, G, P, N, L) || ws == nullptr) return (int)cudaErrorInvalidValue;
  const Dims d = dims_of(B, S, H, G, P, N, L);
  Args a{x, Bm, Cm, dy,
         static_cast<const float*>(dt), static_cast<const float*>(A),
         static_cast<const float*>(D), static_cast<const float*>(dstate),
         dx, dB, dC,
         static_cast<float*>(ddt), static_cast<float*>(dA), static_cast<float*>(dD),
         carve(static_cast<float*>(ws), d)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_p<float>(a, d, st);
  if (dtype == 1) return by_p<bf16>(a, d, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
