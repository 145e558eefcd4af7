// Mamba2 SSD chunked scan for one H100, chunks in parallel on the tensor cores.
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
// Bound on an H100. The scan moves x in and y out (2 * S * H * P elements),
// B and C once per group, dt and the final state; its products (the causal
// C B^T per group, and per head the scores times x, C times the carried
// state and the chunk's state update) are ~6.5 GFLOP at S = 2048, H = 64,
// P = 64, N = 128: at the bf16 tensor-core rate that is 0.0066 ms against
// 0.0111 ms for the 37 MB, so the scan is bound by bytes. At the engine's
// S = 32 it is ~2.7 MB, about a microsecond: launches dominate there.
//
// Design: Mamba2's own chunked form (Dao & Gu 2024, the state-space duality
// algorithm), with the chunks in parallel, as three kinds of blocks:
//   - ssd_chunk state blocks, one per (b, chunk, head, P-slice, 32 * WQ state
//     columns): the chunk's own state contribution, sum_s (x[s] w[s]) (x) B[s]
//     with w[s] = exp(cs[last] - cs[s]) dt[s], one [P, L] x [L, N] product.
//   - ssd_state_pass, one thread per (b, h, p, n): the recurrence over chunks,
//     S_c = S_{c-1} exp(cs[last]_{c-1}) + contrib_{c-1}, from a float32
//     workspace; it writes each chunk's starting state as the bf16 parts the
//     output blocks multiply by, and the last S as the final state.
//   - ssd_chunk output blocks, one per (b, chunk, head, P-slice, 16 * WQ query
//     rows, the longest first): exp(cs) C S_start, then per key tile up to the
//     diagonal C B^T -> decay, dt and the causal mask -> times x, then D x.
//   One chunk (S <= L, every engine prefill) is one launch of ssd_chunk with
//   both kinds of blocks, the state blocks writing the final state; more
//   chunks are three launches: state blocks, the state pass, output blocks.
//   Blocks never wait on each other. The planner (kernel.py `plan`) takes 2
//   warps when L <= 32, so that no query row is dead at the engine's S = 32,
//   and cuts P into slices until one chunk gives 128 output blocks.
//   Every product runs as mma.sync m16n8k16 bf16 with a float32 accumulator,
//   operands through ldmatrix from padded shared tiles (a row is an odd
//   number of 16-byte units, so ldmatrix is free of bank conflicts). A
//   float32 operand is split into bf16 parts (v = hi + lo (+ lo2)): the
//   products of parts whose indices sum below the larger part count are
//   taken, each into the same float32 accumulator. With bf16 inputs, C B^T is
//   exact (bf16 x bf16 into float32); the scores, the carried state and x w
//   are float32 and take two parts (~16 bits). With float32 inputs every
//   operand takes three parts (~24 bits).
//   What the measurements taught (PERF.md): the blocks are bound by the
//   latency of their loads, not by the tensor cores. So bf16 tiles arrive by
//   cp.async, all of a tile in flight at once, and the loads that need no cs
//   are issued before the cumsum; other loads keep four 16-byte loads a
//   thread in flight before they store; state blocks stage their float32
//   result in shared memory and leave in whole rows; the launch bounds hold
//   state launches to 5 blocks and output launches to 4 blocks an SM.
//   The cumsum is a block-wide warp scan, the same code and order in every
//   block. Groups are read where they lie; C B^T is recomputed per head (one
//   [16 x 16 * WQ] tile per warp and key tile) rather than kept in a
//   workspace: its operands are in shared memory already, and a float32
//   [L, L] tile per group would be read back by every head.
//   The ragged last chunk: steps past S load as zeros, cs ends at the last
//   live step, w and the scores of padded steps are zero, their rows are not
//   written. No atomics: two calls give bitwise the same outputs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// state columns per state block: 4 n8 tiles per warp
__host__ __device__ constexpr int state_cols(int wq) { return 32 * wq; }

// ssd_scan_launch's return value when one block's tiles do not fit the
// device's shared memory (every other non-zero value is a cudaError_t)
constexpr int ERR_SHARED_MEMORY = -1;

template <typename T> struct Parts;  // bf16 parts of an input and of a float32 operand
template <> struct Parts<float> { static constexpr int IN = 3, F = 3; };
template <> struct Parts<bf16> { static constexpr int IN = 1, F = 2; };

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Shared memory of one ssd_chunk block: float32 cs[L], dt[L], w[BK] and the
// scan's warp totals, then the bf16 tiles (element offsets from `tiles`).
// A y block holds C [NPI][BQ][LDN] and then either the carried state
// [NPF][PS][LDN] or a key tile of B [NPI][BK][LDN] and x [NPI][BK][LDP]; a
// state block holds x w [NPF][BK][LDP] and B [NPI][BK][NG + 8], and at its end
// stages its float32 state [PS][NG + 4] over them, so that it leaves in whole
// rows of 16-byte stores.
struct Layout {
  size_t tiles;  // byte offset of the bf16 tiles
  size_t c, u, bt, xt;  // y block: C, the union, B and x tiles
  size_t xw, bs;        // state block
  size_t y_bytes, state_bytes;  // a launch of y blocks only, of state blocks only
  size_t bytes;                 // a launch of both
};

template <typename T, int WQ, int PS>
__host__ __device__ inline Layout layout(int npad, int L) {
  constexpr int NPI = Parts<T>::IN, NPF = Parts<T>::F;
  constexpr int BQ = 16 * WQ, BK = BQ, LDP = PS + 8;
  const size_t ldn = (size_t)npad + 8;
  Layout o;
  const size_t nf = ((size_t)2 * L + BK + 32 + 7) / 8 * 8;
  o.tiles = nf * 4;
  o.c = 0;
  o.u = NPI * BQ * ldn;
  o.bt = o.u;
  o.xt = o.u + NPI * BK * ldn;
  const size_t y_end = o.u + cmax((int)(NPF * PS * ldn), (int)(NPI * BK * (ldn + LDP)));
  o.xw = 0;
  o.bs = (size_t)NPF * BK * LDP;
  const size_t st_end = cmax((int)(o.bs + (size_t)NPI * BK * (state_cols(WQ) + 8)),
                             2 * PS * (state_cols(WQ) + 4));  // or the state's staging
  o.y_bytes = o.tiles + 2 * y_end;
  o.state_bytes = o.tiles + 2 * st_end;
  o.bytes = o.y_bytes > o.state_bytes ? o.y_bytes : o.state_bytes;
  return o;
}

struct Args {
  const void* x;
  const void* Bm;
  const void* Cm;
  const float* dt;
  const float* A;
  const float* D;
  void* y;
  float* st_out;       // state blocks write here: [B][nc][H][P][N]
  float* dec_out;      // exp(cs[last]) per (b, chunk, h), or null
  const bf16* st_in;   // each chunk's starting state in bf16 parts [B][nc][H][NPF][P][N],
                       // or null (zero)
  int S, H, G, P, N, npad, L, nc, nqt, nng, vec_x, vec_bc;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(const bf16* p, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(const bf16* p, uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
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

// Two n8 accumulator tiles (keys k..k+7, k+8..k+15 of a warp's 16 rows) as
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
__device__ __forceinline__ void cp_async16(bf16* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}
// every cp.async of this thread has landed (a __syncthreads makes them the block's)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Rows [0, rows) and columns [0, cols) of a row-major source (row r at
// src + r * stride) into NP bf16 parts at dst[part * pstride + r * ld + col]:
// live where r < r_live and col < c_live, zero elsewhere; each row times
// rscale[r] when given. `vec`: the rows are 16-byte aligned. A bf16 source
// taken as it is (one part, no scale) is copied by cp.async, all in flight
// at once (cp_async_wait_all before the __syncthreads that publishes it);
// else each thread has 4 loads of 8 elements in flight, then splits them.
template <int NP, typename T>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, size_t pstride, const T* src,
                                          size_t stride, int rows, int r_live, int cols,
                                          int c_live, bool vec, const float* rscale, int tid,
                                          int nt) {
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

// cs[i] = sum_{s <= i} dt[s] * a and dts[i] = dt[s] for i < lc: a warp scan
// per NT steps, the warps' totals added in order, a running carry.
template <int NT>
__device__ __forceinline__ void chunk_cumsum(float* cs, float* dts, float* tot,
                                             const float* dtb, int H, float a, int lc) {
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float carry = 0.f;
  for (int base = 0; base < lc; base += NT) {
    const int i = base + tid;
    const float d = i < lc ? dtb[(size_t)i * H] : 0.f;
    float v = __fmul_rn(d, a);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v = __fadd_rn(v, u);
    }
    if (lane == 31) tot[warp] = v;
    __syncthreads();
    float pre = carry;
    for (int w = 0; w < warp; ++w) pre = __fadd_rn(pre, tot[w]);
    float all = carry;
#pragma unroll
    for (int w = 0; w < NW; ++w) all = __fadd_rn(all, tot[w]);
    if (i < lc) {
      cs[i] = __fadd_rn(pre, v);
      dts[i] = d;
    }
    carry = all;
    __syncthreads();
  }
}

// Which blocks a launch of ssd_chunk holds: both kinds (one chunk), state
// blocks only, or output blocks only. The mode is a template argument, so
// each launch's kernel carries only its blocks' code and registers.
constexpr int MODE_BOTH = 0, MODE_STATE = 1, MODE_OUT = 2;

// Blocks an SM holds at least, for the register budget: with bf16 inputs a
// state-only launch takes 5 (a few spilled registers, faster than 3 at its
// natural ~150) and an output-only launch 4 (128 registers, as many as its
// shared memory allows); the rest are left to the compiler.
template <typename T, int MODE>
constexpr int min_blocks() {
  return sizeof(T) != 2 ? 1 : MODE == MODE_STATE ? 5 : MODE == MODE_OUT ? 4 : 1;
}

template <typename T, int WQ, int PS, int MODE>
__global__ void __launch_bounds__(32 * WQ, (min_blocks<T, MODE>()))
ssd_chunk(const Args a) {
  constexpr int NT = 32 * WQ, BQ = 16 * WQ, BK = BQ;
  constexpr int NPI = Parts<T>::IN, NPF = Parts<T>::F, NPM = cmax(NPI, NPF);
  constexpr int LDP = PS + 8;
  const int ldn = a.npad + 8;
  const Layout lay = layout<T, WQ, PS>(a.npad, a.L);
  extern __shared__ __align__(16) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem);
  float* dts = cs + a.L;
  float* wb = dts + a.L;
  float* tot = wb + BK;
  bf16* tiles = reinterpret_cast<bf16*>(smem + lay.tiles);

  const int bch = blockIdx.x;  // (b * nc + chunk) * H + h
  const int h = bch % a.H;
  const int bc = bch / a.H;
  const int c = bc % a.nc;
  const int b = bc / a.nc;
  const int g = h / (a.H / a.G);
  const int p0 = blockIdx.z * PS;
  const int c0 = c * a.L;
  const int lc = min(a.L, a.S - c0);  // live steps of this chunk
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;  // an accumulator's row and column pair

  const size_t xs = (size_t)a.H * a.P;  // one step of x and y
  const size_t bs = (size_t)a.G * a.N;  // one step of Bm and Cm
  const size_t row0 = (size_t)b * a.S + c0;
  const T* xb = static_cast<const T*>(a.x) + row0 * xs + (size_t)h * a.P + p0;
  const T* Bb = static_cast<const T*>(a.Bm) + row0 * bs + (size_t)g * a.N;
  const T* Cb = static_cast<const T*>(a.Cm) + row0 * bs + (size_t)g * a.N;
  const size_t sofs = (size_t)bch * a.P * a.N + (size_t)p0 * a.N;

  const float* dtb = a.dt + row0 * a.H + h;

  if (MODE == MODE_STATE || (MODE == MODE_BOTH && (int)blockIdx.y < a.nng)) {
    // ---- state block: sum_s (x[s] w[s]) (x) B[s] over the chunk, NG columns
    constexpr int NG = state_cols(WQ), LDG = NG + 8;
    constexpr int NTW = NG / 8 / WQ;  // n8 tiles per warp
    const int n0 = blockIdx.y * NG;
    const int wn = warp * NTW * 8;  // this warp's first column in the group
    const bool active = n0 + wn < a.npad;
    bf16* sxw = tiles + lay.xw;
    bf16* sbs = tiles + lay.bs;
    constexpr size_t pxw = (size_t)BK * LDP, pbs = (size_t)BK * LDG;
    // the first B tile needs no cs: it is in flight during the cumsum
    load_tile<NPI>(sbs, LDG, pbs, Bb + n0, bs, BK, lc, NG, a.N - n0, a.vec_bc, nullptr, tid,
                   NT);
    chunk_cumsum<NT>(cs, dts, tot, dtb, a.H, a.A[h], lc);
    const float last = cs[lc - 1];
    float acc[PS / 16][NTW][4];
#pragma unroll
    for (int mt = 0; mt < PS / 16; ++mt)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

    for (int s0 = 0; s0 < lc; s0 += BK) {
      if (tid < BK) {
        const int s = s0 + tid;
        wb[tid] = s < lc ? expf(last - cs[s]) * dts[s] : 0.f;
      }
      __syncthreads();
      load_tile<NPF>(sxw, LDP, pxw, xb + s0 * xs, xs, BK, lc - s0, PS, PS, a.vec_x, wb, tid,
                     NT);
      if (s0 > 0)
        load_tile<NPI>(sbs, LDG, pbs, Bb + s0 * bs + n0, bs, BK, lc - s0, NG, a.N - n0,
                       a.vec_bc, nullptr, tid, NT);
      cp_async_wait_all();
      __syncthreads();
      if (active) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t xa[PS / 16][NPF][4];  // A = (x w)^T: rows p, k = steps
#pragma unroll
          for (int mt = 0; mt < PS / 16; ++mt)
#pragma unroll
            for (int ip = 0; ip < NPF; ++ip)
              ldsm_x4_t(sxw + ip * pxw + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * LDP +
                            mt * 16 + ((lane >> 3) & 1) * 8,
                        xa[mt][ip][0], xa[mt][ip][1], xa[mt][ip][2], xa[mt][ip][3]);
#pragma unroll
          for (int j = 0; j < NTW; j += 2) {
#pragma unroll
            for (int jp = 0; jp < NPI; ++jp) {
              uint32_t b0, b1, b2, b3;  // B: k = steps, columns n
              ldsm_x4_t(sbs + jp * pbs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDG +
                            wn + j * 8 + (lane >> 4) * 8,
                        b0, b1, b2, b3);
#pragma unroll
              for (int mt = 0; mt < PS / 16; ++mt)
#pragma unroll
                for (int ip = 0; ip < NPF; ++ip)
                  if (ip + jp < NPM) {
                    mma(acc[mt][j], xa[mt][ip], b0, b1);
                    mma(acc[mt][j + 1], xa[mt][ip], b2, b3);
                  }
            }
          }
        }
      }
      __syncthreads();
    }
    float* stage = reinterpret_cast<float*>(tiles);  // [PS][NG + 4], over the tiles
    if (active) {
#pragma unroll
      for (int mt = 0; mt < PS / 16; ++mt)
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(stage + (mt * 16 + gr + 8 * r) * (NG + 4) + wn + j * 8 +
                                       2 * tq) = make_float2(acc[mt][j][2 * r],
                                                             acc[mt][j][2 * r + 1]);
    }
    __syncthreads();
    const bool vec = (a.N & 3) == 0;
    for (int e = tid; e < PS * NG / 4; e += NT) {
      const int p = e / (NG / 4);
      const int n4 = (e - p * (NG / 4)) * 4;
      const int n = n0 + n4;
      if (n >= a.N) continue;
      const float* src = stage + p * (NG + 4) + n4;
      float* dst = a.st_out + sofs + (size_t)p * a.N + n;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
      } else {
        for (int i = 0; i < 4 && n + i < a.N; ++i) dst[i] = src[i];
      }
    }
    if (a.dec_out != nullptr && blockIdx.y == 0 && blockIdx.z == 0 && tid == 0)
      a.dec_out[bch] = expf(last);
    return;
  }

  // ---- y block: query rows [q0, q0 + BQ) of the chunk, the longest tiles first
  const int qt = a.nqt - 1 - ((int)blockIdx.y - a.nng);
  const int q0 = qt * BQ;
  if (q0 >= lc) return;  // a tile past the ragged chunk's end
  const int w0 = q0 + 16 * warp;  // this warp's first row
  const bool live = w0 < lc;
  const int ksteps = a.npad / 16;
  bf16* sc = tiles + lay.c;
  bf16* ss = tiles + lay.u;
  bf16* sb = tiles + lay.bt;
  bf16* sx = tiles + lay.xt;
  const size_t pc = (size_t)BQ * ldn, ps = (size_t)PS * ldn;
  const size_t pb = (size_t)BK * ldn, px = (size_t)BK * LDP;
  const bool carried = a.st_in != nullptr && c > 0;  // a starting state to apply
  auto load_keys = [&](int s0) {
    load_tile<NPI>(sb, ldn, pb, Bb + (size_t)s0 * bs, bs, BK, lc - s0, a.npad, a.N, a.vec_bc,
                   nullptr, tid, NT);
    load_tile<NPI>(sx, LDP, px, xb + (size_t)s0 * xs, xs, BK, lc - s0, PS, PS, a.vec_x,
                   nullptr, tid, NT);
  };
  // what needs no cs is in flight during the cumsum: C, and the starting
  // state or else the first key tile (the two share their shared memory)
  load_tile<NPI>(sc, ldn, pc, Cb + (size_t)q0 * bs, bs, BQ, lc - q0, a.npad, a.N, a.vec_bc,
                 nullptr, tid, NT);
  if (carried) {
    const size_t pn = (size_t)a.P * a.N;
#pragma unroll
    for (int ip = 0; ip < NPF; ++ip)  // the parts, already split by the state pass
      load_tile<1>(ss + ip * ps, ldn, ps, a.st_in + ((size_t)bch * NPF + ip) * pn + p0 * a.N,
                   (size_t)a.N, PS, PS, a.npad, a.N, (a.N & 7) == 0, nullptr, tid, NT);
  } else {
    load_keys(0);
  }
  chunk_cumsum<NT>(cs, dts, tot, dtb, a.H, a.A[h], lc);
  float yacc[PS / 8][4];
#pragma unroll
  for (int j = 0; j < PS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;

  if (carried) {  // exp(cs[l]) C[l] . S_start
    cp_async_wait_all();
    __syncthreads();
    if (live) {
      for (int kk = 0; kk < ksteps; ++kk) {
        uint32_t ca[NPI][4];
#pragma unroll
        for (int ip = 0; ip < NPI; ++ip)
          ldsm_x4(sc + ip * pc + (16 * warp + (lane & 15)) * ldn + kk * 16 + (lane >> 4) * 8,
                  ca[ip][0], ca[ip][1], ca[ip][2], ca[ip][3]);
#pragma unroll
        for (int j = 0; j < PS / 8; j += 2)
#pragma unroll
          for (int jp = 0; jp < NPF; ++jp) {
            uint32_t b0, b1, b2, b3;  // B: k = n, columns p (the state is [p][n])
            ldsm_x4(ss + jp * ps + (j * 8 + (lane & 7) + (lane >> 4) * 8) * ldn + kk * 16 +
                        ((lane >> 3) & 1) * 8,
                    b0, b1, b2, b3);
#pragma unroll
            for (int ip = 0; ip < NPI; ++ip)
              if (ip + jp < NPM) {
                mma(yacc[j], ca[ip], b0, b1);
                mma(yacc[j + 1], ca[ip], b2, b3);
              }
          }
      }
      const int l0 = w0 + gr;
      const float e0 = l0 < lc ? expf(cs[l0]) : 0.f;
      const float e1 = l0 + 8 < lc ? expf(cs[l0 + 8]) : 0.f;
#pragma unroll
      for (int j = 0; j < PS / 8; ++j) {
        yacc[j][0] *= e0;
        yacc[j][1] *= e0;
        yacc[j][2] *= e1;
        yacc[j][3] *= e1;
      }
    }
    __syncthreads();  // the state's readers are done before the key tiles reuse it
  }

  const int s_end = min(q0 + BQ, lc);
  for (int s0 = 0; s0 < s_end; s0 += BK) {  // key tiles up to the diagonal
    if (s0 > 0 || carried) load_keys(s0);
    cp_async_wait_all();
    __syncthreads();
    const int reach = w0 + 16 - s0;  // keys [s0, s0 + reach) can meet this warp's rows
    if (live && reach > 0) {
      float sacc[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
      for (int kk = 0; kk < ksteps; ++kk) {  // C B^T
        uint32_t ca[NPI][4];
#pragma unroll
        for (int ip = 0; ip < NPI; ++ip)
          ldsm_x4(sc + ip * pc + (16 * warp + (lane & 15)) * ldn + kk * 16 + (lane >> 4) * 8,
                  ca[ip][0], ca[ip][1], ca[ip][2], ca[ip][3]);
#pragma unroll
        for (int j = 0; j < BK / 8; j += 2) {
          if (8 * j >= reach) continue;
#pragma unroll
          for (int jp = 0; jp < NPI; ++jp) {
            uint32_t b0, b1, b2, b3;  // B: k = n, columns = keys (B is [s][n])
            ldsm_x4(sb + jp * pb + (j * 8 + (lane & 7) + (lane >> 4) * 8) * ldn + kk * 16 +
                        ((lane >> 3) & 1) * 8,
                    b0, b1, b2, b3);
#pragma unroll
            for (int ip = 0; ip < NPI; ++ip)
              if (ip + jp < NPI) {
                mma(sacc[j], ca[ip], b0, b1);
                mma(sacc[j + 1], ca[ip], b2, b3);
              }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)  // decay, dt and the causal mask
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = s0 + 8 * j + 2 * tq + (e & 1);
          const int l = w0 + gr + 8 * (e >> 1);
          const bool ok = s <= l && l < lc;
          const int si = ok ? s : 0, li = ok ? l : 0;  // in range where masked
          sacc[j][e] = ok ? sacc[j][e] * expf(cs[li] - cs[si]) * dts[si] : 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {  // scores times x
        if (16 * kk >= reach) continue;
        uint32_t pa[NPF][4];
        split_frag<NPF>(sacc[2 * kk], sacc[2 * kk + 1], pa);
#pragma unroll
        for (int j = 0; j < PS / 8; j += 2)
#pragma unroll
          for (int jp = 0; jp < NPI; ++jp) {
            uint32_t b0, b1, b2, b3;  // B: k = keys, columns p (x is [s][p])
            ldsm_x4_t(sx + jp * px + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDP +
                          j * 8 + (lane >> 4) * 8,
                      b0, b1, b2, b3);
#pragma unroll
            for (int ip = 0; ip < NPF; ++ip)
              if (ip + jp < NPM) {
                mma(yacc[j], pa[ip], b0, b1);
                mma(yacc[j + 1], pa[ip], b2, b3);
              }
          }
      }
    }
    __syncthreads();  // this tile's readers are done before the next one loads
  }

  if (live) {  // + D x, then y in x's dtype
    const float dh = a.D[h];
    T* yb = static_cast<T*>(a.y) + row0 * xs + (size_t)h * a.P + p0;
    float xv[2][PS / 8][2];  // every load before the first store: y may alias x for
#pragma unroll             // all the compiler knows, and would serialize them
    for (int r = 0; r < 2; ++r) {
      const int l = min(w0 + gr + 8 * r, lc - 1);
      const T* xl = xb + (size_t)l * xs;
#pragma unroll
      for (int j = 0; j < PS / 8; ++j) {
        xv[r][j][0] = to_f(xl[j * 8 + 2 * tq]);
        xv[r][j][1] = to_f(xl[j * 8 + 2 * tq + 1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int l = w0 + gr + 8 * r;
      if (l >= lc) continue;
      T* yl = yb + (size_t)l * xs;
#pragma unroll
      for (int j = 0; j < PS / 8; ++j)
        store2(yl + j * 8 + 2 * tq, yacc[j][2 * r] + dh * xv[r][j][0],
               yacc[j][2 * r + 1] + dh * xv[r][j][1]);
    }
  }
}

// The recurrence over chunks, one thread per (b, h, p, n): from each
// chunk's own contribution (float32) to its starting state, written as NP
// bf16 parts for the y blocks, and the final state in float32.
template <int NP>
__global__ void __launch_bounds__(256)
ssd_state_pass(const float* __restrict__ contrib, const float* __restrict__ dec,
               bf16* __restrict__ start, float* __restrict__ state, int H, int nc, int PN,
               long long total) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  const long long bh = i / PN;
  const int e = (int)(i - bh * PN);
  const int h = (int)(bh % H);
  const long long b = bh / H;
  constexpr int U = 8;  // chunks whose loads are in flight together
  float s = 0.f;
  for (int c0 = 0; c0 < nc; c0 += U) {
    float v[U], d[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long bch = (b * nc + c0 + u) * H + h;
      v[u] = c0 + u < nc ? contrib[bch * PN + e] : 0.f;
      d[u] = c0 + u < nc ? dec[bch] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + u >= nc) break;
      bf16* out = start + ((b * nc + c0 + u) * H + h) * NP * PN + e;
      float r = s;
#pragma unroll
      for (int part = 0; part < NP; ++part) {
        const bf16 q = __float2bfloat16_rn(r);
        out[part * PN] = q;
        r -= __bfloat162float(q);
      }
      s = fmaf(s, d[u], v[u]);
    }
  }
  state[i] = s;
}

int smem_limit(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

// The workspace of more than one chunk, in bytes from its start: each
// chunk's own state contribution (float32), its decay exp(cs[last]), then
// its starting state in bf16 parts.
struct Workspace {
  size_t dec, start, bytes;
};
inline Workspace workspace_layout(long long bch, long long pn, int parts) {
  Workspace w;
  w.dec = (size_t)(bch * pn) * 4;
  w.start = (w.dec + (size_t)bch * 4 + 15) / 16 * 16;
  w.bytes = w.start + (size_t)(bch * parts * pn) * 2;
  return w;
}

template <typename T, int WQ, int PS>
int run(Args a, int B, void* workspace, cudaStream_t st) {
  constexpr int NPF = Parts<T>::F;
  const Layout lay = layout<T, WQ, PS>(a.npad, a.L);
  int smem_max = 0;
  int err = smem_limit(&smem_max);
  if (err != 0) return err;
  if (lay.bytes > (size_t)smem_max) return ERR_SHARED_MEMORY;
  const unsigned bch = (unsigned)B * a.nc * a.H;
  const unsigned slices = (unsigned)(a.P / PS);
  if (a.nc == 1) {  // one launch: y blocks and state blocks (the final state)
    err = (int)cudaFuncSetAttribute(ssd_chunk<T, WQ, PS, MODE_BOTH>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
    if (err != 0) return err;
    ssd_chunk<T, WQ, PS, MODE_BOTH>
        <<<dim3(bch, a.nqt + a.nng, slices), 32 * WQ, lay.bytes, st>>>(a);
    return (int)cudaGetLastError();
  }
  err = (int)cudaFuncSetAttribute(ssd_chunk<T, WQ, PS, MODE_STATE>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)lay.state_bytes);
  if (err == 0)
    err = (int)cudaFuncSetAttribute(ssd_chunk<T, WQ, PS, MODE_OUT>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)lay.y_bytes);
  if (err != 0) return err;
  const long long pn = (long long)a.P * a.N;
  const Workspace wl = workspace_layout(bch, pn, NPF);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  Args s = a;  // 1: each chunk's own state contribution
  s.st_out = reinterpret_cast<float*>(ws);
  s.dec_out = reinterpret_cast<float*>(ws + wl.dec);
  s.st_in = nullptr;
  s.nqt = 0;
  ssd_chunk<T, WQ, PS, MODE_STATE>
      <<<dim3(bch, a.nng, slices), 32 * WQ, lay.state_bytes, st>>>(s);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  bf16* start = reinterpret_cast<bf16*>(ws + wl.start);
  const long long total = (long long)B * a.H * pn;  // 2: the recurrence over chunks
  ssd_state_pass<NPF><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      s.st_out, s.dec_out, start, a.st_out, a.H, a.nc, (int)pn, total);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  Args yv = a;  // 3: the outputs from each chunk's starting state
  yv.st_in = start;
  yv.st_out = nullptr;
  yv.nng = 0;
  ssd_chunk<T, WQ, PS, MODE_OUT>
      <<<dim3(bch, a.nqt, slices), 32 * WQ, lay.y_bytes, st>>>(yv);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int B, int wq, int ps, void* ws, cudaStream_t st) {
  if (wq == 2 && ps == 16) return run<T, 2, 16>(a, B, ws, st);
  if (wq == 2 && ps == 32) return run<T, 2, 32>(a, B, ws, st);
  if (wq == 2 && ps == 64) return run<T, 2, 64>(a, B, ws, st);
  if (wq == 4 && ps == 16) return run<T, 4, 16>(a, B, ws, st);
  if (wq == 4 && ps == 32) return run<T, 4, 32>(a, B, ws, st);
  if (wq == 4 && ps == 64) return run<T, 4, 64>(a, B, ws, st);
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// x [B, S, H, P], Bm/Cm [B, S, G, N] of one dtype (0 = float32, 1 = bfloat16);
// dt [B, S, H], A [H], D [H] float32; y [B, S, H, P] in x's dtype; state
// [B, H, P, N] float32; all contiguous. P in {16, 32, 64, 128}; H % G == 0;
// L = min(chunk, S) >= 1. The plan: wq warps of 16 query rows per y block
// (2 or 4), P-slices of ps columns (16, 32 or 64, dividing P). With more than
// one chunk (nc = ceil(S / L)), `workspace` holds ssd_scan_workspace_bytes;
// it may be null for one chunk. Launches on `stream` (one kernel for one
// chunk, three for more) and returns cudaGetLastError(), or ERR_SHARED_MEMORY
// (-1), launching nothing, if a block's tiles at this N and L do not fit the
// device's shared memory.
int ssd_scan_launch(const void* x, const void* Bm, const void* Cm, const void* dt,
                    const void* A, const void* D, void* y, void* state, int B, int S, int H,
                    int G, int P, int N, int L, int dtype, int wq, int ps, void* workspace,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || L < 1 || G < 1 || N < 1 || H % G != 0) return (int)cudaErrorInvalidValue;
  if ((P != 16 && P != 32 && P != 64 && P != 128) || ps > P || P % ps != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.Bm = Bm;
  a.Cm = Cm;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.D = static_cast<const float*>(D);
  a.y = y;
  a.st_out = static_cast<float*>(state);
  a.dec_out = nullptr;
  a.st_in = nullptr;
  a.S = S;
  a.H = H;
  a.G = G;
  a.P = P;
  a.N = N;
  a.npad = (N + 15) / 16 * 16;
  a.L = L;
  a.nc = (S + L - 1) / L;
  a.nqt = (L + 16 * wq - 1) / (16 * wq);
  a.nng = (a.npad + state_cols(wq) - 1) / state_cols(wq);
  if (a.nc > 1 && workspace == nullptr) return (int)cudaErrorInvalidValue;
  const int esize = dtype == 0 ? 4 : 2;
  a.vec_x = aligned16(x) && ((size_t)H * P * esize) % 16 == 0;
  a.vec_bc = aligned16(Bm) && aligned16(Cm) && ((size_t)G * N * esize) % 16 == 0 &&
             ((size_t)N * esize) % 16 == 0;
  if (dtype == 0) return dispatch<float>(a, B, wq, ps, workspace, st);
  if (dtype == 1) return dispatch<bf16>(a, B, wq, ps, workspace, st);
  return (int)cudaErrorInvalidValue;
}

// The workspace a call with more than one chunk needs, in bytes.
long long ssd_scan_workspace_bytes(int dtype, int B, int S, int H, int P, int N, int L) {
  const long long bch = (long long)B * ((S + L - 1) / L) * H;
  return (long long)workspace_layout(bch, (long long)P * N, dtype == 0 ? 3 : 2).bytes;
}

}  // extern "C"
