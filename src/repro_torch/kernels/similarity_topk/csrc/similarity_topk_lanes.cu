// Fused similarity scoring + per-lane top-k over a [L, N, D] store bank.
//
// Replaces the Pallas TPU kernel src/repro/kernels/similarity_topk/kernel.py
// :: similarity_topk_lanes_blocks (body _topk_lanes_kernel) together with the
// per-lane candidate merge of src/repro/kernels/similarity_topk/ops.py
// :: _similarity_topk_lanes. For every (lane, query) it returns the k best
// float32 dot scores over the lane's rows and their lane-local indices.
// Invalid rows score NEG_SENTINEL (-3e38), exactly as on the TPU; the Python
// wrapper maps that sentinel to -inf.
//
// Order. Candidates compare lexicographically on (score desc, index asc).
// That is a total order (indices are unique within a lane), so the top-k is
// the same whatever order blocks run in, and both passes below pick "the best
// candidate strictly after the previous pick" each round -- no taken-marks,
// no sort. The TPU kernel's first-argmax extraction followed by lax.top_k's
// lower-position tie rule gives the same order.
//
// Bound on an H100. One read streams the bank once: L*N*D*4 bytes (805 MB at
// L=2, N=131072, D=768, about 0.24 ms at 3.35 TB/s) against 2*Q*L*N*D FP32
// FLOP (no TF32: TF32 moves cosine scores by ~1e-3 and flips cache hits near
// a threshold). Memory-bound while Q is small; on the 67 TFLOP/s FP32 cores
// it turns compute-bound above Q ~ 40.
//
// Design (simple and right first; no wgmma/TMA yet):
//   pass 1 (topk_tiles): one 256-thread block per (query chunk of QC, row tile
//     of TN, lane). The block streams its [TN, D] bank tile through shared
//     memory in DK-wide slabs with coalesced 16-byte loads (a row is
//     contiguous), keeps the [QC, DK] query slab beside it, and each thread
//     accumulates a 2 x 8 (query x row) register tile with FMAs in a fixed d
//     order (identical rows give bitwise identical scores). The masked
//     [QC, TN] score tile then goes to shared memory and one warp per query
//     extracts the tile's top-k by k rounds of warp-wide (score, idx) max.
//     Query chunks of the same tile are adjacent in blockIdx.x, so they run
//     together and re-read the tile from L2, not from HBM.
//   pass 2 (merge_lanes): one block per (query, lane) merges the nb*k tile
//     candidates by k rounds of block-wide (score, idx) max.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 128;       // bank rows per tile
constexpr int QC = 32;        // queries per block
constexpr int DK = 32;        // d-slab width staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 thread grid over (rows, queries)
constexpr int QT = QC / 16;   // queries per thread
constexpr int RT = TN / 16;   // rows per thread
constexpr float NEG_SENTINEL = -3.0e38f;
constexpr int NO_INDEX = 0x7fffffff;

// a is strictly better than b in (score desc, index asc) order
__device__ __forceinline__ bool better(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

__device__ __forceinline__ void warp_argmax(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float os = __shfl_xor_sync(0xffffffffu, s, off);
    int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(os, oi, s, i)) {
      s = os;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
topk_tiles(const float* __restrict__ db, const uint8_t* __restrict__ valid,
           const float* __restrict__ q, float* __restrict__ cand_s,
           int* __restrict__ cand_i, int N, int D, int Q, int k, int nb,
           int nqc) {
  __shared__ float dbs[DK][TN + 1];  // +1: conflict-free transposed stores
  __shared__ float qs[DK][QC + 1];
  __shared__ float S[QC][TN + 1];
  __shared__ uint8_t vs[TN];

  const int lane = blockIdx.y;
  const int qc = blockIdx.x % nqc;
  const int tile = blockIdx.x / nqc;
  const int row0 = tile * TN;
  const int q0 = qc * QC;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // row group
  const int ty = tid / 16;  // query group
  const float* dbl = db + (size_t)lane * N * D;

  if (tid < TN) {
    const int row = row0 + tid;
    vs[tid] = row < N ? valid[(size_t)lane * N + row] : 0;
  }

  float acc[QT][RT];
#pragma unroll
  for (int i = 0; i < QT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) acc[i][j] = 0.0f;

  for (int d0 = 0; d0 < D; d0 += DK) {
    // bank slab: TN rows x DK floats = TN*DK/4 float4, 4 per thread; eight
    // neighbouring threads read one row's 128 contiguous bytes
#pragma unroll
    for (int m = 0; m < (TN * DK / 4) / THREADS; ++m) {
      const int e = tid + m * THREADS;
      const int r = e / (DK / 4);
      const int c = (e % (DK / 4)) * 4;
      const int row = row0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < N && d0 + c < D)
        v = *reinterpret_cast<const float4*>(dbl + (size_t)row * D + d0 + c);
      dbs[c + 0][r] = v.x;
      dbs[c + 1][r] = v.y;
      dbs[c + 2][r] = v.z;
      dbs[c + 3][r] = v.w;
    }
    // query slab: QC x DK floats = one float4 per thread
    {
      const int r = tid / (DK / 4);
      const int c = (tid % (DK / 4)) * 4;
      const int qi = q0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (qi < Q && d0 + c < D)
        v = *reinterpret_cast<const float4*>(q + (size_t)qi * D + d0 + c);
      qs[c + 0][r] = v.x;
      qs[c + 1][r] = v.y;
      qs[c + 2][r] = v.z;
      qs[c + 3][r] = v.w;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < DK; ++kk) {
      float a[QT], b[RT];
#pragma unroll
      for (int i = 0; i < QT; ++i) a[i] = qs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < RT; ++j) b[j] = dbs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < QT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < QT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      const int r = tx + 16 * j;
      S[ty + 16 * i][r] = vs[r] ? acc[i][j] : NEG_SENTINEL;
    }
  __syncthreads();

  // per-tile top-k: one warp per query, each lane owns TN/32 rows
  const int warp = tid / 32;
  const int wl = tid % 32;
  const int nrows = min(TN, N - row0);
  for (int qi = warp; qi < QC; qi += THREADS / 32) {
    if (q0 + qi >= Q) break;
    float prev_s = __int_as_float(0x7f800000);  // +inf: nothing taken yet
    int prev_i = -1;
    float* out_s = cand_s + (((size_t)lane * Q + q0 + qi) * nb + tile) * k;
    int* out_i = cand_i + (((size_t)lane * Q + q0 + qi) * nb + tile) * k;
    for (int t = 0; t < k; ++t) {
      float bs = -__int_as_float(0x7f800000);
      int bi = NO_INDEX;
#pragma unroll
      for (int m = 0; m < TN / 32; ++m) {
        const int r = wl + 32 * m;
        if (r < nrows) {
          const float s = S[qi][r];
          const int idx = row0 + r;
          if (better(prev_s, prev_i, s, idx) && better(s, idx, bs, bi)) {
            bs = s;
            bi = idx;
          }
        }
      }
      warp_argmax(bs, bi);
      if (wl == 0) {
        out_s[t] = bs;
        out_i[t] = bi;
      }
      prev_s = bs;
      prev_i = bi;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
merge_lanes(const float* __restrict__ cand_s, const int* __restrict__ cand_i,
            float* __restrict__ out_s, int* __restrict__ out_i, int Q, int k,
            int M) {
  __shared__ float ws[THREADS / 32];
  __shared__ int wi[THREADS / 32];
  const int qi = blockIdx.x;
  const int lane = blockIdx.y;
  const size_t base = ((size_t)lane * Q + qi) * M;
  const int tid = threadIdx.x;
  float prev_s = __int_as_float(0x7f800000);
  int prev_i = -1;
  for (int t = 0; t < k; ++t) {
    float bs = -__int_as_float(0x7f800000);
    int bi = NO_INDEX;
    for (int m = tid; m < M; m += THREADS) {
      const float s = cand_s[base + m];
      const int idx = cand_i[base + m];
      if (better(prev_s, prev_i, s, idx) && better(s, idx, bs, bi)) {
        bs = s;
        bi = idx;
      }
    }
    warp_argmax(bs, bi);
    if (tid % 32 == 0) {
      ws[tid / 32] = bs;
      wi[tid / 32] = bi;
    }
    __syncthreads();
    if (tid < 32) {
      bs = tid < THREADS / 32 ? ws[tid] : -__int_as_float(0x7f800000);
      bi = tid < THREADS / 32 ? wi[tid] : NO_INDEX;
      warp_argmax(bs, bi);
      if (tid == 0) {
        out_s[((size_t)lane * Q + qi) * k + t] = bs;
        out_i[((size_t)lane * Q + qi) * k + t] = bi;
        ws[0] = bs;
        wi[0] = bi;
      }
    }
    __syncthreads();
    prev_s = ws[0];
    prev_i = wi[0];
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Rows of one tile, for the wrapper's workspace sizing.
int similarity_topk_lanes_tile_rows() { return TN; }

// db [L, N, D] f32, valid [L, N] u8, q [Q, D] f32 (all contiguous, db and q
// 16-byte aligned, D % 4 == 0, 1 <= k <= min(N, TN)); workspace cand_s/cand_i
// [L, Q, ceil(N/TN) * k]; outputs out_s/out_i [L, Q, k]. Launches both passes
// on `stream` and returns cudaGetLastError().
int similarity_topk_lanes_launch(const float* db, const uint8_t* valid,
                                 const float* q, float* cand_s, int* cand_i,
                                 float* out_s, int* out_i, int L, int N, int D,
                                 int Q, int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = (N + TN - 1) / TN;
  const int nqc = (Q + QC - 1) / QC;
  dim3 g1((unsigned)nqc * (unsigned)nb, (unsigned)L);
  topk_tiles<<<g1, THREADS, 0, st>>>(db, valid, q, cand_s, cand_i, N, D, Q, k,
                                     nb, nqc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 g2((unsigned)Q, (unsigned)L);
  merge_lanes<<<g2, THREADS, 0, st>>>(cand_s, cand_i, out_s, out_i, Q, k,
                                      nb * k);
  return (int)cudaGetLastError();
}

}  // extern "C"
