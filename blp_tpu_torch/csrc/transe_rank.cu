// K1: TransE rank-vs-all counts for filtered full-ranking evaluation.
//
// Replaces the TPU kernel blp_tpu/ops/pallas_ranking.py::_kernel (launched by
// _raw_counts). For Q stacked query offsets u (head- and tail-corruption rows
// of one eval batch) and every candidate row c of the (n_rows, d) table it
// accumulates the L1 distance sum_d |c_d + u_d| in a FIXED fp32 add order:
//
//   part = |c_0 + u_0|; part += |c_1 + u_1| ... over each 32-dim chunk,
//   acc  = part_0;      acc  += part_1      ... over the chunks,
//
// then counts, per query q, gt = #(acc < r_q) and geq = #(acc <= r_q) over the
// columns col < num_valid with col != true_pos_q. The pivot r and the
// filtered-column correction are computed outside the kernel in the same add
// order (ops/transe_rank.py::_seq_abs_scores), so every distance here is
// bit-identical to the plain version's and the filtered subtraction gt - fgt
// is exact. The chain has no multiplies, so nothing can be contracted into an
// FMA; build without --use_fast_math so no add is reassociated.
//
// What bounds it on an H100: 2 fp32 ops per (query, candidate, dim) element
// (the add, and the accumulate with |.| folded in as an operand modifier). At
// the Wikidata5M eval shape (Q = 128, 4.8M candidates, d = 128) that is
// 1.6e11 ops against 2.5 GB of table, so the FP32 pipes, not HBM, are the
// limit (operations / 33.5e12 non-FMA fp32 ops/s >> bytes / 3.35e12 B/s).
//
// Design: the table keeps its row-major (n_rows, d) layout (no transposed
// copy). A block of 256 threads owns TQ = 128 queries (blockIdx.y picks the
// query group) and walks candidate tiles of TC = 64 rows grid-stride. Each
// 32-dim chunk of the tile and of the queries' offsets is staged in shared
// memory, transposed so that the inner loop reads conflict-free; each thread
// holds an 8-query x 4-candidate block of partial sums in registers, so one
// shared load feeds 4 or 8 adds. Counts stay in registers across tiles, are
// reduced over the 16 candidate lanes with shuffles, and land in the (2, Q)
// int32 output with one integer atomicAdd per query per block: blocks finish
// in any order, but integer sums do not depend on it. Tiles wholly at or past
// num_valid are skipped (they cannot count). All offsets into the table are
// 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDC = 32;              // d-chunk: the unit of the fixed add order
constexpr int kTC = 64;              // candidates per tile
constexpr int kTQ = 128;             // queries per block
constexpr int kThreads = 256;        // 16 candidate lanes x 16 query lanes
constexpr int kRC = kTC / 16;        // candidates per thread
constexpr int kRQ = kTQ / 16;        // queries per thread
constexpr int kBlocksPerSM = 4;      // grid-stride width per query group

__global__ void __launch_bounds__(kThreads)
transe_rank_kernel(const float* __restrict__ table, const float* __restrict__ u,
                   const float* __restrict__ r, const int* __restrict__ true_pos,
                   int64_t n_rows, int64_t num_valid, int q_total, int d,
                   int* __restrict__ counts) {
  __shared__ float c_s[kDC][kTC + 1];
  __shared__ float u_s[kDC][kTQ + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // candidate lane: columns tx, tx + 16, ...
  const int ty = tid / 16;   // query lane: queries ty, ty + 16, ...
  const int q0 = blockIdx.y * kTQ;

  float rq[kRQ];
  int tp[kRQ];
  int gt[kRQ];
  int geq[kRQ];
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    const int q = q0 + ty + 16 * i;
    // A query past q_total gets a negative pivot: no distance is below it.
    rq[i] = q < q_total ? r[q] : -1.0f;
    tp[i] = q < q_total ? true_pos[q] : -1;
    gt[i] = 0;
    geq[i] = 0;
  }

  const int64_t n_live = n_rows < num_valid ? n_rows : num_valid;
  const int64_t n_tiles = (n_live + kTC - 1) / kTC;

  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t c0 = tile * kTC;
    float acc[kRQ][kRC];
#pragma unroll
    for (int i = 0; i < kRQ; ++i)
#pragma unroll
      for (int c = 0; c < kRC; ++c) acc[i][c] = 0.0f;

    for (int k0 = 0; k0 < d; k0 += kDC) {
      __syncthreads();  // the previous chunk's readers are done
      for (int idx = tid; idx < kTC * kDC; idx += kThreads) {
        const int row = idx / kDC, col = idx % kDC;
        const int64_t g = c0 + row;
        const int k = k0 + col;
        // Zero padding of a partial chunk adds |0 + 0| = +0.0: exact.
        c_s[col][row] = (g < n_rows && k < d) ? table[g * d + k] : 0.0f;
      }
      for (int idx = tid; idx < kTQ * kDC; idx += kThreads) {
        const int row = idx / kDC, col = idx % kDC;
        const int q = q0 + row;
        const int k = k0 + col;
        u_s[col][row] = (q < q_total && k < d) ? u[(int64_t)q * d + k] : 0.0f;
      }
      __syncthreads();

      // 0 + x == x exactly for x >= 0, so starting from 0 keeps the chain
      // bit-identical to one that starts from the first term.
      float part[kRQ][kRC];
#pragma unroll
      for (int i = 0; i < kRQ; ++i)
#pragma unroll
        for (int c = 0; c < kRC; ++c) part[i][c] = 0.0f;

#pragma unroll 4
      for (int j = 0; j < kDC; ++j) {
        float cv[kRC];
        float uv[kRQ];
#pragma unroll
        for (int c = 0; c < kRC; ++c) cv[c] = c_s[j][tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRQ; ++i) uv[i] = u_s[j][ty + 16 * i];
#pragma unroll
        for (int i = 0; i < kRQ; ++i)
#pragma unroll
          for (int c = 0; c < kRC; ++c) part[i][c] += fabsf(cv[c] + uv[i]);
      }
#pragma unroll
      for (int i = 0; i < kRQ; ++i)
#pragma unroll
        for (int c = 0; c < kRC; ++c) acc[i][c] += part[i][c];
    }

#pragma unroll
    for (int c = 0; c < kRC; ++c) {
      const int64_t col = c0 + tx + 16 * c;
      const bool live = col < n_live;
#pragma unroll
      for (int i = 0; i < kRQ; ++i) {
        const bool ok = live && col != (int64_t)tp[i];
        gt[i] += (ok && acc[i][c] < rq[i]) ? 1 : 0;
        geq[i] += (ok && acc[i][c] <= rq[i]) ? 1 : 0;
      }
    }
  }

  // Sum over the 16 candidate lanes of each query lane (one half-warp).
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      gt[i] += __shfl_down_sync(0xffffffffu, gt[i], off, 16);
      geq[i] += __shfl_down_sync(0xffffffffu, geq[i], off, 16);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < kRQ; ++i) {
      const int q = q0 + ty + 16 * i;
      if (q < q_total) {
        if (gt[i]) atomicAdd(&counts[q], gt[i]);
        if (geq[i]) atomicAdd(&counts[q_total + q], geq[i]);
      }
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). `counts` is a zeroed (2, q_total)
// int32 buffer: row 0 gt, row 1 geq. Launches on `stream` without
// synchronising and returns cudaGetLastError() of the launch.
extern "C" int transe_rank_launch(const float* table, const float* u,
                                  const float* r, const int* true_pos,
                                  long long n_rows, long long num_valid,
                                  int q_total, int d, int* counts,
                                  void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long n_live = n_rows < num_valid ? n_rows : num_valid;
  long long n_tiles = (n_live + kTC - 1) / kTC;
  long long gx = (long long)sms * kBlocksPerSM;
  if (n_tiles < gx) gx = n_tiles;
  if (gx < 1) gx = 1;
  const dim3 grid((unsigned)gx, (unsigned)((q_total + kTQ - 1) / kTQ));
  transe_rank_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      table, u, r, true_pos, (int64_t)n_rows, (int64_t)num_valid, q_total, d,
      counts);
  return (int)cudaGetLastError();
}
