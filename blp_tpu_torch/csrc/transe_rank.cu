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
// FMA; build without --use_fast_math so no add is reassociated. No chain is
// split across threads.
//
// What bounds it on an H100: 2 fp32 adds per (query, candidate, dim) element
// (c + u, and the accumulate with |.| folded in as an operand modifier). At
// the Wikidata5M eval shape (Q = 128, 4.8M candidates, d = 128) that is
// 1.6e11 adds against 2.5 GB of table, so the FP32 pipes, not HBM, are the
// limit: one FADD warp instruction per dispatch slot of each SM sub-partition.
// Every instruction that is not an FADD costs the kernel its time directly.
//
// Two variants; `pick_variant` chooses from shape and alignment alone (and
// ops/transe_rank.py `variant` mirrors it):
//
// "tma" (d % 4 == 0, table and u 16-byte aligned, n_rows < 2^30). A
//   persistent grid (blocks per SM from the occupancy API: two blocks of 128
//   threads at ~246 registers; grid.y the query groups of 128) walks
//   candidate tiles of 64 rows grid-stride. Per (tile, 32-dim chunk) one
//   thread starts two TMA loads into a 4-stage ring in shared memory: the
//   table's [64 rows x 32 dims] box (8 KB) and u's [128 queries x 32 dims]
//   box (16 KB), with the 128-byte swizzle (a 32-wide fp32 chunk is exactly
//   one 128-byte row); out-of-bounds rows and dims arrive as zeros, and each
//   stage's mbarrier counts its bytes in. u comes through the ring at every
//   width: a TMA load costs one instruction of one thread, and its 16 KB per
//   chunk is an L2 hit. Each thread owns 8 candidates (tx + 8 i) x 8
//   queries (ty + 16 k): part[8][8] is the chain within a chunk, acc[8][8]
//   the chain over chunks, both in registers. Each 16-byte shared load
//   brings 4 dims of one row; row r's 16-byte piece g sits at piece
//   g ^ (r % 8), so the 8 lanes of a quarter-warp (rows tx = 0..7) read 8
//   distinct bank groups, and the 4 query rows of a warp are broadcasts. 16
//   loads feed 512 FADDs. A partial last chunk sums only its (d % 32) / 4
//   real 4-dim groups: no padded dims. Counts stay in registers across
//   tiles; the epilogue of a tile compares its 64 accumulators with r under
//   the col < n_live, col != true_pos mask.
//
// "scalar" (anything else: d % 4 != 0, a misaligned view). The first design:
//   256 threads own 128 queries x 64-row tiles; each 32-dim chunk of the tile
//   and of the offsets is staged with scalar loads, transposed, and a partial
//   last chunk is zero-padded (|0 + 0| adds +0.0 to a non-negative sum:
//   exact); each thread sums an 8-query x 4-candidate block.
//
// Both reduce counts over the 16 candidate lanes with shuffles and add them
// into the (2, Q) int32 output with one integer atomicAdd per query per
// block: blocks finish in any order, but integer sums do not depend on it.
// Tiles wholly at or past num_valid are skipped (they cannot count).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kDC = 32;              // d-chunk: the unit of the fixed add order
constexpr int kThreads = 256;        // 16 candidate lanes x 16 query lanes
constexpr int kVariantTma = 0;       // the order of VARIANTS in ops/transe_rank.py
constexpr int kVariantScalar = 1;

// Sum the W candidate lanes of each query lane (W consecutive threads) and
// add the totals into counts: row 0 gt, row 1 geq.
template <int W, int R>
__device__ __forceinline__ void flush_counts(int (&gt)[R], int (&geq)[R], int tx, int ty,
                                             int q0, int q_total, int* counts) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int off = W / 2; off > 0; off >>= 1) {
      gt[i] += __shfl_down_sync(0xffffffffu, gt[i], off, W);
      geq[i] += __shfl_down_sync(0xffffffffu, geq[i], off, W);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int q = q0 + ty + 16 * i;
      if (q < q_total) {
        if (gt[i]) atomicAdd(&counts[q], gt[i]);
        if (geq[i]) atomicAdd(&counts[q_total + q], geq[i]);
      }
    }
  }
}

// ---- the "scalar" variant -------------------------------------------------

constexpr int kTC = 64;              // candidates per tile
constexpr int kTQ = 128;             // queries per block
constexpr int kRC = kTC / 16;        // candidates per thread
constexpr int kRQ = kTQ / 16;        // queries per thread
constexpr int kBlocksPerSM = 4;      // grid-stride width per query group

__global__ void __launch_bounds__(kThreads)
transe_rank_scalar_kernel(const float* __restrict__ table, const float* __restrict__ u,
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
  flush_counts<16>(gt, geq, tx, ty, q0, q_total, counts);
}

// ---- PTX: mbarriers and TMA -----------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also sets the bytes the stage's loads will complete.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier has completed the phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// The (x = dim, y = row) box of a 2-D tensor map into shared memory.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// ---- the "tma" variant ----------------------------------------------------

constexpr int kLanes = 8;                    // candidate lanes; 16 query lanes
constexpr int kTmaThreads = kLanes * 16;
constexpr int kRows = 128;                   // queries per block
constexpr int kTile = kLanes * 8;            // candidates per tile
constexpr int kRowBytes = kDC * 4;           // one row of a chunk: the swizzle span
constexpr int kTableBytes = kTile * kRowBytes;
constexpr int kStageBytes = kTableBytes + kRows * kRowBytes;  // the table's box, then u's
constexpr int kStages = 4;
constexpr int kSwizzleAlign = 1024;          // the 128-byte swizzle repeats every 8 rows
constexpr int kRingBytes = kStages * kStageBytes + kSwizzleAlign;
static_assert(kLanes % 8 == 0, "the rows tx + kLanes i must share row tx's swizzle");
static_assert(kTmaThreads >= kRows, "one thread stages each query's pivot");

// Adds one 4-dim group g of the chunk to every (query k, candidate i) chain
// of the thread. cs / us: the thread's first candidate / query row in the
// stage; cg / ug: group g's swizzled 16-byte piece in those rows (the rows
// tx + kLanes i share tx's swizzle, the rows ty + 16 k share ty's). The
// first group of a chunk starts each chain from its first term.
template <bool kFirst>
__device__ __forceinline__ void add_group(float (&part)[8][8], const unsigned char* cs,
                                          const unsigned char* us, int cg, int ug) {
  float4 uv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    uv[k] = *reinterpret_cast<const float4*>(us + k * 16 * kRowBytes + ug * 16);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 cv = *reinterpret_cast<const float4*>(cs + i * kLanes * kRowBytes + cg * 16);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float p = fabsf(cv.x + uv[k].x);
      if (!kFirst) p = part[k][i] + p;
      p += fabsf(cv.y + uv[k].y);
      p += fabsf(cv.z + uv[k].z);
      p += fabsf(cv.w + uv[k].w);
      part[k][i] = p;
    }
  }
}

__global__ void __launch_bounds__(kTmaThreads, 2)   // two blocks per SM
transe_rank_tma_kernel(const __grid_constant__ CUtensorMap table_map,
                       const __grid_constant__ CUtensorMap u_map,
                       const float* __restrict__ r, const int* __restrict__ true_pos,
                       int n_live, int q_total, int d, int* __restrict__ counts) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kStages];
  __shared__ float r_s[kRows];
  __shared__ int tp_s[kRows];
  unsigned char* ring =
      smem_raw + ((kSwizzleAlign - (smem_u32(smem_raw) % kSwizzleAlign)) % kSwizzleAlign);

  const int tid = threadIdx.x;
  const int tx = tid % kLanes;   // candidate lane: rows tx, tx + kLanes, ... of a tile
  const int ty = tid / kLanes;   // query lane: queries ty, ty + 16, ... of the block
  const int q0 = blockIdx.y * kRows;
  const int n_tiles = (n_live + kTile - 1) / kTile;
  const int n_chunks = (d + kDC - 1) / kDC;

  if (tid < kRows) {
    const int q = q0 + tid;
    // A query past q_total gets a negative pivot: no distance is below it.
    r_s[tid] = q < q_total ? r[q] : -1.0f;
    tp_s[tid] = q < q_total ? true_pos[q] : -1;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();

  // The producer (thread 0) walks the block's (tile, chunk) sequence ahead
  // of the consumers by kStages items.
  int p_tile = blockIdx.x, p_chunk = 0;
  auto produce = [&](int slot) {
    if (p_tile >= n_tiles) return;
    unsigned char* st = ring + slot * kStageBytes;
    mbar_arrive_expect_tx(&full[slot], kStageBytes);
    tma_load_2d(st, &table_map, p_chunk * kDC, p_tile * kTile, &full[slot]);
    tma_load_2d(st + kTableBytes, &u_map, p_chunk * kDC, q0, &full[slot]);
    if (++p_chunk == n_chunks) {
      p_chunk = 0;
      p_tile += gridDim.x;
    }
  };
  if (tid == 0)
    for (int s = 0; s < kStages; ++s) produce(s);

  int gt[8], geq[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) gt[k] = geq[k] = 0;
  const int sx = tx % 8, sy = ty % 8;
  uint32_t seq = 0;   // ring items consumed

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    float acc[8][8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[k][i] = 0.0f;

    for (int chunk = 0; chunk < n_chunks; ++chunk, ++seq) {
      const int slot = seq % kStages;
      mbar_wait(&full[slot], (seq / kStages) % 2);
      const unsigned char* cs = ring + slot * kStageBytes + tx * kRowBytes;
      const unsigned char* us = ring + slot * kStageBytes + kTableBytes + ty * kRowBytes;
      // The 4-dim groups of this chunk's real dims: 8, or fewer in a last
      // partial chunk. The loop stays rolled: its body (~530 instructions)
      // stays in the instruction cache, where 8 unrolled groups did not.
      const int groups = min(kDC, d - chunk * kDC) / 4;
      float part[8][8];
      add_group<true>(part, cs, us, sx, sy);
#pragma unroll 1
      for (int g = 1; g < groups; ++g) add_group<false>(part, cs, us, g ^ sx, g ^ sy);
      // 0 + x == x exactly for x >= 0: the first chunk's add leaves part.
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[k][i] += part[k][i];
      __syncthreads();   // every thread is done with this stage
      if (tid == 0) produce(slot);
    }

    const int c0 = tile * kTile;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = c0 + tx + kLanes * i;
      const bool live = col < n_live;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool ok = live && col != tp_s[ty + 16 * k];
        const float rq = r_s[ty + 16 * k];
        gt[k] += (ok && acc[k][i] < rq) ? 1 : 0;
        geq[k] += (ok && acc[k][i] <= rq) ? 1 : 0;
      }
    }
  }
  flush_counts<kLanes>(gt, geq, tx, ty, q0, q_total, counts);
}

// ---- host side ------------------------------------------------------------

int pick_variant(long long n_rows, int d, const void* table, const void* u) {
  const bool aligned = (uintptr_t)table % 16 == 0 && (uintptr_t)u % 16 == 0;
  return (d % 4 == 0 && aligned && n_rows < (1LL << 30)) ? kVariantTma : kVariantScalar;
}

// cuTensorMapEncodeTiled, looked up at run time through
// cudaGetDriverEntryPoint so that the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return (EncodeTiled)p;
  }();
  return fn;
}

// A (rows, d) row-major fp32 matrix read in [box_rows rows x kDC dims] boxes
// with the 128-byte swizzle; outside the matrix the boxes read zeros.
bool make_map(CUtensorMap* map, const float* base, long long rows, int d, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * sizeof(float)};
  const cuuint32_t box[2] = {kDC, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)base, dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The "tma" variant's resident blocks (SMs x blocks per SM from the occupancy
// API at its shared memory), cached per device.
int tma_blocks(int* blocks) {
  static std::mutex mu;
  static int cached_dev = -1, cached_blocks = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mu);
  if (cached_dev != dev) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(transe_rank_tma_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, transe_rank_tma_kernel,
                                                          kTmaThreads, kRingBytes);
    if (err != cudaSuccess) return (int)err;
    cached_dev = dev;
    cached_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = cached_blocks;
  return 0;
}

int launch_tma(const float* table, const float* u, const float* r, const int* true_pos,
               long long n_live, int q_total, int d, int* counts, cudaStream_t stream) {
  CUtensorMap table_map, u_map;
  if (!make_map(&table_map, table, n_live, d, kTile) ||
      !make_map(&u_map, u, q_total, d, kRows))
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const int err = tma_blocks(&blocks);
  if (err != 0) return err;
  const int groups = (q_total + kRows - 1) / kRows;
  const long long n_tiles = (n_live + kTile - 1) / kTile;
  long long gx = blocks / groups;
  if (gx > n_tiles) gx = n_tiles;
  if (gx < 1) gx = 1;
  transe_rank_tma_kernel<<<dim3((unsigned)gx, (unsigned)groups), kTmaThreads, kRingBytes,
                           stream>>>(table_map, u_map, r, true_pos, (int)n_live, q_total, d,
                                     counts);
  return (int)cudaGetLastError();
}

int launch_scalar(const float* table, const float* u, const float* r, const int* true_pos,
                  long long n_rows, long long num_valid, int q_total, int d, int* counts,
                  cudaStream_t stream) {
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
  transe_rank_scalar_kernel<<<grid, kThreads, 0, stream>>>(
      table, u, r, true_pos, (int64_t)n_rows, (int64_t)num_valid, q_total, d, counts);
  return (int)cudaGetLastError();
}

}  // namespace

// The variant transe_rank_launch runs for these inputs: 0 "tma", 1 "scalar".
extern "C" int transe_rank_variant(long long n_rows, int d, const void* table, const void* u) {
  return pick_variant(n_rows, d, table, u);
}

// Plain C entry point (bound with ctypes). `counts` is a zeroed (2, q_total)
// int32 buffer: row 0 gt, row 1 geq. Requires min(n_rows, num_valid) >= 1
// and q_total >= 1. Launches on `stream` without synchronising and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue if a tensor map
// cannot be made).
extern "C" int transe_rank_launch(const float* table, const float* u,
                                  const float* r, const int* true_pos,
                                  long long n_rows, long long num_valid,
                                  int q_total, int d, int* counts,
                                  void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (pick_variant(n_rows, d, table, u) == kVariantTma) {
    const long long n_live = n_rows < num_valid ? n_rows : num_valid;
    return launch_tma(table, u, r, true_pos, n_live, q_total, d, counts, s);
  }
  return launch_scalar(table, u, r, true_pos, n_rows, num_valid, q_total, d, counts, s);
}
