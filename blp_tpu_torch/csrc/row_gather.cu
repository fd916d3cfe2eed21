// The backward of a row gather, out = table[ids]: the dense table gradient
//
//   dtable = zeros(V, E);  dtable[ids[i]] += g[i]  for every position i,
//
// as a segmented sum over the positions sorted by id (ops/row_gather.py
// sorts them with torch's stable sort and zero-fills dtable first).
//
// Replaces no Pallas kernel: the JAX package gathers its word tables with
// jnp indexing (blp_tpu/models/encoders.py, models/bert.py) and leaves the
// scatter-add of the VJP to XLA. It was added because torch's backward of
// advanced indexing (indexing_backward_kernel, after the same sort) adds all
// duplicates of one id in one serial loop, so its time follows the longest
// run of one id and not the bytes: every padded position of a description
// gathers row 0, and at the W5M train step (131,072 positions, ~9% of them
// padding) that one run of ~11,700 adds took ~8.4 ms of an ~18.7 ms
// glove-dkrl step.
//
// What bounds it on an H100: bytes. It must read g (N x E f32) and write the
// rows the ids touch; the zero fill of the untouched rows is the wrapper's.
// At the W5M step: 157 MB of g at E 300 (~47 us at 3.35 TB/s), 403 MB at
// E 768 (~120 us).
//
// Design (index_put_segsum): the sorted positions are cut into chunks of
// kChunk. One block takes one chunk and one slab of at most kMaxThreads
// column vectors (V floats each: 4 where E % 4 == 0 and the rows are 16-byte
// aligned, else 1): each thread walks the chunk's positions in sorted order,
// kUnroll gathered rows in flight, adding in f32 registers, and flushes the
// sum when the id changes. A run that lies inside its chunk is written
// straight to its row. A run that crosses a chunk boundary leaves one
// partial per chunk (slot 0: the run that holds the chunk's first position;
// slot 1: the one that holds its last, where they differ), and the block
// that arrives last among the run's chunks adds its partials in chunk order
// and writes the row. So no serial chain is longer than kChunk + the number
// of chunks of the longest run (92 for the W5M step's padding, 1,024 for
// 131,072 positions on one id), and the same code serves runs of 1, of
// hundreds and of tens of thousands. Each row is written by one block, in a
// fixed order, with no float atomics: the same bits on every call.
//
// Which block arrives last is counted with one 64-bit integer atomicAdd a
// crossing run and slab (arrivals[id * slabs + slab], zeroed by the
// wrapper): each chunk adds 1 to the low word; the run's first chunk a adds
// -a to the high word and its last chunk b adds b + 1. The high word reaches
// b + 1 - a, the number of chunks, exactly when the low word does, and never
// equals it before (with only a's share it reads -a or 0; with only b's,
// b + 1 > the count; with both, the count while the low word is short of
// it). The first chunk also writes where its partial lies (run_start[id]:
// 2a + slot) before its atomicAdd, so the last arriver learns a from it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;       // sorted positions a block adds
constexpr int kUnroll = 8;        // gathered rows in flight a thread
constexpr int kMaxThreads = 256;  // column vectors a block (one slab)

template <int V> struct Vec;
template <> struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    o[0] = __ldg(p);
  }
  static __device__ __forceinline__ void load_l2(const float* p, float* o) {
    o[0] = __ldcg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    p[0] = v[0];
  }
};
template <> struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  static __device__ __forceinline__ void load_l2(const float* p, float* o) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// A run that crosses a boundary of this chunk: its id and what the chunk adds
// to its arrival counter.
struct Crossing {
  int id;
  unsigned long long add;
};

template <int V>
__global__ void __launch_bounds__(kMaxThreads)
index_put_segsum(const int* __restrict__ ids, const int64_t* __restrict__ order,
                 const float* __restrict__ g, int n, int E,
                 float* __restrict__ out, float* __restrict__ partials,
                 int* __restrict__ run_start,
                 unsigned long long* __restrict__ arrivals) {
  __shared__ int s_id[kChunk];
  __shared__ int64_t s_row[kChunk];
  __shared__ int s_count[2];

  const int chunk = blockIdx.x, slab = blockIdx.y, slabs = gridDim.y;
  const int64_t p0 = (int64_t)chunk * kChunk;
  const int len = (int)min((int64_t)kChunk, (int64_t)n - p0);
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    s_id[i] = ids[p0 + i];
    s_row[i] = order[p0 + i];
  }
  const int prev = p0 > 0 ? __ldg(ids + p0 - 1) : -1;
  const int next = p0 + len < n ? __ldg(ids + p0 + len) : -1;
  __syncthreads();

  const int col = (slab * blockDim.x + threadIdx.x) * V;
  const bool active = col < E;
  Crossing cross[2];
  int n_cross = 0;
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.0f;
  int cur = s_id[0];
  bool first = true;

  // Ends the run `cur` (block-uniform: every thread sees the same ids).
  auto flush = [&](bool last) {
    const bool from_left = first && cur == prev;
    const bool to_right = last && cur == next;
    if (!from_left && !to_right) {
      if (active) Vec<V>::store(out + (int64_t)cur * E + col, acc);
      return;
    }
    const int slot = first ? 0 : 1;
    if (active) Vec<V>::store(partials + ((int64_t)chunk * 2 + slot) * E + col, acc);
    unsigned long long add = 1ull;
    if (!from_left) {
      add += (unsigned long long)(0u - (unsigned)chunk) << 32;
      // Every slab's block writes it (the same value), each before its own
      // slab's atomicAdd, so each slab's last arriver is sure to see it.
      if (threadIdx.x == 0) run_start[cur] = chunk * 2 + slot;
    }
    if (!to_right) add += (unsigned long long)(unsigned)(chunk + 1) << 32;
    cross[n_cross++] = Crossing{cur, add};
  };

  for (int i0 = 0; i0 < len; i0 += kUnroll) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (active && i0 + u < len) {
        Vec<V>::load(g + s_row[i0 + u] * E + col, v[u]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) v[u][k] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u < len) {
        const int id = s_id[i0 + u];
        if (id != cur) {
          flush(false);
          first = false;
          cur = id;
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] = 0.0f;
        }
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] += v[u][k];
      }
    }
  }
  flush(true);
  if (n_cross == 0) return;

  // The barrier orders the block's partial (and run_start) writes before
  // thread 0's fence (cumulative), as in fused_layer.cu's F1 backward.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    for (int r = 0; r < n_cross; ++r) {
      const unsigned long long now =
          atomicAdd(arrivals + (int64_t)cross[r].id * slabs + slab, cross[r].add) +
          cross[r].add;
      s_count[r] = (unsigned)(now >> 32) == (unsigned)now ? (int)(unsigned)now : 0;
    }
  }
  __syncthreads();
  for (int r = 0; r < n_cross; ++r) {
    const int count = s_count[r];
    if (count == 0) continue;
    __threadfence();
    const int start = __ldcg(run_start + cross[r].id);
    const int64_t a = start >> 1;
    float sum[V];
#pragma unroll
    for (int k = 0; k < V; ++k) sum[k] = 0.0f;
    for (int t0 = 0; t0 < count; t0 += kUnroll) {
      float v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u;
        if (active && t < count) {
          const int64_t slot_row = t == 0 ? 2 * a + (start & 1) : 2 * (a + t);
          Vec<V>::load_l2(partials + slot_row * E + col, v[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (active && t0 + u < count) {
#pragma unroll
          for (int k = 0; k < V; ++k) sum[k] += v[u][k];
        }
      }
    }
    if (active) Vec<V>::store(out + (int64_t)cross[r].id * E + col, sum);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Threads a block: one a column vector, whole warps, at most kMaxThreads.
int block_threads(int E, int v) {
  const int vecs = (E + v - 1) / v;
  return ((vecs < kMaxThreads ? vecs : kMaxThreads) + 31) / 32 * 32;
}

}  // namespace

// Rows a chunk of sorted positions spans (ops/row_gather.py CHUNK).
extern "C" int index_put_segsum_chunk() { return kChunk; }

// Column slabs a row of E floats takes at vector width v: the arrival
// counters hold V * slabs entries.
extern "C" int index_put_segsum_slabs(int E, int v) {
  const int threads = block_threads(E, v);
  return ((E + v - 1) / v + threads - 1) / threads;
}

// Plain C entry point (bound with ctypes). ids (n,) int32 sorted ascending;
// order (n,) int64: the source row in g of each sorted position; g (rows, E)
// float32; out (V, E) float32, zero-filled, its touched rows overwritten;
// partials (2 * ceil(n / kChunk), E) float32 scratch; run_start (V,) int32
// scratch; arrivals (V * slabs,) uint64, zero-filled. v: 4 or 1 (4 needs
// E % 4 == 0 and g, out, partials 16-byte aligned). All contiguous. Ids are
// trusted to lie in [0, V). Launches on `stream` without synchronising and
// returns cudaGetLastError() (cudaErrorInvalidValue for arguments it does
// not take).
extern "C" int index_put_segsum_launch(const int* ids, const int64_t* order,
                                       const float* g, int n, int E, int v,
                                       float* out, float* partials,
                                       int* run_start,
                                       unsigned long long* arrivals,
                                       void* stream) {
  if (n < 1 || E < 1 || !(v == 1 || v == 4)) return (int)cudaErrorInvalidValue;
  if (v == 4 && (E % 4 || !aligned(g, 16) || !aligned(out, 16) ||
                 !aligned(partials, 16)))
    return (int)cudaErrorInvalidValue;
  const int threads = block_threads(E, v);
  const dim3 grid((unsigned)((n + (int64_t)kChunk - 1) / kChunk),
                  (unsigned)index_put_segsum_slabs(E, v));
  cudaStream_t s = (cudaStream_t)stream;
  if (v == 4) {
    index_put_segsum<4><<<grid, threads, 0, s>>>(ids, order, g, n, E, out,
                                                 partials, run_start, arrivals);
  } else {
    index_put_segsum<1><<<grid, threads, 0, s>>>(ids, order, g, n, E, out,
                                                 partials, run_start, arrivals);
  }
  return (int)cudaGetLastError();
}
