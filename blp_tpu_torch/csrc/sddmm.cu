// K3: positive and in-batch negative scores of one training batch.
//
// Replaces the TPU kernel blp_tpu/ops/pallas_sddmm.py::_make_kernel (launched
// by _sddmm_pallas, entry sddmm_scores). For B edges with in-batch entity
// matrix ent (2B, d) laid out [h0, t0, h1, t1, ...], relation rows rel (B, d)
// and corruption indices neg_idx (B, K, 2) into ent's rows it writes
//
//   pos[b]    = score(ent[2b], ent[2b + 1], rel[b])
//   neg[b, k] = score(ent[neg_idx[b, k, 0]], ent[neg_idx[b, k, 1]], rel[b])
//
// with the scorers of models/scoring.py, their terms formed in the same order:
//   transe   -sum |(h + r) - t|
//   distmult  sum (h * r) * t
//   complex   sum over the first half j (re = j, im = j + d/2) of
//             r_re h_re t_re + r_re h_im t_im + r_im h_re t_im - r_im h_im t_re
//   simple    sum over j < d/2 of (h[j] r[j] t[j+d/2] + t[j] r[j+d/2] h[j+d/2]), / 2
// Sums run in another order than torch.sum (per lane, then a warp shuffle
// tree), so results agree with the plain version to fp32 rounding, not bit
// for bit.
//
// What bounds it on an H100: almost nothing. The HBM traffic is the inputs
// read once and the outputs written once (about 148 KB at B = 64, K = 64,
// d = 128; 2.4 MB at B = 1024), under a microsecond at 3.35 TB/s, below one
// launch's latency. The (2B, d) matrix (64 KB to 1 MB) stays in the 50 MB L2,
// so the 2·B·K·d gathered reads are L2 traffic; the ops (about 4·B·K·d) are
// negligible. The design therefore only keeps the gathers coalesced and the
// launch single.
//
// Design: one block of 8 warps per edge row b (any B; the TPU kernel's
// B % block_b tiling condition has no counterpart). Each lane holds its share
// of rel[b] in registers for the whole block. Task 0 is the positive pair,
// task 1 + k the k-th negative; warps take tasks round robin. A warp gathers
// the head and tail rows with vector loads (float4 when the unit count allows
// it, else float2 or scalar), each lane forms its terms, and the warp reduces
// with shuffles; lane 0 writes pos[b] or neg[b, k]. Indices are trusted: the
// sampler only makes values in [0, 2B).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps per edge row
constexpr int kMaxChunks = 8;   // register chunks per lane: units <= 32·V·8

enum Model { kTransE = 0, kDistMult = 1, kComplEx = 2, kSimplE = 3 };

template <int V> struct Vec;
template <> struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    out[0] = __ldg(p);
  }
};
template <> struct Vec<2> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    out[0] = v.x; out[1] = v.y;
  }
};
template <> struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

// One unit's term. For transe/distmult a unit is one element (a = element);
// for complex/simple it is the pair (j, j + d/2) (a = first, b = second half).
template <int M>
__device__ __forceinline__ float term(float ha, float hb, float ta, float tb,
                                      float ra, float rb) {
  if (M == kTransE) {
    return fabsf((ha + ra) - ta);
  } else if (M == kDistMult) {
    return (ha * ra) * ta;
  } else if (M == kComplEx) {
    return (((ra * ha) * ta + (ra * hb) * tb) + (rb * ha) * tb) - (rb * hb) * ta;
  } else {
    return (ha * ra) * tb + (ta * rb) * hb;
  }
}

template <int M>
__device__ __forceinline__ float finish(float acc) {
  if (M == kTransE) return -acc;
  if (M == kSimplE) return acc / 2.0f;
  return acc;
}

template <int M, int V>
__global__ void __launch_bounds__(kThreads)
sddmm_kernel(const float* __restrict__ ent, const float* __restrict__ rel,
             const int* __restrict__ neg_idx, int K, int d,
             float* __restrict__ pos, float* __restrict__ neg) {
  constexpr bool kPair = (M == kComplEx || M == kSimplE);
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int half = d / 2;
  const int units = kPair ? half : d;
  const int nchunks = units / V;

  // rel[b] in registers: chunk c = lane + 32 i covers units [c·V, c·V + V).
  const float* rrow = rel + (int64_t)b * d;
  float ra[kMaxChunks * V], rb[kMaxChunks * V];
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int c = lane + 32 * i;
#pragma unroll
    for (int v = 0; v < V; ++v) { ra[i * V + v] = 0.0f; rb[i * V + v] = 0.0f; }
    if (c < nchunks) {
      Vec<V>::load(rrow + c * V, &ra[i * V]);
      if (kPair) Vec<V>::load(rrow + half + c * V, &rb[i * V]);
    }
  }

  for (int task = warp; task <= K; task += nwarps) {
    int hi, ti;
    if (task == 0) {
      hi = 2 * b;
      ti = 2 * b + 1;
    } else {
      const int* p = neg_idx + ((int64_t)b * K + (task - 1)) * 2;
      hi = __ldg(p);
      ti = __ldg(p + 1);
    }
    const float* h = ent + (int64_t)hi * d;
    const float* t = ent + (int64_t)ti * d;
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxChunks; ++i) {
      const int c = lane + 32 * i;
      if (c < nchunks) {
        float ha[V], ta[V], hb[V], tb[V];
        Vec<V>::load(h + c * V, ha);
        Vec<V>::load(t + c * V, ta);
        if (kPair) {
          Vec<V>::load(h + half + c * V, hb);
          Vec<V>::load(t + half + c * V, tb);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) { hb[v] = 0.0f; tb[v] = 0.0f; }
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc += term<M>(ha[v], hb[v], ta[v], tb[v], ra[i * V + v], rb[i * V + v]);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) {
      if (task == 0) {
        pos[b] = finish<M>(acc);
      } else {
        neg[(int64_t)b * K + (task - 1)] = finish<M>(acc);
      }
    }
  }
}

template <int M, int V>
cudaError_t launch(const float* ent, const float* rel, const int* neg_idx,
                   int B, int K, int d, float* pos, float* neg,
                   cudaStream_t stream) {
  sddmm_kernel<M, V><<<B, kThreads, 0, stream>>>(ent, rel, neg_idx, K, d, pos,
                                                  neg);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_model(int v, const float* ent, const float* rel,
                         const int* neg_idx, int B, int K, int d, float* pos,
                         float* neg, cudaStream_t stream) {
  if (v == 4) return launch<M, 4>(ent, rel, neg_idx, B, K, d, pos, neg, stream);
  if (v == 2) return launch<M, 2>(ent, rel, neg_idx, B, K, d, pos, neg, stream);
  return launch<M, 1>(ent, rel, neg_idx, B, K, d, pos, neg, stream);
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % (uintptr_t)bytes) == 0;
}

}  // namespace

// Largest unit count (elements for transe/distmult, pairs for
// complex/simple) the register layout takes for vector width v.
extern "C" int sddmm_max_units(int v) { return 32 * v * kMaxChunks; }

// Plain C entry point (bound with ctypes). ent (2B, d), rel (B, d) float32,
// neg_idx (B, K, 2) int32, all contiguous; pos (B,), neg (B, K) float32
// outputs. model: 0 transe, 1 distmult, 2 complex, 3 simple. Launches on
// `stream` without synchronising and returns cudaGetLastError() of the
// launch (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int sddmm_launch(const float* ent, const float* rel,
                            const int* neg_idx, int B, int K, int d, int model,
                            float* pos, float* neg, void* stream) {
  const bool pair = (model == kComplEx || model == kSimplE);
  if (B < 1 || K < 0 || d < 1 || model < 0 || model > 3 || (pair && d % 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const int units = pair ? d / 2 : d;
  int v = 1;
  if (units % 4 == 0 && d % 4 == 0 && aligned(ent, 16) && aligned(rel, 16)) {
    v = 4;
  } else if (units % 2 == 0 && d % 2 == 0 && aligned(ent, 8) && aligned(rel, 8)) {
    v = 2;
  }
  if (units > sddmm_max_units(v)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (model) {
    case kTransE:
      err = launch_model<kTransE>(v, ent, rel, neg_idx, B, K, d, pos, neg, s);
      break;
    case kDistMult:
      err = launch_model<kDistMult>(v, ent, rel, neg_idx, B, K, d, pos, neg, s);
      break;
    case kComplEx:
      err = launch_model<kComplEx>(v, ent, rel, neg_idx, B, K, d, pos, neg, s);
      break;
    default:
      err = launch_model<kSimplE>(v, ent, rel, neg_idx, B, K, d, pos, neg, s);
      break;
  }
  return (int)err;
}
