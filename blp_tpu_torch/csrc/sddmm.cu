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
// so the gathered reads are L2 traffic and the kernel's time is the latency
// of its dependent loads: index, then row, then the shuffle reduction.
//
// Design of the forward (sddmm_fwd): a warp takes a contiguous run of at most
// kTasksPerWarp of one edge row's 1 + K tasks (task 0 the positive pair, task
// 1 + k the k-th negative), so B = 64, K = 64 gives 576 warps in 144 blocks
// of 4 and every SM holds work; a task's score is written by exactly one
// warp. The warp keeps rel[b] and the edge's own rows ent[2b], ent[2b + 1] in
// registers, loads the index pairs of all its tasks in one coalesced load and
// hands them out with shuffles; a task whose head or tail index is an own
// slot (the sampler keeps one own slot in every negative) takes that row from
// registers, so only the other row is gathered. The rows of kInFlight tasks
// are requested before any of them is reduced. Each score is summed per lane,
// then by a shuffle tree, as before; the warp's scores leave in one coalesced
// store. Vector width 4, 2 or 1 follows the width and the pointers'
// alignment; a lane holds C chunks of V units (C = 1 at d = 128). Indices are
// trusted, as the TPU kernel trusts them: the sampler only makes values in
// [0, 2B), and checking them would cost a host sync.
//
// Backward (sddmm_bwd), replacing the TPU package's _bwd (the XLA VJP of
// _sddmm_xla): d_ent (2B, d) and d_rel (B, d) from the cotangents g_pos
// (B, 1) and g_neg (B, K), in one launch that does all the arithmetic. The
// wrapper first sorts the tasks' slot ids (torch's stable sort and
// searchsorted: index bookkeeping only). One warp per gradient row: an
// entity row walks its contributions in that sorted order, gathering each
// task's other row and rel[b] from L2 and adding the partial of its own side;
// a relation row walks its tasks j = 0..K. Each row is written once by its
// warp, with no atomics, so a call gives the same bits every time; every
// product and sum is rounded on its own (no FMA) in the plain version's order,
// so it gives the bits of ops/sddmm.py::sddmm_scores_backward_plain too. Its
// bound is the same kind as the forward's: the 3.9 MB it must move at
// B = 1024 (about 1 µs) against L2 re-reads of the rows for every
// contribution (about 200 MB at B = 1024).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;               // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kTasksPerWarp = 8;        // tasks of one edge row per warp, at most
constexpr int kMaxChunks = 8;           // chunks per lane: units <= 32·V·8
constexpr unsigned kFull = 0xffffffffu;

enum Model { kTransE = 0, kDistMult = 1, kComplEx = 2, kSimplE = 3 };

template <int V> struct Vec;
template <> struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    out[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float* in) {
    p[0] = in[0];
  }
};
template <> struct Vec<2> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    out[0] = v.x; out[1] = v.y;
  }
  static __device__ __forceinline__ void store(float* p, const float* in) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  }
};
template <> struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

// A lane's share of one row: chunk c = lane + 32 i (i < C) covers units
// [c·V, c·V + V). For transe/distmult a unit is one element (held in a); for
// complex/simple it is the pair (j, j + d/2) (first half in a, second in b).
template <int V, int C, bool P>
struct Row {
  float a[C * V];
  float b[C * V];

  __device__ __forceinline__ void load(const float* row, int half, int nchunks,
                                       int lane) {
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int c = lane + 32 * i;
#pragma unroll
      for (int v = 0; v < V; ++v) { a[i * V + v] = 0.0f; b[i * V + v] = 0.0f; }
      if (c < nchunks) {
        Vec<V>::load(row + c * V, &a[i * V]);
        if (P) Vec<V>::load(row + half + c * V, &b[i * V]);
      }
    }
  }

  __device__ __forceinline__ void store(float* row, int half, int nchunks,
                                        int lane) const {
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int c = lane + 32 * i;
      if (c < nchunks) {
        Vec<V>::store(row + c * V, &a[i * V]);
        if (P) Vec<V>::store(row + half + c * V, &b[i * V]);
      }
    }
  }
};

// One unit's score term, as models/scoring.py forms it.
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

// Tasks (forward) or contributions (backward) whose rows a warp requests
// before it uses any of them: fewer when a lane's share of a row is larger.
__host__ __device__ constexpr int in_flight(int c) {
  return c == 1 ? 4 : (c == 2 ? 2 : 1);
}

template <int M, int V, int C>
__global__ void __launch_bounds__(kThreads)
sddmm_fwd(const float* __restrict__ ent, const float* __restrict__ rel,
          const int* __restrict__ neg_idx, int B, int K, int d,
          int warps_per_row, float* __restrict__ pos, float* __restrict__ neg) {
  constexpr bool kPair = (M == kComplEx || M == kSimplE);
  constexpr int kInFlight = in_flight(C);
  using R = Row<V, C, kPair>;
  const int lane = threadIdx.x & 31;
  const int64_t gw = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (gw >= (int64_t)B * warps_per_row) return;   // whole warps leave
  const int b = (int)(gw / warps_per_row);
  const int part = (int)(gw % warps_per_row);
  const int tasks = K + 1;
  const int t0 = (int)((int64_t)part * tasks / warps_per_row);
  const int n = (int)((int64_t)(part + 1) * tasks / warps_per_row) - t0;
  const int half = d / 2;
  const int nchunks = (kPair ? half : d) / V;
  const int own_h = 2 * b, own_t = 2 * b + 1;

  // The index pairs of the warp's tasks: lane l holds task t0 + l.
  int my_h = own_h, my_t = own_t;
  if (lane < n && t0 + lane > 0) {
    const int* p = neg_idx + ((int64_t)b * K + (t0 + lane - 1)) * 2;
    my_h = __ldg(p);
    my_t = __ldg(p + 1);
  }
  R r, oh, ot;
  r.load(rel + (int64_t)b * d, half, nchunks, lane);
  oh.load(ent + (int64_t)own_h * d, half, nchunks, lane);
  ot.load(ent + (int64_t)own_t * d, half, nchunks, lane);

  float result = 0.0f;
  for (int j0 = 0; j0 < n; j0 += kInFlight) {
    R h[kInFlight], t[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int j = j0 + u;
      const int hi = __shfl_sync(kFull, my_h, j & 31);
      const int ti = __shfl_sync(kFull, my_t, j & 31);
      if (j < n) {
        if (hi == own_h) h[u] = oh;
        else if (hi == own_t) h[u] = ot;
        else h[u].load(ent + (int64_t)hi * d, half, nchunks, lane);
        if (ti == own_t) t[u] = ot;
        else if (ti == own_h) t[u] = oh;
        else t[u].load(ent + (int64_t)ti * d, half, nchunks, lane);
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int j = j0 + u;
      if (j >= n) break;   // the same for every lane of the warp
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        if (lane + 32 * i < nchunks) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int e = i * V + v;
            acc += term<M>(h[u].a[e], h[u].b[e], t[u].a[e], t[u].b[e], r.a[e],
                           r.b[e]);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(kFull, acc, off);
      }
      if (lane == j) result = finish<M>(acc);
    }
  }
  if (lane < n) {
    const int task = t0 + lane;
    if (task == 0) {
      pos[b] = result;
    } else {
      neg[(int64_t)b * K + (task - 1)] = result;
    }
  }
}

template <int M, int V, int C>
cudaError_t launch_fwd(const float* ent, const float* rel, const int* neg_idx,
                       int B, int K, int d, float* pos, float* neg,
                       cudaStream_t stream) {
  const int tasks = K + 1;
  const int warps_per_row = (tasks + kTasksPerWarp - 1) / kTasksPerWarp;
  const int64_t warps = (int64_t)B * warps_per_row;
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  sddmm_fwd<M, V, C><<<(unsigned)blocks, kThreads, 0, stream>>>(
      ent, rel, neg_idx, B, K, d, warps_per_row, pos, neg);
  return cudaGetLastError();
}

template <int M, int V>
cudaError_t fwd_chunks(int c, const float* ent, const float* rel,
                       const int* neg_idx, int B, int K, int d, float* pos,
                       float* neg, cudaStream_t s) {
  if (c == 1) return launch_fwd<M, V, 1>(ent, rel, neg_idx, B, K, d, pos, neg, s);
  if (c == 2) return launch_fwd<M, V, 2>(ent, rel, neg_idx, B, K, d, pos, neg, s);
  if (c == 4) return launch_fwd<M, V, 4>(ent, rel, neg_idx, B, K, d, pos, neg, s);
  return launch_fwd<M, V, 8>(ent, rel, neg_idx, B, K, d, pos, neg, s);
}

template <int M>
cudaError_t fwd_model(int v, int c, const float* ent, const float* rel,
                      const int* neg_idx, int B, int K, int d, float* pos,
                      float* neg, cudaStream_t s) {
  if (v == 4) return fwd_chunks<M, 4>(c, ent, rel, neg_idx, B, K, d, pos, neg, s);
  if (v == 2) return fwd_chunks<M, 2>(c, ent, rel, neg_idx, B, K, d, pos, neg, s);
  return fwd_chunks<M, 1>(c, ent, rel, neg_idx, B, K, d, pos, neg, s);
}

// ---- backward ---------------------------------------------------------------
//
// The partial derivatives of one unit's score term, times the task's
// cotangent g, for the head (h), tail (t) and relation (r) rows. Every
// product and sum is rounded on its own (no FMA), in the order
// ops/sddmm.py::_score_partials writes it, so the kernel and the plain
// version give the same bits when they add in the same order.
struct Partials { float ha, hb, ta, tb, ra, rb; };

__device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }

template <int M>
__device__ __forceinline__ Partials partials(float ha, float hb, float ta,
                                             float tb, float ra, float rb,
                                             float g) {
  Partials p;
  if (M == kTransE) {
    // d|x|/dx is sign(x) with sign(0) = 0, as torch's and jax's abs.
    const float x = sub(add(ha, ra), ta);
    const float u = mul(-g, (float)((x > 0.0f) - (x < 0.0f)));
    p.ha = u; p.ta = -u; p.ra = u;
    p.hb = p.tb = p.rb = 0.0f;
  } else if (M == kDistMult) {
    p.ha = mul(mul(ra, ta), g);
    p.ta = mul(mul(ha, ra), g);
    p.ra = mul(mul(ha, ta), g);
    p.hb = p.tb = p.rb = 0.0f;
  } else if (M == kComplEx) {   // a = re, b = im
    p.ha = mul(add(mul(ra, ta), mul(rb, tb)), g);
    p.hb = mul(sub(mul(ra, tb), mul(rb, ta)), g);
    p.ta = mul(sub(mul(ra, ha), mul(rb, hb)), g);
    p.tb = mul(add(mul(ra, hb), mul(rb, ha)), g);
    p.ra = mul(add(mul(ha, ta), mul(hb, tb)), g);
    p.rb = mul(sub(mul(ha, tb), mul(hb, ta)), g);
  } else {                      // SimplE: a = first half, b = second half
    const float g2 = mul(g, 0.5f);
    p.ha = mul(mul(ra, tb), g2);
    p.hb = mul(mul(ta, rb), g2);
    p.ta = mul(mul(rb, hb), g2);
    p.tb = mul(mul(ha, ra), g2);
    p.ra = mul(mul(ha, tb), g2);
    p.rb = mul(mul(ta, hb), g2);
  }
  return p;
}

// Cotangent of task j of edge b: g_pos[b] for the positive pair, else
// g_neg[b, j - 1].
__device__ __forceinline__ float cotangent(const float* g_pos,
                                           const float* g_neg, int b, int j,
                                           int K) {
  return j == 0 ? __ldg(g_pos + b) : __ldg(g_neg + (int64_t)b * K + (j - 1));
}

// One warp per gradient row; blocks [0, 2B) are the entity rows e, blocks
// [2B, 3B) the relation rows b. Entity row e walks its contributions in the
// order of `order` (a stable argsort of the (b, j, side)-ordered slot ids
// `slots`, so each row's contributions come in (b, j, side) order), from
// starts[e] to starts[e + 1]: each is task p >> 1 with e on side p & 1 and
// the task's other row at slots[p ^ 1]; the warp gathers that row and rel[b]
// and adds the partial of e's side. Relation row b walks its tasks j = 0..K
// and adds the partial of r, taking own rows from registers as the forward
// does. The metadata of 32 contributions (or tasks) arrive in one coalesced
// load and go out by shuffles; the rows of kInFlight are requested before any
// is added. Each row is written once, by its warp: no atomics, so the result
// is the same on every call.
template <int M, int V, int C>
__global__ void __launch_bounds__(32)
sddmm_bwd(const float* __restrict__ ent, const float* __restrict__ rel,
          const int* __restrict__ slots, const int64_t* __restrict__ order,
          const int64_t* __restrict__ starts, const float* __restrict__ g_pos,
          const float* __restrict__ g_neg, int B, int K, int d,
          float* __restrict__ d_ent, float* __restrict__ d_rel) {
  constexpr bool kPair = (M == kComplEx || M == kSimplE);
  constexpr int kInFlight = in_flight(C);
  using R = Row<V, C, kPair>;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x;
  const int tasks = K + 1;
  const int half = d / 2;
  const int nchunks = (kPair ? half : d) / V;
  R acc;
#pragma unroll
  for (int e = 0; e < C * V; ++e) { acc.a[e] = 0.0f; acc.b[e] = 0.0f; }

  if (row < 2 * B) {
    R self;
    self.load(ent + (int64_t)row * d, half, nchunks, lane);
    const int64_t lo = starts[row], hi = starts[row + 1];
    for (int64_t i0 = lo; i0 < hi; i0 += 32) {
      const int n = (int)(hi - i0 < 32 ? hi - i0 : 32);
      int other = 0, b = 0, side = 0;
      float g = 0.0f;
      if (lane < n) {
        const int64_t p = order[i0 + lane];
        const int64_t task = p >> 1;
        side = (int)(p & 1);
        other = slots[p ^ 1];
        b = (int)(task / tasks);
        g = cotangent(g_pos, g_neg, b, (int)(task - (int64_t)b * tasks), K);
      }
      for (int j0 = 0; j0 < n; j0 += kInFlight) {
        R o[kInFlight], r[kInFlight];
        int s[kInFlight];
        float gu[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int j = (j0 + u) & 31;
          const int ou = __shfl_sync(kFull, other, j);
          const int bu = __shfl_sync(kFull, b, j);
          s[u] = __shfl_sync(kFull, side, j);
          gu[u] = __shfl_sync(kFull, g, j);
          if (j0 + u < n) {
            o[u].load(ent + (int64_t)ou * d, half, nchunks, lane);
            r[u].load(rel + (int64_t)bu * d, half, nchunks, lane);
          }
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          if (j0 + u >= n) break;   // the same for every lane of the warp
#pragma unroll
          for (int e = 0; e < C * V; ++e) {
            if (s[u] == 0) {        // e is the head
              const Partials p = partials<M>(self.a[e], self.b[e], o[u].a[e],
                                             o[u].b[e], r[u].a[e], r[u].b[e],
                                             gu[u]);
              acc.a[e] = add(acc.a[e], p.ha);
              if (kPair) acc.b[e] = add(acc.b[e], p.hb);
            } else {                // e is the tail
              const Partials p = partials<M>(o[u].a[e], o[u].b[e], self.a[e],
                                             self.b[e], r[u].a[e], r[u].b[e],
                                             gu[u]);
              acc.a[e] = add(acc.a[e], p.ta);
              if (kPair) acc.b[e] = add(acc.b[e], p.tb);
            }
          }
        }
      }
    }
    acc.store(d_ent + (int64_t)row * d, half, nchunks, lane);
  } else {
    const int b = row - 2 * B;
    const int own_h = 2 * b, own_t = 2 * b + 1;
    R r, oh, ot;
    r.load(rel + (int64_t)b * d, half, nchunks, lane);
    oh.load(ent + (int64_t)own_h * d, half, nchunks, lane);
    ot.load(ent + (int64_t)own_t * d, half, nchunks, lane);
    for (int j0 = 0; j0 < tasks; j0 += 32) {
      const int n = tasks - j0 < 32 ? tasks - j0 : 32;
      int my_h = 0, my_t = 0;
      float g = 0.0f;
      if (lane < n) {
        const int64_t q = ((int64_t)b * tasks + j0 + lane) * 2;
        my_h = slots[q];
        my_t = slots[q + 1];
        g = cotangent(g_pos, g_neg, b, j0 + lane, K);
      }
      for (int u0 = 0; u0 < n; u0 += kInFlight) {
        R h[kInFlight], t[kInFlight];
        float gu[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int j = (u0 + u) & 31;
          const int hi = __shfl_sync(kFull, my_h, j);
          const int ti = __shfl_sync(kFull, my_t, j);
          gu[u] = __shfl_sync(kFull, g, j);
          if (u0 + u < n) {
            if (hi == own_h) h[u] = oh;
            else if (hi == own_t) h[u] = ot;
            else h[u].load(ent + (int64_t)hi * d, half, nchunks, lane);
            if (ti == own_t) t[u] = ot;
            else if (ti == own_h) t[u] = oh;
            else t[u].load(ent + (int64_t)ti * d, half, nchunks, lane);
          }
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          if (u0 + u >= n) break;   // the same for every lane of the warp
#pragma unroll
          for (int e = 0; e < C * V; ++e) {
            const Partials p = partials<M>(h[u].a[e], h[u].b[e], t[u].a[e],
                                           t[u].b[e], r.a[e], r.b[e], gu[u]);
            acc.a[e] = add(acc.a[e], p.ra);
            if (kPair) acc.b[e] = add(acc.b[e], p.rb);
          }
        }
      }
    }
    acc.store(d_rel + (int64_t)b * d, half, nchunks, lane);
  }
}

struct BwdArgs {
  const float* ent; const float* rel; const int* slots; const int64_t* order;
  const int64_t* starts; const float* g_pos; const float* g_neg;
  int B, K, d; float* d_ent; float* d_rel;
};

template <int M, int V, int C>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const int64_t blocks = 3 * (int64_t)a.B;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  sddmm_bwd<M, V, C><<<(unsigned)blocks, 32, 0, stream>>>(
      a.ent, a.rel, a.slots, a.order, a.starts, a.g_pos, a.g_neg, a.B, a.K,
      a.d, a.d_ent, a.d_rel);
  return cudaGetLastError();
}

template <int M, int V>
cudaError_t bwd_chunks(int c, const BwdArgs& a, cudaStream_t s) {
  if (c == 1) return launch_bwd<M, V, 1>(a, s);
  if (c == 2) return launch_bwd<M, V, 2>(a, s);
  if (c == 4) return launch_bwd<M, V, 4>(a, s);
  return launch_bwd<M, V, 8>(a, s);
}

template <int M>
cudaError_t bwd_model(int v, int c, const BwdArgs& a, cudaStream_t s) {
  if (v == 4) return bwd_chunks<M, 4>(c, a, s);
  if (v == 2) return bwd_chunks<M, 2>(c, a, s);
  return bwd_chunks<M, 1>(c, a, s);
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % (uintptr_t)bytes) == 0;
}

// Vector width for the rows at ent and rel (and the gradients beside them):
// 4 or 2 where the unit count, the width and the pointers allow it, else 1.
int vector_width(int units, int d, const void* ent, const void* rel) {
  if (units % 4 == 0 && d % 4 == 0 && aligned(ent, 16) && aligned(rel, 16)) {
    return 4;
  }
  if (units % 2 == 0 && d % 2 == 0 && aligned(ent, 8) && aligned(rel, 8)) {
    return 2;
  }
  return 1;
}

// Chunks per lane: the power of two (1, 2, 4 or 8) that covers the row.
int chunks_per_lane(int units, int v) {
  const int per_lane = (units / v + 31) / 32;
  int c = 1;
  while (c < per_lane) c *= 2;
  return c;
}

bool valid(int B, int K, int d, int model) {
  const bool pair = (model == kComplEx || model == kSimplE);
  return B >= 1 && K >= 0 && d >= 1 && model >= 0 && model <= 3 &&
         !(pair && d % 2);
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
  if (!valid(B, K, d, model)) return (int)cudaErrorInvalidValue;
  const bool pair = (model == kComplEx || model == kSimplE);
  const int units = pair ? d / 2 : d;
  const int v = vector_width(units, d, ent, rel);
  if (units > sddmm_max_units(v)) return (int)cudaErrorInvalidValue;
  const int c = chunks_per_lane(units, v);
  cudaStream_t s = (cudaStream_t)stream;
  switch (model) {
    case kTransE:
      return (int)fwd_model<kTransE>(v, c, ent, rel, neg_idx, B, K, d, pos, neg, s);
    case kDistMult:
      return (int)fwd_model<kDistMult>(v, c, ent, rel, neg_idx, B, K, d, pos, neg, s);
    case kComplEx:
      return (int)fwd_model<kComplEx>(v, c, ent, rel, neg_idx, B, K, d, pos, neg, s);
    default:
      return (int)fwd_model<kSimplE>(v, c, ent, rel, neg_idx, B, K, d, pos, neg, s);
  }
}

// Plain C entry point of the backward. ent, rel as for sddmm_launch; slots
// (B, 1 + K, 2) int32: the tasks' slot ids in (b, j, side) order, the own
// pair (2b, 2b + 1) as j = 0; order (B·(1 + K)·2,) int64: a stable argsort
// of slots; starts (2B + 1,) int64: where entity row e's run begins in it;
// g_pos (B,), g_neg (B, K) float32 cotangents; d_ent (2B, d), d_rel (B, d)
// float32 outputs, every element written. All contiguous. Launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int sddmm_backward_launch(const float* ent, const float* rel,
                                     const int* slots, const int64_t* order,
                                     const int64_t* starts, const float* g_pos,
                                     const float* g_neg, int B, int K, int d,
                                     int model, float* d_ent, float* d_rel,
                                     void* stream) {
  if (!valid(B, K, d, model)) return (int)cudaErrorInvalidValue;
  const bool pair = (model == kComplEx || model == kSimplE);
  const int units = pair ? d / 2 : d;
  int v = vector_width(units, d, ent, rel);
  if (v > 1 && !(aligned(d_ent, 4 * v) && aligned(d_rel, 4 * v))) v = 1;
  if (units > sddmm_max_units(v)) return (int)cudaErrorInvalidValue;
  const int c = chunks_per_lane(units, v);
  const BwdArgs a{ent, rel, slots, order, starts, g_pos, g_neg, B, K, d,
                  d_ent, d_rel};
  cudaStream_t s = (cudaStream_t)stream;
  switch (model) {
    case kTransE: return (int)bwd_model<kTransE>(v, c, a, s);
    case kDistMult: return (int)bwd_model<kDistMult>(v, c, a, s);
    case kComplEx: return (int)bwd_model<kComplEx>(v, c, a, s);
    default: return (int)bwd_model<kSimplE>(v, c, a, s);
  }
}
