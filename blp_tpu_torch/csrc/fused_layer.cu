// F1 and F2: the BERT layer's elementwise chains, forward and backward.
//
// No Pallas kernel replaced: in the JAX package XLA fuses these chains of
// blp_tpu/models/bert.py, the bias add of `_dense` (:282) with `poly_gelu`
// (:305) or jax.nn.gelu, and the residual add with `_layer_norm` (:270).
// ops/fused_layer.py holds their plain versions and the autograd wiring.
//
//   F1  y = act(round_out(h + b))           act: none, erf (F.gelu), poly
//       dh = round_h(round_out(g * act'(pre))), db = sum over rows of the same
//   F2  s = round(x + drop(r)), y = (s - mean) * rstd * scale + bias (f32 stats)
//       ds = rstd * (g*scale - mean(g*scale) - xhat * mean(g*scale*xhat)),
//       dscale = sum over rows of g * xhat, dbias = sum over rows of g,
//       dr = drop(ds) (= ds without dropout)
//   drop(v) = keep ? round(v * (1 / keep_p)) : 0, the hidden dropout sites'
//       `_rng_dropout` (models/bert.py); the site kernel applies it alone
//       (the embedding output, forward and backward)
//
// What bounds them on an H100: bytes. F1 moves 4 bytes an element forward
// (bf16 in and out) and 6 backward (g and h in, dh out; for "none" with h
// in g's dtype only g is read, as dh is g); F2 8 forward (x, r
// in; y, s out) and 6 backward (g, s in; ds out; 8 with dr), against at most
// ~60 fp32 operations an element (poly-GeLU's backward): at 3.35 TB/s and 67
// TFLOP/s every kernel is memory-bound. The dropout mask is not read: F2 and
// the site kernel evaluate it in registers (dropout_rng.cuh) from the site's
// seed and each element's flat index in the site (the wrapper passes the
// block's first index), ~25 integer operations an element at 32 bits and ~6
// at 8, which fit under the bytes' time. The design therefore reads each
// input once and writes each output once, in 16-byte vectors of 8 elements
// (two for f32), and keeps every intermediate of the chain in registers:
// where the op-by-op chain wrote and re-read an f32 tensor at each step.
//
// F1 gives each thread one column vector for the whole call (its bias in
// registers) and has it load several rows before the chain: the forward is
// a grid-stride loop whose stride is a multiple of the row, the backward a
// block for each (column tile, row chunk). Its forward writes y row-major
// or, for q, k and v, head-major (B, nh, S, hd), so no transpose copy
// follows; its backward reads the cotangent in either layout, or in the
// (B, nh, hd, S) one that q k^T's backward leaves for k, and writes dh
// row-major. F2's forward and backward hold a row in a warp's registers (w
// <= 4,096), so the backward reads g and s once; the forward's block copies
// its slab of rows, scale and bias into shared memory in bulk
// (bulk_copy.cuh), so its warps run the generator while the rows land and
// scale and bias are read once a block; the backward's warps bring their
// next row in by cp.async while they compute one. F1's backward and F2's
// reduce db, dscale and dbias without atomics on the values: a block owns a
// chunk of rows (the wrapper's `chunk`, a function of the row count) and
// writes one partial row per chunk, adding its rows in a fixed order (F1:
// each row lane its rows in order, then the lanes in a fixed tree; F2: each
// warp its rows in order, then the block's warps in warp order). Each adds
// the partials in the same launch, each column in a fixed tree (strided
// streams of chunks, then the stream sums in order): in F1 the block that
// takes a column tile's last ticket adds that tile's; in F2, whose every
// block writes a partial of all 2w columns, a persistent grid waits at one
// barrier and its blocks share the column groups. So each backward is one
// launch, and a call gives the same bits every time.
//
// Rounding: F1's poly activation and its derivative round every product and
// sum on its own (no FMA), in the order of the plain `poly_gelu` and of the
// VJP autograd takes of it, so they give the plain version's bits; erf
// follows torch's CUDA gelu kernels. F2's row sums run in another order than
// torch's, so F2 agrees with its plain version to f32 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "dropout_rng.cuh"
#include "bulk_copy.cuh"

namespace {

using namespace bulk_copy;

typedef __nv_bfloat16 bf16;

constexpr int kVec = 8;   // elements a thread moves per step
enum Act { kNone = 0, kErf = 1, kPoly = 2 };
enum DType { kF32 = 0, kBF16 = 1 };

// ops/fused_layer.py _POLY_GELU_C, rounded to float as torch rounds them.
__constant__ float kPolyC[7] = {
    0.3985269463542832f, -0.06538842792339565f, 0.009112993720802636f,
    -0.0008789911715555882f, 5.4191581420189626e-05f,
    -1.8919542111355878e-06f, 2.816234526830968e-08f};

__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float v[kVec]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float v[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(bf16* p, const float v[kVec]) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = a;
}

// x rounded to T and back (round to nearest even, as torch's casts).
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

constexpr float kSqrt1_2 = 0.7071067811865476f;     // M_SQRT1_2
constexpr float kInvSqrt2Pi = 0.3989422804014327f;  // M_2_SQRTPI * M_SQRT1_2 / 2

// The polynomial of poly_gelu: p[k] for k = 6..0 (p[6] the top coefficient).
__device__ __forceinline__ void poly_terms(float u, float p[7]) {
  p[6] = kPolyC[6];
#pragma unroll
  for (int k = 5; k >= 0; --k) p[k] = __fadd_rn(__fmul_rn(p[k + 1], u), kPolyC[k]);
}

template <int ACT> __device__ __forceinline__ float act_fwd(float x) {
  if (ACT == kErf)   // torch's GeluCUDAKernelImpl, erf form
    return x * 0.5f * (1.0f + erff(x * kSqrt1_2));
  if (ACT == kPoly) {
    const float xc = clampf(x, -4.0f, 4.0f);
    float p[7];
    poly_terms(__fmul_rn(xc, xc), p);
    const float phi = clampf(__fadd_rn(__fmul_rn(xc, p[0]), 0.5f), 0.0f, 1.0f);
    return __fmul_rn(x, phi);
  }
  return x;
}

// g * act'(x), before the round to the pre-activation's dtype.
template <int ACT> __device__ __forceinline__ float act_bwd(float x, float g) {
  if (ACT == kErf) {  // torch's GeluBackwardCUDAKernelImpl, erf form
    const float cdf = 0.5f * (1.0f + erff(x * kSqrt1_2));
    const float pdf = expf(-0.5f * x * x) * kInvSqrt2Pi;
    return g * (cdf + x * pdf);
  }
  if (ACT == kPoly) {
    // autograd's VJP of poly_gelu, node by node: y = x * phi, phi =
    // clamp(z, 0, 1), z = xc * p0 + 0.5, p_k = p_{k+1} * u + c_k, u = xc * xc,
    // xc = clamp(x, -4, 4); gradients reaching one tensor are added in the
    // order autograd's engine adds them.
    const float xc = clampf(x, -4.0f, 4.0f);
    const float u = __fmul_rn(xc, xc);
    float p[7];
    poly_terms(u, p);
    const float z = __fadd_rn(__fmul_rn(xc, p[0]), 0.5f);
    const float phi = clampf(z, 0.0f, 1.0f);
    const float gx_direct = __fmul_rn(g, phi);
    const float gz = (z >= 0.0f && z <= 1.0f) ? __fmul_rn(g, x) : 0.0f;
    const float gxc_m = __fmul_rn(gz, p[0]);
    float gp = __fmul_rn(gz, xc);            // d/dp0
    float gu = __fmul_rn(gp, p[1]);          // t0 = p1 * u
    gp = __fmul_rn(gp, u);                   // d/dp1
#pragma unroll
    for (int k = 1; k <= 5; ++k) {
      gu = __fadd_rn(gu, __fmul_rn(gp, p[k + 1]));
      if (k < 5) gp = __fmul_rn(gp, u);
    }
    const float gxc_u = __fmul_rn(gu, xc);
    const float gxc = __fadd_rn(__fadd_rn(gxc_m, gxc_u), gxc_u);
    const float gx_clamp = (x >= -4.0f && x <= 4.0f) ? gxc : 0.0f;
    return __fadd_rn(gx_direct, gx_clamp);
  }
  return g;
}

// F2's backward hands its chunk partials from the blocks that write them to
// the blocks that add them: stored so that L2 keeps them before the rows
// streaming through it (evict_last), read once (evict_first), and passed
// through a counter with release and acquire order at GPU scope. The two
// cache policies took 6-8 us off a 0.23-0.37 ms call at 131,072 x 768, in
// calls back to back, after other work and in the W5M step (PERF.md §6,
// F2's backward).
__device__ __forceinline__ void store_kept(float* p, float v) {
  asm volatile(
      "{\n.reg .b64 pol;\ncreatepolicy.fractional.L2::evict_last.b64 pol, 1.0;\n"
      "st.global.L2::cache_hint.f32 [%0], %1, pol;\n}\n" ::"l"(p), "f"(v)
      : "memory");
}

__device__ __forceinline__ float load_last_use(const float* p) {
  float v;
  asm volatile(
      "{\n.reg .b64 pol;\ncreatepolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "ld.global.cg.L2::cache_hint.f32 %0, [%1], pol;\n}\n"
      : "=f"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned add_release(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// cp.async of 16 bytes into shared memory, its groups and the wait for all
// but the newest N of them: F2's backward brings a warp's next row in while
// the warp computes a row.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- F1 ----------------------------------------------------------------------

// Layouts of F1's output (forward) and cotangent (backward). kRows: (rows,
// w) row-major. kHeads: rows = B * S, w = nh * hd, held as (B, nh, S, hd)
// (q, k and v, head-major). kHeadsT: the same held as (B, nh, hd, S), the
// cotangent of k as q k^T's backward leaves it (backward only).
enum Layout { kRows = 0, kHeads = 1, kHeadsT = 2 };

// The head-major geometry: S rows a batch element, nh heads of hd_vec
// vectors.
struct Heads {
  int S, nh, hd_vec;
};

// F1's shapes, the fastest of the values timed on an H100 (PERF.md §6):
// rows a forward thread loads before it computes ("none", and with an
// activation) and the forward's blocks; the backward's tile, 8 column
// vectors (64 columns: one head of q, k or v) and 256 / 8 row lanes, and
// its blocks an SM (launch bounds: fewer registers) for a row-major
// cotangent, and rows in flight and blocks an SM for q's layout and k's
// (k's takes 8, its 8 x 8 transpose). A row-major backward has one block
// shape for every activation, so db adds its rows in one order whether a
// remat policy splits "none" + bias from the activation or not.
constexpr int kF1FwdRows = 2, kF1FwdActRows = 1, kF1FwdGrid = 8192;
constexpr int kF1TileV = 8;
constexpr int kF1RowsMinBlocks = 4, kF1HeadsRows = 2, kF1HeadsMinBlocks = 4,
              kF1HeadsTMinBlocks = 2;
// A head-major row lane takes its 8-row groups R rows at a time.
static_assert(8 % kF1HeadsRows == 0, "kF1HeadsRows divides 8");
template <int ACT> __host__ __device__ constexpr int fwd_rows() {
  return ACT == kNone ? kF1FwdRows : kF1FwdActRows;
}
template <int LAYOUT> __host__ __device__ constexpr int bwd_rows() {
  return LAYOUT == kHeadsT ? 8 : LAYOUT == kHeads ? kF1HeadsRows : 1;
}
template <int LAYOUT> __host__ __device__ constexpr int bwd_min_blocks() {
  return LAYOUT == kHeadsT ? kF1HeadsTMinBlocks
         : LAYOUT == kHeads ? kF1HeadsMinBlocks : kF1RowsMinBlocks;
}

// Element offset of row r's vector cv in a head-major tensor: the vector
// stays in head n = cv / hd_vec (hd % 8 == 0).
__device__ __forceinline__ long long heads_off(int r, int n, int dv, const Heads& hs) {
  const int bi = r / hs.S, s = r - bi * hs.S;
  return (((long long)bi * hs.nh + n) * hs.S + s) * (hs.hd_vec * kVec) + dv * kVec;
}

// A grid-stride loop over the row-major vectors whose stride (the grid's
// threads) is a multiple of w_vec: each thread keeps one column vector, its
// bias in registers, and rows r, r + r_step, ...; it loads kFwdRows of
// them before the chain and stores row-major or head-major.
template <typename TH, typename TO, int ACT, bool HEADS>
__global__ void __launch_bounds__(256)
bias_act_fwd(const TH* __restrict__ h, const float* __restrict__ b,
             TO* __restrict__ y, long long n_vec, int w_vec, Heads hs) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (t >= n_vec) return;
  const int cv = (int)(t % w_vec);
  const int r_step = (int)(stride / w_vec);
  float bb[kVec];
  if (b != nullptr) load8(b + cv * kVec, bb);
  const int n = HEADS ? cv / hs.hd_vec : 0;
  const int dv = HEADS ? cv - n * hs.hd_vec : 0;
  int r = (int)(t / w_vec);
  constexpr int kFwdRows = fwd_rows<ACT>();
  for (long long i = t; i < n_vec; i += kFwdRows * stride, r += kFwdRows * r_step) {
    float v[kFwdRows][kVec];
#pragma unroll
    for (int j = 0; j < kFwdRows; ++j)
      if (i + j * stride < n_vec) load8(h + (i + j * stride) * kVec, v[j]);
#pragma unroll
    for (int j = 0; j < kFwdRows; ++j) {
      if (i + j * stride < n_vec) {
        if (b != nullptr) {
#pragma unroll
          for (int k = 0; k < kVec; ++k) v[j][k] = __fadd_rn(v[j][k], bb[k]);
        }
#pragma unroll
        for (int k = 0; k < kVec; ++k) v[j][k] = act_fwd<ACT>(round_to<TO>(v[j][k]));
        store8(y + (HEADS ? heads_off(r + j * r_step, n, dv, hs) : (i + j * stride) * kVec),
               v[j]);
      }
    }
  }
}

// db for the kF1TileV * 8 columns of tile `tile`: the chunks' partial rows added
// in a fixed order (strided streams of chunks, then the streams in order),
// a float4 of columns a thread. Read through L2: other blocks wrote them.
__device__ void tile_total(const float* __restrict__ partial, float* __restrict__ db,
                           int tile, long long w, int n_chunks) {
  constexpr int TV = kF1TileV;
  constexpr int kQ = TV * kVec / 4 < 256 ? TV * kVec / 4 : 256;   // float4s a pass
  constexpr int kStreams = 256 / kQ;
  __shared__ float4 streams[kStreams][kQ];
  const int q = threadIdx.x % kQ, st = threadIdx.x / kQ;
  for (int q0 = 0; q0 < TV * kVec / 4; q0 += kQ) {
    const long long col = (long long)tile * TV * kVec + (q0 + q) * 4;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (col < w) {
#pragma unroll 16
      for (int c = st; c < n_chunks; c += kStreams) {
        const float4 p = __ldcg(reinterpret_cast<const float4*>(partial + c * w + col));
        s.x = __fadd_rn(s.x, p.x); s.y = __fadd_rn(s.y, p.y);
        s.z = __fadd_rn(s.z, p.z); s.w = __fadd_rn(s.w, p.w);
      }
    }
    streams[st][q] = s;
    __syncthreads();
    if (st == 0 && col < w) {
      float4 t = streams[0][q];
#pragma unroll
      for (int k = 1; k < kStreams; ++k) {
        t.x = __fadd_rn(t.x, streams[k][q].x); t.y = __fadd_rn(t.y, streams[k][q].y);
        t.z = __fadd_rn(t.z, streams[k][q].z); t.w = __fadd_rn(t.w, streams[k][q].w);
      }
      *reinterpret_cast<float4*>(db + col) = t;
    }
    __syncthreads();
  }
}

// Block (column tile, row chunk blockIdx.y). A warp is 8 column vectors x 4 row lanes, so a head-major
// cotangent's loads are whole 32-byte sectors in every layout. A row lane
// takes the chunk's rows R at a time (below): it loads their g (and h)
// before the chain, writes dh row-major
// (unless dh is null: "none" with h in g's dtype and g row-major, where dh
// is g itself) and adds the rounded d/dpre into its column vector's sums
// in row order. kHeadsT loads
// a column vector's 8 head columns along S, 8 positions each, and
// transposes the 8 x 8 block in registers. db: the row lanes' sums are
// added in a fixed order (4 runs of 8 lanes, then the runs) into the
// chunk's partial row; after a fence the block takes a ticket of its column
// tile, and the block that takes the last one adds the tile's partials in a
// fixed order (tile_total) and sets the ticket back to 0 for the next call.
// So F1's backward is one launch, and gives the same bits on every call.
template <typename TH, typename TO, int ACT, int LAYOUT>
__global__ void __launch_bounds__(256, bwd_min_blocks<LAYOUT>())
bias_act_bwd(const TO* __restrict__ g, const TH* __restrict__ h,
             const float* __restrict__ b, TH* __restrict__ dh,
             float* __restrict__ partial, float* __restrict__ db,
             unsigned* __restrict__ tickets, int rows, int w_vec, int chunk,
             int n_chunks, Heads hs) {
  constexpr int R = bwd_rows<LAYOUT>();
  constexpr int TV = kF1TileV, kLanes = 256 / TV, kCols = TV * kVec;
  constexpr int kRuns = kCols < 256 ? 256 / kCols : 1;   // runs of lanes summed apart
  __shared__ float stage[kLanes][kCols + 1];
  __shared__ float runs[kRuns][kCols];
  __shared__ bool last;
  const int cvt = threadIdx.x % TV;                      // vector in the tile
  const int cv = blockIdx.x * TV + cvt;
  const int rl = threadIdx.x / TV;                       // row lane
  const bool on = cv < w_vec;
  const long long w = (long long)w_vec * kVec;
  float bb[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) bb[k] = 0.0f;
  if (ACT != kNone && b != nullptr && on) load8(b + cv * kVec, bb);
  const int n = LAYOUT != kRows ? cv / hs.hd_vec : 0;
  const int dv = LAYOUT != kRows ? cv - n * hs.hd_vec : 0;
  const int c = blockIdx.y;
  const int r0 = c * chunk, r1 = r0 + chunk < rows ? r0 + chunk : rows;
  float acc[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc[k] = 0.0f;
  // R rows starting at rg: their g (and h) loaded before the chain, dh
  // stored, and their d/dpre added into acc in row order.
  const auto rows_from = [&](const int rg) {
    float d[R][kVec];
    if constexpr (LAYOUT == kHeadsT) {
      // S % 8 == 0 and chunk % 8 == 0: the group is 8 positions of one
      // sequence.
      const int bi = rg / hs.S, s = rg - bi * hs.S;
      const TO* p = g + (((long long)bi * hs.nh + n) * hs.hd_vec * kVec + dv * kVec) * hs.S + s;
      float t[kVec][R];
#pragma unroll
      for (int i = 0; i < kVec; ++i) load8(p + (long long)i * hs.S, t[i]);
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int i = 0; i < kVec; ++i) d[j][i] = t[i][j];
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (rg + j < r1)
          load8(g + (LAYOUT == kHeads ? heads_off(rg + j, n, dv, hs)
                                      : (rg + j) * w + cv * kVec), d[j]);
    }
    if constexpr (ACT != kNone) {
      float x[R][kVec];
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (rg + j < r1) load8(h + (rg + j) * w + cv * kVec, x[j]);
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const float pre = round_to<TO>(b != nullptr ? __fadd_rn(x[j][k], bb[k]) : x[j][k]);
          d[j][k] = round_to<TO>(act_bwd<ACT>(pre, d[j][k]));
        }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (rg + j < r1) {
        if (dh != nullptr) store8(dh + (rg + j) * w + cv * kVec, d[j]);
#pragma unroll
        for (int k = 0; k < kVec; ++k) acc[k] = __fadd_rn(acc[k], d[j][k]);
      }
    }
  };
  if constexpr (LAYOUT == kRows) {
    // Row lane rl takes rows rl, rl + kLanes, ...; unrolled, four rows'
    // loads are in flight while each is computed.
#pragma unroll 4
    for (int rg = r0 + rl; on && rg < r1; rg += kLanes) rows_from(rg);
  } else {
    // Head-major: row lane rl owns the chunk's 8-row groups rl, rl +
    // kLanes, ... and takes each R rows at a time, so its sums run in row
    // order whatever R: db has the same bits for q's cotangent whether it
    // comes contiguous or strided as k's.
    for (int rg8 = r0 + rl * 8; on && rg8 < r1; rg8 += kLanes * 8)
#pragma unroll 1
      for (int sub = 0; sub < 8; sub += R) rows_from(rg8 + sub);
  }
  if (partial == nullptr) return;
#pragma unroll
  for (int k = 0; k < kVec; ++k) stage[rl][cvt * kVec + k] = acc[k];
  __syncthreads();
  for (int q = threadIdx.x % kCols, run = threadIdx.x / kCols; q < kCols; q += 256) {
    float t = 0.0f;
#pragma unroll
    for (int l = 0; l < kLanes / kRuns; ++l)
      t = __fadd_rn(t, stage[run * (kLanes / kRuns) + l][q]);
    runs[run][q] = t;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < kCols; q += 256) {
    if (blockIdx.x * TV + q / kVec < w_vec) {
      float t = runs[0][q];
#pragma unroll
      for (int k = 1; k < kRuns; ++k) t = __fadd_rn(t, runs[k][q]);
      partial[c * w + blockIdx.x * kCols + q] = t;
    }
  }
  // The barrier orders the block's partial writes before thread 0's fence
  // (cumulative), so no other thread waits for its stores to drain.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&tickets[blockIdx.x], 1u) == (unsigned)(n_chunks - 1);
  }
  __syncthreads();
  if (last) {
    __threadfence();
    tile_total(partial, db, blockIdx.x, w, n_chunks);
    if (threadIdx.x == 0) tickets[blockIdx.x] = 0u;
  }
}

// ---- F2 ----------------------------------------------------------------------

// drop(v) of an 8-element vector at flat site index n (n % 8 == 0), in
// place: v * (1 / keep_p) rounded to T where kept, else 0.
template <typename T>
__device__ __forceinline__ void drop8(const dropout_rng::Site& drop,
                                      unsigned long long n, float v[kVec]) {
  const uint32_t keep = dropout_rng::keep_run<kVec>(drop, n);
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    v[k] = (keep >> k) & 1u ? round_to<T>(__fmul_rn(v[k], drop.inv_keep_p)) : 0.0f;
}

// v rounded to T and back, two at a time for bf16 (one pack and two shifts,
// where a conversion each runs at a quarter of the rate; round_to's values).
template <typename T> __device__ __forceinline__ void round8(float v[kVec]) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      const float2 f = __bfloat1622float2(__floats2bfloat162_rn(v[2 * i], v[2 * i + 1]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// F2's forward: a block a slab of W consecutive rows, W its warps (8 unless
// 8 wide f32 rows of x and r do not fit a block's shared memory; `f2_plan`).
// Thread 0 copies the slab's rows of x, and of r, and scale and bias into
// shared memory with one bulk copy each, all completing on one mbarrier, so
// scale and bias are read once a block and not once a row. Warp k takes row
// k: it evaluates the row's keep bits while the copies land, then forms each
// rounded sum s = round(x + drop(r)) from shared memory, writes s (unless s
// is null: a call whose sum no backward needs), reduces and writes y.
// kF2Blocks blocks an SM keep copies in flight while the others compute: at
// the W5M train shape one slab a block beat a persistent grid walking every
// slab through one ring of 4 slabs by 4-12%, and runs of 2 or 4 slabs
// through a ring a block by 1-4% (PERF.md §6). Lane l owns vectors l,
// l + 32, ... (at most NV, so w <= 256 * NV); the row's sums run in the
// order of the vectors and then through warp_sum, and the variance is taken
// about the mean from the same registers. At 8 bits the two lanes of a pair
// hold the two halves of each Philox call where the row starts on a call
// (its flat index a multiple of 16): each evaluates one call of two and they
// swap words. `n_off` is the flat site index of x's first element (a hidden
// dropout site is (B, S, H), and x a run of its rows). DROP: the call has a
// dropout site (a kernel without one holds no generator code).
constexpr int kF2Warps = 8;             // warps (rows) a block, at most
constexpr int kF2Blocks = 3;            // blocks an SM (launch bounds), NV <= 3
// The slab's mbarrier, padded so that the copies land 128-byte aligned (at 16
// bytes the same kernel ran 12% slower).
constexpr size_t kF2BarrierBytes = 128;

struct F2Args {
  const void* x;
  const void* r;        // null: LN of x alone
  const float* scale;
  const float* bias;
  void* y;
  void* s;              // null: the sum is not written
  float* mean;
  float* rstd;
  long long rows;
  int w;
  float eps;
  dropout_rng::Site drop;
  unsigned long long n_off;
};

// The keep bits of a lane's NV vectors of the row at flat index n_row (8
// bits a vector, four vectors a word).
template <int NV>
__device__ __forceinline__ void row_keep_bits(const dropout_rng::Site& d,
                                              unsigned long long n_row, int lane,
                                              uint32_t kb[(NV + 3) / 4]) {
  uint32_t bits[NV];
  const auto at = [&](int l, int j) { return n_row + (unsigned long long)kVec * (l + 32 * j); };
  if (d.nbits == 32) {
#pragma unroll
    for (int j = 0; j < NV; ++j) bits[j] = dropout_rng::lane_bits<32>(d, at(lane, j));
  } else if (d.nbits == 16) {
#pragma unroll
    for (int j = 0; j < NV; ++j) bits[j] = dropout_rng::lane_bits<16>(d, at(lane, j));
  } else if (n_row % 16 == 0) {   // vectors l ^ 1 and l share a call: pairs of them
#pragma unroll
    for (int j = 0; j < NV; j += 2) {
      if (j + 1 < NV) {
        const uint32_t b = dropout_rng::pair_bits8(d, at(lane & ~1, j), at(lane & ~1, j + 1),
                                                   lane & 1);
        bits[j] = b & 0xFFu;
        bits[j + 1] = b >> 8;
      } else {
        bits[j] = dropout_rng::lane_bits<8>(d, at(lane, j));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < NV; ++j) bits[j] = dropout_rng::lane_bits<8>(d, at(lane, j));
  }
#pragma unroll
  for (int i = 0; i < (NV + 3) / 4; ++i) kb[i] = 0;
#pragma unroll
  for (int j = 0; j < NV; ++j) kb[j / 4] |= bits[j] << (8 * (j % 4));
}

template <typename TX, typename TO, int NV, bool DROP>
__global__ void __launch_bounds__(32 * kF2Warps, NV <= 3 ? kF2Blocks : 1)
add_ln_fwd(const F2Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x >> 5, w = a.w, w_vec = w / kVec;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool with_r = a.r != nullptr;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  const float* sb_s = reinterpret_cast<const float*>(smem + kF2BarrierBytes);   // scale, bias
  const TX* xs = reinterpret_cast<const TX*>(smem + kF2BarrierBytes + 2 * w * sizeof(float));
  const long long r0 = (long long)blockIdx.x * warps;
  if (threadIdx.x == 0) {
    const long long n = a.rows - r0 < warps ? a.rows - r0 : warps;
    const uint32_t bytes = (uint32_t)(n * w * sizeof(TX)), sb_bytes = w * sizeof(float);
    mbar_init(full, 1);
    mbar_init_fence();
    mbar_arrive_expect_tx(full, 2 * sb_bytes + (with_r ? 2 : 1) * bytes);
    bulk_load(smem + kF2BarrierBytes, a.scale, sb_bytes, full);
    bulk_load(smem + kF2BarrierBytes + sb_bytes, a.bias, sb_bytes, full);
    bulk_load(const_cast<TX*>(xs), static_cast<const TX*>(a.x) + r0 * w, bytes, full);
    if (with_r)
      bulk_load(const_cast<TX*>(xs) + warps * w, static_cast<const TX*>(a.r) + r0 * w, bytes,
                full);
  }
  __syncthreads();
  const long long row = r0 + warp;
  if (row >= a.rows) return;   // the whole warp
  uint32_t kb[(NV + 3) / 4];
  if constexpr (DROP) row_keep_bits<NV>(a.drop, a.n_off + (unsigned long long)row * w, lane, kb);
  mbar_wait(full, 0);
  const TX* xr = xs + warp * w;                 // the row of x
  const TX* rr = xs + (warps + warp) * w;       // and of r
  float v[NV][kVec];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int cv = lane + 32 * j;
    if (cv < w_vec) {
      load8(xr + cv * kVec, v[j]);
      if (with_r) {
        float rv[kVec];
        load8(rr + cv * kVec, rv);
        if constexpr (DROP) {   // drop(r): r * (1 / keep_p) rounded where kept
          const uint32_t keep = kb[j / 4] >> (8 * (j % 4));
#pragma unroll
          for (int k = 0; k < kVec; ++k)
            rv[k] = (keep >> k) & 1u ? __fmul_rn(rv[k], a.drop.inv_keep_p) : 0.0f;
          round8<TX>(rv);
        }
#pragma unroll
        for (int k = 0; k < kVec; ++k) v[j][k] = __fadd_rn(v[j][k], rv[k]);
        round8<TX>(v[j]);
      }
    }
  }

  const long long base = row * w;
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int cv = lane + 32 * j;
    if (cv < w_vec) {
      if (a.s != nullptr) store8(static_cast<TX*>(a.s) + base + cv * kVec, v[j]);
#pragma unroll
      for (int k = 0; k < kVec; ++k) sum += v[j][k];
    }
  }
  const float mu = warp_sum(sum) / (float)w;
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (lane + 32 * j < w_vec) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float d = v[j][k] - mu;
        sq += d * d;
      }
    }
  }
  const float rstd = 1.0f / sqrtf(warp_sum(sq) / (float)w + a.eps);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int cv = lane + 32 * j;
    if (cv < w_vec) {
      float scv[kVec], biv[kVec];
      load8(sb_s + cv * kVec, scv);
      load8(sb_s + w + cv * kVec, biv);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        v[j][k] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[j][k], mu), rstd), scv[k]), biv[k]);
      store8(static_cast<TO*>(a.y) + base + cv * kVec, v[j]);
    }
  }
  if (lane == 0) {
    a.mean[row] = mu;
    a.rstd[row] = rstd;
  }
}

// F2's dscale and dbias: the sums over the n_chunks chunk partials (rows of
// w2 = 2w) of the kF2Cols columns from c0, each in a fixed tree: thread
// (q, st) adds column c0 + q over chunks st, st + 32, ... in chunk order,
// then the 32 stream sums are added in stream order. A thread issues the
// loads of its chunks (16 a batch) before it adds them. 256 threads.
constexpr int kF2Cols = 8, kF2Streams = 32;
__device__ void f2_column_sums(const float* __restrict__ partial, float* __restrict__ dsb,
                               long long c0, long long w2, int n_chunks) {
  constexpr int kBatch = 16;
  __shared__ float streams[kF2Streams][kF2Cols + 1];
  const int q = threadIdx.x % kF2Cols, st = threadIdx.x / kF2Cols;
  const long long col = c0 + q;
  float acc = 0.0f;
  if (col < w2) {
    for (int c = st; c < n_chunks; c += kBatch * kF2Streams) {
      float p[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (c + i * kF2Streams < n_chunks)
          p[i] = load_last_use(partial + (long long)(c + i * kF2Streams) * w2 + col);
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (c + i * kF2Streams < n_chunks) acc = __fadd_rn(acc, p[i]);
    }
  }
  streams[st][q] = acc;
  __syncthreads();
  if (st == 0 && col < w2) {
    float t = streams[0][q];
#pragma unroll
    for (int k = 1; k < kF2Streams; ++k) t = __fadd_rn(t, streams[k][q]);
    dsb[col] = t;
  }
  __syncthreads();
}

// Whether F2's backward stages a warp's next row of g and s in shared memory
// (two slots a warp): rows of at most 768 (NV <= 3), and not f32 g with f32
// s, whose slots would not leave two blocks an SM.
template <typename TS, typename TG, int NV>
__host__ __device__ constexpr bool f2_staged() {
  return NV <= 3 && sizeof(TG) + sizeof(TS) <= 6;
}

// The state words of F2's backward: [0] the blocks arrived, over all
// launches (mod 2^32); [1] its value when the running launch began.
constexpr int kF2State = 2;

// A block takes a chunk of rows at a time, a warp a row with the row in
// registers (lane l owns column vectors l, l + 32, ..., at most NV): g and
// s are read once, the row sums give ds, and each lane adds g * xhat and g
// into its columns' dscale and dbias partials, in the order of the warp's
// rows (r0 + warp, r0 + warp + 8, ...). Then the block's warps add their
// partials in warp order through shared memory, a vector index at a time,
// into the chunk's partial row (dscale in columns [0, w), dbias in [w,
// 2w)). With dropout (DROP) the branch's gradient dr = drop(round(ds)) is
// written beside ds, its mask evaluated again from the seed. Where
// f2_staged, a warp's next row of g and s comes into shared memory by
// cp.async while it computes a row, so each warp has two rows' loads in
// flight and no register holds them (at 131,072 x 768, 77-81% of the bound
// against 64-67% with one row in flight; PERF.md §6).
//
// dscale and dbias in the same launch: a persistent grid (the blocks the
// card holds at once, launched cooperatively so that all are resident),
// block b taking chunks b, b + gridDim.x, ... After its last partial row
// (or none, where the grid is wider than the chunks) a block arrives
// (state[0], release order) and waits until every block has (acquire
// order); the last to arrive moves state[1] on by the grid for the next
// launch on the stream, so no word is set back. Then block b adds the
// partials of the 8-column groups b, b + gridDim.x, ... (f2_column_sums).
// One arrival a block, not one a chunk: at 131,072 rows a block a chunk,
// with the last 64 blocks adding the columns, was no faster than a second
// kernel adding them (PERF.md §6). The sums' order is that of the
// chunk plan alone, so their bits depend on neither the grid nor the
// blocks' order.
template <typename TS, typename TG, int NV, bool DROP>
__global__ void __launch_bounds__(256, 2)
add_ln_bwd(const TG* __restrict__ g, const TS* __restrict__ s,
           const float* __restrict__ mean, const float* __restrict__ rstd,
           const float* __restrict__ scale, TS* __restrict__ ds,
           TS* __restrict__ dr, float* __restrict__ partial, float* __restrict__ dsb,
           unsigned* __restrict__ state, long long rows, int w, int chunk,
           int n_chunks, dropout_rng::Site drop, unsigned long long n_off) {
  constexpr int kWarps = 8;
  constexpr bool kStaged = f2_staged<TS, TG, NV>();
  __shared__ float stage[kWarps][32][2 * kVec];
  extern __shared__ __align__(16) unsigned char row_slots[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w_vec = w / kVec;
  const size_t slot_bytes = (size_t)w * (sizeof(TG) + sizeof(TS));
  // Row `row` of g and s into this warp's slot: each lane copies the vectors
  // it reads back itself, so no lane waits for another.
  const auto prefetch = [&](long long row, int slot) {
    unsigned char* b = row_slots + (size_t)(2 * warp + slot) * slot_bytes;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int cv = lane + 32 * j;
      if (cv < w_vec) {
#pragma unroll
        for (int h = 0; h < (int)(sizeof(TG) * kVec / 16); ++h)
          cp_async16(b + (cv * kVec * sizeof(TG) + 16 * h), g + row * w + cv * kVec + h * 16 / sizeof(TG));
#pragma unroll
        for (int h = 0; h < (int)(sizeof(TS) * kVec / 16); ++h)
          cp_async16(b + (w * sizeof(TG) + cv * kVec * sizeof(TS) + 16 * h),
                     s + row * w + cv * kVec + h * 16 / sizeof(TS));
      }
    }
  };
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const long long r0 = (long long)c * chunk;
    const long long r1 = r0 + chunk < rows ? r0 + chunk : rows;
    float as[NV][kVec], ab[NV][kVec];
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int k = 0; k < kVec; ++k) as[j][k] = ab[j][k] = 0.0f;
    if constexpr (kStaged) {
      if (r0 + warp < r1) prefetch(r0 + warp, 0);
      cp_async_commit();
    }
    int slot = 0;
    for (long long row = r0 + warp; row < r1; row += kWarps, slot ^= 1) {
      const long long base = row * w;
      const TG* gr = g + base;
      const TS* sr = s + base;
      if constexpr (kStaged) {
        if (row + kWarps < r1) prefetch(row + kWarps, slot ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
        const unsigned char* b = row_slots + (size_t)(2 * warp + slot) * slot_bytes;
        gr = reinterpret_cast<const TG*>(b);
        sr = reinterpret_cast<const TS*>(b + w * sizeof(TG));
      }
      const float mu = mean[row], rs = rstd[row];
      float gs[NV][kVec], xh[NV][kVec];
      float c1 = 0.0f, c2 = 0.0f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int cv = lane + 32 * j;
        if (cv < w_vec) {
          float gv[kVec], sc[kVec];
          load8(gr + cv * kVec, gv);
          load8(sr + cv * kVec, xh[j]);
          load8(scale + cv * kVec, sc);
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            xh[j][k] = (xh[j][k] - mu) * rs;
            gs[j][k] = gv[k] * sc[k];
            c1 += gs[j][k];
            c2 += gs[j][k] * xh[j][k];
            as[j][k] = __fadd_rn(as[j][k], __fmul_rn(gv[k], xh[j][k]));
            ab[j][k] = __fadd_rn(ab[j][k], gv[k]);
          }
        }
      }
      c1 = warp_sum(c1) / (float)w;
      c2 = warp_sum(c2) / (float)w;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int cv = lane + 32 * j;
        if (cv < w_vec) {
#pragma unroll
          for (int k = 0; k < kVec; ++k)
            gs[j][k] = round_to<TS>(rs * (gs[j][k] - c1 - xh[j][k] * c2));
          store8(ds + base + cv * kVec, gs[j]);
          if constexpr (DROP) {
            drop8<TS>(drop, n_off + base + cv * kVec, gs[j]);
            store8(dr + base + cv * kVec, gs[j]);
          }
        }
      }
    }
    if constexpr (kStaged) cp_async_wait<0>();
    float* out = partial + (long long)c * 2 * w;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        stage[warp][lane][k] = as[j][k];
        stage[warp][lane][kVec + k] = ab[j][k];
      }
      __syncthreads();
      for (int v = threadIdx.x; v < 32 * 2 * kVec; v += blockDim.x) {
        const int ln = v / (2 * kVec), q = v % (2 * kVec);
        const int cv = ln + 32 * j;
        if (cv < w_vec) {
          float t = 0.0f;
#pragma unroll
          for (int wp = 0; wp < kWarps; ++wp) t = __fadd_rn(t, stage[wp][ln][q]);
          store_kept(out + (q < kVec ? 0 : w) + cv * kVec + q % kVec, t);
        }
      }
      __syncthreads();
    }
  }
  // The barrier above orders the block's partial writes before thread 0's
  // release (cumulative).
  if (threadIdx.x == 0) {
    const unsigned base = load_relaxed(&state[1]);
    if (add_release(&state[0], 1u) - base == gridDim.x - 1)   // the last to arrive
      state[1] = base + gridDim.x;
    while (load_acquire(&state[0]) - base < gridDim.x) __nanosleep(32);
  }
  __syncthreads();
  for (long long c0 = (long long)blockIdx.x * kF2Cols; c0 < 2LL * w;
       c0 += (long long)gridDim.x * kF2Cols)
    f2_column_sums(partial, dsb, c0, 2LL * w, n_chunks);
}

// ---- launches ----------------------------------------------------------------

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

bool shape_ok(long long rows, int w) { return rows > 0 && w > 0 && w % kVec == 0; }

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// The forward's grid: kF1FwdGrid blocks (a grid of what the card holds at
// once ran slower, PERF.md §6), rounded down to a multiple of w_vec /
// gcd(w_vec, 256) blocks (its threads then a multiple of w_vec), and no
// more than the vectors need.
template <typename TH, typename TO, int ACT, bool HEADS>
void f1_fwd_launch(const void* h, const float* b, void* y, int rows, int w_vec,
                   const Heads& hs, cudaStream_t st) {
  const auto kernel = bias_act_fwd<TH, TO, ACT, HEADS>;
  const long long n_vec = (long long)rows * w_vec;
  const long long unit = w_vec / gcd(w_vec, 256);
  const long long need = ((n_vec + 255) / 256 + unit - 1) / unit * unit;
  long long blocks = kF1FwdGrid / unit * unit;
  if (blocks < unit) blocks = unit;
  if (blocks > need) blocks = need;
  kernel<<<(unsigned)blocks, 256, 0, st>>>(static_cast<const TH*>(h), b,
                                           static_cast<TO*>(y), n_vec, w_vec, hs);
}

// heads null: row-major; else head-major, "none" only (the layout of q, k
// and v, which have no activation).
template <typename TH, typename TO>
cudaError_t f1_fwd(int act, const void* h, const float* b, void* y, int rows,
                   int w_vec, const Heads* heads, cudaStream_t st) {
  const Heads hs = heads != nullptr ? *heads : Heads{1, 1, 1};
  if (heads != nullptr) {
    if (act != kNone) return cudaErrorInvalidValue;
    f1_fwd_launch<TH, TO, kNone, true>(h, b, y, rows, w_vec, hs, st);
    return cudaGetLastError();
  }
  switch (act) {
    case kNone: f1_fwd_launch<TH, TO, kNone, false>(h, b, y, rows, w_vec, hs, st); break;
    case kErf: f1_fwd_launch<TH, TO, kErf, false>(h, b, y, rows, w_vec, hs, st); break;
    case kPoly: f1_fwd_launch<TH, TO, kPoly, false>(h, b, y, rows, w_vec, hs, st); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename TH, typename TO, int ACT, int LAYOUT>
void f1_bwd_launch(const void* g, const void* h, const float* b, void* dh,
                   float* partial, float* db, unsigned* tickets, int rows,
                   int w_vec, int chunk, const Heads& hs, cudaStream_t st) {
  const auto kernel = bias_act_bwd<TH, TO, ACT, LAYOUT>;
  const int tiles = (w_vec + kF1TileV - 1) / kF1TileV;
  const int n_chunks = (rows + chunk - 1) / chunk;
  const dim3 grid(tiles, n_chunks);
  kernel<<<grid, 256, 0, st>>>(static_cast<const TO*>(g), static_cast<const TH*>(h), b,
                               static_cast<TH*>(dh), partial, db, tickets, rows,
                               w_vec, chunk, n_chunks, hs);
}

template <typename TH, typename TO>
cudaError_t f1_bwd(int act, int layout, const void* g, const void* h,
                   const float* b, void* dh, float* partial, float* db,
                   unsigned* tickets, int rows, int w_vec, int chunk,
                   const Heads& hs, cudaStream_t st) {
  if (layout != kRows && act != kNone) return cudaErrorInvalidValue;
#define F1_BWD(ACT, LAYOUT) f1_bwd_launch<TH, TO, ACT, LAYOUT>( \
    g, h, b, dh, partial, db, tickets, rows, w_vec, chunk, hs, st)
  if (layout == kHeads) F1_BWD(kNone, kHeads);
  else if (layout == kHeadsT) F1_BWD(kNone, kHeadsT);
  else if (act == kNone) F1_BWD(kNone, kRows);
  else if (act == kErf) F1_BWD(kErf, kRows);
  else if (act == kPoly) F1_BWD(kPoly, kRows);
  else return cudaErrorInvalidValue;
#undef F1_BWD
  return cudaGetLastError();
}

// F2's launches carry the dropout site and the call's first flat index in
// it (no dropout: nbits 0).
struct Drop {
  dropout_rng::Site site;
  unsigned long long n_off;
};

// F2's forward plan for rows of w elements of `elem` bytes, x alone or x
// and r (`tensors`): kF2Warps rows a block, fewer where they do not fit a
// block's shared memory (8 f32 rows of x and r of 4,096), and that memory.
struct F2Plan {
  int warps;
  size_t smem;
};
F2Plan f2_plan(int w, size_t elem, int tensors) {
  const size_t fixed = kF2BarrierBytes + 2 * (size_t)w * sizeof(float);
  const size_t row = (size_t)w * elem * tensors;
  const size_t fit = (bulk_copy::kMaxSmem - fixed) / row;
  const int warps = fit < (size_t)kF2Warps ? (int)fit : kF2Warps;
  return F2Plan{warps, fixed + (size_t)warps * row};
}

template <typename TX, typename TO, int NV>
cudaError_t f2_fwd_nv(const F2Args& a, cudaStream_t st) {
  const auto kernel = a.drop.nbits != 0 ? add_ln_fwd<TX, TO, NV, true>
                                        : add_ln_fwd<TX, TO, NV, false>;
  const F2Plan plan = f2_plan(a.w, sizeof(TX), a.r != nullptr ? 2 : 1);
  const cudaError_t err = raise_smem_limit((const void*)kernel, plan.smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (a.rows + plan.warps - 1) / plan.warps;
  kernel<<<(unsigned)blocks, 32 * plan.warps, plan.smem, st>>>(a);
  return cudaGetLastError();
}

// The fewest vectors a lane that hold the row: 3 at H 768, 4 at H 1024.
template <typename TX, typename TO>
cudaError_t f2_fwd(const F2Args& a, cudaStream_t st) {
  const int per_lane = (a.w / kVec + 31) / 32;
  if (per_lane <= 1) return f2_fwd_nv<TX, TO, 1>(a, st);
  if (per_lane <= 2) return f2_fwd_nv<TX, TO, 2>(a, st);
  if (per_lane <= 3) return f2_fwd_nv<TX, TO, 3>(a, st);
  if (per_lane <= 4) return f2_fwd_nv<TX, TO, 4>(a, st);
  if (per_lane <= 8) return f2_fwd_nv<TX, TO, 8>(a, st);
  if (per_lane <= 16) return f2_fwd_nv<TX, TO, 16>(a, st);
  return cudaErrorInvalidValue;
}

// The grid: the blocks the card holds at once (launch bounds: at least two an
// SM), launched cooperatively; with fewer chunks the blocks past them only
// add columns.
template <typename TS, typename TG, int NV>
cudaError_t f2_bwd_nv(const void* g, const void* s, const float* mean,
                      const float* rstd, const float* scale, void* ds, void* dr,
                      float* partial, float* dsb, unsigned* state, long long rows,
                      int w, int chunk, const Drop& d, cudaStream_t st) {
  int n_chunks = (int)((rows + chunk - 1) / chunk);
  const auto kernel = d.site.nbits != 0 ? add_ln_bwd<TS, TG, NV, true>
                                        : add_ln_bwd<TS, TG, NV, false>;
  const size_t smem = f2_staged<TS, TG, NV>() ? 8 * 2 * (size_t)w * (sizeof(TG) + sizeof(TS)) : 0;
  int grid = 0;
  const cudaError_t err = resident_blocks((const void*)kernel, 256, smem, &grid);
  if (err != cudaSuccess) return err;
  const TG* gp = static_cast<const TG*>(g);
  const TS* sp = static_cast<const TS*>(s);
  TS* dsp = static_cast<TS*>(ds);
  TS* drp = static_cast<TS*>(dr);
  dropout_rng::Site site = d.site;
  unsigned long long n_off = d.n_off;
  void* args[] = {&gp, &sp, &mean, &rstd, &scale, &dsp, &drp, &partial, &dsb, &state,
                  &rows, &w, &chunk, &n_chunks, &site, &n_off};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(256), args, smem, st);
}

template <typename TS, typename TG>
cudaError_t f2_bwd(const void* g, const void* s, const float* mean,
                   const float* rstd, const float* scale, void* ds, void* dr,
                   float* partial, float* dsb, unsigned* state, long long rows, int w,
                   int chunk, const Drop& d, cudaStream_t st) {
  const int per_lane = (w / kVec + 31) / 32;
#define F2_BWD(NV) f2_bwd_nv<TS, TG, NV>(g, s, mean, rstd, scale, ds, dr, partial, dsb, \
                                         state, rows, w, chunk, d, st)
  if (per_lane <= 1) return F2_BWD(1);
  if (per_lane <= 2) return F2_BWD(2);
  if (per_lane <= 3) return F2_BWD(3);
  if (per_lane <= 4) return F2_BWD(4);
  if (per_lane <= 8) return F2_BWD(8);
  if (per_lane <= 16) return F2_BWD(16);
#undef F2_BWD
  return cudaErrorInvalidValue;
}

// ---- the site kernel ---------------------------------------------------------

// y = drop(x) over n_vec vectors of 8 (a grid-stride loop), x's first
// element at flat index n_off of its dropout site: the embedding output's
// dropout, and its backward on the cotangent.
template <typename T>
__global__ void __launch_bounds__(256)
site_dropout(const T* __restrict__ x, T* __restrict__ y, long long n_vec,
             dropout_rng::Site drop, unsigned long long n_off) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    float v[kVec];
    load8(x + i * kVec, v);
    drop8<T>(drop, n_off + (unsigned long long)i * kVec, v);
    store8(y + i * kVec, v);
  }
}

// The dropout site of a call (dropout_rng.cuh): nbits 0 (none), 8, 16 or 32.
bool drop_ok(int nbits) { return nbits == 0 || nbits == 8 || nbits == 16 || nbits == 32; }

Drop drop_of(unsigned seed_lo, unsigned seed_hi, int nbits, unsigned threshold,
             float keep_p, unsigned long long n_off) {
  return Drop{dropout_rng::make_site(seed_lo, seed_hi, nbits, threshold, keep_p),
              n_off};
}

}  // namespace

// Plain C entry points (bound with ctypes). Tensors are contiguous (rows, w)
// row-major, 16-byte aligned, w a multiple of 8; dtype ids 0 float32, 1
// bfloat16; act 0 none, 1 erf, 2 poly; b, r may be null. A dropout site is
// nbits (0: none, 8, 16, 32), the seed's two words, the integer threshold
// and keep_p (dropout_rng.cuh), and the flat index in the site of the
// call's first element. Each launches on `stream` without synchronising and
// returns cudaGetLastError() of its launches (cudaErrorInvalidValue for
// shapes or alignments it does not take).

// seq, head_dim: 0, 0 for a row-major y; else y is head-major (B, w /
// head_dim, seq, head_dim) with rows = B * seq, head_dim a multiple of 8,
// act none.
extern "C" int bias_act_forward(const void* h, const void* b, void* y,
                                long long rows, int w, int h_dtype,
                                int out_dtype, int act, int seq, int head_dim,
                                void* stream) {
  if (!shape_ok(rows, w) || rows > INT_MAX || !aligned16(h) || !aligned16(b) ||
      !aligned16(y))
    return (int)cudaErrorInvalidValue;
  if (head_dim != 0 && (head_dim < 0 || head_dim % kVec || w % head_dim ||
                        seq <= 0 || rows % seq || act != kNone))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* bb = static_cast<const float*>(b);
  const int r = (int)rows, wv = w / kVec;
  const Heads hs{seq, head_dim != 0 ? w / head_dim : 1, head_dim / kVec};
  const Heads* heads = head_dim != 0 ? &hs : nullptr;
  if (h_dtype == kBF16 && out_dtype == kBF16) return (int)f1_fwd<bf16, bf16>(act, h, bb, y, r, wv, heads, st);
  if (h_dtype == kF32 && out_dtype == kBF16) return (int)f1_fwd<float, bf16>(act, h, bb, y, r, wv, heads, st);
  if (h_dtype == kBF16 && out_dtype == kF32) return (int)f1_fwd<bf16, float>(act, h, bb, y, r, wv, heads, st);
  if (h_dtype == kF32 && out_dtype == kF32) return (int)f1_fwd<float, float>(act, h, bb, y, r, wv, heads, st);
  return (int)cudaErrorInvalidValue;
}

// g: the cotangent of y (out dtype) in layout g_layout (0 row-major; 1
// (B, nh, seq, head_dim); 2 (B, nh, head_dim, seq), seq a multiple of 8;
// both head-major ones "none" only, with dh written); h, b: read only for
// act != none; dh (rows, w) may be null when with_db and g is row-major
// (db alone); chunk a multiple of 8; with_db: partial ((rows + chunk - 1) /
// chunk, w) f32 scratch, db (w,) f32 out, and n_tickets tickets, at least
// one unsigned per 64 columns (kF1TileV vectors), 0 before the call and 0
// after it.
extern "C" int bias_act_backward(const void* g, const void* h, const void* b,
                                 void* dh, void* partial, void* db, void* tickets,
                                 long long rows, int w, int h_dtype,
                                 int out_dtype, int act, int chunk, int with_db,
                                 int g_layout, int seq, int head_dim,
                                 int n_tickets, void* stream) {
  if (!shape_ok(rows, w) || rows > INT_MAX || chunk <= 0 || chunk % kVec ||
      (rows + chunk - 1) / chunk > 65535 || !aligned16(g) || !aligned16(h) || !aligned16(b) || !aligned16(dh) ||
      !aligned16(partial) || !aligned16(db) || (act != kNone && h == nullptr) ||
      (with_db && (partial == nullptr || db == nullptr || tickets == nullptr ||
                   (long long)n_tickets * kF1TileV * kVec < w)) ||
      (!with_db && dh == nullptr) || g_layout < kRows || g_layout > kHeadsT)
    return (int)cudaErrorInvalidValue;
  if (g_layout != kRows &&
      (act != kNone || dh == nullptr || head_dim <= 0 || head_dim % kVec ||
       w % head_dim || seq <= 0 || rows % seq || (g_layout == kHeadsT && seq % kVec)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* bb = static_cast<const float*>(b);
  float* pp = with_db ? static_cast<float*>(partial) : nullptr;
  float* dd = with_db ? static_cast<float*>(db) : nullptr;
  unsigned* tt = static_cast<unsigned*>(tickets);
  const int r = (int)rows, wv = w / kVec;
  const Heads hs{g_layout != kRows ? seq : 1, g_layout != kRows ? w / head_dim : 1,
                 g_layout != kRows ? head_dim / kVec : 1};
  if (h_dtype == kBF16 && out_dtype == kBF16) return (int)f1_bwd<bf16, bf16>(act, g_layout, g, h, bb, dh, pp, dd, tt, r, wv, chunk, hs, st);
  if (h_dtype == kF32 && out_dtype == kBF16) return (int)f1_bwd<float, bf16>(act, g_layout, g, h, bb, dh, pp, dd, tt, r, wv, chunk, hs, st);
  if (h_dtype == kBF16 && out_dtype == kF32) return (int)f1_bwd<bf16, float>(act, g_layout, g, h, bb, dh, pp, dd, tt, r, wv, chunk, hs, st);
  if (h_dtype == kF32 && out_dtype == kF32) return (int)f1_bwd<float, float>(act, g_layout, g, h, bb, dh, pp, dd, tt, r, wv, chunk, hs, st);
  return (int)cudaErrorInvalidValue;
}

// r null: LN of x alone (s null, no dropout); s null with r: the sum is
// not kept (no backward needs it). mean, rstd (rows,) f32 out; w at most
// 4,096 (16 vectors a lane). With dropout r is the site's block, n_off a
// multiple of 8.
extern "C" int add_layer_norm_forward(const void* x, const void* r,
                                      const void* scale, const void* bias,
                                      void* y, void* s, void* mean, void* rstd,
                                      long long rows, int w, int x_dtype,
                                      int out_dtype, float eps, unsigned seed_lo,
                                      unsigned seed_hi, int nbits,
                                      unsigned threshold, float keep_p,
                                      unsigned long long n_off, void* stream) {
  if (!shape_ok(rows, w) || (r == nullptr && s != nullptr) ||
      !aligned16(x) || !aligned16(r) || !aligned16(scale) || !aligned16(bias) ||
      !aligned16(y) || !aligned16(s) || !drop_ok(nbits) ||
      (nbits != 0 && (r == nullptr || n_off % kVec)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Drop d = drop_of(seed_lo, seed_hi, nbits, threshold, keep_p, n_off);
  const F2Args a{x, r, static_cast<const float*>(scale), static_cast<const float*>(bias),
                 y, s, static_cast<float*>(mean), static_cast<float*>(rstd), rows, w, eps,
                 d.site, d.n_off};
  if (x_dtype == kBF16 && out_dtype == kBF16) return (int)f2_fwd<bf16, bf16>(a, st);
  if (x_dtype == kF32 && out_dtype == kBF16) return (int)f2_fwd<float, bf16>(a, st);
  if (x_dtype == kBF16 && out_dtype == kF32) return (int)f2_fwd<bf16, float>(a, st);
  if (x_dtype == kF32 && out_dtype == kF32) return (int)f2_fwd<float, float>(a, st);
  return (int)cudaErrorInvalidValue;
}

// g: the cotangent of y (g_dtype); partial ((rows + chunk - 1) / chunk, 2w)
// f32 scratch; dsb (2w,) f32 out: dscale, then dbias; dr (s's dtype) the
// dropout branch's gradient, null without dropout; state: n_state unsigned
// words, at least 2, zeros before a stream's first call and left to the
// calls after it (one launch writes ds, dr, dscale and dbias).
extern "C" int add_layer_norm_backward(const void* g, const void* s,
                                       const void* mean, const void* rstd,
                                       const void* scale, void* ds, void* dr,
                                       void* partial, void* dsb, void* state,
                                       long long rows, int w, int s_dtype,
                                       int g_dtype, int chunk, int n_state,
                                       unsigned seed_lo, unsigned seed_hi,
                                       int nbits, unsigned threshold, float keep_p,
                                       unsigned long long n_off, void* stream) {
  if (!shape_ok(rows, w) || chunk <= 0 || (rows + chunk - 1) / chunk > (1LL << 30) ||
      !aligned16(g) || !aligned16(s) || !aligned16(scale) || !aligned16(ds) ||
      !aligned16(dr) || !aligned16(partial) || !aligned16(dsb) || partial == nullptr ||
      dsb == nullptr || state == nullptr || n_state < kF2State || !drop_ok(nbits) ||
      (nbits != 0) != (dr != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  const float* sc = static_cast<const float*>(scale);
  float* pp = static_cast<float*>(partial);
  float* sb = static_cast<float*>(dsb);
  unsigned* ss = static_cast<unsigned*>(state);
  const Drop d = drop_of(seed_lo, seed_hi, nbits, threshold, keep_p, n_off);
  if (s_dtype == kBF16 && g_dtype == kBF16) return (int)f2_bwd<bf16, bf16>(g, s, mu, rs, sc, ds, dr, pp, sb, ss, rows, w, chunk, d, st);
  if (s_dtype == kF32 && g_dtype == kBF16) return (int)f2_bwd<float, bf16>(g, s, mu, rs, sc, ds, dr, pp, sb, ss, rows, w, chunk, d, st);
  if (s_dtype == kBF16 && g_dtype == kF32) return (int)f2_bwd<bf16, float>(g, s, mu, rs, sc, ds, dr, pp, sb, ss, rows, w, chunk, d, st);
  if (s_dtype == kF32 && g_dtype == kF32) return (int)f2_bwd<float, float>(g, s, mu, rs, sc, ds, dr, pp, sb, ss, rows, w, chunk, d, st);
  return (int)cudaErrorInvalidValue;
}

// y = drop(x) (x and y: n elements, n a multiple of 8, of dtype `dtype`):
// the site kernel, for a dropout site that no fused kernel takes (nbits 8,
// 16 or 32).
extern "C" int site_dropout_apply(const void* x, void* y, long long n, int dtype,
                                  unsigned seed_lo, unsigned seed_hi, int nbits,
                                  unsigned threshold, float keep_p,
                                  unsigned long long n_off, void* stream) {
  if (n <= 0 || n % kVec || !aligned16(x) || !aligned16(y) || x == nullptr ||
      y == nullptr || nbits == 0 || !drop_ok(nbits))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Drop d = drop_of(seed_lo, seed_hi, nbits, threshold, keep_p, n_off);
  const long long n_vec = n / kVec;
  long long blocks = (n_vec + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  if (dtype == kBF16)
    site_dropout<bf16><<<(int)blocks, 256, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<bf16*>(y), n_vec, d.site, d.n_off);
  else if (dtype == kF32)
    site_dropout<float><<<(int)blocks, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n_vec, d.site, d.n_off);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
