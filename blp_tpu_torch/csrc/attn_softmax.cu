// F3: the BERT layer's attention softmax chain, forward and backward.
//
// No Pallas kernel replaced: in the JAX package XLA fuses this chain of
// blp_tpu/models/bert.py, the training layer's scale, mask bias,
// jax.nn.softmax, bf16 cast and `_rng_dropout` (:430-441), and the inference
// layer's bf16 logits with f32 softmax statistics (:357-365).
// ops/attn_softmax.py holds the plain version and the autograd wiring.
//
//   forward   x = f32(l) * (1 / scale) + bias     (round_logits: x = round_bf16(x))
//             p = exp(x - max x) * (1 / sum exp(x - max x))
//             y = round_out(p); with dropout y = keep ? round_out(y * (1 / keep_p)) : 0
//   backward  gd = keep ? round_out(g * (1 / keep_p)) : 0    (gd = g without dropout)
//             t = gd * p, dx = t - p * sum(t), dl = round_l(dx * (1 / scale))
//
// The elementwise steps are the op-by-op chain's on the card (torch's CUDA
// division by a Python number multiplies by its f32 reciprocal; its softmax
// backward forms t = g * p, then t - p * sum(t) in one fused multiply-add),
// each written out without contraction. The row sums run in another order
// than torch's, and p takes the sum's reciprocal where torch divides, so the
// kernel agrees with the plain version to f32 rounding of the sums (bf16
// outputs within one ulp), not bit for bit.
//
// The dropout mask is not read: the forward and the backward evaluate it in
// registers from the site's seed and each element's flat index in the whole
// site (dropout_rng.cuh, ops/dropout_rng.py), so a rank's block of the site
// (its first row, and its first head of the whole site's heads under tensor
// parallelism) gets the one-device mask. A lane's four-key chunk is one
// Philox call at 32 bits and a quarter (16 bits: a half) of one at 8 bits;
// there the lanes whose chunks share a call take its words by shuffles
// from the one lane that evaluates it (`keep_rows_shared`).
//
// What bounds it on an H100: bytes, or with 32-bit masks nearly the
// generator's operations. At the W5M train shape (1,024 packed rows x 12
// heads x 128 x 128) the forward reads the bf16 logits (2 bytes an element)
// and the f32 bias (shared by the 12 heads) and writes the bf16 output (2);
// the backward reads l and g and writes dl (6); against ~10 (forward) and
// ~16 (backward) fp32 operations an element, plus the generator's ~100
// integer operations a call, 25 an element at 32 bits and ~6 at 8 (what the
// data needs; at 8 bits a warp evaluates half a call for each 4-key chunk,
// its lanes sharing it, and the kernel reached ~45% of its bound: PERF.md
// §6). The op-by-op chain moved ~10 GB forward and ~8.6 GB backward a layer
// through f32 temporaries; this moves ~0.8 and ~1.2 GB. Design: a warp a
// row (row, head, query), the row in registers (Sk <= 1,024), loaded once:
// the max, the exponentials, their sum and the output from registers; the
// backward recomputes the row's softmax from l instead of reading a saved
// f32 output. Rows of up to 256 keys go two to a warp, their loads issued
// before either row's reductions. A lane owns chunks of W consecutive keys:
// W = 4 (8- or 16-byte loads and stores, the bias as float4) when Sk is a
// multiple of 4 and every pointer and bias stride is aligned to it, else
// W = 1. Sums are row-local shuffles, so two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_rng.cuh"

namespace {

typedef __nv_bfloat16 bf16;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back (round to nearest even, as torch's casts).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// The additive bias read through the strides of its broadcast to (B, nh,
// Sq, Sk), in elements (0 along a broadcast axis).
struct Bias {
  const float* p;
  long long sb, sh, sq, sk;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = v < w ? w : v;
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int kWarps = 8;   // warps a block

// Loads and stores of W consecutive values as f32 (W = 4: one vector).
__device__ __forceinline__ void load4(const bf16* p, float v[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void store4(bf16* p, const float v[4]) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <int W, typename T>
__device__ __forceinline__ void load_w(const T* p, float v[W]) {
  if constexpr (W == 4) load4(p, v); else v[0] = to_f32(p[0]);
}
template <int W, typename T>
__device__ __forceinline__ void store_w(T* p, const float v[W]) {
  if constexpr (W == 4) store4(p, v); else p[0] = from_f32<T>(v[0]);
}
// The bias at keys e .. e + W - 1 of a row (W = 4: key stride 1).
template <int W>
__device__ __forceinline__ void load_bias(const float* row, long long bsk, int e,
                                          float b[W]) {
  if constexpr (W == 4) load4(row + e, b); else b[0] = row[e * bsk];
}

// Rows a warp takes at once: two while a row is at most 8 values a lane.
template <int NE> __host__ __device__ constexpr int rows_per_warp() { return NE <= 8 ? 2 : 1; }

// Where this call's (B, nh, Sq, Sk) block lies in its dropout site's
// whole (B', heads, Sq, Sk): its first row and first head.
struct Block {
  long long row0;
  int head0, heads;
};

// Block (batch * nh + head, chunk of queries): warp w takes queries
// q0 + r, r < R, q0 = (chunk * kWarps + w) * R.
struct Site {
  long long off;            // of the row's first key in l, y, g, dl
  unsigned long long n0;    // the same key's flat index in the dropout site
  const float* bias;        // the row's bias
  bool valid;               // q < Sq
};

template <int R>
__device__ __forceinline__ void locate(const Bias& b, const Block& blk, int nh,
                                       int sq, int sk, unsigned chunks,
                                       Site site[R]) {
  const unsigned bh = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int q0 = (int)(chunk * kWarps + (threadIdx.x >> 5)) * R;
  const int bi = (int)(bh / nh), h = (int)(bh % nh);
  const float* brow = b.p + (long long)bi * b.sb + (long long)h * b.sh;
  const unsigned long long site_bh =
      (unsigned long long)(blk.row0 + bi) * blk.heads + blk.head0 + h;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = q0 + r;
    site[r].valid = q < sq;
    site[r].off = ((long long)bh * sq + q) * sk;
    site[r].n0 = (site_bh * sq + q) * sk;
    site[r].bias = brow + (long long)q * b.sq;
  }
}

// Lane's chunk j holds keys W (lane + 32 j) .. + W - 1, values W j .. of
// the lane's NE = W NC. A chunk lies wholly inside or past Sk (W divides Sk).
template <int W>
__device__ __forceinline__ int key_of(int lane, int j) { return W * (lane + 32 * j); }

// The scaled, biased logits of the warp's rows (-inf past Sk and in rows
// past Sq).
template <int W, int NC, int R, typename TL>
__device__ __forceinline__ void load_logits(const TL* __restrict__ l,
                                            const Site site[R], long long bsk,
                                            int sk, int lane, float inv_scale,
                                            bool round_logits, float x[R][W * NC]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int e = key_of<W>(lane, j);
      float v[W], b[W];
      if (site[r].valid && e < sk) {
        load_w<W>(l + site[r].off + e, v);
        load_bias<W>(site[r].bias, bsk, e, b);
      }
#pragma unroll
      for (int k = 0; k < W; ++k) {
        float xv = -INFINITY;
        if (site[r].valid && e < sk) {
          xv = __fadd_rn(__fmul_rn(v[k], inv_scale), b[k]);
          if (round_logits) xv = round_to<bf16>(xv);
        }
        x[r][W * j + k] = xv;
      }
    }
}

// x <- softmax(x) in f32, row by row: the max, exp(x - max) and their sum
// (a lane's values in order, then over the warp), times its reciprocal.
template <int NE, int R>
__device__ __forceinline__ void softmax_rows(float x[R][NE]) {
  float m[R], s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
#pragma unroll
    for (int i = 0; i < NE; ++i) m[r] = m[r] < x[r][i] ? x[r][i] : m[r];
    m[r] = warp_max(m[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    s[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      x[r][i] = expf(__fsub_rn(x[r][i], m[r]));
      s[r] = __fadd_rn(s[r], x[r][i]);
    }
    s[r] = __frcp_rn(warp_sum(s[r]));
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < NE; ++i) x[r][i] = __fmul_rn(x[r][i], s[r]);
}

// The keep bits of the warp's rows at 8 or 16 bits with four-key chunks,
// when Sk is a multiple of a call's M = 128 / NBITS masks: the G = M / 4
// lanes whose chunks one call covers share it. Lane p of a group evaluates
// the group's calls p, p + G, ... (one per row chunk: R * NC of them) and
// each lane takes its words of every call by shuffles, so a warp evaluates
// ceil(R * NC / G) calls where each lane would evaluate R * NC.
template <int NBITS, int NC, int R>
__device__ __forceinline__ void keep_rows_shared(const dropout_rng::Site& drop,
                                                 const Site site[R], int lane,
                                                 uint32_t kept[R]) {
  constexpr int M = 128 / NBITS, G = M / 4, C = R * NC, S = (C + G - 1) / G;
  constexpr int PER = 32 / NBITS;   // masks a word
  const int p = lane & (G - 1), base = lane & ~(G - 1);
  uint32_t words[S][4];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int c = p + G * k;        // the group's call this lane evaluates
    // site[c / NC].n0 by selects: an index known only at run time would
    // put the whole site array in local memory.
    unsigned long long n0 = site[0].n0;
#pragma unroll
    for (int r = 1; r < R; ++r)
      if (c / NC == r) n0 = site[r].n0;
    if (c < C)
      dropout_rng::call_words(drop, (n0 + (unsigned long long)key_of<4>(base, c % NC)) / M,
                              words[k]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) kept[r] = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = __shfl_sync(0xffffffffu, words[c / G][i], base | (c % G));
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // this lane's chunk: masks 4p .. 4p + 3
      const uint32_t word = dropout_rng::pick(w, p * (4 / PER) + i / PER);
      kept[c / NC] |= dropout_rng::kept<NBITS>(word >> (NBITS * (i % PER)), drop.t)
                      << (4 * (c % NC) + i);
    }
  }
}

// kept[r]: bit W j + k keeps key W (lane + 32 j) + k of the warp's row r
// (set past Sk or Sq).
template <int W, int NC, int R>
__device__ __forceinline__ void keep_rows(const dropout_rng::Site& drop,
                                          const Site site[R], int sk, int lane,
                                          uint32_t kept[R]) {
  if constexpr (W == 4) {   // warp-uniform branches
    if (drop.nbits == 8 && sk % 16 == 0) {
      keep_rows_shared<8, NC, R>(drop, site, lane, kept);
      return;
    }
    if (drop.nbits == 16 && sk % 8 == 0) {
      keep_rows_shared<16, NC, R>(drop, site, lane, kept);
      return;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    kept[r] = 0xFFFFFFFFu;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int e = key_of<W>(lane, j);
      if (site[r].valid && e < sk)
        kept[r] = (kept[r] & ~(((1u << W) - 1u) << (W * j))) |
                  dropout_rng::keep_run<W>(drop, site[r].n0 + e) << (W * j);
    }
  }
}

// DROP: the call has a dropout site (a kernel without one holds no
// generator code, so it keeps the registers the chain alone needs).
template <typename TL, typename TO, int W, int NC, bool DROP>
__global__ void __launch_bounds__(256)
attn_softmax_fwd(const TL* __restrict__ l, Bias bias, dropout_rng::Site drop,
                 Block blk, TO* __restrict__ y, int nh, int sq, int sk,
                 unsigned chunks, float inv_scale, bool round_logits) {
  constexpr int NE = W * NC, R = rows_per_warp<NE>();
  const int lane = threadIdx.x & 31;
  Site site[R];
  locate<R>(bias, blk, nh, sq, sk, chunks, site);
  float p[R][NE];
  load_logits<W, NC, R>(l, site, bias.sk, sk, lane, inv_scale, round_logits, p);
  uint32_t kept[R];
  if constexpr (DROP) keep_rows<W, NC, R>(drop, site, sk, lane, kept);
  softmax_rows<NE, R>(p);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int e = key_of<W>(lane, j);
      if (site[r].valid && e < sk) {
        float v[W];
#pragma unroll
        for (int k = 0; k < W; ++k) {
          v[k] = round_to<TO>(p[r][W * j + k]);
          if constexpr (DROP)
            v[k] = (kept[r] >> (W * j + k)) & 1u
                       ? round_to<TO>(__fmul_rn(v[k], drop.inv_keep_p)) : 0.0f;
        }
        store_w<W>(y + site[r].off + e, v);
      }
    }
}

template <typename TL, typename TO, int W, int NC, bool DROP>
__global__ void __launch_bounds__(256)
attn_softmax_bwd(const TL* __restrict__ l, Bias bias, dropout_rng::Site drop,
                 Block blk, const TO* __restrict__ g, TL* __restrict__ dl, int nh,
                 int sq, int sk, unsigned chunks, float inv_scale) {
  constexpr int NE = W * NC, R = rows_per_warp<NE>();
  const int lane = threadIdx.x & 31;
  Site site[R];
  locate<R>(bias, blk, nh, sq, sk, chunks, site);
  float p[R][NE], t[R][NE];
  load_logits<W, NC, R>(l, site, bias.sk, sk, lane, inv_scale, false, p);
  uint32_t kept[R];
  if constexpr (DROP) keep_rows<W, NC, R>(drop, site, sk, lane, kept);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int e = key_of<W>(lane, j);
      float gv[W];
#pragma unroll
      for (int k = 0; k < W; ++k) gv[k] = 0.0f;
      if (site[r].valid && e < sk) load_w<W>(g + site[r].off + e, gv);
#pragma unroll
      for (int k = 0; k < W; ++k) {   // gd
        t[r][W * j + k] = gv[k];
        if constexpr (DROP)
          t[r][W * j + k] = (kept[r] >> (W * j + k)) & 1u
              ? round_to<TO>(__fmul_rn(gv[k], drop.inv_keep_p)) : 0.0f;
      }
    }
  softmax_rows<NE, R>(p);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      t[r][i] = __fmul_rn(t[r][i], p[r][i]);
      s = __fadd_rn(s, t[r][i]);
    }
    s = warp_sum(s);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int e = key_of<W>(lane, j);
      if (site[r].valid && e < sk) {
        float v[W];
#pragma unroll
        for (int k = 0; k < W; ++k)
          v[k] = __fmul_rn(__fmaf_rn(-p[r][W * j + k], s, t[r][W * j + k]), inv_scale);
        store_w<W>(dl + site[r].off + e, v);
      }
    }
  }
}

// Blocks of each (batch, head): ceil(Sq / (kWarps * R)).
template <int NE> unsigned chunks_for(int sq) {
  constexpr int per_block = kWarps * rows_per_warp<NE>();
  return (unsigned)((sq + per_block - 1) / per_block);
}

// Arguments shared by the launches.
struct Args {
  const void* l;
  Bias b;
  dropout_rng::Site drop;
  Block blk;
  const void* g;   // backward
  void* out;       // y or dl
  long long rows;
  int nh, sq, sk;
  float inv_scale;
  bool round_logits;
};

template <typename TL, typename TO, int W, int NC, bool DROP>
void launch_drop(const Args& a, bool backward, cudaStream_t st) {
  const unsigned chunks = chunks_for<W * NC>(a.sq);
  const unsigned blocks = (unsigned)(a.rows / a.sq * chunks);
  if (backward)
    attn_softmax_bwd<TL, TO, W, NC, DROP><<<blocks, 32 * kWarps, 0, st>>>(
        static_cast<const TL*>(a.l), a.b, a.drop, a.blk, static_cast<const TO*>(a.g),
        static_cast<TL*>(a.out), a.nh, a.sq, a.sk, chunks, a.inv_scale);
  else
    attn_softmax_fwd<TL, TO, W, NC, DROP><<<blocks, 32 * kWarps, 0, st>>>(
        static_cast<const TL*>(a.l), a.b, a.drop, a.blk, static_cast<TO*>(a.out),
        a.nh, a.sq, a.sk, chunks, a.inv_scale, a.round_logits);
}

template <typename TL, typename TO, int W, int NC>
cudaError_t launch(const Args& a, bool backward, cudaStream_t st) {
  if (a.drop.nbits != 0) launch_drop<TL, TO, W, NC, true>(a, backward, st);
  else launch_drop<TL, TO, W, NC, false>(a, backward, st);
  return cudaGetLastError();
}

bool aligned(const void* p, size_t n) { return ((uintptr_t)p % n) == 0; }

// W = 4 when Sk and the bias strides are multiples of 4, the bias's key
// stride is 1, and every pointer is aligned to 4 of its elements.
template <typename TL, typename TO>
bool vector_ok(const Args& a) {
  return a.sk % 4 == 0 && a.b.sk == 1 && a.b.sb % 4 == 0 && a.b.sh % 4 == 0 &&
         a.b.sq % 4 == 0 && aligned(a.b.p, 16) && aligned(a.l, 4 * sizeof(TL)) &&
         (a.g == nullptr || aligned(a.g, 4 * sizeof(TO))) &&
         aligned(a.out, 4 * (a.g == nullptr ? sizeof(TO) : sizeof(TL)));
}

// The fewest chunks a lane that hold the row: Sk 128 is one chunk of 4.
template <typename TL, typename TO>
cudaError_t dispatch(const Args& a, bool backward, cudaStream_t st) {
  if (vector_ok<TL, TO>(a)) {
    const int nc = (a.sk + 127) / 128;
    if (nc <= 1) return launch<TL, TO, 4, 1>(a, backward, st);
    if (nc <= 2) return launch<TL, TO, 4, 2>(a, backward, st);
    if (nc <= 4) return launch<TL, TO, 4, 4>(a, backward, st);
    if (nc <= 8) return launch<TL, TO, 4, 8>(a, backward, st);
    return cudaErrorInvalidValue;
  }
  const int nc = (a.sk + 31) / 32;
  if (nc <= 1) return launch<TL, TO, 1, 1>(a, backward, st);
  if (nc <= 2) return launch<TL, TO, 1, 2>(a, backward, st);
  if (nc <= 4) return launch<TL, TO, 1, 4>(a, backward, st);
  if (nc <= 8) return launch<TL, TO, 1, 8>(a, backward, st);
  if (nc <= 16) return launch<TL, TO, 1, 16>(a, backward, st);
  if (nc <= 32) return launch<TL, TO, 1, 32>(a, backward, st);
  return cudaErrorInvalidValue;
}

cudaError_t by_dtype(const Args& a, int l_dtype, int out_dtype, bool backward,
                     cudaStream_t st) {
  if (l_dtype == kBF16 && out_dtype == kBF16) return dispatch<bf16, bf16>(a, backward, st);
  if (l_dtype == kBF16 && out_dtype == kF32) return dispatch<bf16, float>(a, backward, st);
  if (l_dtype == kF32 && out_dtype == kF32) return dispatch<float, float>(a, backward, st);
  return cudaErrorInvalidValue;
}

bool shape_ok(long long rows, int nh, int sq, int sk) {
  return rows > 0 && nh > 0 && sq > 0 && sk > 0 && sk <= 1024 &&
         rows % ((long long)nh * sq) == 0 && rows / sq * sq < (1LL << 31);
}

// The dropout site of a call: no dropout when nbits is 0; else the key,
// threshold and keep probability, and the block's place in the site (its
// heads within the site's `heads`).
bool drop_ok(int nbits, long long row0, int head0, int heads, int nh) {
  return nbits == 0 || ((nbits == 8 || nbits == 16 || nbits == 32) && row0 >= 0 &&
                        head0 >= 0 && head0 + nh <= heads);
}

}  // namespace

// Plain C entry points (bound with ctypes). l (and y, g, dl) are contiguous
// (B, nh, Sq, Sk), rows = B * nh * Sq, Sk <= 1,024; bias is f32, read at
// bias[b * sb + h * sh + q * sq + k * sk]; dtype ids 0 float32, 1 bfloat16
// (l, out: bf16, bf16; bf16, f32; or f32, f32); scale is the divisor
// (sqrt(head_dim)). The dropout site: nbits 0 (none), 8, 16 or 32; the
// seed's two words, the integer threshold and keep_p (dropout_rng.cuh); the
// call's block of the site's (B', heads, Sq, Sk): first row row0, first
// head head0. Each launches on `stream` without synchronising and returns
// cudaGetLastError() of its launch (cudaErrorInvalidValue for what it does
// not take).

extern "C" int attn_softmax_forward(const void* l, const void* bias,
                                    long long sb, long long sh, long long sq_,
                                    long long sk_, void* y, long long rows, int nh,
                                    int sq, int sk, int l_dtype, int out_dtype,
                                    float scale, int round_logits,
                                    unsigned seed_lo, unsigned seed_hi, int nbits,
                                    unsigned threshold, float keep_p,
                                    long long row0, int head0, int heads,
                                    void* stream) {
  if (!shape_ok(rows, nh, sq, sk) || l == nullptr || bias == nullptr ||
      y == nullptr || !drop_ok(nbits, row0, head0, heads, nh))
    return (int)cudaErrorInvalidValue;
  const Args a{l, Bias{static_cast<const float*>(bias), sb, sh, sq_, sk_},
               dropout_rng::make_site(seed_lo, seed_hi, nbits, threshold, keep_p),
               Block{row0, head0, heads}, nullptr, y, rows, nh, sq, sk,
               1.0f / scale, round_logits != 0};
  return (int)by_dtype(a, l_dtype, out_dtype, false, (cudaStream_t)stream);
}

// g: the cotangent of y (out dtype); dl: l's dtype. The training variant
// only (no round_logits).
extern "C" int attn_softmax_backward(const void* l, const void* bias,
                                     long long sb, long long sh, long long sq_,
                                     long long sk_, const void* g, void* dl,
                                     long long rows, int nh, int sq, int sk,
                                     int l_dtype, int out_dtype, float scale,
                                     unsigned seed_lo, unsigned seed_hi, int nbits,
                                     unsigned threshold, float keep_p,
                                     long long row0, int head0, int heads,
                                     void* stream) {
  if (!shape_ok(rows, nh, sq, sk) || l == nullptr || bias == nullptr ||
      g == nullptr || dl == nullptr || !drop_ok(nbits, row0, head0, heads, nh))
    return (int)cudaErrorInvalidValue;
  const Args a{l, Bias{static_cast<const float*>(bias), sb, sh, sq_, sk_},
               dropout_rng::make_site(seed_lo, seed_hi, nbits, threshold, keep_p),
               Block{row0, head0, heads}, g, dl, rows, nh, sq, sk, 1.0f / scale,
               false};
  return (int)by_dtype(a, l_dtype, out_dtype, true, (cudaStream_t)stream);
}
