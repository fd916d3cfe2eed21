// F3: the BERT layer's attention softmax chain, forward and backward.
//
// No Pallas kernel replaced: in the JAX package XLA fuses this chain of
// blp_tpu/models/bert.py, the training layer's scale, mask bias,
// jax.nn.softmax, bf16 cast and `_rng_dropout` (:430-441), and the inference
// layer's bf16 logits with f32 softmax statistics (:357-365).
// ops/attn_softmax.py holds the plain version, the autograd wiring and the
// choice between the two designs below.
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
// outputs within one ulp), not bit for bit. The sums are row-local and in a
// fixed order, so two calls give the same bits.
//
// The dropout mask is not read: both designs evaluate it in registers from
// the site's seed and each element's flat index in the whole site
// (dropout_rng.cuh, ops/dropout_rng.py), so a rank's block of the site (its
// first row, and its first head of the whole site's heads under tensor
// parallelism) gets the one-device mask.
//
// What bounds it on an H100: bytes, and with 32-bit masks nearly the
// generator's operations too. At the W5M train shape (1,024 packed rows x 12
// heads x 128 x 128) the forward reads the bf16 logits (2 bytes an element)
// and the f32 bias once (it has no head axis) and writes the bf16 output (2):
// 0.80 GB, 0.24 ms at 3.35 TB/s; the backward reads l and g and writes dl
// (6). Against that, ~10 (forward) and ~16 (backward) fp32 operations an
// element and the generator's ~100 integer operations a Philox call, 25 an
// element at 32 bits (a call covers 4 masks) and ~6 at 8 (16 masks); sm_90
// runs 32-bit integer multiplies at half the fp32 rate, so at 32 bits only
// loads that overlap the generator can approach the byte bound.
//
// Two designs:
//
// "tile" (Sk % 8 == 0, Sk <= 256, a bias with no head stride, 16-byte
//   aligned pointers: every launch of the layer). A persistent grid (blocks
//   per SM from the occupancy API: 3 forward, 2 backward) walks tiles of one
//   batch row and T query rows across all heads. A producer thread copies
//   each head's T x Sk run of l (and g) with one bulk copy into a ring of
//   slabs in shared memory, and the tile's bias once for all heads, so the
//   bias is read from memory once where the row design read it once a head;
//   each mbarrier counts its slab's bytes in. The consumer warps evaluate
//   their slab's keep bits before they wait for it and release it as soon as
//   its values are in registers, so the next slabs' copies are in flight
//   while the generator, the reductions, the exponentials and the stores
//   run. A lane holds 16 keys of one row in two 8-key chunks (16-byte loads
//   and stores); at 8 bits the two lanes that share a Philox call in each
//   chunk evaluate one call each and swap two words; mask fields are
//   compared a word at a time and bf16 roundings packed two at a time,
//   because the dropout variants are bound by instructions, not loads.
//
// "row" (the rest: Sk not a multiple of 8 or above 256, up to 1,024; a bias
//   read through a head stride; an unaligned view). A warp a row (row, head,
//   query), the row in registers, loaded once; rows of up to 256 keys go two
//   to a warp, their loads issued before either row's reductions. A lane owns
//   chunks of W consecutive keys: W = 4 when Sk is a multiple of 4 and every
//   pointer and bias stride is aligned to it, else W = 1. At 8 and 16 bits
//   the lanes whose chunks share a Philox call take its words by shuffles
//   from the one lane that evaluates it (`keep_rows_shared`).
//
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6, chip_smoke.py;
// bounds 0.260 ms forward, 0.381 backward) at 1,024 x 12 x 128 x 128: the
// tile forward 0.337 ms with 8-bit masks (77% of its bound), 0.457 with
// 32-bit (57%), 0.344 without (76%), against the row design's 0.580, 0.608
// and 0.363 in the same run; the backward 0.471 and 0.500 ms (81%, 76%)
// against 0.650 and 0.671.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_rng.cuh"
#include "bulk_copy.cuh"

namespace {

using namespace bulk_copy;

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

// ---- the "row" design -------------------------------------------------------

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

// ---- the "tile" design ------------------------------------------------------
//
// A persistent grid walks tiles: one batch row b and T query rows, across all
// nh heads of the call. Each head's T x Sk logits are one contiguous run of
// l (and of g), so one thread of a producer warp copies them with one bulk
// copy (TMA) into a ring of `stages` slabs in shared memory; the tile's bias
// (T rows of Sk f32, or one row when it is the same for every query) comes
// once into one of two bias slots and serves every head. Each slab's
// mbarrier counts its bytes in; each consumer warp releases a slab as soon
// as its values are in registers (the bias slot after the tile's last head),
// so the copies of the next slabs are in flight while the warps evaluate the
// dropout generator, reduce, exponentiate and store. A lane holds two chunks
// of 8 consecutive keys of one row (16-byte shared loads and global stores
// in bf16), LPR lanes a row, T = 8 warps x 32 / LPR rows: one row a lane in
// every slab, so a slab is a warp's one step. Row sums go over the row's
// lanes in a fixed order.

// The ring's mbarriers and bulk copies: bulk_copy.cuh.

constexpr int kTileWarps = 8;                       // consumer warps a block
constexpr int kTileThreads = 32 * (kTileWarps + 1); // and one producer warp
constexpr int kTileMaxSk = 256;

// Lanes a row and rows a tile for rows of Sk keys (Sk % 8 == 0, Sk <= 256).
// A lane holds two chunks of 8 keys, 8 (sub + LPR c) .. + 7 for c = 0, 1,
// sub its place among the row's LPR lanes.
constexpr int kChunks = 2;
__host__ __device__ constexpr int lanes_per_row(int sk) {
  return sk <= 64 ? 4 : sk <= 128 ? 8 : 16;
}
__host__ __device__ constexpr int tile_rows(int lpr) { return kTileWarps * 32 / lpr; }

// Shared memory: 2 stages + 4 mbarriers (padded to 128 bytes), the ring of
// slabs (l's T x Sk values, then g's in the backward) and two bias slots.
__host__ __device__ inline size_t tile_barrier_bytes(int stages) {
  return ((size_t)(2 * stages + 4) * 8 + 127) / 128 * 128;
}
__host__ __device__ inline size_t tile_smem_bytes(int rows, int sk, int slab_elem_bytes,
                                                  int stages) {
  return tile_barrier_bytes(stages) + (size_t)stages * rows * sk * slab_elem_bytes +
         2 * (size_t)rows * sk * sizeof(float);
}

struct TileArgs {
  const void* l;
  const void* g;             // backward
  void* out;                 // y or dl
  const float* bias;
  long long bsb, bsq;        // bias strides (elements); bsq 0: one row for all queries
  dropout_rng::Site drop;
  Block blk;
  int nh, sq, sk, stages;
  int tiles_per_b;           // ceil(Sq / T)
  long long tiles;           // B * tiles_per_b
  float inv_scale;
};

// 8 consecutive values as f32, and back (16 bytes of bf16; 32 of f32).
__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  load4(p, v);
  load4(p + 4, v + 4);
}
__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<__nv_bfloat162*>(&w[i]) = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  store4(p, v);
  store4(p + 4, v + 4);
}

// v rounded to T and back (bf16: two at a time, one pack and two shifts,
// where a conversion each runs at a quarter of the rate; the same values as
// round_to).
template <typename T> __device__ __forceinline__ void round8(float v[8]) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(__floats2bfloat162_rn(v[2 * i], v[2 * i + 1]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

template <int LPR> __device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = v < w ? w : v;
  }
  return v;
}
template <int LPR> __device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The flat index in the dropout site of key 0 of the tile's row r in head 0.
__device__ __forceinline__ unsigned long long tile_n0(const TileArgs& a, long long t,
                                                      int rows_per_tile, int r) {
  const long long bi = t / a.tiles_per_b;
  const int q = (int)(t % a.tiles_per_b) * rows_per_tile + r;
  return (((unsigned long long)(a.blk.row0 + bi) * a.blk.heads + a.blk.head0) * a.sq + q) *
         a.sk;
}

// LPR = lanes_per_row(Sk). ROUND: the forward rounds the scaled, biased
// logits to bf16 (the inference variant, without dropout).
template <typename TL, typename TO, int LPR, int NB, bool BWD, bool ROUND>
__device__ __forceinline__ void tile_body(const TileArgs& a, unsigned char* smem) {
  constexpr int T = tile_rows(LPR), RW = 32 / LPR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sk = a.sk, sq = a.sq, nh = a.nh, stages = a.stages;
  const uint32_t l_bytes = (uint32_t)(T * sk * sizeof(TL));
  const uint32_t slab_bytes = l_bytes + (BWD ? (uint32_t)(T * sk * sizeof(TO)) : 0u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + stages;
  uint64_t* bias_full = empty + stages;
  uint64_t* bias_empty = bias_full + 2;
  unsigned char* ring = smem + tile_barrier_bytes(stages);
  float* bias_s = reinterpret_cast<float*>(ring + (size_t)stages * slab_bytes);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTileWarps);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bias_full[s], 1);
      mbar_init(&bias_empty[s], kTileWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kTileWarps) {   // the producer: one thread issues every copy
    if (lane != 0) return;
    int slot = 0;
    uint32_t phase = 0, j = 0;
    for (long long t = blockIdx.x; t < a.tiles; t += gridDim.x, ++j) {
      const long long bi = t / a.tiles_per_b;
      const int q0 = (int)(t % a.tiles_per_b) * T, rows = min(T, sq - q0);
      const int bs = j & 1;
      mbar_wait(&bias_empty[bs], ((j >> 1) & 1) ^ 1);
      const float* bsrc = a.bias + bi * a.bsb + (long long)q0 * a.bsq;
      float* bdst = bias_s + bs * T * sk;
      const uint32_t row_bytes = (uint32_t)(sk * sizeof(float));
      if (a.bsq == 0) {
        mbar_arrive_expect_tx(&bias_full[bs], row_bytes);
        bulk_load(bdst, bsrc, row_bytes, &bias_full[bs]);
      } else {
        mbar_arrive_expect_tx(&bias_full[bs], rows * row_bytes);
        if (a.bsq == sk)
          bulk_load(bdst, bsrc, rows * row_bytes, &bias_full[bs]);
        else
          for (int r = 0; r < rows; ++r)
            bulk_load(bdst + r * sk, bsrc + r * a.bsq, row_bytes, &bias_full[bs]);
      }
      const uint32_t lb = (uint32_t)(rows * sk * sizeof(TL));
      const uint32_t gb = BWD ? (uint32_t)(rows * sk * sizeof(TO)) : 0u;
      for (int h = 0; h < nh; ++h) {
        mbar_wait(&empty[slot], phase ^ 1);
        const long long off = ((bi * nh + h) * sq + q0) * (long long)sk;
        unsigned char* st = ring + (size_t)slot * slab_bytes;
        mbar_arrive_expect_tx(&full[slot], lb + gb);
        bulk_load(st, static_cast<const TL*>(a.l) + off, lb, &full[slot]);
        if constexpr (BWD)
          bulk_load(st + l_bytes, static_cast<const TO*>(a.g) + off, gb, &full[slot]);
        if (++slot == stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // The consumers: row r of each slab, keys e[c] .. e[c] + 7 of chunk c.
  const int sub = lane % LPR, r = warp * RW + lane / LPR;
  const int e[kChunks] = {8 * sub, 8 * (sub + LPR)};
  const bool key_ok[kChunks] = {e[0] < sk, e[1] < sk};
  const bool pair8 = NB == 8 && sk % 16 == 0;
  const unsigned long long head_n = (unsigned long long)sq * sk;   // n from head to head
  int slot = 0;
  uint32_t phase = 0, j = 0;
  for (long long t = blockIdx.x; t < a.tiles; t += gridDim.x, ++j) {
    const long long bi = t / a.tiles_per_b;
    const int q0 = (int)(t % a.tiles_per_b) * T;
    const bool row_ok = r < sq - q0;
    const bool ok[kChunks] = {row_ok && key_ok[0], row_ok && key_ok[1]};
    const int bs = j & 1;
    const float* brow = bias_s + bs * T * sk + (a.bsq == 0 ? 0 : r * sk);
    mbar_wait(&bias_full[bs], (j >> 1) & 1);
    const unsigned long long n_tile = tile_n0(a, t, T, r);
    const long long row_off = (bi * nh * sq + q0 + r) * (long long)sk;   // head 0
    for (int h = 0; h < nh; ++h) {
      const unsigned long long n0 = n_tile + h * head_n;
      uint32_t kept = 0xFFFFFFFFu;
      if constexpr (NB == 8) {
        if (pair8)
          kept = dropout_rng::pair_bits8(a.drop, n0 + 8 * (sub & ~1),
                                          n0 + 8 * (sub & ~1) + 8 * LPR, sub & 1);
        else
          kept = dropout_rng::lane_bits<8>(a.drop, n0 + e[0]) |
                 dropout_rng::lane_bits<8>(a.drop, n0 + e[1]) << 8;
      } else if constexpr (NB != 0) {
        kept = dropout_rng::lane_bits<NB>(a.drop, n0 + e[0]) |
               dropout_rng::lane_bits<NB>(a.drop, n0 + e[1]) << 8;
      }
      float x[8 * kChunks], gv[8 * kChunks], bv[8];
      mbar_wait(&full[slot], phase);
      const unsigned char* st = ring + (size_t)slot * slab_bytes;
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        if (ok[c]) {
          load8(reinterpret_cast<const TL*>(st) + r * sk + e[c], x + 8 * c);
          if constexpr (BWD)
            load8(reinterpret_cast<const TO*>(st + l_bytes) + r * sk + e[c], gv + 8 * c);
        }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (++slot == stages) {
        slot = 0;
        phase ^= 1;
      }
      // softmax: the max, exp(x - max) and their sum, times its reciprocal
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (ok[c]) load8(brow + e[c], bv);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          x[8 * c + k] = __fadd_rn(__fmul_rn(x[8 * c + k], a.inv_scale), bv[k]);
        if constexpr (ROUND) round8<bf16>(x + 8 * c);
      }
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < 8 * kChunks; ++k) {
        if (!ok[k / 8]) x[k] = -INFINITY;
        m = m < x[k] ? x[k] : m;
      }
      m = group_max<LPR>(m);
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < 8 * kChunks; ++k) {
        x[k] = expf(__fsub_rn(x[k], m));
        s = __fadd_rn(s, x[k]);
      }
      s = __frcp_rn(group_sum<LPR>(s));
#pragma unroll
      for (int k = 0; k < 8 * kChunks; ++k) x[k] = __fmul_rn(x[k], s);
      const long long off = row_off + (long long)h * head_n;
      if constexpr (!BWD) {
        if constexpr (NB != 0) {   // round_out(round_out(p) / keep_p); store8 rounds
#pragma unroll
          for (int c = 0; c < kChunks; ++c) round8<TO>(x + 8 * c);
#pragma unroll
          for (int k = 0; k < 8 * kChunks; ++k)
            x[k] = (kept >> k) & 1u ? __fmul_rn(x[k], a.drop.inv_keep_p) : 0.0f;
        }
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          if (ok[c]) store8(static_cast<TO*>(a.out) + off + e[c], x + 8 * c);
      } else {
        if constexpr (NB != 0) {   // gd = round_out(g / keep_p) where kept
#pragma unroll
          for (int k = 0; k < 8 * kChunks; ++k) gv[k] = __fmul_rn(gv[k], a.drop.inv_keep_p);
#pragma unroll
          for (int c = 0; c < kChunks; ++c) round8<TO>(gv + 8 * c);
        }
        float tsum = 0.0f;
#pragma unroll
        for (int k = 0; k < 8 * kChunks; ++k) {
          const float gd = ok[k / 8] && (NB == 0 || (kept >> k) & 1u) ? gv[k] : 0.0f;
          gv[k] = __fmul_rn(gd, x[k]);
          tsum = __fadd_rn(tsum, gv[k]);
        }
        tsum = group_sum<LPR>(tsum);
#pragma unroll
        for (int k = 0; k < 8 * kChunks; ++k)
          gv[k] = __fmul_rn(__fmaf_rn(-x[k], tsum, gv[k]), a.inv_scale);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          if (ok[c]) store8(static_cast<TL*>(a.out) + off + e[c], gv + 8 * c);
      }
    }
    __syncwarp();   // the bias slot serves every head of the tile
    if (lane == 0) mbar_arrive(&bias_empty[bs]);
  }
}

// Three forward blocks an SM (up to 72 registers a thread), two backward
// ones: the backward holds l's and g's values, which at 72 registers spilled.
template <typename TL, typename TO, int LPR, int NB, bool ROUND>
__global__ void __launch_bounds__(kTileThreads, 3) attn_softmax_tile_fwd(TileArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  tile_body<TL, TO, LPR, NB, false, ROUND>(a, smem);
}

template <typename TL, typename TO, int LPR, int NB>
__global__ void __launch_bounds__(kTileThreads, 2) attn_softmax_tile_bwd(TileArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  tile_body<TL, TO, LPR, NB, true, false>(a, smem);
}

// ---- host side --------------------------------------------------------------

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
  int stages;      // 0: the row design; else the tile design's ring stages
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

// The row design: the fewest chunks a lane that hold the row (Sk 128 is one
// chunk of 4).
template <typename TL, typename TO>
cudaError_t row_dispatch(const Args& a, bool backward, cudaStream_t st) {
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

// What the tile design takes (ops/attn_softmax.py `design` mirrors it): Sk a
// multiple of 8 up to 256; a bias with key stride 1 that is the same for
// every head (head stride 0, or one head), whose batch and query strides are
// multiples of 4 floats (16 bytes); every pointer 16-byte aligned; rounded
// logits only without dropout; at least two stages whose shared memory fits
// a block.
bool tile_ok(const Args& a, int slab_elem_bytes) {
  const long long batches = a.rows / ((long long)a.nh * a.sq);
  const int rows = tile_rows(lanes_per_row(a.sk));
  return a.sk % 8 == 0 && a.sk <= kTileMaxSk && !(a.round_logits && a.drop.nbits != 0) &&
         a.b.sk == 1 && (a.b.sh == 0 || a.nh == 1) &&
         (batches == 1 || a.b.sb % 4 == 0) && (a.sq == 1 || a.b.sq % 4 == 0) &&
         aligned(a.b.p, 16) && aligned(a.l, 16) && aligned(a.out, 16) &&
         (a.g == nullptr || aligned(a.g, 16)) && a.stages >= 2 &&
         tile_smem_bytes(rows, a.sk, slab_elem_bytes, a.stages) <= kMaxSmem;
}

template <typename TL, typename TO, int LPR, int NB, bool BWD, bool ROUND = false>
cudaError_t launch_tile(const Args& a, cudaStream_t st) {
  constexpr int T = tile_rows(LPR);
  void (*kernel)(TileArgs) = BWD ? attn_softmax_tile_bwd<TL, TO, LPR, NB>
                                 : attn_softmax_tile_fwd<TL, TO, LPR, NB, ROUND>;
  const size_t smem =
      tile_smem_bytes(T, a.sk, (int)(sizeof(TL) + (BWD ? sizeof(TO) : 0)), a.stages);
  int blocks = 0;
  cudaError_t err = resident_blocks((const void*)kernel, kTileThreads, smem, &blocks);
  if (err != cudaSuccess) return err;
  const long long batches = a.rows / ((long long)a.nh * a.sq);
  const int tiles_per_b = (a.sq + T - 1) / T;
  const TileArgs t{a.l, a.g, a.out, a.b.p, batches == 1 ? 0 : a.b.sb,
                   a.sq == 1 ? 0 : a.b.sq, a.drop, a.blk, a.nh, a.sq, a.sk, a.stages,
                   tiles_per_b, batches * tiles_per_b, a.inv_scale};
  const long long grid = t.tiles < blocks ? t.tiles : blocks;
  kernel<<<(unsigned)grid, kTileThreads, smem, st>>>(t);
  return cudaGetLastError();
}

template <typename TL, typename TO, int LPR, bool BWD>
cudaError_t tile_bits(const Args& a, cudaStream_t st) {
  if (!BWD && a.round_logits) return launch_tile<TL, TO, LPR, 0, false, true>(a, st);
  switch (a.drop.nbits) {
    case 0: return launch_tile<TL, TO, LPR, 0, BWD>(a, st);
    case 8: return launch_tile<TL, TO, LPR, 8, BWD>(a, st);
    case 16: return launch_tile<TL, TO, LPR, 16, BWD>(a, st);
    case 32: return launch_tile<TL, TO, LPR, 32, BWD>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TL, typename TO, bool BWD>
cudaError_t tile_dispatch(const Args& a, cudaStream_t st) {
  if (!tile_ok(a, (int)(sizeof(TL) + (BWD ? sizeof(TO) : 0)))) return cudaErrorInvalidValue;
  switch (lanes_per_row(a.sk)) {
    case 4: return tile_bits<TL, TO, 4, BWD>(a, st);
    case 8: return tile_bits<TL, TO, 8, BWD>(a, st);
    default: return tile_bits<TL, TO, 16, BWD>(a, st);
  }
}

// The design the wrapper chose: the tile design with a.stages > 0 (it
// refuses what that design does not take), else the row design.
template <typename TL, typename TO>
cudaError_t dispatch(const Args& a, bool backward, cudaStream_t st) {
  if (a.stages == 0) return row_dispatch<TL, TO>(a, backward, st);
  return backward ? tile_dispatch<TL, TO, true>(a, st) : tile_dispatch<TL, TO, false>(a, st);
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
// head head0. `stages`: 0 takes the row design; above 0 the tile design with
// a ring of that many slabs (ops/attn_softmax.py `tile_plan`), refused with
// cudaErrorInvalidValue where it does not take the call. Each launches on
// `stream` without synchronising and returns cudaGetLastError() of its launch
// (cudaErrorInvalidValue for what it does not take).

extern "C" int attn_softmax_forward(const void* l, const void* bias,
                                    long long sb, long long sh, long long sq_,
                                    long long sk_, void* y, long long rows, int nh,
                                    int sq, int sk, int l_dtype, int out_dtype,
                                    float scale, int round_logits,
                                    unsigned seed_lo, unsigned seed_hi, int nbits,
                                    unsigned threshold, float keep_p,
                                    long long row0, int head0, int heads,
                                    int stages, void* stream) {
  if (!shape_ok(rows, nh, sq, sk) || l == nullptr || bias == nullptr ||
      y == nullptr || !drop_ok(nbits, row0, head0, heads, nh))
    return (int)cudaErrorInvalidValue;
  const Args a{l, Bias{static_cast<const float*>(bias), sb, sh, sq_, sk_},
               dropout_rng::make_site(seed_lo, seed_hi, nbits, threshold, keep_p),
               Block{row0, head0, heads}, nullptr, y, rows, nh, sq, sk,
               1.0f / scale, round_logits != 0, stages};
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
                                     int stages, void* stream) {
  if (!shape_ok(rows, nh, sq, sk) || l == nullptr || bias == nullptr ||
      g == nullptr || dl == nullptr || !drop_ok(nbits, row0, head0, heads, nh))
    return (int)cudaErrorInvalidValue;
  const Args a{l, Bias{static_cast<const float*>(bias), sb, sh, sq_, sk_},
               dropout_rng::make_site(seed_lo, seed_hi, nbits, threshold, keep_p),
               Block{row0, head0, heads}, g, dl, rows, nh, sq, sk, 1.0f / scale,
               false, stages};
  return (int)by_dtype(a, l_dtype, out_dtype, true, (cudaStream_t)stream);
}
