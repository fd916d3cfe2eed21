// K2: packed block-diagonal attention for the bf16 inference encoder.
//
// Replaces the TPU kernel blp_tpu/ops/pallas_attention.py::_attn_kernel
// (launched by block_diag_attention). The fast inference encoder packs
// `Sp / seg` short descriptions into one row; a query attends only to the
// real keys of its own segment. Per (row b, head h), with the TPU kernel's
// rounding points:
//
//   logits = q_h k_h^T                      f32 accumulation
//   x      = bf16(logits * scale + bias)    bias 0 for a real key of the same
//                                           segment, -10000 otherwise (-9984
//                                           after the bf16 round)
//   p      = bf16(e / sum(e)), e = exp(x - max(x))   max, exp, sum in f32
//   out[b, :, h*hd:(h+1)*hd] = bf16(p v_h)  f32 accumulation
//
// The bias is rebuilt from the (Sp,) key mask and the segment length; no
// (Sp, Sp) bias tensor is read.
//
// What bounds it on an H100: at the table-build shape (B = 1024 packed rows,
// 12 heads, Sp = 128, hd = 64) the call reads q, k, v and writes the
// context, 805 MB of bf16 (0.24 ms at 3.35 TB/s); the products are 51.5
// GFLOP at the full Sp x Sp (0.05 ms at 989 TFLOP/s), a quarter of that on
// the segment diagonal. HBM bytes are the limit, so the design is about
// keeping loads in flight, not about the tensor-core rate.
//
// Only the diagonal blocks are computed, and that is exact. Take a query
// whose segment has a real key. Every key outside its segment, and every
// masked key inside it, has x = bf16(logit * scale - 10000), about -9984,
// while the row max comes from a real key. exp(x - max) is then below
// 2^-150 and rounds to exactly 0.0 in f32 as long as the row's logits*scale
// span less than about 9,800 (|logit * scale| < 4,900 suffices; encoder
// activations are orders of magnitude inside that). Such keys add exactly 0
// to the sum and exactly 0 * v = 0 to p v, so leaving them out changes
// nothing. A segment with no real key is different: all its logits carry
// -10000, and its softmax spreads over all Sp keys of the packed row (the
// TPU kernel's result). A warp detects that case with one vote per segment
// over the staged key mask and runs those query rows against all Sp keys.
//
// Design:
// - A persistent grid walks over the B * nh (row, head) pairs: blocks = SMs
//   x blocks per SM, each block taking every grid-th pair. A block of 4
//   warps loads a pair's q, k, v (Sp x hd bf16 each, 48 KB at the main
//   shape) and its key mask into shared memory with cp.async (16 bytes a
//   thread, bypassing L1), waits, computes the pair and moves on. The
//   overlap comes from blocks, not from a ring of stages: at the main shape
//   four such blocks share an SM (199 KB of shared memory, 128 registers a
//   thread), so up to 4 x 48 KB are in flight per SM against the ~25 KB the
//   card needs to cover HBM latency at full rate, and a block that waits on
//   its loads or on one slow warp leaves the SM to the other three. One or
//   two blocks of 8 warps with a 2-4 stage ring each ran slower on the card
//   (PERF.md). cp.async rather than cp.async.bulk: a bulk copy writes a
//   pair's 128-byte rows linearly, and ldmatrix over rows 128 bytes apart
//   hits the same banks 8 times over; per-thread copies place each 16-byte
//   chunk at chunk ^ (row & 7), which makes every ldmatrix conflict-free.
// - One warp per 16 query rows. Both products use mma.sync m16n8k16 bf16
//   with f32 accumulators in the FlashAttention-2 register layout: a warp
//   holds its 16 rows x 32 keys of logits in 16 registers a lane, applies
//   scale, bias and the bf16 round, takes the row max and sum with quad
//   shuffles, and repacks bf16 p directly as the A operand of p v. No logits
//   tile goes to shared memory. A warp's key range is the union of the
//   segments of its rows (32 keys at seg 32, 64 at seg 64); when a segment
//   of the tile has no real key, the range is all Sp keys. The range runs
//   in 32-key chunks. One or two chunks stay in registers (16 or 32 logits
//   a lane; each count its own instance, so seg 32 pays for one), so q k^T
//   is computed once and the max and sum taken over both. A wider range
//   runs over two passes, recomputing q k^T: the first takes the row max
//   and the sum of e (the partial sum rescaled when the max grows), the
//   second p = bf16(exp(x - max) / sum) and p v.
// - The context tile goes through the warp's own (now dead) q rows in
//   shared memory, so each 128-byte head slice of an output row is written
//   with 16-byte stores into the (B, Sp, nh*hd) layout the attention-output
//   GEMM reads.
// - Any shape: hd up to 128 (padded to 16, 32, 64 or 128 columns, zeros in
//   the padding), any Sp that fits one stage in shared memory (Sp <= 592 at
//   hd 64), any seg dividing Sp. When hd is not a multiple of 8 the rows are
//   not 16-byte aligned and the stage is filled with plain element loads
//   (slow, but no shape the encoder uses).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;  // keys per logits chunk (4 n8 tiles)

// Blocks per SM the registers are budgeted for: four at HDP <= 64 (128
// registers a thread); at HDP 128 a Sp-128 stage takes 98.8 KB, so two
// blocks fit, and capping registers for four would only force spills.
__host__ __device__ constexpr int min_blocks(int hdp) { return hdp <= 64 ? 4 : 2; }

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// A block's shared memory: q, k, v as sp16 rows of hdp bf16 each, then the
// (sp16,) f32 key mask.
struct Layout {
  int sp16;       // Sp rounded up to the 16-row tile
  int qkv_bytes;  // one of q, k, v
  int bytes;      // the whole stage
};

__host__ __device__ inline Layout make_layout(int sp, int hdp) {
  Layout L;
  L.sp16 = round_up(sp, 16);
  L.qkv_bytes = L.sp16 * hdp * 2;
  L.bytes = round_up(3 * L.qkv_bytes + L.sp16 * 4, 128);
  return L;
}

__host__ inline int padded_hd(int hd) {
  return hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : -1;
}

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte chunk `c` of staged row `r`, swizzled as
// c ^ (r & 7) when a row has 8 or 16 chunks.
template <int HDP>
__device__ inline uint32_t chunk_off(int r, int c) {
  constexpr int swz = (HDP / 8) % 8 == 0 ? 7 : 0;
  return r * (HDP * 2) + ((c ^ (r & swz)) << 4);
}

__device__ inline void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ inline void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// Wait for all of this thread's cp.async copies.
__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ inline void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                               uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ inline void ldsm_x4_t(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                 uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += a b for one m16n8k16 bf16 tile, f32 accumulators.
__device__ inline void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy the (sp, hd) rows of q, k, v into the stage, 16 bytes a thread. CPR,
// the 16-byte chunks per row, is fixed at compile time when hd == HDP (a
// shift and a mask instead of a division); 0 means hd / 8.
template <int HDP, int CPR>
__device__ inline void copy_rows(uint32_t s0, const Layout& L,
                                 const __nv_bfloat16* const (&src)[3], int sp, int hd) {
  const int cpr = CPR ? CPR : hd / 8;
#pragma unroll
  for (int t = 0; t < 3; ++t)
    for (int i = threadIdx.x; i < sp * cpr; i += kThreads) {
      const int r = i / cpr, c = i % cpr;
      cp_async16(s0 + t * L.qkv_bytes + chunk_off<HDP>(r, c), src[t] + (size_t)r * hd + c * 8);
    }
}

// Fill the stage with pair `bh`'s q, k, v rows and its key mask. Rows and
// columns outside (Sp, hd) are never written: they stay zero.
template <int HDP>
__device__ inline void load_stage(unsigned char* stage, const Layout& L,
                                  const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v,
                                  const float* __restrict__ key_mask, int bh, int nh,
                                  int sp, int hd) {
  const size_t base = (size_t)bh * sp * hd;
  const __nv_bfloat16* src[3] = {q + base, k + base, v + base};
  const uint32_t s0 = smem_u32(stage);
  if (hd == HDP) {
    copy_rows<HDP, HDP / 8>(s0, L, src, sp, hd);
  } else if (hd % 8 == 0) {
    copy_rows<HDP, 0>(s0, L, src, sp, hd);
  } else {
    for (int t = 0; t < 3; ++t)
      for (int i = threadIdx.x; i < sp * hd; i += kThreads) {
        const int r = i / hd, d = i % hd;
        *reinterpret_cast<__nv_bfloat16*>(stage + t * L.qkv_bytes + chunk_off<HDP>(r, d / 8) +
                                          (d % 8) * 2) = src[t][(size_t)r * hd + d];
      }
  }
  const float* m = key_mask + (size_t)(bh / nh) * sp;
  for (int j = threadIdx.x; j < sp; j += kThreads)
    cp_async4(s0 + 3 * L.qkv_bytes + j * 4, m + j);
}

// A warp's tile: its 16 query rows from r0 and their key range [k0, kend),
// nch chunks of kChunk keys, as chunk_logits reads them.
struct Tile {
  uint32_t q_s, k_s, v_s;  // the staged q, k, v
  const float* mk;         // the staged key mask
  int r0, k0, kend, nch, seg, lo0, lo1;
  bool one_seg;
  float scale;
};

// Chunk c of tile T, from key c0 = k0 + 32c: x[j][e] for keys
// c0 + 8j + 2t + (e & 1), rows g + 8 (e >> 1) of the tile:
// bf16(q k^T * scale + bias), or -inf for keys at or past `kend`. A key is
// visible to a row when it is real and inside [lo, lo + seg) of the row's
// segment; when the tile's rows and the key range are one segment
// (`one_seg`), every real key is.
template <int HDP>
__device__ inline void chunk_logits(float (&x)[4][4], const Tile& T, const Layout& L, int c) {
  const int c0 = T.k0 + c * kChunk;
  const int lane = threadIdx.x & 31;
  const uint32_t real = __ballot_sync(0xffffffffu, c0 + lane < T.kend && T.mk[c0 + lane] > 0.0f);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.0f;
  const int m = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(T.q_s + chunk_off<HDP>(T.r0 + (lane & 15), kk * 2 + (lane >> 4)), a[0], a[1], a[2],
            a[3]);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int key = min(c0 + jj * 16 + (m >> 1) * 8 + (lane & 7), L.sp16 - 1);
      uint32_t b0, b1, b2, b3;
      ldsm_x4(T.k_s + chunk_off<HDP>(key, kk * 2 + (m & 1)), b0, b1, b2, b3);
      mma16816(x[2 * jj], a, b0, b1);
      mma16816(x[2 * jj + 1], a, b2, b3);
    }
  }
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int off = 8 * j + 2 * t + (e & 1), key = c0 + off;
      const int lo = (e >> 1) ? T.lo1 : T.lo0;
      const bool vis = ((real >> off) & 1u) && (T.one_seg || (key >= lo && key < lo + T.seg));
      const float y = __bfloat162float(__float2bfloat16_rn(
          __fadd_rn(__fmul_rn(x[j][e], T.scale), vis ? 0.0f : -10000.0f)));
      x[j][e] = key < T.kend ? y : -INFINITY;
    }
}

__device__ inline float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ inline float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The running row max of a chunk's logits, this lane's share (rows g and
// g + 8 of the tile).
__device__ inline void row_max(const float (&x)[4][4], float& m0, float& m1) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m0 = fmaxf(m0, fmaxf(x[j][0], x[j][1]));
    m1 = fmaxf(m1, fmaxf(x[j][2], x[j][3]));
  }
}

// x = e = exp(x - max), added to this lane's share of the row sums.
__device__ inline void exp_sum(float (&x)[4][4], float m0, float m1, float& s0, float& s1) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[j][0] = expf(x[j][0] - m0);
    x[j][1] = expf(x[j][1] - m0);
    x[j][2] = expf(x[j][2] - m1);
    x[j][3] = expf(x[j][3] - m1);
    s0 += x[j][0] + x[j][1];
    s1 += x[j][2] + x[j][3];
  }
}

// p = bf16(e / sum) of a chunk, packed as the A operands of its two 16-key
// k-steps of p v.
__device__ inline void pack_p(uint32_t (&p)[2][4], const float (&x)[4][4], float s0, float s1) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    p[s][0] = pack_bf16(x[2 * s][0] / s0, x[2 * s][1] / s0);
    p[s][1] = pack_bf16(x[2 * s][2] / s1, x[2 * s][3] / s1);
    p[s][2] = pack_bf16(x[2 * s + 1][0] / s0, x[2 * s + 1][1] / s0);
    p[s][3] = pack_bf16(x[2 * s + 1][2] / s1, x[2 * s + 1][3] / s1);
  }
}

// o += p v over the 32 keys from c0.
template <int HDP>
__device__ inline void chunk_pv(float (&o)[HDP / 8][4], const uint32_t (&p)[2][4], uint32_t v_s,
                                const Layout& L, int c0) {
  const int lane = threadIdx.x & 31;
  const int m = lane >> 3;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int key = min(c0 + s * 16 + (m & 1) * 8 + (lane & 7), L.sp16 - 1);
#pragma unroll
    for (int u = 0; u < HDP / 16; ++u) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(v_s + chunk_off<HDP>(key, 2 * u + (m >> 1)), b0, b1, b2, b3);
      mma16816(o[2 * u], p[s], b0, b1);
      mma16816(o[2 * u + 1], p[s], b2, b3);
    }
  }
}

// The tile's context o = softmax(x) v in f32. NCH > 0: the range is NCH
// chunks, held in registers, so q k^T is computed once and the max and sum
// are taken over all of them; p is packed before o goes live. NCH = 0: any
// number of chunks streamed over two passes, the first taking the row max
// and the sum of e (the partial sum rescaled when a later chunk raises the
// max), the second recomputing q k^T for p v. A chunk starts below kend, so
// every row's max is finite. One instance for each NCH keeps the one-chunk
// path's registers those of one chunk.
template <int HDP, int NCH>
__device__ inline void tile_context(float (&o)[HDP / 8][4], const Tile& T, const Layout& L) {
  float m0 = -INFINITY, m1 = -INFINITY, s0 = 0.0f, s1 = 0.0f;
  if constexpr (NCH > 0) {
    float x[NCH][4][4];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      chunk_logits<HDP>(x[c], T, L, c);
      row_max(x[c], m0, m1);
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
#pragma unroll
    for (int c = 0; c < NCH; ++c) exp_sum(x[c], m0, m1, s0, s1);
    s0 = quad_sum(s0);
    s1 = quad_sum(s1);
    uint32_t p[NCH][2][4];
#pragma unroll
    for (int c = 0; c < NCH; ++c) pack_p(p[c], x[c], s0, s1);
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) chunk_pv<HDP>(o, p[c], T.v_s, L, T.k0 + c * kChunk);
  } else {
    float x[4][4];
    for (int c = 0; c < T.nch; ++c) {
      chunk_logits<HDP>(x, T, L, c);
      float n0 = m0, n1 = m1;
      row_max(x, n0, n1);
      n0 = quad_max(n0);
      n1 = quad_max(n1);
      if (c > 0) {
        s0 *= expf(m0 - n0);
        s1 *= expf(m1 - n1);
      }
      m0 = n0;
      m1 = n1;
      exp_sum(x, m0, m1, s0, s1);
    }
    s0 = quad_sum(s0);
    s1 = quad_sum(s1);
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
    for (int c = 0; c < T.nch; ++c) {
      chunk_logits<HDP>(x, T, L, c);
      float unused0 = 0.0f, unused1 = 0.0f;  // the sums are pass 1's
      exp_sum(x, m0, m1, unused0, unused1);
      uint32_t p[2][4];
      pack_p(p, x, s0, s1);
      chunk_pv<HDP>(o, p, T.v_s, L, T.k0 + c * kChunk);
    }
  }
}

// Write `rows` staged context rows from r0 on, 16 bytes a lane (CPR as in
// copy_rows).
template <int HDP, int CPR>
__device__ inline void store_rows(const unsigned char* qrows, int r0, int rows, int hd,
                                  __nv_bfloat16* __restrict__ out_rows, size_t out_stride) {
  const int cpr = CPR ? CPR : hd / 8;
  for (int i = threadIdx.x & 31; i < rows * cpr; i += 32) {
    const int r = i / cpr, c = i % cpr;
    *reinterpret_cast<uint4*>(out_rows + (size_t)(r0 + r) * out_stride + c * 8) =
        *reinterpret_cast<const uint4*>(qrows + chunk_off<HDP>(r0 + r, c));
  }
}

// One warp's 16 query rows starting at r0 of the staged pair.
template <int HDP>
__device__ inline void attend_tile(unsigned char* stage, const Layout& L, int r0, int sp,
                                   int hd, int seg, float scale,
                                   __nv_bfloat16* __restrict__ out_rows, size_t out_stride) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t q_s = smem_u32(stage);
  const uint32_t k_s = q_s + L.qkv_bytes;
  const float* mk = reinterpret_cast<const float*>(stage + 3 * L.qkv_bytes);

  // Key range: the segments of the tile's real rows, or the whole row when
  // one of those segments has no real key.
  const int sa = r0 / seg, sb = (min(r0 + 15, sp - 1)) / seg;
  bool wide = false;
  for (int s = sa; s <= sb && !wide; ++s) {
    bool any = false;
    for (int j = lane; j < seg; j += 32) any |= mk[s * seg + j] > 0.0f;
    wide = !__any_sync(0xffffffffu, any);
  }
  const int k0 = wide ? 0 : sa * seg;
  const int kend = wide ? sp : (sb + 1) * seg;
  const Tile T = {q_s, k_s, q_s + 2 * L.qkv_bytes, mk, r0, k0, kend,
                  (kend - k0 + kChunk - 1) / kChunk, seg, (r0 + g) / seg * seg,
                  (r0 + g + 8) / seg * seg, !wide && sa == sb, scale};
  float o[HDP / 8][4];
  if (T.nch == 1)
    tile_context<HDP, 1>(o, T, L);
  else if (T.nch == 2)
    tile_context<HDP, 2>(o, T, L);
  else
    tile_context<HDP, 0>(o, T, L);

  // Stage the bf16 context in the tile's own q rows (read above, by this
  // warp only; every read has fed an mma whose result the stores depend
  // on), then write each real row's hd columns.
  __syncwarp();
  unsigned char* qrows = stage;
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n) {
    if (r0 + g < sp)
      *reinterpret_cast<uint32_t*>(qrows + chunk_off<HDP>(r0 + g, n) + 4 * t) =
          pack_bf16(o[n][0], o[n][1]);
    if (r0 + g + 8 < sp)
      *reinterpret_cast<uint32_t*>(qrows + chunk_off<HDP>(r0 + g + 8, n) + 4 * t) =
          pack_bf16(o[n][2], o[n][3]);
  }
  __syncwarp();
  const int rows = min(16, sp - r0);
  if (hd == HDP) {
    store_rows<HDP, HDP / 8>(qrows, r0, rows, hd, out_rows, out_stride);
  } else if (hd % 8 == 0) {
    store_rows<HDP, 0>(qrows, r0, rows, hd, out_rows, out_stride);
  } else {
    for (int i = lane; i < rows * hd; i += 32) {
      const int r = i / hd, d = i % hd;
      out_rows[(size_t)(r0 + r) * out_stride + d] = *reinterpret_cast<const __nv_bfloat16*>(
          qrows + chunk_off<HDP>(r0 + r, d / 8) + (d % 8) * 2);
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, min_blocks(HDP))
packed_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const float* __restrict__ key_mask,
                        __nv_bfloat16* __restrict__ out, int pairs, int nh, int sp,
                        int hd, int seg, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(sp, HDP);

  // Zero the stage once: padded rows and columns are never loaded, so they
  // stay zero for every pair.
  {
    uint4* p = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < L.bytes / 16; i += kThreads) p[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const size_t H = (size_t)nh * hd;
  for (int bh = blockIdx.x; bh < pairs; bh += gridDim.x) {
    load_stage<HDP>(smem, L, q, k, v, key_mask, bh, nh, sp, hd);
    cp_async_wait_all();
    __syncthreads();
    const int b = bh / nh, h = bh % nh;
    for (int r0 = warp * 16; r0 < sp; r0 += kWarps * 16)
      attend_tile<HDP>(smem, L, r0, sp, hd, seg, scale,
                       out + (size_t)b * sp * H + (size_t)h * hd, H);
    __syncthreads();
  }
}

// The grid for one (device, Sp) and the shared-memory attribute behind it,
// cached per HDP instance: the encoder launches at one Sp many times.
struct GridCache {
  std::mutex mu;
  int dev = -1, sp = -1, blocks = 0;
};

template <int HDP>
int launch(const void* q, const void* k, const void* v, const float* key_mask, void* out,
           int batch, int nh, int sp, int hd, int seg, float scale, cudaStream_t stream) {
  static GridCache cache;
  const int bytes = make_layout(sp, HDP).bytes;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int blocks;
  {
    std::lock_guard<std::mutex> lock(cache.mu);
    if (cache.dev != dev || cache.sp != sp) {
      int sms = 0, per_sm = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(packed_attention_kernel<HDP>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, packed_attention_kernel<HDP>, kThreads, bytes);
      if (err != cudaSuccess) return (int)err;
      cache.dev = dev;
      cache.sp = sp;
      cache.blocks = sms * max(per_sm, 1);
    }
    blocks = cache.blocks;
  }
  const int pairs = batch * nh;
  packed_attention_kernel<HDP><<<min(pairs, blocks), kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), key_mask, static_cast<__nv_bfloat16*>(out), pairs,
      nh, sp, hd, seg, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory bytes a block of the kernel needs at (sp, hd); -1 for hd
// above 128. The wrapper refuses shapes above the card's per-block limit.
extern "C" long long packed_attention_smem_bytes(int sp, int hd) {
  const int hdp = padded_hd(hd);
  return hdp < 0 ? -1 : (long long)make_layout(sp, hdp).bytes;
}

// Plain C entry point (bound with ctypes). q, k, v: (B, nh, Sp, hd) bf16
// contiguous (16-byte aligned when hd % 8 == 0); key_mask: (B, Sp) f32; out:
// (B, Sp, nh*hd) bf16, 16-byte aligned. Requires Sp % seg == 0, hd <= 128
// and packed_attention_smem_bytes within the card's limit (checked by the
// wrapper). Launches on `stream` without synchronising; returns
// cudaGetLastError().
extern "C" int packed_attention_launch(const void* q, const void* k, const void* v,
                                       const float* key_mask, void* out, int batch, int nh,
                                       int sp, int hd, int seg, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (padded_hd(hd)) {
    case 16: return launch<16>(q, k, v, key_mask, out, batch, nh, sp, hd, seg, scale, s);
    case 32: return launch<32>(q, k, v, key_mask, out, batch, nh, sp, hd, seg, scale, s);
    case 64: return launch<64>(q, k, v, key_mask, out, batch, nh, sp, hd, seg, scale, s);
    case 128: return launch<128>(q, k, v, key_mask, out, batch, nh, sp, hd, seg, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
