// K2: packed block-diagonal attention for the bf16 inference encoder.
//
// Replaces the TPU kernel blp_tpu/ops/pallas_attention.py::_attn_kernel
// (launched by block_diag_attention). The fast inference encoder packs
// `Sp / seg` short descriptions into one row; a query attends only to the
// real keys of its own segment. Per (row b, head h):
//
//   logits = q_h k_h^T                      f32 accumulation
//   x      = bf16(logits * scale + bias)    bias 0 for a real key of the same
//                                           segment, -10000 otherwise (-9984
//                                           after the bf16 round: still a hard
//                                           mask)
//   p      = bf16(softmax(x))               max, exp and sum in f32
//   out[b, :, h*hd:(h+1)*hd] = bf16(p v_h)  f32 accumulation
//
// The bias is rebuilt from the (Sp,) key mask and the segment length; no
// (Sp, Sp) bias tensor is read. Each row's softmax runs over all Sp keys, as
// the TPU kernel's does, so a segment whose keys are all masked gives the same
// result as there (computing only the diagonal seg x seg blocks would be exact
// only when every segment has a real key).
//
// What bounds it on an H100: at the flagship table-build shape (B = 1024
// packed rows, 12 heads, Sp = 128, hd = 64) the call reads q, k, v and writes
// the context, 805 MB in bf16 (0.24 ms at 3.35 TB/s), against 51.5 GFLOP of
// tensor-core products (0.05 ms at 989 TFLOP/s): HBM bytes are the limit.
//
// Design (a simple first form): one block of 8 warps per (row, head). q, k and
// v for that pair are staged in shared memory (16-byte loads when hd % 8 ==
// 0); both products run on the tensor cores through WMMA bf16 16x16x16
// fragments with f32 accumulators; the logits tile (Sp x Sp f32) and the bf16
// probabilities stay in shared memory, so nothing between the two products
// touches HBM; the context is written straight into the (B, Sp, nh*hd) layout
// the attention-output GEMM reads. Sp and hd need not be multiples of 16: the
// staged tiles are zero-padded up to the fragment size, padded keys are left
// out of the softmax (probability exactly 0) and padded rows and columns are
// never written. About 155 KB of shared memory at the flagship shape, so one
// block per SM: the loads of one block do not yet overlap the products of
// another.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct Layout {
  int sp16; // Sp rounded up to the fragment size
  int hd16; // hd rounded up to the fragment size
  int ldh;  // bf16 row stride of the staged q, k, v
  int lds;  // f32 row stride of the logits / context tile
  int ldp;  // bf16 row stride of the probabilities
  size_t q_off, k_off, v_off, s_off, p_off, m_off, bytes;
};

__host__ __device__ inline Layout make_layout(int sp, int hd) {
  Layout L;
  L.sp16 = (sp + 15) / 16 * 16;
  L.hd16 = (hd + 15) / 16 * 16;
  L.ldh = L.hd16 + 8;
  L.lds = (L.sp16 > L.hd16 ? L.sp16 : L.hd16) + 4;
  L.ldp = L.sp16 + 8;
  const size_t qkv = (size_t)L.sp16 * L.ldh * sizeof(__nv_bfloat16);
  L.q_off = 0;
  L.k_off = qkv;
  L.v_off = 2 * qkv;
  L.s_off = 3 * qkv;
  L.p_off = L.s_off + (size_t)L.sp16 * L.lds * sizeof(float);
  L.m_off = L.p_off + (size_t)L.sp16 * L.ldp * sizeof(__nv_bfloat16);
  L.bytes = L.m_off + (size_t)L.sp16 * sizeof(float);
  return L;
}

__device__ inline float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(kThreads)
packed_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const float* __restrict__ key_mask,
                        __nv_bfloat16* __restrict__ out, int nh, int sp,
                        int hd, int seg, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(sp, hd);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L.q_off);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + L.k_off);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + L.v_off);
  float* s_s = reinterpret_cast<float*>(smem + L.s_off);
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(smem + L.p_off);
  float* m_s = reinterpret_cast<float*>(smem + L.m_off);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x;  // b * nh + h
  const int b = bh / nh;
  const int h = bh % nh;
  const size_t base = (size_t)bh * sp * hd;  // (B, nh, Sp, hd) contiguous

  // Stage q, k, v, zero-padded to (sp16, hd16): zeros add nothing to q k^T,
  // and zero rows of v meet probabilities that are exactly 0.
  if (hd % 8 == 0) {  // 8 bf16 (16 bytes) per load
    const int vecs = L.hd16 / 8;
    for (int idx = tid; idx < L.sp16 * vecs; idx += kThreads) {
      const int row = idx / vecs, c8 = (idx % vecs) * 8;
      uint4 qv = make_uint4(0, 0, 0, 0), kv = qv, vv = qv;
      if (row < sp && c8 < hd) {
        const size_t g = base + (size_t)row * hd + c8;
        qv = *reinterpret_cast<const uint4*>(q + g);
        kv = *reinterpret_cast<const uint4*>(k + g);
        vv = *reinterpret_cast<const uint4*>(v + g);
      }
      *reinterpret_cast<uint4*>(q_s + row * L.ldh + c8) = qv;
      *reinterpret_cast<uint4*>(k_s + row * L.ldh + c8) = kv;
      *reinterpret_cast<uint4*>(v_s + row * L.ldh + c8) = vv;
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    for (int idx = tid; idx < L.sp16 * L.hd16; idx += kThreads) {
      const int row = idx / L.hd16, c = idx % L.hd16;
      const bool in = row < sp && c < hd;
      const size_t g = base + (size_t)row * hd + c;
      q_s[row * L.ldh + c] = in ? q[g] : zero;
      k_s[row * L.ldh + c] = in ? k[g] : zero;
      v_s[row * L.ldh + c] = in ? v[g] : zero;
    }
  }
  for (int j = tid; j < L.sp16; j += kThreads)
    m_s[j] = j < sp ? key_mask[(size_t)b * sp + j] : 0.0f;
  __syncthreads();

  // logits = q k^T. k stored row-major (Sp, hd) is k^T in column-major form.
  const int nt = L.sp16 / 16;
  for (int t = warp; t < nt * nt; t += kWarps) {
    const int ti = t / nt, tj = t % nt;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < L.hd16; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, q_s + ti * 16 * L.ldh + kk, L.ldh);
      wmma::load_matrix_sync(fb, k_s + tj * 16 * L.ldh + kk, L.ldh);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(s_s + ti * 16 * L.lds + tj * 16, acc, L.lds,
                            wmma::mem_row_major);
  }
  __syncthreads();

  // Softmax, one warp per query row, with the TPU kernel's rounding points,
  // over the Sp real keys; a padded key's probability is exactly 0.
  for (int i = warp; i < sp; i += kWarps) {
    float* row = s_s + i * L.lds;
    const int iseg = i / seg;
    float mx = -INFINITY;
    for (int j = lane; j < sp; j += 32) {
      const float bias = (j / seg == iseg && m_s[j] > 0.0f) ? 0.0f : -10000.0f;
      const float x = __bfloat162float(__float2bfloat16_rn(row[j] * scale + bias));
      row[j] = x;
      mx = fmaxf(mx, x);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < sp; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < L.sp16; j += 32)
      p_s[i * L.ldp + j] = __float2bfloat16_rn(j < sp ? row[j] / sum : 0.0f);
  }
  __syncthreads();

  // ctx = p v, written over the logits tile (no longer read). Rows of p at
  // or past Sp were never written; they only feed context rows that are not
  // stored.
  const int nd = L.hd16 / 16;
  for (int t = warp; t < nt * nd; t += kWarps) {
    const int ti = t / nd, tj = t % nd;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < L.sp16; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, p_s + ti * 16 * L.ldp + kk, L.ldp);
      wmma::load_matrix_sync(fb, v_s + kk * L.ldh + tj * 16, L.ldh);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(s_s + ti * 16 * L.lds + tj * 16, acc, L.lds,
                            wmma::mem_row_major);
  }
  __syncthreads();

  // out[b, i, h*hd + d] for i < Sp, d < hd: two bf16 per store when hd is
  // even (then every pair is 4-byte aligned).
  const int H = nh * hd;
  if (hd % 2 == 0) {
    const int pairs = hd / 2;
    for (int idx = tid; idx < sp * pairs; idx += kThreads) {
      const int i = idx / pairs, d2 = (idx % pairs) * 2;
      const float* o = s_s + i * L.lds + d2;
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * sp + i) * H + h * hd + d2) =
          __floats2bfloat162_rn(o[0], o[1]);
    }
  } else {
    for (int idx = tid; idx < sp * hd; idx += kThreads) {
      const int i = idx / hd, d = idx % hd;
      out[((size_t)b * sp + i) * H + h * hd + d] =
          __float2bfloat16_rn(s_s[i * L.lds + d]);
    }
  }
}

}  // namespace

// Shared-memory bytes the kernel needs at (sp, hd); the wrapper refuses
// shapes above the card's per-block limit.
extern "C" long long packed_attention_smem_bytes(int sp, int hd) {
  return (long long)make_layout(sp, hd).bytes;
}

// Plain C entry point (bound with ctypes). q, k, v: (B, nh, Sp, hd) bf16
// contiguous (16-byte aligned when hd % 8 == 0); key_mask: (B, Sp) f32; out:
// (B, Sp, nh*hd) bf16. Requires Sp % seg == 0 and the shared memory of
// packed_attention_smem_bytes (checked by the wrapper). Launches on `stream`
// without synchronising; returns cudaGetLastError().
extern "C" int packed_attention_launch(const void* q, const void* k,
                                       const void* v, const float* key_mask,
                                       void* out, int batch, int nh, int sp,
                                       int hd, int seg, float scale,
                                       void* stream) {
  const size_t bytes = make_layout(sp, hd).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      packed_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  packed_attention_kernel<<<batch * nh, kThreads, bytes, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), key_mask,
      static_cast<__nv_bfloat16*>(out), nh, sp, hd, seg, scale);
  return (int)cudaGetLastError();
}
