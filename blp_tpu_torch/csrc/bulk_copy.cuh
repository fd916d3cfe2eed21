// Bulk copies (TMA) from global into shared memory that complete on an
// mbarrier, and the host side of kernels that use them: F3's tile design
// (attn_softmax.cu), a ring of slabs that a producer thread keeps filled,
// and F2's forward (fused_layer.cu), a slab of rows a block. ops/_cuda.py
// hashes this header into every library's name.
//
// A ring's protocol: a producer thread waits until a slot is empty
// (`mbar_wait(&empty[slot], phase ^ 1)`), sets the bytes its copies will
// bring (`mbar_arrive_expect_tx(&full[slot], bytes)`) and issues them
// (`bulk_load`); each consumer waits for the slot's fill
// (`mbar_wait(&full[slot], phase)`), moves its values into registers and
// arrives on `empty[slot]`.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace bulk_copy {

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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also sets the bytes the phase's copies will complete.
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

// A bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"((uint64_t)src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// ---- end of the PTX helpers

constexpr size_t kMaxSmem = 232448;   // a block's shared memory on sm_90

// Raise `kernel`'s dynamic shared memory limit on the current device to
// `smem` bytes if it is below: a limit is only ever raised, so every size
// asked of a kernel before still launches.
inline cudaError_t raise_smem_limit(const void* kernel, size_t smem) {
  struct Limit {
    const void* kernel;
    int dev;
    size_t smem;
  };
  static std::mutex mu;
  static std::vector<Limit> limits;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  Limit* limit = nullptr;
  for (Limit& l : limits)
    if (l.kernel == kernel && l.dev == dev) limit = &l;
  if (limit != nullptr && limit->smem >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (limit == nullptr) limits.push_back(Limit{kernel, dev, smem});
  else limit->smem = smem;
  return cudaSuccess;
}

// Resident blocks of `kernel` with `threads` threads and `smem` bytes of
// dynamic shared memory (its limit raised to that first): SMs x blocks an SM
// from the occupancy API, cached by kernel, device and size.
inline cudaError_t resident_blocks(const void* kernel, int threads, size_t smem,
                                   int* blocks) {
  struct Entry {
    const void* kernel;
    int dev, threads;
    size_t smem;
    int blocks;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  cudaError_t err = raise_smem_limit(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.kernel == kernel && e.dev == dev && e.threads == threads && e.smem == smem) {
      *blocks = e.blocks;
      return cudaSuccess;
    }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  cache.push_back(Entry{kernel, dev, threads, smem, sms * (per_sm > 0 ? per_sm : 1)});
  *blocks = cache.back().blocks;
  return cudaSuccess;
}

}  // namespace bulk_copy
