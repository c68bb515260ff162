// What the persistent wgmma group-min kernels share (groupmin_wgmma.cu:
// bf16x3 and bf16; groupmin_wgmma_i8.cu: int8): mbarriers, the 1-D bulk
// copy, the consumers' barrier, the proxy and wgmma fences, the
// shared-memory matrix descriptor and the 128B swizzle. All of it is in
// bytes, so one 128-byte swizzle row holds 64 bf16 or 128 int8 values, and
// a wgmma k-step (16 bf16 or 32 int8) advances an operand by 32 bytes.
//
// The Python wrapper keys each library by a hash of its source and of every
// file the source includes, so an edit here rebuilds both libraries.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D bulk copy global -> shared, completing `bytes` on the mbarrier
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the consumer warpgroups' own barrier (id 1; the producer never joins)
__device__ __forceinline__ void consumer_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nthreads) : "memory");
}

// generic-proxy stores to shared memory, made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// shared-memory matrix descriptor: K-major, 128B swizzle, 8-row core
// matrices 1024 bytes apart (SBO); LBO is unused for swizzled K-major
// layouts. A k-step (32 bytes) inside a 128-byte row advances the start
// address; every tile base is 1024-byte aligned.
__device__ __forceinline__ uint64_t sdesc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// byte offset of the 16-byte chunk cc of row r in a 128B-swizzled K-major
// tile of 128-byte rows
__device__ __forceinline__ int swz(int r, int cc) { return r * 128 + ((cc ^ (r & 7)) << 4); }
