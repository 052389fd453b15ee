// Helpers shared by the clustering kernels (built for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace uoc {

// Element types the kernels read: 0 = float32, 1 = bfloat16.
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Grid-wide barrier of a cooperative launch (every block co-resident).
// `arrived` is a zero-initialised counter in device memory that only
// grows: the q-th barrier of the launch (q = 1, 2, ...) waits until it
// reaches q * gridDim.x.  Writes made before the barrier by any block are
// visible after it to loads that bypass L1 (__ldcg) or to atomics.
__device__ __forceinline__ void grid_barrier(unsigned* arrived, unsigned q) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrived, 1u);
    const unsigned target = q * gridDim.x;
    while (load_acquire(arrived) < target) {
    }
  }
  __syncthreads();
}

// Launch `kernel` cooperatively; refuses (returns an error) when `grid`
// blocks cannot all be resident at once.
template <typename... KArgs>
cudaError_t launch_cooperative_as(void (*kernel)(KArgs...), int grid,
                                  int threads, size_t smem,
                                  cudaStream_t stream, KArgs... args) {
  void* argv[] = {static_cast<void*>(&args)...};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(grid), dim3(threads), argv, smem,
                                     stream);
}

template <typename... KArgs, typename... Args>
cudaError_t launch_cooperative(void (*kernel)(KArgs...), int grid, int threads,
                               size_t smem, cudaStream_t stream,
                               Args... args) {
  static_assert(sizeof...(KArgs) == sizeof...(Args), "argument count");
  return launch_cooperative_as<KArgs...>(kernel, grid, threads, smem, stream,
                                         args...);
}

// Blocks of `kernel` that fit on one SM of device `dev` at once with
// `threads` threads and `smem` bytes of dynamic shared memory.  The
// kernel's dynamic shared-memory limit is raised to `max_smem` (>= every
// smem it is launched with) once per device.
template <auto kernel>
cudaError_t blocks_per_sm(int dev, int threads, size_t smem, size_t max_smem,
                          int* out) {
  constexpr int kDevices = 64;
  static bool raised[kDevices] = {};
  if (dev >= kDevices || !raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(max_smem));
    if (err != cudaSuccess) return err;
    if (dev < kDevices) raised[dev] = true;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads,
                                                       smem);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier in shared memory whose phase completes when `count`
// threads have arrived and the bytes they announced (bulk copies) have
// landed; wait on its phase parity.
__device__ __forceinline__ void mbar_init(void* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(void* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(void* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(void* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory by the bulk-copy engine, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, void* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's generic-proxy accesses to shared memory before
// later async-proxy ones (bulk copies, wgmma operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace uoc
