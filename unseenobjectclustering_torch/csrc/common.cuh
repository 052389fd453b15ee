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

}  // namespace uoc
