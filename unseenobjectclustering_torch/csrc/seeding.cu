// Farthest-point seed selection (cosine metric) for the vMF mean shift.
//
// Replaces the TPU kernel _seeding_kernel / select_seeds_pallas
// (unseenobjectclustering_tpu/ops/pallas_seeding.py), which kept X resident
// in VMEM and ran the whole m-step loop in one kernel.
//
// What it computes: starting from `first`, m-1 sequential steps; step s
// takes the newest seed x_sel, folds dist_i = 0.5 * (1 - x_i . x_sel) into
// the running min_dist_i, and the next seed is argmax_i min_dist_i, lowest
// index on a tie.
//
// Bound on the H100: one read of X and 2*(m-1)*n*d flops.  What costs is
// the m-1 sequential steps: X at the parity shape ([307200, 64] fp32,
// 78.6 MB; 157 MB at d = 128) does not fit the 50 MB L2, so a kernel that
// reads X anew at every step is bound by HBM, and one launch per step is
// bound by launches at the fast shape ([38400, 64] bf16, 4.9 MB).
//
// Design: one persistent cooperative launch (every block resident), one
// grid-wide barrier per step.  Block b owns the pixels [b*len, b*len+len)
// for all m-1 steps and holds as much of their X on chip as fits: the first
// kThreads pixels in registers (one pixel's d values per thread, widened
// to fp32), the next ones in shared memory (as [d][S], so the threads of a
// warp read neighbouring words), and only the rest is read again each step,
// from L2 (or, past what L2 holds, from HBM).  min_dist never leaves the
// chip (a register, or shared memory).  X arrives as rows (a strided view
// such as x[::8] is read in place); at start-up each block transposes the
// pixels it re-reads into a [d, *] scratch in device memory, so that the
// re-reads coalesce.  Each dot is the same sequential fp32 FMA chain over
// j = 0..d-1 as the plain version's reference arithmetic (bf16 widens
// exactly; no tensor cores, so no TF32 truncation).  The argmax packs
// (order-preserving float bits, ~index) into one 64-bit key: a warp/block
// max, then one atomicMax per block into keys[s + 1] before the barrier;
// every block reads the winner after it.
//
// The width d is a template parameter, 64 or 128 (2 * NUM_UNITS under the
// cat fusion).  At d = 64 a block has 512 threads (128 registers each at
// most).  At d = 128 a pixel's values take 128 registers, so a block has
// 256 threads (255 registers each at most) and holds 256 pixels in
// registers: the register file holds the same 128 KB of X per SM either
// way (two threads per pixel with a shuffle per dot would hold no more),
// and the sequential chain per pixel stays one thread's.  At the parity
// frame each block then re-reads about 1,640 of its 2,328 pixels a step,
// 110 MB in all, from HBM: about 33 us a step against 5 us at d = 64.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kTile = 64;  // pixels per step of the start-up transpose

// Threads per block at width d, and the bytes before min_dist in shared
// memory (the newest seed, the warps' best keys).
__host__ __device__ constexpr int seed_threads(int d) {
  return d == 64 ? 512 : 256;
}
__host__ __device__ constexpr size_t fixed_bytes(int d) {
  return d * sizeof(float) + (seed_threads(d) / 32) * sizeof(uint64_t);
}

__device__ __forceinline__ unsigned int ordered_bits(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Larger key <=> larger value, then lower index.
__device__ __forceinline__ unsigned long long pack_key(float v, int i) {
  return (static_cast<unsigned long long>(ordered_bits(v)) << 32) |
         static_cast<unsigned long long>(0xFFFFFFFFu - static_cast<unsigned int>(i));
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<unsigned int>(key & 0xFFFFFFFFull));
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xFFFFFFFFu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

__host__ __device__ __forceinline__ size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

template <typename T, int kD>
__global__ void __launch_bounds__(seed_threads(kD), 1)
select_seeds_kernel(const T* __restrict__ x, long long ld, int n, int len,
                    int smem_px, int str_px, int num_seeds, int first,
                    unsigned long long* __restrict__ keys,
                    unsigned* __restrict__ arrived, int* __restrict__ idx,
                    T* __restrict__ xs_t) {
  constexpr int kThreads = seed_threads(kD);
  constexpr int kWarps = kThreads / 32;
  constexpr size_t kFixedBytes = fixed_bytes(kD);
  extern __shared__ __align__(16) unsigned char smem[];
  float* v = reinterpret_cast<float*>(smem);  // [kD] newest seed, fp32
  unsigned long long* warp_best =
      reinterpret_cast<unsigned long long*>(smem + kD * sizeof(float));
  float* smd = reinterpret_cast<float*>(smem + kFixedBytes);  // min_dist
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * len;
  const int count = max(0, min(n - p0, len));
  const int reg_px = min(kThreads, count);
  const int rest = count - reg_px;  // pixels past the register ones
  const int s_px = min(smem_px, rest);
  // [kD][smem_px] X values of pixels p0 + reg_px + [0, s_px)
  T* sx = reinterpret_cast<T*>(
      smem + kFixedBytes + align16(sizeof(float) * max(0, len - kThreads)));
  // the pixels past those, re-read every step: [kD][gridDim.x * str_px]
  // in device memory, this block's str_px columns from column c0
  const size_t spitch = static_cast<size_t>(gridDim.x) * str_px;
  const size_t c0 = static_cast<size_t>(blockIdx.x) * str_px;
  auto row = [&](int p) { return x + static_cast<size_t>(p) * ld; };

  // transpose the re-read pixels through shared memory (sx is free yet)
  T* tile = sx;  // [kTile][kD + 1]
  for (int q0 = s_px; q0 < rest; q0 += kTile) {
    const int cnt = min(kTile, rest - q0);
    for (int e = tid; e < cnt * kD; e += kThreads)
      tile[(e / kD) * (kD + 1) + e % kD] = row(p0 + reg_px + q0 + e / kD)[e % kD];
    __syncthreads();
    for (int e = tid; e < cnt * kD; e += kThreads) {
      const int j = e / cnt, q = e % cnt;
      xs_t[j * spitch + c0 + q0 - s_px + q] = tile[q * (kD + 1) + j];
    }
    __syncthreads();
  }
  float xr[kD];
  if (tid < reg_px) {
#pragma unroll
    for (int j = 0; j < kD; ++j) xr[j] = uoc::to_f32(row(p0 + tid)[j]);
  }
#pragma unroll 8
  for (int e = tid; e < s_px * kD; e += kThreads)
    sx[(e % kD) * smem_px + e / kD] = row(p0 + reg_px + e / kD)[e % kD];
  __syncthreads();
  float md_r = 0.0f;
  const float4* v4 = reinterpret_cast<const float4*>(v);

  for (int step = 0; step + 1 < num_seeds; ++step) {
    const int sel = step == 0 ? first : key_index(__ldcg(&keys[step]));
    if (tid < kD) v[tid] = uoc::to_f32(row(sel)[tid]);
    __syncthreads();

    unsigned long long best = 0;
    if (tid < reg_px) {
      float acc = 0.0f;
#pragma unroll
      for (int j4 = 0; j4 < kD / 4; ++j4) {
        const float4 w = v4[j4];
        acc = fmaf(xr[4 * j4], w.x, acc);
        acc = fmaf(xr[4 * j4 + 1], w.y, acc);
        acc = fmaf(xr[4 * j4 + 2], w.z, acc);
        acc = fmaf(xr[4 * j4 + 3], w.w, acc);
      }
      const float dist = 0.5f * (1.0f - acc);
      md_r = step == 0 ? dist : fminf(md_r, dist);
      best = pack_key(md_r, p0 + tid);
    }
    for (int q = tid; q < s_px; q += kThreads) {
      float acc = 0.0f;
#pragma unroll
      for (int j4 = 0; j4 < kD / 4; ++j4) {
        const float4 w = v4[j4];
        acc = fmaf(uoc::to_f32(sx[(4 * j4) * smem_px + q]), w.x, acc);
        acc = fmaf(uoc::to_f32(sx[(4 * j4 + 1) * smem_px + q]), w.y, acc);
        acc = fmaf(uoc::to_f32(sx[(4 * j4 + 2) * smem_px + q]), w.z, acc);
        acc = fmaf(uoc::to_f32(sx[(4 * j4 + 3) * smem_px + q]), w.w, acc);
      }
      const float dist = 0.5f * (1.0f - acc);
      const float md = step == 0 ? dist : fminf(smd[q], dist);
      smd[q] = md;
      const unsigned long long key = pack_key(md, p0 + reg_px + q);
      best = key > best ? key : best;
    }
    for (int q = s_px + tid; q < rest; q += kThreads) {
      const int i = p0 + reg_px + q;
      const T* col = xs_t + c0 + q - s_px;
      // unrolled so that many independent L2 loads are in flight
      float acc = 0.0f;
#pragma unroll 16
      for (int j = 0; j < kD; ++j)
        acc = fmaf(uoc::to_f32(col[j * spitch]), v[j], acc);
      const float dist = 0.5f * (1.0f - acc);
      const float md = step == 0 ? dist : fminf(smd[q], dist);
      smd[q] = md;
      const unsigned long long key = pack_key(md, i);
      best = key > best ? key : best;
    }

    best = warp_max(best);
    if ((tid & 31) == 0) warp_best[tid >> 5] = best;
    __syncthreads();
    if (tid < 32) {
      best = tid < kWarps ? warp_best[tid] : 0ull;
      best = warp_max(best);
      if (tid == 0 && best != 0ull) atomicMax(&keys[step + 1], best);
    }
    uoc::grid_barrier(arrived, step + 1);
  }

  if (blockIdx.x == 0)
    for (int k = tid; k < num_seeds; k += kThreads)
      idx[k] = k == 0 ? first : key_index(__ldcg(&keys[k]));
}

// The launch shape for n pixels: one block of seed_threads(d) per SM
// (fewer when n is small), `len` pixels per block, `smem_px` of them in
// shared memory.
struct SeedPlan {
  int grid, per_sm, threads, len, smem_px, str_px;
  size_t smem;
};

template <typename T, int kD>
cudaError_t plan_seeds(int n, SeedPlan* p) {
  constexpr int kThreads = seed_threads(kD);
  constexpr size_t kFixedBytes = fixed_bytes(kD);
  int dev, sms, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return err;
  p->threads = kThreads;
  p->grid = std::max(1, std::min(sms, (n + kThreads - 1) / kThreads));
  p->len = (n + p->grid - 1) / p->grid;
  const int rest = std::max(0, p->len - kThreads);
  const size_t base = kFixedBytes + align16(sizeof(float) * rest);
  // min_dist of the pixels past the register ones must fit on chip
  if (base > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  p->smem_px =
      std::min(rest, static_cast<int>((optin - base) / (kD * sizeof(T))));
  p->str_px = rest - p->smem_px;
  // the start-up transpose stages kTile pixels in the shared-memory slice
  if (p->str_px > 0 && p->smem_px * kD < kTile * (kD + 1))
    return cudaErrorInvalidValue;
  p->smem = base + sizeof(T) * kD * p->smem_px;
  return uoc::blocks_per_sm<select_seeds_kernel<T, kD>>(
      dev, kThreads, p->smem, optin, &p->per_sm);
}

template <typename T>
cudaError_t plan_width(int n, int d, SeedPlan* p) {
  if (d == 64) return plan_seeds<T, 64>(n, p);
  if (d == 128) return plan_seeds<T, 128>(n, p);
  return cudaErrorInvalidValue;
}

cudaError_t plan_for(int dtype, int n, int d, SeedPlan* p) {
  return dtype == uoc::kF32 ? plan_width<float>(n, d, p)
                            : plan_width<__nv_bfloat16>(n, d, p);
}

template <typename T, int kD>
cudaError_t launch_seeds(const SeedPlan& p, const void* x, long long ld,
                         int n, int num_seeds, int first,
                         unsigned long long* keys, unsigned* arrived,
                         int* idx, void* xs_t, cudaStream_t s) {
  return uoc::launch_cooperative(
      select_seeds_kernel<T, kD>, p.grid, p.threads, p.smem, s,
      static_cast<const T*>(x), ld, n, p.len, p.smem_px, p.str_px, num_seeds,
      first, keys, arrived, idx, static_cast<T*>(xs_t));
}

}  // namespace

// The launch configuration uoc_select_seeds uses for n pixels of width d
// (64 or 128; any other width returns cudaErrorInvalidValue): out = [grid,
// blocks per SM, threads per block, dynamic shared bytes, bytes of X held
// on chip by the fullest block, pixels per block, pixels per block re-read
// every step].
extern "C" int uoc_select_seeds_plan(int dtype, int n, int d,
                                     long long* out) {
  SeedPlan p;
  const cudaError_t err = plan_for(dtype, n, d, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int esize = dtype == uoc::kF32 ? 4 : 2;
  out[0] = p.grid;
  out[1] = p.per_sm;
  out[2] = p.threads;
  out[3] = static_cast<long long>(p.smem);
  out[4] = static_cast<long long>(std::min(p.len, p.threads)) * d * 4 +
           static_cast<long long>(p.smem_px) * d * esize;
  out[5] = p.len;
  out[6] = p.str_px;
  return 0;
}

// x: [n, d] rows (d = 64 or 128; float32 or bfloat16, unit stride along a
// row) ld elements apart; keys: [num_seeds + 1] uint64 scratch (the argmax
// keys, then the grid barrier's counter), zero-filled here; idx:
// [num_seeds] int32 out; xs_t: scratch of d * grid * (re-read pixels per
// block) elements of x's type, from uoc_select_seeds_plan.  One
// cooperative launch on `stream`.  Returns the first CUDA error (0 on
// success); a grid that cannot be resident at once is refused by the
// launch.
extern "C" int uoc_select_seeds(const void* x, int dtype, int n, int d,
                                long long ld, int num_seeds, int first,
                                unsigned long long* keys, int* idx,
                                void* xs_t, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SeedPlan p;
  cudaError_t err = plan_for(dtype, n, d, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  unsigned* arrived = reinterpret_cast<unsigned*>(keys + num_seeds);
  err = cudaMemsetAsync(keys, 0, sizeof(*keys) * (num_seeds + 1), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool f32 = dtype == uoc::kF32;
  if (d == 64)
    err = f32 ? launch_seeds<float, 64>(p, x, ld, n, num_seeds, first, keys,
                                        arrived, idx, xs_t, s)
              : launch_seeds<__nv_bfloat16, 64>(p, x, ld, n, num_seeds,
                                                first, keys, arrived, idx,
                                                xs_t, s);
  else
    err = f32 ? launch_seeds<float, 128>(p, x, ld, n, num_seeds, first,
                                         keys, arrived, idx, xs_t, s)
              : launch_seeds<__nv_bfloat16, 128>(p, x, ld, n, num_seeds,
                                                 first, keys, arrived, idx,
                                                 xs_t, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* uoc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
