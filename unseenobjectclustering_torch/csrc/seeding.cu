// Farthest-point seed selection (cosine metric) for the vMF mean shift.
//
// Replaces the TPU kernel _seeding_kernel / select_seeds_pallas
// (unseenobjectclustering_tpu/ops/pallas_seeding.py), which kept X resident
// in VMEM and ran the whole m-step loop in one kernel, and, at d = 128
// where X is re-read, the JAX package's select_smart_seeds_lazy
// (unseenobjectclustering_tpu/ops/mean_shift.py), its route for an X that
// does not fit on chip.
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
// warp read neighbouring words), and only the rest ("off-chip") is read
// from the [d, *] scratch xs_t in device memory, into which each block
// transposes them at start-up so that the reads coalesce (X arrives as
// rows; a strided view such as x[::8] is read in place).  min_dist never
// leaves the chip (a register, or shared memory).  Each dot is the same
// sequential fp32 FMA chain over j = 0..d-1 as the plain version's
// reference arithmetic (bf16 widens exactly; no tensor cores, so no TF32
// truncation).  The argmax packs (order-preserving float bits, ~index)
// into one 64-bit key: a warp/block max, then one atomicMax per block into
// keys[s + 1] before the barrier; every block reads the winner after it.
//
// The width d is a template parameter, 64, 128 (2 * NUM_UNITS under the
// cat fusion) or 256 (the cat fusion of two 128-unit heads).  At d = 64 a
// block has 512 threads (128 registers each at most).  At d = 128 a
// pixel's values take 128 registers, so a block has 256 threads (255
// registers each at most) and holds 256 pixels in registers: the register
// file holds the same 128 KB of X per SM either way, and the sequential
// chain per pixel stays one thread's.  At d = 256 a pixel's values would
// take 256 registers, past the 255 a thread may have, so no pixel is held
// in registers: a block of 256 threads keeps as many pixels as fit in
// shared memory (about 215 in float32) and reads the rest, eager, from the
// transposed scratch at every step (the lazy tiles' per-warp staging would
// take 256 KB there).  Each dot stays one thread's sequential chain over
// j = 0..255.
//
// Off-chip pixels, eager (kLazy false: d = 64, and d = 128 past the lazy
// path's limit): every step reads all of them again.  At d = 64's parity
// frame that is about 938 pixels a block, 32 MB a step from L2.  At d =
// 128's it would be about 1,640 of a block's 2,328 pixels, 110 MB a step
// from HBM.
//
// Off-chip pixels, lazy (kLazy true: d = 128 with off-chip pixels where
// the lazy state fits, plan_width; the design of select_smart_seeds_lazy,
// per block).  They are stored tile by tile (kLazyTile = 32 consecutive
// pixels, a warp's), and each tile keeps on chip a stale bound, the key pack_key(max
// min_dist, lowest index in the tile) at its last refresh, and the count
// of seeds applied then.  min_dist only shrinks, so no key of a tile
// exceeds its bound.  Each step, after the on-chip pixels, the block takes
// a threshold no larger than the step's global best: the best of
// its on-chip keys and of the previous step's block bests brought up to
// this step (every block stores its best key; each block copies those
// pixels' rows, one bulk copy each, and applies the new seed to them in
// the same FMA chain, so each is the true min_dist of a pixel).  A tile
// whose bound is below the threshold cannot hold the argmax and is
// skipped; every other tile, and every tile that has missed kRing seeds
// (the block keeps the kRing newest seeds on chip), is refreshed by one
// warp: one bulk copy brings its X into the warp's staging tile, every
// seed it missed is applied in seed order, kCatchUp a pass, each with the
// same FMA chain, and its bound and count are renewed.  fminf is exact and
// order-free, so every min_dist read has the eager kernel's bits (the
// picks are the eager kernel's), and the bound's lowest index keeps ties
// on the lowest index.  refreshed[s] counts the tiles refreshed at step s
// (every tile at step 0).  ops/cuda_seeding.py select_seeds_lazy_reference
// models this schedule in torch.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kTile = 64;      // pixels per step of the start-up transpose
constexpr int kLazyTile = 32;  // off-chip pixels per lazy tile: a warp's
constexpr int kRing = 64;      // the lazy path's newest seeds kept on chip
constexpr int kCatchUp = 8;    // seeds a lazy refresh applies per pass
// bytes between the staged rows of the previous step's block bests (16
// past a row: the threads, a row each, read 16 bytes without conflicts)
template <typename T, int kD>
constexpr int kCandPitch = kD * sizeof(T) + 16;

// Threads per block at width d, and the bytes before min_dist in shared
// memory: the newest seed (on the lazy path the kRing newest), the warps'
// best keys, on the lazy path also the warps' threshold keys, the length
// of the refresh list, the candidate rows' mbarrier and one per warp.
__host__ __device__ constexpr int seed_threads(int d) {
  return d == 64 ? 512 : 256;
}
// Pixels a block holds in registers, one a thread: none at d = 256.
__host__ __device__ constexpr int reg_pixels(int d) {
  return d <= 128 ? seed_threads(d) : 0;
}
__host__ __device__ constexpr size_t fixed_bytes(int d, bool lazy) {
  return (lazy ? kRing : 1) * d * sizeof(float) +
         (seed_threads(d) / 32) * sizeof(uint64_t) +
         (lazy ? 2 * (seed_threads(d) / 32) * sizeof(uint64_t) + 16 : 0);
}

__host__ __device__ __forceinline__ size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

// Lazy tiles for `rest` off-chip pixels, and the shared memory of the lazy
// path past min_dist: per tile its bound (uint64), the seeds applied to it
// and a slot of the refresh list (int32 each); then one staged tile of X
// per warp ([d][kLazyTile] each), which at the start of a step hold the
// rows of the previous step's block bests.
__host__ __device__ constexpr int lazy_tiles(int rest) {
  return (rest + kLazyTile - 1) / kLazyTile;
}
template <typename T, int kD, bool kLazy>
__host__ __device__ __forceinline__ size_t lazy_bytes(int rest) {
  return kLazy ? align16(static_cast<size_t>(lazy_tiles(rest)) * 16) +
                     (seed_threads(kD) / 32) * kLazyTile * kD * sizeof(T)
               : 0;
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

// A study build (-DSEED_CLOCKS, seeding_study.py) records, for each block
// and lazy step, its clock at the step's start, after the staging of the
// previous block bests, after the refresh list, after the refreshes and
// before the grid barrier, and the length of its refresh list.
#ifdef SEED_CLOCKS
constexpr int kClockBlocks = 160, kClockSteps = 128, kMarks = 6;
__device__ long long seed_clocks[kClockBlocks][kClockSteps][kMarks];
__device__ __forceinline__ void mark(int step, int at, long long value) {
  if (threadIdx.x == 0 && blockIdx.x < kClockBlocks && step < kClockSteps)
    seed_clocks[blockIdx.x][step][at] = value;
}
#else
__device__ __forceinline__ void mark(int, int, long long) {}
#endif

// Element u of 16 bytes of x's type, widened to fp32 (exactly).
template <typename T>
__device__ __forceinline__ float widen(const uint4& r, int u);
template <>
__device__ __forceinline__ float widen<float>(const uint4& r, int u) {
  return __uint_as_float(u == 0 ? r.x : u == 1 ? r.y : u == 2 ? r.z : r.w);
}
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(const uint4& r, int u) {
  const unsigned w = u < 2 ? r.x : u < 4 ? r.y : u < 6 ? r.z : r.w;
  return __uint_as_float(u % 2 ? w & 0xFFFF0000u : w << 16);
}

// The value a key packs (ordered_bits inverted).
__device__ __forceinline__ float key_value(unsigned long long key) {
  const unsigned int u = static_cast<unsigned int>(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
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

// The warp's max in every lane.
__device__ __forceinline__ unsigned long long warp_max_all(
    unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// Lazy path: one warp brings tile t up to date.  xt: its X, staged
// ([kD][kLazyTile]); the seeds applied[t] .. step are in the ring (slot
// k % kRing), applied in seed order, kCatchUp a pass (the newest repeated
// to fill the last pass: fminf is idempotent).  Renews the tile's bound
// and count; returns its best key.
template <typename T, int kD>
__device__ __forceinline__ unsigned long long refresh_tile(
    const T* xt, const float* ring, float* smd, unsigned long long* bound,
    int* applied, int t, int q, bool live, int lo, int step) {
  const int lane = threadIdx.x & 31;
  const int from = applied[t];
  // NaN before any seed: fminf(NaN, d) = d, as the eager step 0
  float md = from == 0 || !live ? __uint_as_float(0x7FC00000u) : smd[q];
  for (int k = from; k <= step; k += kCatchUp) {
    const float4* w4[kCatchUp];
    float acc[kCatchUp];
#pragma unroll
    for (int g = 0; g < kCatchUp; ++g) {
      w4[g] = reinterpret_cast<const float4*>(
          ring + (min(k + g, step) % kRing) * kD);
      acc[g] = 0.0f;
    }
#pragma unroll 8
    for (int j4 = 0; j4 < kD / 4; ++j4) {
      const float x0 = uoc::to_f32(xt[(4 * j4) * kLazyTile + lane]);
      const float x1 = uoc::to_f32(xt[(4 * j4 + 1) * kLazyTile + lane]);
      const float x2 = uoc::to_f32(xt[(4 * j4 + 2) * kLazyTile + lane]);
      const float x3 = uoc::to_f32(xt[(4 * j4 + 3) * kLazyTile + lane]);
#pragma unroll
      for (int g = 0; g < kCatchUp; ++g) {
        const float4 w = w4[g][j4];
        acc[g] = fmaf(x0, w.x, acc[g]);
        acc[g] = fmaf(x1, w.y, acc[g]);
        acc[g] = fmaf(x2, w.z, acc[g]);
        acc[g] = fmaf(x3, w.w, acc[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < kCatchUp; ++g)
      md = fminf(md, 0.5f * (1.0f - acc[g]));
  }
  unsigned long long key = 0;
  if (live) {
    smd[q] = md;
    key = pack_key(md, lo + lane);
  }
  key = warp_max_all(key);
  if (lane == 0) {
    bound[t] = (key & 0xFFFFFFFF00000000ull) |
               (0xFFFFFFFFull - static_cast<unsigned int>(lo));
    applied[t] = step + 1;
  }
  return key;
}

template <typename T, int kD, bool kLazy>
__global__ void __launch_bounds__(seed_threads(kD), 1)
select_seeds_kernel(const T* __restrict__ x, long long ld, int n, int len,
                    int smem_px, int str_px, int num_seeds, int first,
                    unsigned long long* __restrict__ keys,
                    unsigned* __restrict__ arrived, int* __restrict__ idx,
                    T* __restrict__ xs_t, int* __restrict__ refreshed,
                    unsigned long long* __restrict__ block_best) {
  constexpr int kThreads = seed_threads(kD);
  constexpr int kRegPx = reg_pixels(kD);
  constexpr int kWarps = kThreads / 32;
  constexpr size_t kFixedBytes = fixed_bytes(kD, kLazy);
  constexpr int kTileElems = kLazyTile * kD;
  extern __shared__ __align__(16) unsigned char smem[];
  // [kD] newest seed, fp32 (lazy path: [kRing][kD], seed k in slot
  // k % kRing)
  float* ring = reinterpret_cast<float*>(smem);
  constexpr int kRingSlots = kLazy ? kRing : 1;
  unsigned long long* warp_best = reinterpret_cast<unsigned long long*>(
      smem + kRingSlots * kD * sizeof(float));
  float* smd = reinterpret_cast<float*>(smem + kFixedBytes);  // min_dist
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * len;
  const int count = max(0, min(n - p0, len));
  const int reg_px = min(kRegPx, count);
  const int rest = count - reg_px;  // pixels past the register ones
  const int s_px = min(smem_px, rest);
  const int rest_max = max(0, len - kRegPx);
  const size_t md_bytes = align16(sizeof(float) * rest_max);
  // [kD][smem_px] X values of pixels p0 + reg_px + [0, s_px)
  T* sx = reinterpret_cast<T*>(smem + kFixedBytes + md_bytes +
                               lazy_bytes<T, kD, kLazy>(rest_max));
  // the off-chip pixels, past those, in device memory: eager [kD][gridDim.x
  // * str_px], this block's str_px columns from column c0; lazy, tile by
  // tile, [gridDim.x * tiles_max][kD][kLazyTile]
  const size_t spitch = static_cast<size_t>(gridDim.x) * str_px;
  const size_t c0 = static_cast<size_t>(blockIdx.x) * str_px;
  const int tiles_max = lazy_tiles(str_px);
  auto row = [&](int p) { return x + static_cast<size_t>(p) * ld; };
  auto xs_index = [&](int o, int j) {  // off-chip pixel o, element j
    return kLazy ? ((static_cast<size_t>(blockIdx.x) * tiles_max +
                     o / kLazyTile) * kD + j) * kLazyTile + o % kLazyTile
                 : j * spitch + c0 + o;
  };
  // lazy path: the warps' threshold keys, the refresh list's length, the
  // warps' mbarriers, per tile its bound, the seeds applied to it and a
  // list slot, and one staged tile per warp
  unsigned long long* on_best = warp_best + kWarps;
  int* listed = reinterpret_cast<int*>(on_best + kWarps);
  // the candidate rows' mbarrier, beside the list's length
  unsigned long long* cand_bar = on_best + kWarps + 1;
  unsigned long long* bars = on_best + kWarps + 2;  // one per warp
  unsigned long long* bound =
      reinterpret_cast<unsigned long long*>(smem + kFixedBytes + md_bytes);
  int* applied = reinterpret_cast<int*>(bound + lazy_tiles(rest_max));
  int* list = applied + lazy_tiles(rest_max);
  T* stage = reinterpret_cast<T*>(
      smem + kFixedBytes + md_bytes +
      align16(static_cast<size_t>(lazy_tiles(rest_max)) * 16));
  const int tiles = lazy_tiles(max(0, rest - s_px));  // this block's
  // lazy path, at the start of a step: the X of the previous step's block
  // bests, a row each, kCandPitch bytes apart, in the staging tiles
  unsigned char* cand_rows = reinterpret_cast<unsigned char*>(stage);
  const bool rows16 = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      ld * sizeof(T) % 16 == 0;
  unsigned parity = 0, cand_parity = 0;  // of the mbarriers

  // transpose the off-chip pixels through shared memory (the staging
  // tiles, or sx, are free yet)
  T* tile = kLazy ? stage : sx;  // [kTile][kD + 1]
  for (int q0 = s_px; q0 < rest; q0 += kTile) {
    const int cnt = min(kTile, rest - q0);
    for (int e = tid; e < cnt * kD; e += kThreads)
      tile[(e / kD) * (kD + 1) + e % kD] = row(p0 + reg_px + q0 + e / kD)[e % kD];
    __syncthreads();
    for (int e = tid; e < cnt * kD; e += kThreads) {
      const int j = e / cnt, q = e % cnt;
      xs_t[xs_index(q0 - s_px + q, j)] = tile[q * (kD + 1) + j];
    }
    __syncthreads();
  }
  float xr[kRegPx > 0 ? kD : 1];
  if constexpr (kRegPx > 0) {
    if (tid < reg_px) {
#pragma unroll
      for (int j = 0; j < kD; ++j) xr[j] = uoc::to_f32(row(p0 + tid)[j]);
    }
  }
#pragma unroll 8
  for (int e = tid; e < s_px * kD; e += kThreads)
    sx[(e % kD) * smem_px + e / kD] = row(p0 + reg_px + e / kD)[e % kD];
  if constexpr (kLazy) {
    // every tile is refreshed at step 0, with no seed applied before
    for (int t = tid; t < tiles; t += kThreads) {
      bound[t] = ~0ull;
      applied[t] = 0;
    }
    if (tid == 0) {
      *listed = 0;
      for (int w = 0; w < kWarps; ++w) uoc::mbar_init(bars + w, 1);
      uoc::mbar_init(cand_bar, gridDim.x);
    }
    // the transpose wrote the staging tiles, which bulk copies write next
    uoc::fence_proxy_async();
  }
  __syncthreads();
  float md_r = 0.0f;

  for (int step = 0; step + 1 < num_seeds; ++step) {
    if (kLazy) mark(step, 0, clock64());
    // lazy path: thread c < grid reads block c's best key of the previous
    // step (0 for a block without pixels) and brings its pixel's X into
    // row c of cand_rows (one bulk copy), while the seed is read
    unsigned long long cand_key = 0;
    if (kLazy && step > 0 && tid < gridDim.x) {
      cand_key = __ldcg(&block_best[((step - 1) & 1) * gridDim.x + tid]);
      unsigned char* dst = cand_rows + tid * kCandPitch<T, kD>;
      if (cand_key == 0ull) {
        uoc::mbar_arrive(cand_bar);
      } else if (rows16) {
        uoc::mbar_expect(cand_bar, kD * sizeof(T));
        uoc::bulk_copy(dst, row(key_index(cand_key)), kD * sizeof(T),
                       cand_bar);
      } else {
        const T* src = row(key_index(cand_key));
        for (int j = 0; j < kD; ++j) reinterpret_cast<T*>(dst)[j] = src[j];
        // the staging tiles take bulk copies later this step
        uoc::fence_proxy_async();
        uoc::mbar_arrive(cand_bar);
      }
    }
    const int sel = step == 0 ? first : key_index(__ldcg(&keys[step]));
    float* v = ring + (step % kRingSlots) * kD;
    const float4* v4 = reinterpret_cast<const float4*>(v);
    if (tid < kD) v[tid] = uoc::to_f32(row(sel)[tid]);
    __syncthreads();
    if (kLazy && step > 0) {
      if (tid < gridDim.x) uoc::mbar_wait(cand_bar, cand_parity);
      cand_parity ^= 1u;
    }
    if (kLazy) mark(step, 1, clock64());

    unsigned long long best = 0;
    if (kRegPx > 0 && tid < reg_px) {
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
    if constexpr (!kLazy) {
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
    } else {
      const int warp = tid >> 5;
      // the threshold, a key no larger than the step's global best: the
      // best of this block's on-chip keys and of the previous step's block
      // bests brought up to this step (each the true min_dist of its pixel,
      // in the same FMA chain as its own block's)
      unsigned long long cand_now = 0;
      if (cand_key != 0ull) {
        constexpr int kPer = 16 / sizeof(T);
        const unsigned char* r = cand_rows + tid * kCandPitch<T, kD>;
        float acc = 0.0f;
#pragma unroll 4
        for (int o = 0; o < kD / kPer; ++o) {
          const uint4 raw = *reinterpret_cast<const uint4*>(r + 16 * o);
#pragma unroll
          for (int u = 0; u < kPer; ++u)
            acc = fmaf(widen<T>(raw, u), v[o * kPer + u], acc);
        }
        cand_now = pack_key(fminf(key_value(cand_key), 0.5f * (1.0f - acc)),
                            key_index(cand_key));
      }
      cand_now = warp_max(cand_now > best ? cand_now : best);
      if ((tid & 31) == 0) on_best[warp] = cand_now;
      __syncthreads();
      unsigned long long thresh = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        thresh = on_best[w] > thresh ? on_best[w] : thresh;
      // list the tiles whose bound is not below it, and those that have
      // missed kRing seeds (the oldest leaves the ring at the next step)
      for (int t = tid; t < tiles; t += kThreads)
        if (bound[t] >= thresh || step + 1 - applied[t] >= kRing)
          list[atomicAdd(listed, 1)] = t;
      __syncthreads();
      // each warp takes the list's entries warp, warp + kWarps, ...: one
      // bulk copy brings the tile's X into the warp's staging tile
      const int to_refresh = *listed;
      mark(step, 2, clock64());
      mark(step, 5, to_refresh);
      T* mine = stage + warp * kTileElems;
      for (int l = warp; l < to_refresh; l += kWarps) {
        const int t = list[l];
        if ((tid & 31) == 0) {
          uoc::mbar_expect(bars + warp, kTileElems * sizeof(T));
          uoc::bulk_copy(mine,
                         xs_t + (static_cast<size_t>(blockIdx.x) * tiles_max +
                                 t) * kTileElems,
                         kTileElems * sizeof(T), bars + warp);
        }
        uoc::mbar_wait(bars + warp, parity);
        parity ^= 1u;
        const int q = s_px + t * kLazyTile + (tid & 31);
        const unsigned long long key = refresh_tile<T, kD>(
            mine, ring, smd, bound, applied, t, q, q < rest,
            p0 + reg_px + s_px + t * kLazyTile, step);
        best = key > best ? key : best;
        __syncwarp();  // the warp is done with `mine` before its next copy
      }
    }

    best = warp_max(best);
    if ((tid & 31) == 0) warp_best[tid >> 5] = best;
    __syncthreads();
    if (kLazy) mark(step, 3, clock64());
    if (tid < 32) {
      best = tid < kWarps ? warp_best[tid] : 0ull;
      best = warp_max(best);
      if (tid == 0 && best != 0ull) atomicMax(&keys[step + 1], best);
      if constexpr (kLazy) {
        if (tid == 0) {
          block_best[(step & 1) * gridDim.x + blockIdx.x] = best;
          atomicAdd(&refreshed[step], *listed);
          *listed = 0;
          mark(step, 4, clock64());
        }
      }
    }
    uoc::grid_barrier(arrived, step + 1);
  }

  if (blockIdx.x == 0)
    for (int k = tid; k < num_seeds; k += kThreads)
      idx[k] = k == 0 ? first : key_index(__ldcg(&keys[k]));
}

// The launch shape for n pixels: one block of seed_threads(d) per SM
// (fewer when n is small), `len` pixels per block, `smem_px` of them in
// shared memory, `str_px` off-chip; `lazy`: the off-chip pixels in lazy
// tiles.
struct SeedPlan {
  int grid, per_sm, threads, reg_px, len, smem_px, str_px, optin;
  bool lazy;
  size_t smem;
};

// Shared bytes a block needs before any X: the fixed part, min_dist of
// the `rest` pixels past the register ones and, lazy, their tiles' state
// and the staging tiles.
template <typename T, int kD, bool kLazy>
size_t base_bytes(int rest) {
  return fixed_bytes(kD, kLazy) + align16(sizeof(float) * rest) +
         lazy_bytes<T, kD, kLazy>(rest);
}

template <typename T, int kD, bool kLazy>
cudaError_t plan_seeds(int n, SeedPlan* p) {
  constexpr int kThreads = seed_threads(kD);
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
  p->reg_px = reg_pixels(kD);
  p->optin = optin;
  p->lazy = kLazy;
  p->grid = std::max(1, std::min(sms, (n + kThreads - 1) / kThreads));
  p->len = (n + p->grid - 1) / p->grid;
  const int rest = std::max(0, p->len - p->reg_px);
  const size_t base = base_bytes<T, kD, kLazy>(rest);
  // min_dist of the pixels past the register ones must fit on chip
  if (base > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  p->smem_px =
      std::min(rest, static_cast<int>((optin - base) / (kD * sizeof(T))));
  p->str_px = rest - p->smem_px;
  // the eager start-up transpose stages kTile pixels in the shared-memory
  // slice (the lazy one in the staging tiles)
  if (!kLazy && p->str_px > 0 && p->smem_px * kD < kTile * (kD + 1))
    return cudaErrorInvalidValue;
  // the lazy start of a step stages a row per block, a thread each
  if (kLazy && (p->grid > kThreads ||
                static_cast<size_t>(kCandPitch<T, kD>) * p->grid >
                    (seed_threads(kD) / 32) * kLazyTile * kD * sizeof(T)))
    return cudaErrorInvalidValue;
  p->smem = base + sizeof(T) * kD * p->smem_px;
  return uoc::blocks_per_sm<select_seeds_kernel<T, kD, kLazy>>(
      dev, kThreads, p->smem, optin, &p->per_sm);
}

// d = 64, and d = 128 without off-chip pixels: the eager kernel; d = 128
// with off-chip pixels: the lazy one where its tiles' state and staging
// tiles fit beside min_dist (a block of up to about 15,400 pixels in
// float32, 30,000 in bfloat16: n up to about 2.0M and 4.0M on 132 SMs),
// the eager one past that.  d = 256: the eager kernel, no register pixels
// (min_dist of a block's pixels must fit: about 55,000 a block).
template <typename T>
cudaError_t plan_width(int n, int d, SeedPlan* p) {
  if (d == 64) return plan_seeds<T, 64, false>(n, p);
  if (d == 256) return plan_seeds<T, 256, false>(n, p);
  if (d != 128) return cudaErrorInvalidValue;
  const cudaError_t err = plan_seeds<T, 128, false>(n, p);
  if (err != cudaSuccess || p->str_px == 0 ||
      base_bytes<T, 128, true>(p->len - p->threads) >
          static_cast<size_t>(p->optin))
    return err;
  return plan_seeds<T, 128, true>(n, p);
}

cudaError_t plan_for(int dtype, int n, int d, SeedPlan* p) {
  return dtype == uoc::kF32 ? plan_width<float>(n, d, p)
                            : plan_width<__nv_bfloat16>(n, d, p);
}

template <typename T, int kD, bool kLazy>
cudaError_t launch_seeds(const SeedPlan& p, const void* x, long long ld,
                         int n, int num_seeds, int first,
                         unsigned long long* keys, unsigned* arrived,
                         int* idx, void* xs_t, int* refreshed,
                         unsigned long long* block_best, cudaStream_t s) {
  return uoc::launch_cooperative(
      select_seeds_kernel<T, kD, kLazy>, p.grid, p.threads, p.smem, s,
      static_cast<const T*>(x), ld, n, p.len, p.smem_px, p.str_px, num_seeds,
      first, keys, arrived, idx, static_cast<T*>(xs_t), refreshed,
      block_best);
}

template <typename T>
cudaError_t launch_typed(const SeedPlan& p, int d, const void* x,
                         long long ld, int n, int num_seeds, int first,
                         unsigned long long* keys, unsigned* arrived,
                         int* idx, void* xs_t, int* refreshed,
                         unsigned long long* block_best, cudaStream_t s) {
  if (d == 64)
    return launch_seeds<T, 64, false>(p, x, ld, n, num_seeds, first, keys,
                                      arrived, idx, xs_t, nullptr, nullptr,
                                      s);
  if (d == 256)
    return launch_seeds<T, 256, false>(p, x, ld, n, num_seeds, first, keys,
                                       arrived, idx, xs_t, nullptr, nullptr,
                                       s);
  if (p.lazy)
    return launch_seeds<T, 128, true>(p, x, ld, n, num_seeds, first, keys,
                                      arrived, idx, xs_t, refreshed,
                                      block_best, s);
  return launch_seeds<T, 128, false>(p, x, ld, n, num_seeds, first, keys,
                                     arrived, idx, xs_t, nullptr, nullptr, s);
}

}  // namespace

// The launch configuration uoc_select_seeds uses for n pixels of width d
// (64, 128 or 256; any other width returns cudaErrorInvalidValue): out = [grid,
// blocks per SM, threads per block, dynamic shared bytes, bytes of X held
// on chip by the fullest block, pixels per block, off-chip pixels per
// block, 1 on the lazy path (else 0), pixels per lazy tile (0 off it),
// elements of the off-chip scratch xs_t].
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
  out[4] = static_cast<long long>(std::min(p.len, p.reg_px)) * d * 4 +
           static_cast<long long>(p.smem_px) * d * esize;
  out[5] = p.len;
  out[6] = p.str_px;
  out[7] = p.lazy;
  out[8] = p.lazy ? kLazyTile : 0;
  out[9] = static_cast<long long>(d) * p.grid *
           (p.lazy ? lazy_tiles(p.str_px) * kLazyTile : p.str_px);
  return 0;
}

// x: [n, d] rows (d = 64, 128 or 256; float32 or bfloat16, unit stride along a
// row) ld elements apart; keys: scratch of num_seeds + 1 + num_seeds / 2 +
// 2 * grid uint64 (the argmax keys, the grid barrier's counter, then on
// the lazy path the int32 count of tiles refreshed at each of the
// num_seeds - 1 steps, zero-filled here, and each block's best key at the
// last two steps); idx: [num_seeds] int32 out; xs_t: scratch of
// x's type, as many elements as uoc_select_seeds_plan gives.  One
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
  int* refreshed = reinterpret_cast<int*>(keys + num_seeds + 1);
  unsigned long long* block_best = keys + num_seeds + 1 + num_seeds / 2;
  const size_t zeroed = sizeof(*keys) * (num_seeds + 1) +
                        (p.lazy ? sizeof(int) * (num_seeds - 1) : 0);
  err = cudaMemsetAsync(keys, 0, zeroed, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = dtype == uoc::kF32
            ? launch_typed<float>(p, d, x, ld, n, num_seeds, first, keys,
                                  arrived, idx, xs_t, refreshed, block_best,
                                  s)
            : launch_typed<__nv_bfloat16>(p, d, x, ld, n, num_seeds, first,
                                          keys, arrived, idx, xs_t, refreshed,
                                          block_best, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

#ifdef SEED_CLOCKS
// The study build's clocks of the last lazy launch: [160][128][6] int64.
extern "C" int uoc_seed_clocks(long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, seed_clocks, sizeof(seed_clocks)));
}
#endif

extern "C" const char* uoc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
