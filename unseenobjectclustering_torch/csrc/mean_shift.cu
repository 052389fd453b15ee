// vMF mean-shift kernels on Hopper: hill climbing, connected components
// over the converged seeds, and the fused pixel assignment + histograms.
//
// Replace the TPU kernels in unseenobjectclustering_tpu/ops/pallas_mean_shift.py:
//   hill_tf32_kernel,
//   hill_bf16_kernel    <- _hill_climb_kernel / hill_climb_pallas
//   cc_kernel           <- _cc_kernel / connected_components_pallas
//   assign_tf32_kernel,
//   assign_bf16_kernel  <- _assign_kernel / assign_labels_pallas
//
// The kernels take the embedding width d = 64 (NUM_UNITS of every recipe)
// and m <= 128 seeds.  The hill climb and the assignment stream X through a
// cp.async ring of 128-pixel tiles and run their products on the tensor
// cores in both modes: float32 as split TF32 on wgmma (about fp32
// accuracy), bfloat16 on mma.sync (hill climb) or wgmma (assignment).  The
// assignment re-checks the few pixels whose best two labels are nearly tied
// with the exact fp32 FMA chain; see its section.
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxSeeds = 128;
constexpr int kD = 64;

// bf16 on the tensor cores (mma.sync m16n8k16, fp32 accumulators) for the
// bf16 hill climb: the products of bf16 values
// are exact and the sums fp32, in the tensor cores' order.  Warp w owns
// seed rows [16w, 16w + 16) and keeps their Z fragments in registers.  X
// tiles sit in shared memory as bf16 with a 144-byte row pitch, so every
// ldmatrix row hits its own banks; the global loads need 16-byte aligned
// rows of X.
constexpr int kMmaPitch = kD + 8;

using uoc::smem_addr;

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// A fragments of Z rows [r0, r0 + 16), one per k-chunk of 16.
__device__ __forceinline__ void load_seed_fragments(const __nv_bfloat16* zs,
                                                    int r0, int lane,
                                                    unsigned (&za)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(za[kk], &zs[(r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kMmaPitch +
                           16 * kk + (lane >> 4) * 8]);
}

// S (16 seeds x 64 pixels) = Z_rows X_tile^T as eight m16n8 accumulators.
__device__ __forceinline__ void mma_similarity(const unsigned (&za)[4][4],
                                               const __nv_bfloat16* xs,
                                               int lane, float (&s)[8][4]) {
  const int quad = lane >> 3;  // which 8x8 matrix this lane addresses
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) s[t][q] = 0.0f;
#pragma unroll
  for (int t = 0; t < 8; t += 2)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned b[4];
      ldmatrix_x4(b, &xs[(8 * t + (lane & 7) + (quad >> 1) * 8) * kMmaPitch +
                         16 * kk + (quad & 1) * 8]);
      mma_bf16(s[t], za[kk], b[0], b[1]);
      mma_bf16(s[t + 1], za[kk], b[2], b[3]);
    }
}

// ---------------------------------------------------------------------------
// Hill climbing: Z <- normalize_rows(exp(kappa * Z X^T) X), max_iters times.
//
// Replaces _hill_climb_kernel / hill_climb_pallas.  It is attention with
// m <= 128 queries and K = V = X: S = Z X^T, W = exp(kappa S) (no max
// subtraction: kappa = 20 stays finite in fp32, as in the reference),
// acc += W X.
//
// Bound on the H100: 4*m*n*d flops per iteration (78.6 GFLOP for 10
// iterations at m=100, n=307200, d=64) against one read of X per
// iteration; bound by the tensor cores in both modes.
//
// Design: one persistent cooperative launch runs every iteration, one
// block per SM.  Each block walks its share of 128-pixel X tiles (split-K
// over pixels) through a ring of tiles in shared memory, filled by
// cp.async so that the next tile loads while the warps compute; the ring
// runs on across iterations, so the first tiles of the next iteration load
// during the barriers.  No seed row past what the instruction shape forces
// is computed.  The [m, n] weights never leave registers: S comes out of
// the first product as accumulators, becomes W in place and is fed
// straight back as the A operand of W X_tile.  Each block writes one
// [m, 64] partial; after a grid-wide barrier, block b sums the partials of
// seed rows b, b + grid, ... in a fixed block order (the same result from
// run to run) and normalizes them; a second barrier publishes the new Z.
//
//  * float32 X: split TF32 ("3xTF32") on the tensor cores with wgmma
//    (hill_tf32_kernel).  Each operand a is big + small, big = tf32(a)
//    (round to nearest even), small = a - big rounded to tf32 (nearest,
//    split_tf32_rn), and each product is small*big + big*small + big*big
//    with fp32 accumulators.  The tensor cores add each wgmma step to the
//    accumulator after aligning every term to the largest and truncating
//    it toward zero two bits below the largest one's last (the rule whose
//    emulation in hill_climb_study.py reproduces this kernel): an error
//    that grows with the accumulator and the steps it takes, always of one
//    sign per term.  exp(kappa S) multiplies an error in S by kappa, and a
//    seed that rests on few pixels moves with every error in W X.  So each
//    product sums its 16 small steps (tiny terms) first and then its 8 big
//    steps in groups of kBigPerGroup, every group in a fresh accumulator,
//    and the CUDA cores add the groups (fp32, rounded to nearest):
//    grouped_sum keeps two accumulators, one on the tensor cores while the
//    other's sum is added.  On trained crop embeddings this keeps Z within
//    4e-6 of a float64 replay where the plain float32 version (cuBLAS)
//    strays up to 2.5e-5.  A warpgroup
//    owns 64 seed rows (ceil(m/64) warpgroups) and keeps Z's split A
//    fragments in registers.  The whole block splits each landed tile once
//    into big and small copies in the two K-major layouts that wgmma reads
//    from shared memory (8-row x 16-byte core matrices, no swizzle): X as
//    [pixel][dim] for S = Z X^T and as [dim][pixel] for W X.  The
//    accumulator columns (2t, 2t+1) of S are taken as the A operand's k
//    columns (t, t+4) of W X by storing the pixels of each group of 8 in
//    the order 0, 2, 4, 6, 1, 3, 5, 7 in the second layout: the sum over
//    pixels does not depend on their order.
//  * bfloat16 X: mma.sync m16n8k16 (hill_bf16_kernel), two halves of
//    ceil(m/16) warps, each half owning 64 pixels of a tile; Z is rounded
//    to bf16 for the first product and W before the second, as the TPU
//    kernel did.  The halves' sums are added in shared memory.
// ---------------------------------------------------------------------------
constexpr int kHillTile = 128;        // pixels per X tile
constexpr int kHalfTile = kHillTile / 2;
constexpr int kStages = 3;            // bf16 X tiles in flight per block
constexpr int kTf32Stages = 2;        // float32 X tiles in flight per block
constexpr int kBF16Threads = 2 * 32 * (kMaxSeeds / 16);
constexpr int kF32Pitch = kD + 4;     // floats per raw X row in the ring
constexpr int kRedFloats = 16 * kD;   // per-group sums of a reduced row
constexpr int kCore = 128;            // bytes of a core matrix (8 x 16 B)
constexpr int kHalfWords = kHalfTile * kD;  // one split copy of a half

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// X rows [p0, p0 + rows) -> xs [rows][kPitch], 16 bytes per copy, by
// threads tid, tid + threads, ...; rows past n are zero-filled.
template <typename T, int kPitch>
__device__ __forceinline__ void issue_rows(const T* __restrict__ x, int n,
                                           int p0, int rows, int tid,
                                           int threads, T* xs) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int kChunks = kD / kPer;
  for (int e = tid; e < rows * kChunks; e += threads) {
    const int p = e / kChunks, c = e % kChunks;
    const bool ok = p0 + p < n;
    cp_async16(xs + p * kPitch + c * kPer,
               ok ? x + static_cast<size_t>(p0 + p) * kD + c * kPer : x, ok);
  }
}

// The whole block: X rows [p0, p0 + kHillTile) -> xs [kHillTile][kPitch].
template <typename T, int kPitch>
__device__ __forceinline__ void issue_tile(const T* __restrict__ x, int n,
                                           int p0, T* xs) {
  issue_rows<T, kPitch>(x, n, p0, kHillTile, threadIdx.x, blockDim.x, xs);
}

// a = big + small: big = tf32(a) (the mantissa rounded to 10 bits,
// nearest even, by Veltkamp's split: four fp32 operations, none fused),
// small = a - big exactly, whose low 13 bits the tensor cores drop (a
// truncation of small: 2^-22 of a).  a is finite and below 4e34 here.
__device__ __forceinline__ void split_tf32(float a, unsigned& big,
                                           unsigned& small) {
  const float t = __fmul_rn(a, 8193.0f);  // 2^13 + 1
  const float hi = __fsub_rn(t, __fsub_rn(t, a));
  big = __float_as_uint(hi);
  small = __float_as_uint(__fsub_rn(a, hi));
}

// As split_tf32, with small rounded to tf32 (nearest, ties away) before
// the tensor cores read it: within 2^-23 of a and unbiased, where the
// truncation leaves up to 2^-22 toward zero.  The hill climb needs this;
// the assignment keeps split_tf32, whose error its exact re-check of
// near-tied pixels covers (see kRecheckMargin).
__device__ __forceinline__ void split_tf32_rn(float a, unsigned& big,
                                              unsigned& small) {
  split_tf32(a, big, small);
  asm("cvt.rna.tf32.f32 %0, %1;\n"
      : "=r"(small)
      : "f"(__uint_as_float(small)));
}

// d (64 x 64, fp32, the m64n64 accumulator layout) += a (64 x 8 tf32 from
// registers, the m16n8k8 A layout per warp) * b (8 x 64 tf32, K-major in
// shared memory, described by desc); with accumulate false, d = a * b.
// Asynchronous: see wgmma_commit and wgmma_wait.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const unsigned (&a)[4],
                                           uint64_t desc,
                                           bool accumulate = true) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(static_cast<int>(accumulate)));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most kPending of this warpgroup's committed wgmma groups
// are still running (0: all have finished).
template <int kPending = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// The compiler does not see that a wgmma reads and writes its registers
// after it issues: pinning them here, after wgmma_wait, keeps them from
// being read early or reused while the wgmma runs.
__device__ __forceinline__ void pin_registers(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ void pin_registers(unsigned& r) {
  asm volatile("" : "+r"(r)::"memory");
}

template <typename T, int N>
__device__ __forceinline__ void pin_registers(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin_registers(r[i]);
}

// A named barrier with an immediate id (0 is __syncthreads): waits until
// `threads` threads have arrived.
template <int kId>
__device__ __forceinline__ void bar_sync(int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kId), "r"(threads) : "memory");
}

// The descriptor of a K-major operand in shared memory without swizzle:
// core matrices lbo bytes apart along K and sbo bytes apart along M/N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, unsigned lbo,
                                              unsigned sbo) {
  return static_cast<uint64_t>((smem_addr(p) >> 4) & 0x3FFFu) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// The whole block: pixels [64h, 64h + 64) of the landed raw tile xs
// [kHillTile][kF32Pitch] -> big and small copies in the two layouts of
// `buf` (4 x kHalfWords words):
//   first  [dim / 4][pixel / 8] core matrices, row = pixel % 8;
//   second [pixel / 4][dim / 8] core matrices, row = dim % 8, pixels of
//          each group of 8 in the order 0, 2, 4, 6, 1, 3, 5, 7.
// The core matrices neighbouring along N (pixels, then dims) are adjacent.
// In each pass 8 neighbouring threads read and write 8 distinct 16-byte
// bank groups.
__device__ __forceinline__ void split_half(const float* xs, int h,
                                           unsigned* buf) {
  uint4* pb = reinterpret_cast<uint4*>(buf);     // [pixel][dim], big
  uint4* ps = pb + kHalfWords / 4;               // [pixel][dim], small
  uint4* qb = ps + kHalfWords / 4;               // [dim][pixel], big
  uint4* qs = qb + kHalfWords / 4;               // [dim][pixel], small
  xs += kHalfTile * h * kF32Pitch;
  for (int e = threadIdx.x; e < kHalfTile * kD / 4; e += blockDim.x) {
    const int r = e % 8, kq = (e / 8) % (kD / 4), c = e / (2 * kD);
    const float4 v =
        reinterpret_cast<const float4*>(xs + (8 * c + r) * kF32Pitch)[kq];
    uint4 b, s;
    split_tf32_rn(v.x, b.x, s.x);
    split_tf32_rn(v.y, b.y, s.y);
    split_tf32_rn(v.z, b.z, s.z);
    split_tf32_rn(v.w, b.w, s.w);
    const int o = (kq * (kHalfTile / 8) + c) * 8 + r;
    pb[o] = b;
    ps[o] = s;
  }
  for (int e = threadIdx.x; e < kHalfTile * kD / 4; e += blockDim.x) {
    const int n = e % kD, par = (e / kD) % 2, c = e / (2 * kD);
    const float* col = xs + (8 * c + par) * kF32Pitch + n;
    uint4 b, s;
    split_tf32_rn(col[0], b.x, s.x);
    split_tf32_rn(col[2 * kF32Pitch], b.y, s.y);
    split_tf32_rn(col[4 * kF32Pitch], b.z, s.z);
    split_tf32_rn(col[6 * kF32Pitch], b.w, s.w);
    const int o = ((2 * c + par) * (kD / 8) + n / 8) * 8 + n % 8;
    qb[o] = b;
    qs[o] = s;
  }
}

// One warp's state and per-tile work, bfloat16 X.
struct HillBF16 {
  unsigned za[4][4];  // A fragments of bf16(Z), per k-chunk of 16

  // Every thread of the block stages z into zs (bf16, as many rows as a
  // half has warps), then each warp loads its fragments; the caller's
  // barrier has freed zs.
  __device__ __forceinline__ void load_seeds(const float* z, int m, int r0,
                                             int lane, __nv_bfloat16* zs) {
    const int rows = blockDim.x / 4;  // 16 rows per warp of a half
    for (int e = threadIdx.x; e < rows * kD; e += blockDim.x) {
      const int s = e / kD, j = e % kD;
      zs[s * kMmaPitch + j] =
          __float2bfloat16_rn(s < m ? __ldcg(&z[s * kD + j]) : 0.0f);
    }
    __syncthreads();
    load_seed_fragments(zs, r0, lane, za);
  }

  __device__ __forceinline__ void tile(const __nv_bfloat16* xs, int half,
                                       int lane, float kappa,
                                       float (&acc)[8][4]) const {
    const int quad = lane >> 3;
    const __nv_bfloat16* xh = xs + half * kHalfTile * kMmaPitch;
    float s[8][4];
    mma_similarity(za, xh, lane, s);
    // W = bf16(exp(kappa S)), laid out as the A operand over pixel chunks
    // of 16 (the m16n8 accumulator layout is the m16k16 operand layout)
    unsigned wa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wa[kk][0] = pack_bf16(expf(kappa * s[2 * kk][0]),
                            expf(kappa * s[2 * kk][1]));
      wa[kk][1] = pack_bf16(expf(kappa * s[2 * kk][2]),
                            expf(kappa * s[2 * kk][3]));
      wa[kk][2] = pack_bf16(expf(kappa * s[2 * kk + 1][0]),
                            expf(kappa * s[2 * kk + 1][1]));
      wa[kk][3] = pack_bf16(expf(kappa * s[2 * kk + 1][2]),
                            expf(kappa * s[2 * kk + 1][3]));
    }
    // acc += W X_tile, X read transposed as [d][pixel]
#pragma unroll
    for (int t = 0; t < 8; t += 2)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned b[4];
        ldmatrix_x4_trans(
            b, &xh[(16 * kk + (lane & 7) + (quad & 1) * 8) * kMmaPitch +
                   8 * t + (quad >> 1) * 8]);
        mma_bf16(acc[t], wa[kk], b[0], b[1]);
        mma_bf16(acc[t + 1], wa[kk], b[2], b[3]);
      }
  }
};

// Seed row r of the next Z: the block sums partial[0..grid)[r] in block
// order, then z[r] = v / max(||v||, 1e-12).
__device__ __forceinline__ void reduce_row(const float* partial, int m, int r,
                                           float* red, float* z) {
  const int ng = max(1, static_cast<int>(blockDim.x) / kD);  // <= 16 groups
  for (int e = threadIdx.x; e < kD * ng; e += blockDim.x) {
    const int dim = e % kD, q = e / kD;
    float acc = 0.0f;
#pragma unroll 4
    for (int b = q; b < static_cast<int>(gridDim.x); b += ng)
      acc += __ldcg(&partial[(static_cast<size_t>(b) * m + r) * kD + dim]);
    red[q * kD + dim] = acc;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float v[2] = {0.0f, 0.0f}, ss = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      for (int q = 0; q < ng; ++q) v[h] += red[q * kD + lane + 32 * h];
      ss = fmaf(v[h], v[h], ss);
    }
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xFFFFFFFFu, ss, off);
    const float den = fmaxf(sqrtf(ss), 1e-12f);
    z[r * kD + lane] = v[0] / den;
    z[r * kD + lane + 32] = v[1] / den;
  }
  __syncthreads();  // red is free again
}

// acc (the m16n8 accumulators of eight 8-column tiles, rows [r0, r0 + 16))
// plus, when given, the same rows of `other` ([rows][64]) -> rows < m of
// `out` [m][64].
__device__ __forceinline__ void store_rows(const float (&acc)[8][4], int r0,
                                           int m, const float* other,
                                           float* out) {
  const int lane = threadIdx.x % 32;
  const int row = r0 + lane / 4, col = 2 * (lane % 4);
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = row + (q >> 1) * 8, c = 8 * t + col + (q & 1);
      if (r < m)
        out[r * kD + c] = acc[t][q] + (other ? other[r * kD + c] : 0.0f);
    }
}

// Every partial is written: sum them into the next Z (two grid barriers).
__device__ __forceinline__ void next_seeds(const float* partial, int m,
                                           float* red, float* z,
                                           unsigned* arrived,
                                           unsigned& barriers) {
  uoc::grid_barrier(arrived, ++barriers);  // every partial is written
  for (int r = blockIdx.x; r < m; r += gridDim.x)
    reduce_row(partial, m, r, red, z);
  uoc::grid_barrier(arrived, ++barriers);  // the new Z is written
}

// This block's tiles are blockIdx.x + k * gridDim.x, k < tiles_of_block();
// the q-th load of the launch (q = it * mine + k) goes to ring stage
// q % stages.
__device__ __forceinline__ int tiles_of_block(int n) {
  const int num_tiles = (n + kHillTile - 1) / kHillTile;
  return (num_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) /
         gridDim.x;
}

template <typename T, int kPitch, int kRing>
__device__ __forceinline__ void issue_load(const T* x, int n, int q, int mine,
                                           int total, T* ring) {
  if (q < total)
    issue_tile<T, kPitch>(
        x, n,
        (static_cast<int>(blockIdx.x) + (q % mine) * gridDim.x) * kHillTile,
        ring + (q % kRing) * kHillTile * kPitch);
  cp_async_commit();
}

// The float32 hill climb sums each product (S, and W X_h) in kGroups
// groups of wgmma steps, each group in a fresh accumulator: the first holds
// the small products and the first kBigPerGroup big ones, each later group
// the next kBigPerGroup big ones.  hill_climb_study.py builds the kernel
// with other values (-DHILL_BIG_PER_GROUP=1, 2, 4 or 8) to compare them.
#ifndef HILL_BIG_PER_GROUP
#define HILL_BIG_PER_GROUP 2
#endif
constexpr int kBigPerGroup = HILL_BIG_PER_GROUP;
constexpr int kGroups = 8 / kBigPerGroup;

// out (or out +, with kAdd) = the sum of the kGroups groups that issue(g, d)
// puts into d, added in group order on the CUDA cores.  Two accumulators
// take turns: group g runs on the tensor cores while group g - 1's sum is
// added.
template <bool kAdd, typename Issue>
__device__ __forceinline__ void grouped_sum(float (&out)[32],
                                            float (&t)[2][32], Issue issue) {
  wgmma_fence();
  issue(0, t[0]);
  wgmma_commit();
#pragma unroll
  for (int g = 1; g <= kGroups; ++g) {
    if (g < kGroups) {
      wgmma_fence();  // t[g & 1] was read by the CUDA cores
      issue(g, t[g & 1]);
      wgmma_commit();
      wgmma_wait<1>();  // group g - 1 has finished
    } else {
      wgmma_wait<0>();
    }
    float(&done)[32] = t[(g - 1) & 1];
    pin_registers(done);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      out[i] = (kAdd || g > 1) ? out[i] + done[i] : done[i];
  }
}

// x: [n, 64] rows 16-byte aligned; z: [m, 64] float32, holding Z0 on entry
// and the result on exit; partial: [gridDim.x, m, 64] scratch; arrived: a
// zeroed counter for the grid barriers.  blockDim.x = 128 * ceil(m / 64).
// Shared memory: the ring of raw tiles, the split copies of a tile's two
// halves, the reduction scratch.
__global__ void __launch_bounds__(256, 1)
hill_tf32_kernel(const float* __restrict__ x, int n, int m, float kappa,
                 int max_iters, float* __restrict__ partial,
                 unsigned* __restrict__ arrived, float* __restrict__ z) {
  constexpr int kRawElems = kHillTile * kF32Pitch;
  extern __shared__ __align__(128) float tf32_smem[];
  float* ring = tf32_smem;
  unsigned* split = reinterpret_cast<unsigned*>(ring + kTf32Stages * kRawElems);
  float* red = reinterpret_cast<float*>(split + 8 * kHalfWords);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;  // rows of this warp: warpgroup warp / 4
  const int mine = tiles_of_block(n);
  const int total = max_iters * mine;
  unsigned barriers = 0;

  issue_load<float, kF32Pitch, kTf32Stages>(x, n, 0, mine, total, ring);
  for (int it = 0; it < max_iters; ++it) {
    // split A fragments of Z rows [r0, r0 + 16), per k-chunk of 8
    unsigned zb[8][4], zs[8][4];
    {
      const int lo = r0 + g, hi = r0 + g + 8;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int c = 8 * kk + t;
        const float a[4] = {lo < m ? __ldcg(&z[lo * kD + c]) : 0.0f,
                            hi < m ? __ldcg(&z[hi * kD + c]) : 0.0f,
                            lo < m ? __ldcg(&z[lo * kD + c + 4]) : 0.0f,
                            hi < m ? __ldcg(&z[hi * kD + c + 4]) : 0.0f};
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32_rn(a[q], zb[kk][q], zs[kk][q]);
      }
    }
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

    for (int k = 0; k < mine; ++k) {
      const int q = it * mine + k;
      cp_async_wait<0>();  // load q has landed
      __syncthreads();     // ... for every thread; tile q-1 is done with
      issue_load<float, kF32Pitch, kTf32Stages>(x, n, q + 1, mine, total,
                                                ring);
      const float* xs = ring + (q % kTf32Stages) * kRawElems;
      split_half(xs, 0, split);
      split_half(xs, 1, split + 4 * kHalfWords);
      // the split copies are read by wgmma (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();

#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        const unsigned* pb = split + 4 * h * kHalfWords;  // [pixel][dim] big
        const unsigned* ps = pb + kHalfWords;          // [pixel][dim] small
        const unsigned* qb = pb + 2 * kHalfWords;      // [dim][pixel] big
        const unsigned* qs = pb + 3 * kHalfWords;      // [dim][pixel] small
        // S (64 seeds x 64 pixels) = Z X_h^T: K = dims, 8 per wgmma
        float s[32], pair[2][32];
        grouped_sum<false>(s, pair, [&](int grp, float (&d)[32]) {
          const auto desc = [&](const unsigned* p, int kk) {
            return smem_desc(p + 2 * kk * (kHalfTile / 8) * (kCore / 4),
                             (kHalfTile / 8) * kCore, kCore);
          };
          if (grp == 0) {
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {
              wgmma_tf32(d, zs[kk], desc(pb, kk), kk > 0);
              wgmma_tf32(d, zb[kk], desc(ps, kk));
            }
          }
#pragma unroll
          for (int j = 0; j < kBigPerGroup; ++j) {
            const int kk = grp * kBigPerGroup + j;
            wgmma_tf32(d, zb[kk], desc(pb, kk), grp == 0 || j > 0);
          }
        });
        // W as the A operand over pixel chunks of 8: accumulator order
        // (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) -> operand order
        // (g, k t), (g+8, t), (g, t+4), (g+8, t+4)
        unsigned wb[8][4], ws[8][4];
#pragma unroll
        for (int kc = 0; kc < 8; ++kc)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split_tf32_rn(expf(kappa * s[4 * kc + (i & 1) * 2 + (i >> 1)]),
                          wb[kc][i], ws[kc][i]);
        // acc (64 seeds x 64 dims) += W X_h: K = pixels, 8 per wgmma
        grouped_sum<true>(acc, pair, [&](int grp, float (&d)[32]) {
          const auto desc = [&](const unsigned* p, int kc) {
            return smem_desc(p + 2 * kc * (kD / 8) * (kCore / 4),
                             (kD / 8) * kCore, kCore);
          };
          if (grp == 0) {
#pragma unroll
            for (int kc = 0; kc < 8; ++kc) {
              wgmma_tf32(d, ws[kc], desc(qb, kc), kc > 0);
              wgmma_tf32(d, wb[kc], desc(qs, kc));
            }
          }
#pragma unroll
          for (int j = 0; j < kBigPerGroup; ++j) {
            const int kc = grp * kBigPerGroup + j;
            wgmma_tf32(d, wb[kc], desc(qb, kc), grp == 0 || j > 0);
          }
        });
        pin_registers(wb);
        pin_registers(ws);
      }
    }

    float rows[8][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) rows[i / 4][i % 4] = acc[i];
    store_rows(rows, r0, m, nullptr,
               partial + static_cast<size_t>(blockIdx.x) * m * kD);
    next_seeds(partial, m, red, z, arrived, barriers);
  }
  cp_async_wait<0>();
}

// As hill_tf32_kernel, for bf16 X on mma.sync; blockDim.x = 64 *
// ceil(m / 16).  Shared memory: the ring of tiles, the second half's sums
// [16 * groups][64], the reduction scratch, bf16(Z) [16 * groups][72].
__global__ void __launch_bounds__(kBF16Threads, 1)
hill_bf16_kernel(const __nv_bfloat16* __restrict__ x, int n, int m,
                 float kappa, int max_iters, float* __restrict__ partial,
                 unsigned* __restrict__ arrived, float* __restrict__ z) {
  constexpr int kStageElems = kHillTile * kMmaPitch;
  extern __shared__ __align__(16) float bf16_smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(bf16_smem);
  float* other = bf16_smem + kStages * kStageElems / 2;
  const int groups = blockDim.x / 64;
  float* red = other + 16 * groups * kD;
  __nv_bfloat16* zs = reinterpret_cast<__nv_bfloat16*>(red + kRedFloats);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = warp / groups;
  const int r0 = 16 * (warp % groups);
  const int mine = tiles_of_block(n);
  const int total = max_iters * mine;
  unsigned barriers = 0;

#pragma unroll
  for (int q = 0; q < kStages - 1; ++q)
    issue_load<__nv_bfloat16, kMmaPitch, kStages>(x, n, q, mine, total, ring);
  for (int it = 0; it < max_iters; ++it) {
    HillBF16 w;
    w.load_seeds(z, m, r0, lane, zs);
    float acc[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[t][q] = 0.0f;

    for (int k = 0; k < mine; ++k) {
      const int q = it * mine + k;
      cp_async_wait<kStages - 2>();  // load q has landed
      __syncthreads();  // ... for every thread; tile q-1 is done with
      issue_load<__nv_bfloat16, kMmaPitch, kStages>(x, n, q + kStages - 1,
                                                    mine, total, ring);
      w.tile(ring + (q % kStages) * kStageElems, half, lane, kappa, acc);
    }

    // the two halves' sums, added in a fixed order, are the block's partial
    if (half == 1) store_rows(acc, r0, 16 * groups, nullptr, other);
    __syncthreads();
    if (half == 0)
      store_rows(acc, r0, m, other,
                 partial + static_cast<size_t>(blockIdx.x) * m * kD);
    next_seeds(partial, m, red, z, arrived, barriers);
  }
  cp_async_wait<0>();
}

size_t hill_tf32_smem_bytes() {
  return sizeof(float) * kTf32Stages * kHillTile * kF32Pitch +
         sizeof(unsigned) * 8 * kHalfWords + sizeof(float) * kRedFloats;
}

size_t hill_bf16_smem_bytes(int groups) {
  return sizeof(__nv_bfloat16) * kStages * kHillTile * kMmaPitch +
         sizeof(float) * 16 * groups * kD + sizeof(float) * kRedFloats +
         sizeof(__nv_bfloat16) * 16 * groups * kMmaPitch;
}

// The launch shape: ceil(m/64) warpgroups per block (float32) or two
// halves of ceil(m/16) warps (bfloat16), as many blocks as can be resident
// at once (at most one per X tile).
struct HillPlan {
  int grid, per_sm, threads;
  size_t smem;
};

cudaError_t plan_hill_for(int dtype, int n, int m, HillPlan* p) {
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if (dtype == uoc::kBF16) {
    const int groups = (m + 15) / 16;
    p->threads = 64 * groups;
    p->smem = hill_bf16_smem_bytes(groups);
    err = uoc::blocks_per_sm<hill_bf16_kernel>(
        dev, p->threads, p->smem, hill_bf16_smem_bytes(kMaxSeeds / 16),
        &p->per_sm);
  } else {
    p->threads = 128 * ((m + 63) / 64);
    p->smem = hill_tf32_smem_bytes();
    err = uoc::blocks_per_sm<hill_tf32_kernel>(dev, p->threads, p->smem,
                                               p->smem, &p->per_sm);
  }
  if (err != cudaSuccess) return err;
  const int num_tiles = (n + kHillTile - 1) / kHillTile;
  p->grid = std::max(1, std::min(p->per_sm * sms, num_tiles));
  return cudaSuccess;
}


// ---------------------------------------------------------------------------
// Connected components over the m converged seeds (reference
// lib/utils/mean_shift.py:41-76).
//
// Replaces _cc_kernel / connected_components_pallas.  Bound on the H100: a
// few KB of Z in and m labels out, and m (m + 1) / 2 dot products of width
// 64 (0.65 MFLOP at m = 100), nanoseconds of bytes and flops; what bounds it
// is latency: one launch, the 64-long dependent FMA chains of the
// adjacency, and one dependent merge step for each seed that is still
// unlabeled when its turn comes (about one per cluster).
//
// Design: one block of 16 warps, static shared memory only (36 KB).
//   Adjacency as bitmasks, each pair computed once.  Row i is four uint32
//   words: bit b of adj[i][w] is set when 0.5 * (1 - z_i . z_j) <= eps for
//   j = 32 w + b < m; bits at or past m stay 0.  Of the 32 x 32 tiles of the
//   matrix only those on or above the diagonal are computed, each in the
//   orientation whose row block holds fewer seeds.  A lane owns one column
//   seed j and keeps its 64 floats in registers; it runs kCCRows rows'
//   chains at once, reading the rows' values as shared-memory broadcasts.
//   A row's word is one __ballot_sync; the lane's own bits over the rows
//   are column j's word of the row block (the mirror, OR-ed in shared
//   memory).  The mirror is exact: every dot is the sequential fp32 fmaf
//   chain over k = 0..63, and fmaf(a, b, c) == fmaf(b, a, c) bit for bit,
//   so (i, j) and (j, i) agree.  The diagonal is computed like any pair.
//   The merge on one warp, with no block barrier.  Labels are membership
//   bitmasks of four words; lane l % 32 holds labels l, l + 32, l + 64 and
//   l + 96 in registers.  A 128-bit set of the seeds still unlabeled and
//   not yet visited, the same in every lane, drives the loop: the next step
//   is its lowest set bit, which lies above the seed last visited, so the
//   steps visit, in index order, the seeds that are unlabeled when their
//   turn comes, and a seed outside its own ball (a z_i of norm below 1) is
//   not visited twice.  A step counts each label among i's neighbours as
//   popc(adj[i] & member[l]), takes the mode (the smallest label on a tie)
//   with one __reduce_max_sync over the keys (count << 8) | (255 - l), and
//   moves all of i's neighbours to that label; when no neighbour is labeled
//   (a uniform test against the union of the masks) every count is 0, and
//   the step opens label num_labels without the counts.  The next step's
//   row is loaded while this one runs.  At the end each seed's label is
//   read from the masks one bit of the label at a time (one
//   __reduce_or_sync per label bit and word); a seed in no mask is -1.
// ---------------------------------------------------------------------------
constexpr int kCCThreads = 512;
constexpr int kCCWarps = kCCThreads / 32;
constexpr int kCCWords = kMaxSeeds / 32;
// Z's row pitch in shared memory, in floats: rows stay 16-byte aligned, and
// the 8 lanes of one 16-byte load phase, each reading its own row, hit 8
// disjoint groups of 4 banks.
constexpr int kCCPitch = kD + 4;
constexpr int kCCRows = 8;  // rows of one work item, run as independent chains

// Rows [r0, r0 + kCCRows) of row block rb (which holds `rows` seeds)
// against the 32 seeds of column block cb: the rows' words of block cb, by
// ballot, and when `mirror` is set each lane's bits over these rows, OR-ed
// into its column's word of block rb.
__device__ __forceinline__ void cc_rows(const float* zs,
                                        unsigned (*adj)[kCCWords], int m,
                                        float eps, int rb, int rows, int r0,
                                        int cb, bool mirror) {
  const int lane = threadIdx.x & 31;
  const int j = 32 * cb + lane;
  const float* zj = zs + min(j, m - 1) * kCCPitch;
  float col[kD];
#pragma unroll
  for (int k = 0; k < kD; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(zj + k);
    col[k] = v.x;
    col[k + 1] = v.y;
    col[k + 2] = v.z;
    col[k + 3] = v.w;
  }
  const float* zi[kCCRows];
  float acc[kCCRows];
#pragma unroll
  for (int r = 0; r < kCCRows; ++r) {
    zi[r] = zs + (32 * rb + min(r0 + r, rows - 1)) * kCCPitch;
    acc[r] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kD; k += 4) {
#pragma unroll
    for (int r = 0; r < kCCRows; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(zi[r] + k);
      acc[r] = fmaf(v.x, col[k], acc[r]);
      acc[r] = fmaf(v.y, col[k + 1], acc[r]);
      acc[r] = fmaf(v.z, col[k + 2], acc[r]);
      acc[r] = fmaf(v.w, col[k + 3], acc[r]);
    }
  }
  unsigned own = 0;  // column j's bits over these rows
#pragma unroll
  for (int r = 0; r < kCCRows; ++r) {
    const bool in = r0 + r < rows && j < m && 0.5f * (1.0f - acc[r]) <= eps;
    const unsigned word = __ballot_sync(0xffffffffu, in);
    if (lane == 0 && r0 + r < rows) adj[32 * rb + r0 + r][cb] = word;
    own |= static_cast<unsigned>(in) << (r0 + r);
  }
  if (mirror && own) atomicOr(&adj[j][rb], own);
}

// The lowest seed whose bit is set in s, or -1; the four __ffs are
// independent, so there is no branch.
__device__ __forceinline__ int cc_first(const unsigned (&s)[kCCWords]) {
  int first = -1;
#pragma unroll
  for (int w = kCCWords - 1; w >= 0; --w) {
    const int f = __ffs(s[w]);
    first = f ? 32 * w + f - 1 : first;
  }
  return first;
}

__global__ void __launch_bounds__(kCCThreads)
cc_kernel(const float* __restrict__ z, int m, float eps,
          int* __restrict__ labels, int* __restrict__ steps) {
  __shared__ __align__(16) float zs[kMaxSeeds * kCCPitch];
  __shared__ __align__(16) unsigned adj[kMaxSeeds][kCCWords];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  for (int e = t; e < kMaxSeeds * kCCWords; e += kCCThreads)
    adj[e / kCCWords][e % kCCWords] = 0u;
  for (int e = t; e < m * (kD / 4); e += kCCThreads)
    *reinterpret_cast<float4*>(zs + (e / (kD / 4)) * kCCPitch +
                               4 * (e % (kD / 4))) =
        reinterpret_cast<const float4*>(z)[e];
  __syncthreads();

  // Work items of kCCRows rows of one tile, dealt to the warps in turn.
  // Only the last block can hold fewer than 32 seeds; off the diagonal it
  // gives the rows.
  const int blocks = (m + 31) / 32;
  const bool short_last = m % 32 != 0;
  int item = 0;
  for (int a = 0; a < blocks; ++a)
    for (int c = a; c < blocks; ++c) {
      const bool swap = short_last && c == blocks - 1;
      const int rb = swap ? c : a, cb = swap ? a : c;
      const int rows = min(32, m - 32 * rb);
      for (int r0 = 0; r0 < rows; r0 += kCCRows, ++item)
        if (item % kCCWarps == warp)
          cc_rows(zs, adj, m, eps, rb, rows, r0, cb, a != c);
    }
  __syncthreads();
  if (warp != 0) return;

  // The merge, on warp 0.  pending: the seeds neither labeled nor visited;
  // labeled: the union of the label masks (both the same in every lane).
  unsigned pending[kCCWords], labeled[kCCWords];
  unsigned member[kCCWords][kCCWords];  // [q][w]: label lane + 32 q's seeds
#pragma unroll
  for (int w = 0; w < kCCWords; ++w) {
    const int left = m - 32 * w;
    pending[w] = left >= 32 ? 0xffffffffu : left > 0 ? (1u << left) - 1u : 0u;
    labeled[w] = 0u;
#pragma unroll
    for (int q = 0; q < kCCWords; ++q) member[q][w] = 0u;
  }
  const uint4* balls = reinterpret_cast<const uint4*>(&adj[0][0]);
  int num_labels = 0, n_steps = 0;
  int i = 0;  // m >= 1: seed 0 is the first step
  uint4 row = balls[0];
  while (true) {
    const unsigned ball[kCCWords] = {row.x, row.y, row.z, row.w};
    // i and its neighbours leave the pending set, whose lowest seed is the
    // next step (every seed below it is labeled or visited); its row is
    // loaded while this step runs
#pragma unroll
    for (int w = 0; w < kCCWords; ++w)
      pending[w] &= ~(ball[w] | (w == i >> 5 ? 1u << (i & 31) : 0u));
    const int next = cc_first(pending);
    const uint4 next_row = balls[next & (kMaxSeeds - 1)];
    bool seen = false;  // some neighbour of i is labeled
#pragma unroll
    for (int w = 0; w < kCCWords; ++w) {
      seen |= (ball[w] & labeled[w]) != 0u;
      labeled[w] |= ball[w];
    }
    int label = num_labels;
    if (seen) {
      // the mode of the neighbours' labels, the smallest on a tie (the
      // best count is at least 1); the neighbours leave their labels
      unsigned key = 0;
#pragma unroll
      for (int q = 0; q < kCCWords; ++q) {
        int count = 0;
#pragma unroll
        for (int w = 0; w < kCCWords; ++w)
          count += __popc(ball[w] & member[q][w]);
        key = max(key, static_cast<unsigned>(count) << 8 |
                           static_cast<unsigned>(255 - lane - 32 * q));
      }
      key = __reduce_max_sync(0xffffffffu, key);
      label = 255 - static_cast<int>(key & 255u);
#pragma unroll
      for (int q = 0; q < kCCWords; ++q)
#pragma unroll
        for (int w = 0; w < kCCWords; ++w) member[q][w] &= ~ball[w];
    } else {
      ++num_labels;  // every count is 0: a new label
    }
    const bool mine = (label & 31) == lane;
#pragma unroll
    for (int q = 0; q < kCCWords; ++q) {
      const unsigned take = mine && label >> 5 == q ? 0xffffffffu : 0u;
#pragma unroll
      for (int w = 0; w < kCCWords; ++w) member[q][w] |= ball[w] & take;
    }
    ++n_steps;
    if (next < 0) break;
    i = next;
    row = next_row;
  }

  // Seed 32 w + lane's label, bit by bit: bits 0-4 of a label are its
  // owner's lane, bits 5-6 its slot q.  A seed outside `labeled` is in no
  // label's mask.
#pragma unroll
  for (int w = 0; w < kCCWords; ++w) {
    if (32 * w >= m) break;
    const unsigned held =
        member[0][w] | member[1][w] | member[2][w] | member[3][w];
    int label = 0;
#pragma unroll
    for (int p = 0; p < 5; ++p)
      label |= ((__reduce_or_sync(0xffffffffu, lane >> p & 1 ? held : 0u) >>
                 lane) & 1) << p;
    label |= ((__reduce_or_sync(0xffffffffu, member[1][w] | member[3][w]) >>
               lane) & 1) << 5;
    label |= ((__reduce_or_sync(0xffffffffu, member[2][w] | member[3][w]) >>
               lane) & 1) << 6;
    if (32 * w + lane < m)
      labels[32 * w + lane] = labeled[w] >> lane & 1 ? label : -1;
  }
  if (lane == 0) *steps = n_steps;
}

// ---------------------------------------------------------------------------
// Assignment: each pixel goes to its most similar real seed (first
// occurrence on a tie) and takes seed_labels[closest]; the same sweep counts
// pixels per label and valid-depth pixels per label (the fused depth
// filter).
//
// Replaces _assign_kernel / assign_labels_pallas.  Bound on the H100: one
// read of X (78.6 MB fp32, 39.3 MB bf16 at n = 307200) against 2*m*n*d
// flops (3.9 GFLOP at m = 100; three TF32 products each for fp32 accuracy):
// bytes-bound in both modes, by a factor of about 1.3 at fp32.
//
// Design: one persistent launch (no grid barrier), as many blocks as fit
// on the card.  A block of two warpgroups walks its 128-pixel tiles
// through a cp.async ring of kAssignStages tiles (three in flight while one
// is computed); warpgroup h loads and takes pixels [64h, 64h + 64) of each
// tile, with its own barrier, so the warpgroups do not wait for each other.
// S = X Z^T runs on wgmma with pixels on M and seeds on N (one m64n64
// product per 64 seeds, the second only when m > 64): A is the warp's X
// fragment read from the ring into registers, B is Z staged once per block
// in the K-major core-matrix layout, seed rows past m zero.  float32: A and
// Z are split into big + small TF32 parts (split_tf32), three products per
// k-chunk (small*big, big*small, big*big); bfloat16: A by ldmatrix, Z
// rounded to bf16 (nearest even), one product.  S never leaves registers: a thread
// holds pixels 16w + g and 16w + g + 8 of its warpgroup's 64 and seeds
// 8j + 2t, 8j + 2t + 1; per pixel it finds b1, the best score, with the
// label l1 of a seed that attains it, then b2, the best score among seeds
// of any other label (thread_best), and the quad merges the four by
// shuffle.  Seeds of one label may tie freely; only a near-tie across
// labels can change a pixel's label.
//
// The re-check margin.  X and Z rows are unit vectors.  Split TF32 drops,
// per product a_i b_i, small * small (<= 2^-22 |a_i b_i|) and the
// truncation of each small part as the tensor cores read it (< 2^-21
// |a_i b_i| each): < 1.3 * 2^-20 over the dot, since sum |a_i b_i| <=
// |a| |b| = 1.  The accumulator takes 24 wgmma steps (8 k-chunks x 3
// products); each step truncates its nine terms (the accumulator and eight
// products) two bits below the largest one's last, the rule whose
// emulation reproduces the hill climb's results on the H100: < 24 * 9 *
// 2^-25.  The float32 plain version's own sum of 64 products is within
// 64 * 2^-24 of the exact dot.  So the kernel's S and the plain version's
// differ by less than 1.2e-5 < 2^-16 = kRecheckMargin / 2.  Where b1 - b2
// >= kRecheckMargin the plain version's best seed carries label l1; the
// other pixels (b1 - b2 < kRecheckMargin, a tie at b1 between labels
// included) are re-checked out of line (recheck): the quad recomputes the
// pixel's similarity to every real seed as the sequential fp32 FMA chain over d
// from 0 (Z = big + small, exact), each thread a quarter of the seeds,
// lowest index on a tie.  bf16 products are exact and take 4 steps, so the
// same margin holds there (the re-check then uses bf16 X and bf16(Z)
// widened to fp32, as the plain version does).  When every seed carries one
// label, b2 stays -inf and nothing is re-checked.
//
// Outputs: one thread per pixel writes its label; per-block int32
// histograms in shared memory take warp-aggregated adds (__match_any_sync
// on the label), and are flushed with one float atomicAdd per label per
// block: sums of integers below 2^24 are exact in float32 and do not
// depend on the order.  The kernel counts the pixels it re-checked.
// ---------------------------------------------------------------------------
constexpr int kAssignThreads = 256;  // two warpgroups
constexpr int kAssignStages = 4;     // X tiles in the ring
constexpr float kRecheckMargin = 3.0517578125e-05f;  // 2^-15

// d (64 x 64, fp32, the m64n64 accumulator layout) += a (64 x 16 bf16 from
// registers, the m16n8k16 A layout per warp) * b (16 x 64 bf16, K-major in
// shared memory, described by desc).  Asynchronous, as wgmma_tf32.
__device__ __forceinline__ void wgmma_bf16(float (&d)[32],
                                           const unsigned (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Z in shared memory as the B operand: [dim / kPer][seed / 8] core matrices
// (kPer = 4 fp32 or 8 bf16 dims per 16-byte row), row = seed % 8.  float32
// keeps a big and a small copy, kMaxSeeds * kD words apart.
__device__ __forceinline__ int seed_word(int s, int j, int per) {
  return (((j / per) * (kMaxSeeds / 8) + s / 8) * 8 + s % 8) * per + j % per;
}

// Every thread: Z [m, 64] float32 (16-byte aligned) -> the split copies
// (or bf16(Z)), zero past m.
__device__ __forceinline__ void stage_assign(const float* __restrict__ z,
                                             int m, unsigned* zs) {
  for (int e = threadIdx.x; e < kMaxSeeds * kD / 4; e += blockDim.x) {
    const int s = e / (kD / 4), j = 4 * (e % (kD / 4));
    const float4 v = s < m ? reinterpret_cast<const float4*>(z)[e]
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    uint4 b, sm;
    split_tf32(v.x, b.x, sm.x);
    split_tf32(v.y, b.y, sm.y);
    split_tf32(v.z, b.z, sm.z);
    split_tf32(v.w, b.w, sm.w);
    const int w = seed_word(s, j, 4);
    *reinterpret_cast<uint4*>(zs + w) = b;
    *reinterpret_cast<uint4*>(zs + kMaxSeeds * kD + w) = sm;
  }
}

__device__ __forceinline__ void stage_assign(const float* __restrict__ z,
                                             int m, __nv_bfloat16* zs) {
  for (int e = threadIdx.x; e < kMaxSeeds * kD / 4; e += blockDim.x) {
    const int s = e / (kD / 4), j = 4 * (e % (kD / 4));
    const float4 v = s < m ? reinterpret_cast<const float4*>(z)[e]
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *reinterpret_cast<uint2*>(zs + seed_word(s, j, 8)) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// Seed s, dim j, as the re-check reads it: big + small (exactly Z) or
// bf16(Z) widened.
__device__ __forceinline__ float seed_value(const unsigned* zs, int s, int j) {
  const int w = seed_word(s, j, 4);
  return __fadd_rn(__uint_as_float(zs[w]),
                   __uint_as_float(zs[kMaxSeeds * kD + w]));
}

__device__ __forceinline__ float seed_value(const __nv_bfloat16* zs, int s,
                                            int j) {
  return __bfloat162float(zs[seed_word(s, j, 8)]);
}

// S of the warpgroup's 64 pixels (xs: their rows in the ring) against the
// seeds: acc[nh] holds seeds [64 nh, 64 nh + 64).  Split TF32, the hill
// climb's order: small * big, big * small, big * big per k-chunk of 8.
__device__ __forceinline__ void assign_product(const float* xs,
                                               const unsigned* zs, int m,
                                               float (&acc)[2][32]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const float* xw = xs + (16 * (threadIdx.x / 32 % 4) + g) * kF32Pitch + t;
  unsigned xb[8][4], xsm[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const float a[4] = {xw[8 * kk], xw[8 * kF32Pitch + 8 * kk],
                        xw[8 * kk + 4], xw[8 * kF32Pitch + 8 * kk + 4]};
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(a[q], xb[kk][q], xsm[kk][q]);
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i / 32][i % 32] = 0.0f;
  const unsigned* zb = zs;
  const unsigned* zsm = zs + kMaxSeeds * kD;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int nh = 0; nh < 2; ++nh) {
      if (nh == 1 && m <= 64) continue;  // uniform over the warpgroup
      const int o = (2 * kk * (kMaxSeeds / 8) + 8 * nh) * (kCore / 4);
      const uint64_t db = smem_desc(zb + o, (kMaxSeeds / 8) * kCore, kCore);
      const uint64_t ds = smem_desc(zsm + o, (kMaxSeeds / 8) * kCore, kCore);
      wgmma_tf32(acc[nh], xsm[kk], db);
      wgmma_tf32(acc[nh], xb[kk], ds);
      wgmma_tf32(acc[nh], xb[kk], db);
    }
  wgmma_commit();
  wgmma_wait();
  pin_registers(acc[0]);
  pin_registers(acc[1]);
  pin_registers(xb);
  pin_registers(xsm);
}

// The same for bf16 X: one product per k-chunk of 16.
__device__ __forceinline__ void assign_product(const __nv_bfloat16* xs,
                                               const __nv_bfloat16* zs, int m,
                                               float (&acc)[2][32]) {
  const int lane = threadIdx.x % 32;
  unsigned xa[4][4];
  load_seed_fragments(xs, 16 * (threadIdx.x / 32 % 4), lane, xa);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i / 32][i % 32] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int nh = 0; nh < 2; ++nh) {
      if (nh == 1 && m <= 64) continue;
      const int o = (2 * kk * (kMaxSeeds / 8) + 8 * nh) * (kCore / 2);
      wgmma_bf16(acc[nh], xa[kk],
                 smem_desc(zs + o, (kMaxSeeds / 8) * kCore, kCore));
    }
  wgmma_commit();
  wgmma_wait();
  pin_registers(acc[0]);
  pin_registers(acc[1]);
  pin_registers(xa);
}

// A pixel's best scores over a set of seeds: b1, the label l1 of a seed
// that attains it, and b2, the best score among seeds whose label is not
// l1.  When seeds of two labels both attain b1, b2 = b1 whichever label l1
// is, so the pixel is re-checked; the index of the best seed is not needed.
struct Best {
  float b1, b2;
  int l1;
};

// This thread's Best for both of its pixels, from the accumulators: its
// seeds are 8 blk + 2 t + e (blk = 8 nh + j, e = 0, 1), ascending.  Blocks
// of 8 seeds at or past m are skipped (uniform over the warp); seeds past m
// in the block that straddles m are set to -inf.  b1 (with l1), then b2,
// each as four interleaved running maxima, so that no step waits on the
// one before it.
__device__ __forceinline__ void thread_best(float (&acc)[2][32], int t, int m,
                                            const int* slab, Best (&r)[2]) {
  auto score = [&](int i, int blk, int e) -> float& {
    return acc[blk / 8][4 * (blk % 8) + 2 * i + e];
  };
  // labels of seeds 8 blk + 2t and 8 blk + 2t + 1: lab2[4 blk]
  const int2* lab2 = reinterpret_cast<const int2*>(slab + 2 * t);
  float b[2][4];
  int l[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      b[i][c] = -INFINITY;
      l[i][c] = -1;
    }
#pragma unroll
  for (int blk = 0; blk < 16; ++blk) {
    if (8 * blk >= m) break;
    if (8 * blk + 8 > m)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * blk + 2 * t + e >= m) score(0, blk, e) = score(1, blk, e) = -INFINITY;
    const int2 lb = lab2[4 * blk];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = (2 * blk + e) % 4;
        if (score(i, blk, e) > b[i][c]) {
          b[i][c] = score(i, blk, e);
          l[i][c] = e ? lb.y : lb.x;
        }
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int c = 1; c < 4; ++c)
      if (b[i][c] > b[i][0]) {
        b[i][0] = b[i][c];
        l[i][0] = l[i][c];
      }
    r[i].b1 = b[i][0];
    r[i].l1 = l[i][0];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[i][c] = -INFINITY;
  }
#pragma unroll
  for (int blk = 0; blk < 16; ++blk) {
    if (8 * blk >= m) break;
    const int2 lb = lab2[4 * blk];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if ((e ? lb.y : lb.x) != r[i].l1) {
          const int c = (2 * blk + e) % 4;
          b[i][c] = fmaxf(b[i][c], score(i, blk, e));
        }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    r[i].b2 = fmaxf(fmaxf(b[i][0], b[i][1]), fmaxf(b[i][2], b[i][3]));
}

// The four threads of a quad (disjoint seed sets) merge: the larger b1
// wins (either on a tie); b2 takes the loser's b2 when the labels agree and
// the loser's b1 when they differ.  b1 and b2 come out the same on all four
// threads, exact over the quad's seeds for the l1 each holds.
__device__ __forceinline__ void merge_quad(Best& r) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float ob1 = __shfl_xor_sync(0xFFFFFFFFu, r.b1, off);
    const float ob2 = __shfl_xor_sync(0xFFFFFFFFu, r.b2, off);
    const int ol1 = __shfl_xor_sync(0xFFFFFFFFu, r.l1, off);
    const bool other = ob1 > r.b1;
    const float loser = ol1 == r.l1 ? (other ? r.b2 : ob2)
                                    : (other ? r.b1 : ob1);
    r.b2 = fmaxf(other ? ob2 : r.b2, loser);
    if (other) {
      r.b1 = ob1;
      r.l1 = ol1;
    }
  }
}

// The exact argmax for one pixel (xrow: its row in the ring): thread t of
// the quad takes seeds t, t + 4, ... < m, each the fp32 FMA chain over d
// from 0; lowest index on a tie.  Every lane of the warp calls it; a quad
// that passes active = false gets a meaningless seed.
template <typename T, typename Z>
__device__ __forceinline__ int exact_argmax(const T* xrow, const Z* zs, int m,
                                            bool active, int t) {
  float best = -INFINITY;
  int best_s = kMaxSeeds;
  if (active) {
    for (int s = t; s < m; s += 4) {
      float acc = 0.0f;
#pragma unroll 8
      for (int j = 0; j < kD; ++j)
        acc = fmaf(uoc::to_f32(xrow[j]), seed_value(zs, s, j), acc);
      if (acc > best) {
        best = acc;
        best_s = s;
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float ov = __shfl_xor_sync(0xFFFFFFFFu, best, off);
    const int os = __shfl_xor_sync(0xFFFFFFFFu, best_s, off);
    if (ov > best || (ov == best && os < best_s)) {
      best = ov;
      best_s = os;
    }
  }
  return best_s;
}

// The labels l1 of a quad's two pixels (xrow: the first one's row), with
// those of the near-tied ones (bit i of near: pixel i) replaced by the
// exact argmax's; counts the re-checked pixels.  Out of line: it runs
// rarely, and its registers stay out of the main loop.
template <typename T, typename Z, int kPitch>
__device__ __noinline__ int2 recheck(const T* xrow, const Z* zs, int m, int t,
                                     int near, const int* slab,
                                     float* rechecked, int2 l1) {
#pragma unroll 1
  for (int i = 0; i < 2; ++i) {
    const bool mine = (near >> i) & 1;
    if (!__any_sync(0xFFFFFFFFu, mine)) continue;
    const int s = exact_argmax(xrow + 8 * i * kPitch, zs, m, mine, t);
    if (mine) {
      (i ? l1.y : l1.x) = slab[s];
      if (t == 0) atomicAdd(rechecked, 1.0f);
    }
  }
  return l1;
}

// x: [n, 64] rows 16-byte aligned (float32 with kPitch = kF32Pitch, bf16
// with kMmaPitch); z: [m, 64] float32; seed_labels: [m]; z_valid: [n] or
// null; labels: [n] out; counts: [2 m] float32 (zeroed) += the block's
// histograms; rechecked: += the pixels this block re-checked (float32, an
// exact integer below 2^24).
template <typename T, typename Z, int kPitch>
__device__ __forceinline__ void assign_body(
    const T* __restrict__ x, int n, const float* __restrict__ z,
    const int* __restrict__ seed_labels, int m,
    const unsigned char* __restrict__ z_valid, int* __restrict__ labels,
    float* __restrict__ counts, float* __restrict__ rechecked, T* ring) {
  constexpr int kStageElems = kHillTile * kPitch;
  Z* zs = reinterpret_cast<Z*>(ring + kAssignStages * kStageElems);
  __shared__ __align__(16) int slab[kMaxSeeds];
  __shared__ int hist[2][kMaxSeeds];
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int half = threadIdx.x / 128;            // warpgroup
  const int row = 16 * (threadIdx.x / 32 % 4) + g;  // first pixel of a thread
  const int mine = tiles_of_block(n);
  // warpgroup `half` loads rows [64 half, 64 half + 64) of tile q into
  // ring stage q % kAssignStages
  auto issue = [&](int q) {
    if (q < mine)
      issue_rows<T, kPitch>(
          x, n,
          (static_cast<int>(blockIdx.x) + q * gridDim.x) * kHillTile +
              kHalfTile * half,
          kHalfTile, threadIdx.x % 128, 128,
          ring + (q % kAssignStages) * kStageElems + kHalfTile * half * kPitch);
    cp_async_commit();
  };

#pragma unroll
  for (int q = 0; q < kAssignStages - 1; ++q) issue(q);
  stage_assign(z, m, zs);
  for (int s = threadIdx.x; s < kMaxSeeds; s += blockDim.x) {
    slab[s] = s < m ? seed_labels[s] : 0;
    hist[0][s] = hist[1][s] = 0;
  }
  // Z is read by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  for (int k = 0; k < mine; ++k) {
    // this warpgroup's rows of tile k have landed for all its threads, and
    // its rows of tile k - 1 are done with; the warpgroups do not wait for
    // each other
    cp_async_wait<kAssignStages - 2>();
    if (half == 0)
      bar_sync<1>(128);
    else
      bar_sync<2>(128);
    issue(k + kAssignStages - 1);
    const T* xs = ring + (k % kAssignStages) * kStageElems +
                  kHalfTile * half * kPitch;
    const int p0 = (static_cast<int>(blockIdx.x) + k * gridDim.x) * kHillTile +
                   kHalfTile * half + row;
    // thread t < 2 of the quad owns pixel p0 + 8t; its validity is loaded
    // before the products, which hide the load
    const int p = p0 + 8 * t;
    const bool owner = t < 2 && p < n;
    const bool valid = owner && (z_valid == nullptr || z_valid[p]);
    float acc[2][32];
    assign_product(xs, zs, m, acc);
    Best r[2];
    thread_best(acc, t, m, slab, r);
    int near = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      merge_quad(r[i]);
      if (p0 + 8 * i < n && r[i].b1 - r[i].b2 < kRecheckMargin)
        near |= 1 << i;
    }
    int2 l1 = make_int2(r[0].l1, r[1].l1);
    if (__any_sync(0xFFFFFFFFu, near != 0))
      l1 = recheck<T, Z, kPitch>(xs + row * kPitch, zs, m, t, near, slab,
                                 rechecked, l1);

    // the owner writes its pixel's label and adds the pixel to the
    // histograms, aggregated over the warp's lanes of equal label
    int key = -1, vkey = -1;
    if (owner) {
      const int lab = t == 0 ? l1.x : l1.y;
      labels[p] = lab;
      if (lab >= 0 && lab < m) {
        key = lab;
        if (valid) vkey = lab;
      }
    }
    const unsigned same = __match_any_sync(0xFFFFFFFFu, key);
    if (key >= 0 && lane == __ffs(same) - 1)
      atomicAdd(&hist[0][key], __popc(same));
    const unsigned vsame = __match_any_sync(0xFFFFFFFFu, vkey);
    if (vkey >= 0 && lane == __ffs(vsame) - 1)
      atomicAdd(&hist[1][vkey], __popc(vsame));
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int s = threadIdx.x; s < m; s += blockDim.x) {
    if (hist[0][s]) atomicAdd(&counts[s], static_cast<float>(hist[0][s]));
    if (hist[1][s])
      atomicAdd(&counts[m + s], static_cast<float>(hist[1][s]));
  }
}

__global__ void __launch_bounds__(kAssignThreads, 1)
assign_tf32_kernel(const float* __restrict__ x, int n,
                   const float* __restrict__ z,
                   const int* __restrict__ seed_labels, int m,
                   const unsigned char* __restrict__ z_valid,
                   int* __restrict__ labels, float* __restrict__ counts,
                   float* __restrict__ rechecked) {
  extern __shared__ __align__(128) float assign_f32_smem[];
  assign_body<float, unsigned, kF32Pitch>(x, n, z, seed_labels, m, z_valid,
                                          labels, counts, rechecked,
                                          assign_f32_smem);
}

__global__ void __launch_bounds__(kAssignThreads, 2)
assign_bf16_kernel(const __nv_bfloat16* __restrict__ x, int n,
                   const float* __restrict__ z,
                   const int* __restrict__ seed_labels, int m,
                   const unsigned char* __restrict__ z_valid,
                   int* __restrict__ labels, float* __restrict__ counts,
                   float* __restrict__ rechecked) {
  extern __shared__ __align__(128) __nv_bfloat16 assign_bf16_smem[];
  assign_body<__nv_bfloat16, __nv_bfloat16, kMmaPitch>(
      x, n, z, seed_labels, m, z_valid, labels, counts, rechecked,
      assign_bf16_smem);
}

// The ring of X tiles and Z (float32: its two split copies).
size_t assign_smem_bytes(int dtype) {
  return dtype == uoc::kBF16
             ? sizeof(__nv_bfloat16) *
                   (kAssignStages * kHillTile * kMmaPitch + kMaxSeeds * kD)
             : sizeof(float) *
                   (kAssignStages * kHillTile * kF32Pitch + 2 * kMaxSeeds * kD);
}

// The launch shape: 256 threads, as many blocks as fit on the card at once
// (at most one per X tile).
struct AssignPlan {
  int grid, per_sm;
  size_t smem;
};

cudaError_t plan_assign_for(int dtype, int n, AssignPlan* p) {
  // {blocks per SM, SMs} per device and dtype, found at the first call (0:
  // not yet): the launch asks for its plan on every call
  constexpr int kDevices = 64;
  static int cached[kDevices][2][2] = {};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  const bool bf16 = dtype == uoc::kBF16;
  int* c = cached[dev][bf16];
  p->smem = assign_smem_bytes(dtype);
  if (c[1] == 0) {
    int per_sm, sms;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    err = bf16 ? uoc::blocks_per_sm<assign_bf16_kernel>(
                     dev, kAssignThreads, p->smem, p->smem, &per_sm)
               : uoc::blocks_per_sm<assign_tf32_kernel>(
                     dev, kAssignThreads, p->smem, p->smem, &per_sm);
    if (err != cudaSuccess) return err;
    c[0] = per_sm;
    c[1] = sms;
  }
  p->per_sm = c[0];
  const int num_tiles = (n + kHillTile - 1) / kHillTile;
  p->grid = std::max(1, std::min(c[0] * c[1], num_tiles));
  return cudaSuccess;
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

}  // namespace

// The launch configuration uoc_hill_climb uses for n pixels and m seeds:
// out = [grid, blocks per SM, threads per block, dynamic shared bytes,
// bytes of X held on chip per block].
extern "C" int uoc_hill_climb_plan(int dtype, int n, int m, long long* out) {
  if (m < 1 || m > kMaxSeeds) return static_cast<int>(cudaErrorInvalidValue);
  HillPlan p;
  const cudaError_t err = plan_hill_for(dtype, n, m, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.grid;
  out[1] = p.per_sm;
  out[2] = p.threads;
  out[3] = static_cast<long long>(p.smem);
  // the ring of raw tiles, and for float32 the tile's four split copies
  out[4] = dtype == uoc::kBF16 ? 2LL * kStages * kHillTile * kD
                               : 4LL * (kTf32Stages + 4) * kHillTile * kD;
  return 0;
}

// x: [n, 64] row-major float32 or bfloat16, rows 16-byte aligned; z0:
// [m, 64] float32; partial: [grid, m, 64] float32 scratch with the grid of
// uoc_hill_climb_plan; arrived: one uint32 scratch (the grid barrier's
// counter, zero-filled here); z: [m, 64] float32 out.
// m <= 128.  One cooperative launch on `stream` runs all iterations; a
// grid that cannot be resident at once is refused by the launch.
extern "C" int uoc_hill_climb(const void* x, int dtype, int n,
                              const float* z0, int m, float kappa,
                              int max_iters, float* partial, unsigned* arrived,
                              float* z, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || m > kMaxSeeds) return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(x)) return static_cast<int>(cudaErrorMisalignedAddress);
  HillPlan p;
  cudaError_t err = plan_hill_for(dtype, n, m, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  err = cudaMemcpyAsync(z, z0, sizeof(float) * m * kD,
                        cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaMemsetAsync(arrived, 0, sizeof(*arrived), s)) != cudaSuccess)
    return static_cast<int>(err);
  if (dtype == uoc::kBF16)
    err = uoc::launch_cooperative(
        hill_bf16_kernel, p.grid, p.threads, p.smem, s,
        static_cast<const __nv_bfloat16*>(x), n, m, kappa, max_iters, partial,
        arrived, z);
  else
    err = uoc::launch_cooperative(hill_tf32_kernel, p.grid, p.threads, p.smem,
                                  s, static_cast<const float*>(x), n, m, kappa,
                                  max_iters, partial, arrived, z);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// z: [m, 64] float32, rows 16-byte aligned; labels: [m] int32 out; steps:
// one int32 out, the merge steps taken (the seeds still unlabeled when their
// turn came).  1 <= m <= 128.  One launch on `stream`, with static shared
// memory only.
extern "C" int uoc_connected_components(const float* z, int m, float epsilon,
                                        int* labels, int* steps,
                                        void* stream) {
  if (m < 1 || m > kMaxSeeds) return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(z)) return static_cast<int>(cudaErrorMisalignedAddress);
  cc_kernel<<<1, kCCThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      z, m, epsilon, labels, steps);
  return static_cast<int>(cudaGetLastError());
}

// The launch configuration uoc_assign_labels uses for n pixels and m seeds:
// out = [grid, blocks per SM, threads per block, dynamic shared bytes,
// bytes of X held on chip per block (its ring of tiles)].
extern "C" int uoc_assign_labels_plan(int dtype, int n, int m,
                                      long long* out) {
  if (m < 1 || m > kMaxSeeds) return static_cast<int>(cudaErrorInvalidValue);
  AssignPlan p;
  const cudaError_t err = plan_assign_for(dtype, n, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.grid;
  out[1] = p.per_sm;
  out[2] = kAssignThreads;
  out[3] = static_cast<long long>(p.smem);
  out[4] = (dtype == uoc::kBF16 ? 2LL : 4LL) * kAssignStages * kHillTile * kD;
  return 0;
}

// x: [n, 64] row-major float32 or bfloat16, rows 16-byte aligned; z:
// [m, 64] float32; seed_labels: [m] int32; z_valid: [n] bytes (0 or 1) or
// null (every pixel valid); labels: [n] int32 out; counts: [2 m + 1]
// float32 out, zero-filled here: pixels per label, valid pixels per label,
// then the count of re-checked pixels.  m <= 128, n < 2^24 (the float
// counts stay exact).  One launch on `stream`.
extern "C" int uoc_assign_labels(const void* x, int dtype, int n,
                                 const float* z, const int* seed_labels,
                                 int m, const unsigned char* z_valid,
                                 int* labels, float* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || m > kMaxSeeds || n >= (1 << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(x)) return static_cast<int>(cudaErrorMisalignedAddress);
  AssignPlan p;
  cudaError_t err = plan_assign_for(dtype, n, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaMemsetAsync(counts, 0, sizeof(float) * (2 * m + 1), s)) !=
      cudaSuccess)
    return static_cast<int>(err);
  float* rechecked = counts + 2 * m;
  if (dtype == uoc::kBF16)
    assign_bf16_kernel<<<p.grid, kAssignThreads, p.smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), n, z, seed_labels, m, z_valid,
        labels, counts, rechecked);
  else
    assign_tf32_kernel<<<p.grid, kAssignThreads, p.smem, s>>>(
        static_cast<const float*>(x), n, z, seed_labels, m, z_valid, labels,
        counts, rechecked);
  return static_cast<int>(cudaGetLastError());
}
