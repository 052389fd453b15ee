// vMF mean-shift kernels on Hopper: hill climbing, connected components
// over the converged seeds, and the fused pixel assignment + histograms.
//
// Replace the TPU kernels in unseenobjectclustering_tpu/ops/pallas_mean_shift.py:
//   hill_tf32_kernel, hill_tf32_wide_kernel,
//   hill_bf16_kernel, hill_bf16_wide_kernel
//                       <- _hill_climb_kernel / hill_climb_pallas
//   hill_simt_kernel    <- the same, at d = 256
//   cc_kernel, cc_cluster_kernel, cc_wide_kernel
//                       <- _cc_kernel / connected_components_pallas
//   assign_tf32_kernel, assign_tf32_wide_kernel,
//   assign_bf16_kernel, assign_bf16_wide_kernel, assign_exact_kernel
//                       <- _assign_kernel / assign_labels_pallas
//
// The kernels take m <= 128 seeds of the embedding width d = 64 (NUM_UNITS
// of every recipe) or d = 128 (2 * NUM_UNITS: the RGB-D cat fusion), each
// width its own instantiation or kernel; the C entry points take d and
// refuse any other width (the wrappers pad a narrower embedding with zero
// columns).  Past 128 seeds, up to 256: the hill climb runs in groups of
// at most 128 (one launch each, from the wrapper); the connected
// components run cc_kernel<d, 256> (rows and label masks of 8 words); the
// assignment runs its kernel of the width twice over X (passes 1 and 2,
// each against at most 128 seeds), which the entry points pick only there.
// Past 256 seeds, up to 512, at d = 64 and 128: the hill climb in more
// groups of 128, the assignment in ceil(m / 128) passes (a first, middle
// ones and a last), the connected components on cc_wide_kernel (16-word
// rows, label masks in shared memory).  At d = 256 (the cat fusion of two
// 128-unit heads), up to 512 seeds, simple designs on the CUDA cores take
// over what the tensor-core kernels' shared memory cannot hold: the hill
// climb on hill_simt_kernel (groups of at most 64 seeds), the connected
// components on cc_wide_kernel and the assignment on assign_exact_kernel
// (one launch, every score the exact FMA chain).
// The hill climb and the assignment stream X
// through a ring of pixel tiles (cp.async, or TMA at d = 128 but for the
// float32 hill climb) and run their products on the
// tensor cores in both modes: float32 as split TF32 on wgmma (about fp32
// accuracy), bfloat16 on
// mma.sync (hill climb at d = 64) or wgmma (the rest).  The assignment
// re-checks the few pixels whose best two labels are nearly tied with the
// exact fp32 FMA chain; see its section.  What changes with the width is
// said in each section.
#include <math.h>
#include <cuda.h>  // CUtensorMap
#include <stdint.h>

#include <algorithm>
#include <chrono>
#include <numeric>

#include "common.cuh"

namespace {

constexpr int kMaxSeeds = 128;
// Past kMaxSeeds, up to kMaxSeedsMany seeds: the hill climb runs in groups
// of kMaxSeeds, the connected components on cc_kernel<kD, kMaxSeedsMany>, the
// assignment in two passes (see each).
constexpr int kMaxSeedsMany = 2 * kMaxSeeds;
// The most seeds any kernel takes (MAX_SEEDS in ops/cuda_mean_shift.py):
// past kMaxSeedsMany the connected components run cc_wide_kernel and the
// assignment ceil(m / kMaxSeeds) passes.
constexpr int kMaxSeedsAll = 4 * kMaxSeeds;

// bf16 on the tensor cores (mma.sync m16n8k16, fp32 accumulators) for the
// bf16 hill climb at d = 64: the products of bf16 values
// are exact and the sums fp32, in the tensor cores' order.  Warp w owns
// seed rows [16w, 16w + 16) and keeps their Z fragments in registers.  X
// tiles sit in shared memory as bf16 with a row pitch of d + 8 elements
// (144 or 272 bytes), so every ldmatrix row hits its own banks; the global
// loads need 16-byte aligned rows of X.
template <int kD>
constexpr int kMmaPitch = kD + 8;
// float32 rows in shared memory: d + 4 floats, 16-byte aligned rows whose
// 8 neighbours fall in 8 distinct 16-byte bank groups.
template <int kD>
constexpr int kF32Pitch = kD + 4;

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

// A fragments of rows [r0, r0 + 16) of zs (row pitch kPitch), one per
// k-chunk of 16 columns from column 0 of zs.
template <int kPitch, int kChunks>
__device__ __forceinline__ void load_seed_fragments(
    const __nv_bfloat16* zs, int r0, int lane, unsigned (&za)[kChunks][4]) {
#pragma unroll
  for (int kk = 0; kk < kChunks; ++kk)
    ldmatrix_x4(za[kk], &zs[(r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch +
                           16 * kk + (lane >> 4) * 8]);
}

// S (16 seeds x 64 pixels) = Z_rows X_tile^T as eight m16n8 accumulators.
template <int kD>
__device__ __forceinline__ void mma_similarity(
    const unsigned (&za)[kD / 16][4], const __nv_bfloat16* xs, int lane,
    float (&s)[8][4]) {
  constexpr int kPitch = kMmaPitch<kD>;
  const int quad = lane >> 3;  // which 8x8 matrix this lane addresses
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) s[t][q] = 0.0f;
#pragma unroll
  for (int t = 0; t < 8; t += 2)
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      unsigned b[4];
      ldmatrix_x4(b, &xs[(8 * t + (lane & 7) + (quad >> 1) * 8) * kPitch +
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
// iterations at m=100, n=307200, d=64; 157 GFLOP at d=128) against one
// read of X per iteration; bound by the tensor cores in both modes.
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
//    it toward zero about two bits below the largest one's last (of the
//    rules that hill_climb_study.py's emulation tried, this one comes
//    nearest both float32 kernels on the card: within a few ulps of Z
//    after one iteration, not bitwise): an error that grows with the
//    accumulator and the steps it takes, always of one sign per term.  exp(kappa S) multiplies an error in S by kappa, and a
//    seed that rests on few pixels moves with every error in W X.  So each
//    product sums its 16 small steps (tiny terms) first and then its 8 big
//    steps in groups of kBigPerGroup, every group in a fresh accumulator,
//    and the CUDA cores add the groups (fp32, rounded to nearest):
//    grouped_sum keeps two accumulators, one on the tensor cores while the
//    other's sum is added.  On trained crop embeddings this keeps Z within
//    4e-6 of a float64 replay where the plain float32 version (cuBLAS)
//    strays up to 2.5e-5.  A warpgroup
//    owns 64 seed rows (ceil(m/64) warpgroups) and keeps Z's split A
//    fragments in registers (d = 64; d = 128 below).  The whole block
//    splits each landed tile once
//    into big and small copies in the two K-major layouts that wgmma reads
//    from shared memory (8-row x 16-byte core matrices, no swizzle): X as
//    [pixel][dim] for S = Z X^T and as [dim][pixel] for W X.  The
//    accumulator columns (2t, 2t+1) of S are taken as the A operand's k
//    columns (t, t+4) of W X by storing the pixels of each group of 8 in
//    the order 0, 2, 4, 6, 1, 3, 5, 7 in the second layout: the sum over
//    pixels does not depend on their order.
//  * float32 X at d = 128 (hill_tf32_wide_kernel), for the RGB-D cat
//    fusion's embeddings.  Bound on the H100: 4*m*n*d flops per iteration,
//    tripled by the split (157 GFLOP for 10 iterations at m = 100, n =
//    307200: 0.95 ms at 495 TFLOP/s of TF32; 1.22 ms for the 128 seed
//    rows that two m64 warpgroups compute).  The design, by what it buys:
//    - Registers.  Z's split fragments (128 registers a thread) and the
//      W X accumulator (64) do not both fit, so Z's big part stays in
//      registers as A fragments (64) and its small part sits in shared
//      memory (64 KB, the [dim/4][seed/8] core-matrix layout of the
//      assignment's Z): two of S's three products read only X (1 KB a
//      wgmma step) from shared memory.
//    - Overlap.  The block is ceil(m/64) consumer warpgroups, which own the
//      seeds and run the products, and one producer warpgroup.  Each
//      producer warp loads 8 pixels of every 32-pixel tile by cp.async two
//      tiles ahead (a ring of two raw tiles, 33 KB) and splits them into
//      one of two stages of the tile's four split copies (64 KB each: big
//      and small in the two K-major layouts wgmma reads), signalling the
//      stage's full mbarrier; the consumers run the tile's S (m64n32k8, 48
//      steps), W's exp and split and W X (four m64n32 products, one per 32
//      dims, A = W from registers), then signal its empty mbarrier.  So the
//      split runs on the CUDA cores beside the tensor cores, and the only
//      handshakes a tile are the two mbarriers, where the kernel before
//      split each tile between two block barriers with the tensor cores
//      idle.  setmaxnreg gives the consumers 216 registers, the producer
//      72 (230,432 bytes of shared memory, one block an SM).
//    - The fixed cost of an iteration.  The consumers copy Z in with
//      coalesced 16-byte loads and split their own fragments in place (no
//      block-wide re-split), store their partial through shared memory as
//      whole rows, and reduce each row from float4s of the blocks'
//      partials in 8 groups of blocks (fixed order: the same result run to
//      run); the grid barriers span the consumers, and the producer splits
//      the next iteration's first tiles meanwhile.
//    The accumulation rule is the d = 64 kernel's with larger groups in S:
//    each product sums its small steps first and then its big steps in
//    groups, each group in a fresh accumulator, added on the CUDA cores.
//    S takes 32 small and 16 big steps, in groups of kWideBigPerGroup = 4
//    (4 groups), each W X product 8 small and 4 big (2 groups of 2), each
//    group added on the CUDA cores to the block's sum.  S's error: a step
//    truncates each of its 9 terms by less than 2^-25 of the largest one
//    and rounds its sum toward zero, by less than 2^-23 of the sum; in
//    the group over dims J every term and partial sum is at most |z_J|
//    |x_J| (Cauchy-Schwarz on the dims of J), and the sum of |z_J| |x_J|
//    over the groups is at most |z||x| = 1.  So the 16 big steps'
//    truncations add up to less than 4 * 9 * 2^-25 and their roundings to
//    4 * 2^-23; the 32 small steps' (every term and sum at most 2^-10) to
//    32 * (9 * 2^-35 + 2^-33) < 2^-26; the small sum that group 0's big
//    steps start from adds 4 * (9 * 2^-35 + 2^-33) < 2^-29.  The CUDA
//    cores' 3 adds round to nearest, at most 3 * 2^-24, and the split
//    drops small * small and rounds the small parts, 3 * 2^-22.  So |S -
//    S_exact| < 36 * 2^-25 + 4 * 2^-23 + 3 * 2^-24 + 3 * 2^-22 + 2^-26 +
//    2^-29, about 2.5e-6 (the same argument gives 1.9e-6 for groups of
//    2, which the kernel before kept, and whose note gave 5e-6), against
//    the plain float32 version's 128 * 2^-24 = 7.6e-6.  W X's error per
//    tile is no larger than at d = 64, and its accumulator takes as many
//    CUDA-core adds (two groups per 32-pixel tile).
//  * bfloat16 X at d = 64: mma.sync m16n8k16 (hill_bf16_kernel), two
//    halves of ceil(m/16) warps, each half owning 64 pixels of a tile; Z is
//    rounded to bf16 for the first product and W before the second, as the
//    TPU kernel did.  The halves' sums are added in shared memory.
//  * bfloat16 X at d = 128 (hill_bf16_wide_kernel), for the RGB-D cat
//    fusion's embeddings in fast mode.  Bounds on the H100 (989 TFLOP/s of
//    bf16, 3.35 TB/s), m = 100, 10 iterations: operations 4*m*n*d, 157 GFLOP
//    at the 480x640 frame (0.159 ms; 0.203 for the 128 seed rows that two
//    m64 warpgroups compute), 25.7 at 224^2 (0.026; 0.033), 8.4 at 128^2
//    (0.0085; 0.011); and X re-read every iteration: 78.6 MB at the frame,
//    786 MB over 10 iterations (0.235 ms, the binding bound there: the
//    50 MB L2 does not hold X), 12.8 MB at 224^2 and 4.2 MB at 128^2 (in
//    L2).  The design, by what it buys:
//    - Tensor-core rate.  The block is ceil(m/64) consumer warpgroups, each
//      owning 64 seed rows with bf16(Z) as wgmma A fragments in registers
//      (8 k-chunks of 16 dims, 32 registers), and a producer warpgroup.
//      Its first thread loads each 64-pixel tile by TMA as two boxes
//      of 64 pixels x 64 dims (128-byte rows, 128-byte swizzle) into a
//      ring of kBWStages stages with full and empty mbarriers.  A consumer
//      runs S = Z X^T as 8 wgmma m64n64k16 with B = the tile read K-major,
//      turns the accumulators into W = bf16(exp(kappa S)) as A fragments in
//      registers (the m64 accumulator layout is the A layout), and runs acc
//      += W X as 4 wgmma m64n128k16 with B = the same tile read MN-major
//      (the transpose flag of 16-bit types): the tile lands once, in one
//      layout.  The producer is a whole warpgroup (registers are given
//      out by warpgroups: a lone producer warp left 168 a thread and
//      spills), so setmaxnreg gives the consumers 232 and it keeps 40.
//    - Overlap.  A consumer issues the next tile's S before this tile's W X
//      and computes the next W on the CUDA cores while W X runs on the
//      tensor cores; the two warpgroups interleave freely (taking turns
//      on named barriers gained nothing).  exp is taken as ex2.approx(k2
//      S), k2 = kappa log2(e) rounded to fp32: a MUFU op and a multiply
//      where expf takes about ten instructions (on the H100, 0.46 ms at
//      the frame with expf against 0.34).  The two W buffers swap roles
//      over a loop of two tiles a turn: a copy between them let ptxas
//      serialize the wgmmas (0.43 ms).
//    - The fixed cost of an iteration.  Each consumer warp loads its Z
//      rows with 16-byte loads (a row's 16 dims of a k-chunk over 4 lanes)
//      and builds its fragments with shuffles, with no block-wide staging;
//      the accumulators go straight to the block's partial as float2s
//      (whole 32-byte sectors); each row of the next Z is reduced by every
//      consumer, a float4 a lane, in groups of blocks (reduce_row_wide);
//      the grid barriers span the consumers while the producer loads the
//      next iteration's first tiles.
//    - Bytes.  A block keeps its first kBWResident tiles in shared memory
//      for the whole launch (22% of X at the frame: 17.3 MB over 132
//      SMs; all of X at both crops), loaded once; the rest stream through
//      the ring, in ascending order on even iterations and descending on
//      odd ones, so that an iteration starts on the tiles that the last
//      one read last, which L2 still holds.
//    Rounding: Z to bf16 (nearest even) for S; S summed by the tensor
//    cores in fp32 (products of bf16 are exact); W = bf16(2^(k2 S)) with
//    k2 S rounded to fp32; W X summed in fp32.  Before W's rounding to
//    bf16, its error against exp(kappa S) is below 2.1e-6 of W: k2's
//    rounding (2^-24 of |k2 S| <= 28.9, times ln 2: 1.2e-6), k2 S's
//    (2^-20 absolute: 6.6e-7) and ex2.approx's own (2 ulp, 2.4e-7), where
//    the plain version's expf(kappa S) is within about 1.2e-6; both are
//    far below bf16's half ulp, 2^-9 of W, so only the few W that lie that
//    close to a rounding boundary round the other way.  The order of
//    every sum is fixed, so the same input gives bitwise the same Z: a
//    block's tiles in the order above (its resident tiles, then its
//    streamed ones), each tile's 16-pixel k-steps in order; the blocks'
//    partials in reduce_row_wide's groups.
// ---------------------------------------------------------------------------
constexpr int kHillTile = 128;        // pixels per X tile
constexpr int kHalfTile = kHillTile / 2;
constexpr int kStages = 3;            // bf16 X tiles in flight per block
constexpr int kTf32Stages = 2;        // float32 X tiles in flight per block
// bf16 hill climb at d = 64: two halves of at most kMaxSeeds / 16 warps
constexpr int kBf16Threads = 2 * 32 * (kMaxSeeds / 16);
template <int kD>
constexpr int kRedFloats = 16 * kD;   // per-group sums of a reduced row
constexpr int kCore = 128;            // bytes of a core matrix (8 x 16 B)
constexpr int kHalfWords = kHalfTile * 64;  // one split copy of a half, d = 64
// float32 at d = 128: pixels per tile, one split copy of a tile and Z's
// small part in words, stages of split copies, raw tiles in flight
constexpr int kWideD = 128;
constexpr int kWideTile = 32;
constexpr int kWideTileWords = kWideTile * kWideD;
constexpr int kWideZWords = kMaxSeeds * kWideD;
constexpr int kWideStages = 2;
constexpr int kWideRaw = 2;

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

// X ([n, kD] rows) rows [p0, p0 + rows) -> xs [rows][kPitch], 16 bytes
// per copy, by threads tid, tid + threads, ...; rows past n are
// zero-filled.
template <typename T, int kD, int kPitch>
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

// Named barrier `id` (a register): this thread waits until `threads`
// threads have arrived; named_arrive counts this thread without waiting.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The descriptor of a K-major operand in shared memory without swizzle:
// core matrices lbo bytes apart along K and sbo bytes apart along M/N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, unsigned lbo,
                                              unsigned sbo) {
  return static_cast<uint64_t>((smem_addr(p) >> 4) & 0x3FFFu) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Pass e (0 <= e < kPx * kD / 4) of splitting kPx pixels of a landed raw
// tile from xs ([kPx][kD + 4] floats) into big and small copies in one of
// the two layouts of `buf` (4 x kPx x kD words):
//   first  [dim / 4][pixel / 8] core matrices, row = pixel % 8;
//   second [pixel / 4][dim / 8] core matrices, row = dim % 8, pixels of
//          each group of 8 in the order 0, 2, 4, 6, 1, 3, 5, 7.
// The core matrices neighbouring along N (pixels, then dims) are adjacent.
// 8 threads on neighbouring passes read and write 8 distinct 16-byte bank
// groups.  split_load reads a pass's 4 floats, split_store writes their
// split parts.
template <int kD, int kPx, bool kSecond>
__device__ __forceinline__ float4 split_load(const float* xs, int e) {
  constexpr int kPitch = kF32Pitch<kD>;
  if (!kSecond) {
    const int r = e % 8, kq = (e / 8) % (kD / 4), c = e / (2 * kD);
    return reinterpret_cast<const float4*>(xs + (8 * c + r) * kPitch)[kq];
  }
  const int n = e % kD, par = (e / kD) % 2, c = e / (2 * kD);
  const float* col = xs + (8 * c + par) * kPitch + n;
  return make_float4(col[0], col[2 * kPitch], col[4 * kPitch],
                     col[6 * kPitch]);
}

template <int kD, int kPx, bool kSecond>
__device__ __forceinline__ void split_store(unsigned* buf, int e, float4 v) {
  constexpr int kWords = kPx * kD;
  uint4* big = reinterpret_cast<uint4*>(buf) + (kSecond ? kWords / 2 : 0);
  uint4* small = big + kWords / 4;
  uint4 b, s;
  split_tf32_rn(v.x, b.x, s.x);
  split_tf32_rn(v.y, b.y, s.y);
  split_tf32_rn(v.z, b.z, s.z);
  split_tf32_rn(v.w, b.w, s.w);
  int o;
  if (!kSecond) {
    const int r = e % 8, kq = (e / 8) % (kD / 4), c = e / (2 * kD);
    o = (kq * (kPx / 8) + c) * 8 + r;
  } else {
    const int n = e % kD, par = (e / kD) % 2, c = e / (2 * kD);
    o = ((2 * c + par) * (kD / 8) + n / 8) * 8 + n % 8;
  }
  big[o] = b;
  small[o] = s;
}

// The whole block: every pass of both layouts, the first layout first.
template <int kD, int kPx>
__device__ __forceinline__ void split_pixels(const float* xs, unsigned* buf) {
  for (int e = threadIdx.x; e < kPx * kD / 4; e += blockDim.x)
    split_store<kD, kPx, false>(buf, e, split_load<kD, kPx, false>(xs, e));
  for (int e = threadIdx.x; e < kPx * kD / 4; e += blockDim.x)
    split_store<kD, kPx, true>(buf, e, split_load<kD, kPx, true>(xs, e));
}

// One warp's state and per-tile work, bfloat16 X of width 64.
struct HillBF16 {
  static constexpr int kD = 64;
  static constexpr int kPitch = kMmaPitch<kD>;
  unsigned za[kD / 16][4];  // A fragments of bf16(Z), per k-chunk of 16

  // Every thread of the block stages z into zs (bf16, as many rows as a
  // half has warps), then each warp loads its fragments; the caller's
  // barrier has freed zs.
  __device__ __forceinline__ void load_seeds(const float* z, int m, int r0,
                                             int lane, __nv_bfloat16* zs) {
    // 16 rows per warp of a half
    const int rows = blockDim.x / 4;
    for (int e = threadIdx.x; e < rows * kD; e += blockDim.x) {
      const int s = e / kD, j = e % kD;
      zs[s * kPitch + j] =
          __float2bfloat16_rn(s < m ? __ldcg(&z[s * kD + j]) : 0.0f);
    }
    __syncthreads();
    load_seed_fragments<kPitch>(zs, r0, lane, za);
  }

  __device__ __forceinline__ void tile(const __nv_bfloat16* xs, int half,
                                       int lane, float kappa,
                                       float (&acc)[kD / 8][4]) const {
    const int quad = lane >> 3;
    const __nv_bfloat16* xh = xs + half * kHalfTile * kPitch;
    float s[8][4];
    mma_similarity<kD>(za, xh, lane, s);
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
    for (int t = 0; t < kD / 8; t += 2)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned b[4];
        ldmatrix_x4_trans(
            b, &xh[(16 * kk + (lane & 7) + (quad & 1) * 8) * kPitch +
                   8 * t + (quad >> 1) * 8]);
        mma_bf16(acc[t], wa[kk], b[0], b[1]);
        mma_bf16(acc[t + 1], wa[kk], b[2], b[3]);
      }
  }
};

// Seed row r of the next Z: the block sums partial[0..grid)[r] in block
// order, then z[r] = v / max(||v||, 1e-12).
template <int kD>
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
    float v[kD / 32], ss = 0.0f;
#pragma unroll
    for (int h = 0; h < kD / 32; ++h) {
      v[h] = 0.0f;
      for (int q = 0; q < ng; ++q) v[h] += red[q * kD + lane + 32 * h];
      ss = fmaf(v[h], v[h], ss);
    }
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xFFFFFFFFu, ss, off);
    const float den = fmaxf(sqrtf(ss), 1e-12f);
#pragma unroll
    for (int h = 0; h < kD / 32; ++h) z[r * kD + lane + 32 * h] = v[h] / den;
  }
  __syncthreads();  // red is free again
}

// acc (the m16n8 accumulators of kT 8-column tiles, rows [r0, r0 + 16))
// plus, when given, the same rows of `other` ([rows][kPitch]) -> rows < m
// of `out` [m][kPitch].
template <int kPitch, int kT>
__device__ __forceinline__ void store_rows(const float (&acc)[kT][4], int r0,
                                           int m, const float* other,
                                           float* out) {
  const int lane = threadIdx.x % 32;
  const int row = r0 + lane / 4, col = 2 * (lane % 4);
#pragma unroll
  for (int t = 0; t < kT; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = row + (q >> 1) * 8, c = 8 * t + col + (q & 1);
      if (r < m)
        out[r * kPitch + c] =
            acc[t][q] + (other ? other[r * kPitch + c] : 0.0f);
    }
}

// Every partial is written: sum them into the next Z (two grid barriers).
template <int kD>
__device__ __forceinline__ void next_seeds(const float* partial, int m,
                                           float* red, float* z,
                                           unsigned* arrived,
                                           unsigned& barriers) {
  uoc::grid_barrier(arrived, ++barriers);  // every partial is written
  for (int r = blockIdx.x; r < m; r += gridDim.x)
    reduce_row<kD>(partial, m, r, red, z);
  uoc::grid_barrier(arrived, ++barriers);  // the new Z is written
}

// This block's tiles of kTile pixels are blockIdx.x + k * gridDim.x, k <
// tiles_of_block(); the q-th load of the launch (q = it * mine + k) goes
// to ring stage q % stages.
template <int kTile>
__device__ __forceinline__ int tiles_of_block(int n) {
  const int num_tiles = (n + kTile - 1) / kTile;
  return (num_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) /
         gridDim.x;
}

template <typename T, int kD, int kPitch, int kRing, int kTile>
__device__ __forceinline__ void issue_load(const T* x, int n, int q, int mine,
                                           int total, T* ring) {
  if (q < total)
    issue_rows<T, kD, kPitch>(
        x, n, (static_cast<int>(blockIdx.x) + (q % mine) * gridDim.x) * kTile,
        kTile, threadIdx.x, blockDim.x, ring + (q % kRing) * kTile * kPitch);
  cp_async_commit();
}

// The float32 hill climb sums each product (S, and W X_h) in groups of
// wgmma steps, each group in a fresh accumulator: the first holds the
// small products and the first kBigPerGroup big ones, each later group the
// next kBigPerGroup big ones (at most all of a product's big steps, one
// per k-chunk).  hill_climb_study.py builds the kernel with other values
// (-DHILL_BIG_PER_GROUP=1, 2, 4 or 8) to compare them.
#ifndef HILL_BIG_PER_GROUP
#define HILL_BIG_PER_GROUP 2
#endif
constexpr int kBigPerGroup = HILL_BIG_PER_GROUP;
// big steps per group, and groups, of a product of `chunks` k-chunks
__host__ __device__ constexpr int big_per_group(int chunks) {
  return kBigPerGroup < chunks ? kBigPerGroup : chunks;
}
__host__ __device__ constexpr int groups_of(int chunks) {
  return chunks / big_per_group(chunks);
}
constexpr int kGroups = groups_of(8);  // d = 64: S and W X_h, 8 chunks each
// The width-128 float32 kernel's S (16 k-chunks) sums its big steps in
// groups of 4 (see the section's comment).
constexpr int kWideBigPerGroup = 4;

// out (or out +, with kAdd) = the sum of the kG groups that issue(g, d)
// puts into d, added in group order on the CUDA cores.  Two accumulators
// take turns: group g runs on the tensor cores while group g - 1's sum is
// added.
template <int kG, bool kAdd, int kR, typename Issue>
__device__ __forceinline__ void grouped_sum(float (&out)[kR],
                                            float (&t)[2][kR], Issue issue) {
  wgmma_fence();
  issue(0, t[0]);
  wgmma_commit();
#pragma unroll
  for (int g = 1; g <= kG; ++g) {
    if (g < kG) {
      wgmma_fence();  // t[g & 1] was read by the CUDA cores
      issue(g, t[g & 1]);
      wgmma_commit();
      wgmma_wait<1>();  // group g - 1 has finished
    } else {
      wgmma_wait<0>();
    }
    float(&done)[kR] = t[(g - 1) & 1];
    pin_registers(done);
#pragma unroll
    for (int i = 0; i < kR; ++i)
      out[i] = (kAdd || g > 1) ? out[i] + done[i] : done[i];
  }
}

// d = 64.  x: [n, 64] rows 16-byte aligned; z: [m, 64] float32, holding
// Z0 on entry and the result on exit; partial: [gridDim.x, m, 64] scratch;
// arrived: a zeroed counter for the grid barriers.  blockDim.x = 128 *
// ceil(m / 64).  Shared memory: the ring of raw tiles, the split copies of
// a tile's two halves, the reduction scratch.
__global__ void __launch_bounds__(256, 1)
hill_tf32_kernel(const float* __restrict__ x, int n, int m, float kappa,
                 int max_iters, float* __restrict__ partial,
                 unsigned* __restrict__ arrived, float* __restrict__ z) {
  constexpr int kD = 64;
  constexpr int kPitch = kF32Pitch<kD>;
  constexpr int kRawElems = kHillTile * kPitch;
  extern __shared__ __align__(128) float tf32_smem[];
  float* ring = tf32_smem;
  unsigned* split = reinterpret_cast<unsigned*>(ring + kTf32Stages * kRawElems);
  float* red = reinterpret_cast<float*>(split + 8 * kHalfWords);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;  // rows of this warp: warpgroup warp / 4
  const int mine = tiles_of_block<kHillTile>(n);
  const int total = max_iters * mine;
  unsigned barriers = 0;

  issue_load<float, kD, kPitch, kTf32Stages, kHillTile>(x, n, 0, mine, total,
                                                         ring);
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
      issue_load<float, kD, kPitch, kTf32Stages, kHillTile>(x, n, q + 1, mine,
                                                             total, ring);
      const float* xs = ring + (q % kTf32Stages) * kRawElems;
      split_pixels<kD, kHalfTile>(xs, split);
      split_pixels<kD, kHalfTile>(xs + kHalfTile * kPitch,
                                  split + 4 * kHalfWords);
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
        grouped_sum<kGroups, false>(s, pair, [&](int grp, float (&d)[32]) {
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
        grouped_sum<kGroups, true>(acc, pair, [&](int grp, float (&d)[32]) {
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
    store_rows<kD>(rows, r0, m, nullptr,
                   partial + static_cast<size_t>(blockIdx.x) * m * kD);
    next_seeds<kD>(partial, m, red, z, arrived, barriers);
  }
  cp_async_wait<0>();
}

// d (64 x 32, fp32, the m64n32 accumulator layout) += a (64 x 8 tf32) * b
// (8 x 32 tf32), both K-major in shared memory, described by adesc and
// bdesc; with accumulate false, d = a * b.  Asynchronous, as wgmma_tf32.
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], uint64_t adesc,
                                               uint64_t bdesc,
                                               bool accumulate = true) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(adesc), "l"(bdesc), "r"(static_cast<int>(accumulate)));
}

// As above with a from registers (the m16n8k8 A layout per warp, as
// wgmma_tf32 takes it).
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16],
                                               const unsigned (&a)[4],
                                               uint64_t bdesc,
                                               bool accumulate = true) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc),
        "r"(static_cast<int>(accumulate)));
}

// Z in shared memory as a K-major operand: [dim / kPer][seed / 8] core
// matrices (kPer = 4 fp32 or 8 bf16 dims per 16-byte row), row = seed % 8;
// the word (or element) of seed s, dim j.
__device__ __forceinline__ int seed_word(int s, int j, int per) {
  return (((j / per) * (kMaxSeeds / 8) + s / 8) * 8 + s % 8) * per + j % per;
}

// The width-128 float32 kernel's block: ceil(m / 64) consumer warpgroups,
// which own the seeds and run the products, and one producer warpgroup,
// which loads and splits the tiles.  setmaxnreg moves registers from the
// producer to the consumers: the launch gives every thread the kernel's
// count (168 at 384 threads), the producer keeps kProducerRegs and each
// consumer takes kConsumerRegs, 2 * 216 + 72 <= 3 * 168.  Named barrier 2
// spans the consumers.
constexpr int kWideProducers = 128;
constexpr int kProducerRegs = 72;
constexpr int kConsumerRegs = 216;

// Z [m, 128] float32 -> this warp's rows [r0, r0 + 16), split as
// split_tf32_rn splits them (zero past m): the big parts into zb, the A
// fragments per k-chunk of 8 dims (rows g, g + 8 and dims t, t + 4 of the
// chunk, as hill_tf32_kernel holds its Z), the small parts into zsm in the
// seed_word layout.  The consumers (threads 0 .. consumers - 1) first copy
// the rows of their warpgroups into zsm with coalesced 16-byte loads (a
// warp: 8 rows of 64 bytes, its 8-thread phases on 8 distinct bank
// groups), then each thread splits its own fragments' words in place (a
// warp's 32 on 32 banks).
__device__ __forceinline__ void stage_wide_seeds(const float* z, int m, int r0,
                                                 int lane, int consumers,
                                                 unsigned (&zb)[kWideD / 8][4],
                                                 unsigned* zsm) {
  constexpr int kPer = 16;  // 16-byte loads a consumer thread
  float4 v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * consumers;
    const int s = 8 * (e / (8 * (kWideD / 4))) + e % 8;
    const int j = 4 * ((e / 8) % (kWideD / 4));
    v[i] = s < m ? __ldcg(reinterpret_cast<const float4*>(z + s * kWideD + j))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  static_assert(kPer * 128 == 64 * (kWideD / 4), "a warpgroup's rows");
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * consumers;
    const int s = 8 * (e / (8 * (kWideD / 4))) + e % 8;
    const int j = 4 * ((e / 8) % (kWideD / 4));
    *reinterpret_cast<float4*>(zsm + seed_word(s, j, 4)) = v[i];
  }
  bar_sync<2>(consumers);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kWideD / 8; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int s = r0 + g + 8 * (q & 1), j = 8 * kk + t + 4 * (q >> 1);
      unsigned& w = zsm[seed_word(s, j, 4)];
      unsigned small;
      split_tf32_rn(__uint_as_float(w), zb[kk][q], small);
      w = small;
    }
}

// The block's W X sums acc (this warp's m64n32 accumulators, 32 dims
// each) -> rows < m of partial ([m, 128]) through stage ([128][128]
// floats): each consumer warp writes float2s at column pairs p ^ 4 (row %
// 8) (a half warp's 16 on 32 banks), then copies whole rows with coalesced
// 16-byte stores.
__device__ __forceinline__ void store_wide_partial(const float (&acc)[4][16],
                                                   int r0, int m,
                                                   int consumers, float* stage,
                                                   float* partial) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 4; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = r0 + g + 8 * half, p = 16 * h + 4 * j + t;
        *reinterpret_cast<float2*>(stage + s * kWideD +
                                   2 * (p ^ (4 * (s % 8)))) =
            make_float2(acc[h][4 * j + 2 * half],
                        acc[h][4 * j + 2 * half + 1]);
      }
  bar_sync<2>(consumers);
  for (int s = warp; s < m; s += consumers / 32)
    reinterpret_cast<float4*>(partial + s * kWideD)[lane] =
        *reinterpret_cast<const float4*>(stage + s * kWideD +
                                         2 * ((2 * lane) ^ (4 * (s % 8))));
}

// Seed row r of the next Z at d = 128, by the consumers: group q of 32
// threads sums the partials of blocks q, q + groups, ... in block order (a
// float4 a thread, kPer loads in flight), then warp 0 adds the groups in
// order and writes z[r] = v / max(||v||, 1e-12).  red: [consumers / 32][128]
// floats.
__device__ __forceinline__ void reduce_row_wide(const float* partial, int m,
                                                int r, int consumers,
                                                float* red, float* z) {
  constexpr int kPer = 18;
  const int groups = consumers / 32, q = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int blocks = gridDim.x;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int b0 = q; b0 < blocks; b0 += kPer * groups) {
    float4 v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int b = b0 + i * groups;
      v[i] = b < blocks
                 ? __ldcg(reinterpret_cast<const float4*>(
                              partial +
                              (static_cast<size_t>(b) * m + r) * kWideD) +
                          lane)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (b0 + i * groups < blocks) {
        acc.x += v[i].x;
        acc.y += v[i].y;
        acc.z += v[i].z;
        acc.w += v[i].w;
      }
    }
  }
  reinterpret_cast<float4*>(red + q * kWideD)[lane] = acc;
  bar_sync<2>(consumers);
  if (q == 0) {
    float4 v = reinterpret_cast<const float4*>(red)[lane];
    for (int k = 1; k < groups; ++k) {
      const float4 u = reinterpret_cast<const float4*>(red + k * kWideD)[lane];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    float ss = fmaf(v.w, v.w, fmaf(v.z, v.z, fmaf(v.y, v.y, v.x * v.x)));
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xFFFFFFFFu, ss, off);
    const float den = fmaxf(sqrtf(ss), 1e-12f);
    reinterpret_cast<float4*>(z + r * kWideD)[lane] =
        make_float4(v.x / den, v.y / den, v.z / den, v.w / den);
  }
  bar_sync<2>(consumers);  // red is free again
}

// uoc::grid_barrier over the consumers only (the producer may still be
// splitting the next iteration's tiles).
__device__ __forceinline__ void consumer_grid_barrier(unsigned* arrived,
                                                      unsigned q,
                                                      int consumers) {
  bar_sync<2>(consumers);
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrived, 1u);
    const unsigned target = q * gridDim.x;
    while (uoc::load_acquire(arrived) < target) {
    }
  }
  bar_sync<2>(consumers);
}

// A study build (-DHILL_CLOCKS, hill_climb_study.py) records, for each
// block and iteration of hill_tf32_wide_kernel, consumer thread 0's
// clock64 at the iteration's start, after Z is staged, after the tiles,
// after the partial is stored, after the first grid barrier, after the
// reduction and after the second barrier (marks 0, 1, 2, 3, 4, 5, 6), and
// its cycles summed over the tiles in S, in the wait for the producer's
// split copies, in W's exp and split, in W X and in the release of the
// stage (7-11); and the first producer thread's cycles summed over the
// iteration's tiles in the wait for their loads, in the wait for a free
// stage, in the split and in the release and the next load (12-15).
// hill_bf16_wide_kernel records marks 0-6 the same way, its consumer
// thread 0's cycles summed over the tiles in the wait for a tile to land,
// from issuing the next tile's S and this tile's W X to the end of S, in
// W's exp, in the wait for W X and in the release of the stage (7-11), and
// its producer thread's cycles in the wait for a free stage and in
// issuing the loads (12, 13).
#ifdef HILL_CLOCKS
constexpr int kClockBlocks = 160, kClockIters = 16, kHillMarks = 16;
__device__ long long hill_clocks[kClockBlocks][kClockIters][kHillMarks];
__device__ __forceinline__ long long hill_now() { return clock64(); }
__device__ __forceinline__ void hill_mark(bool me, int it, int at,
                                          long long value) {
  if (me && blockIdx.x < kClockBlocks && it < kClockIters)
    hill_clocks[blockIdx.x][it][at] = value;
}
#else
__device__ __forceinline__ long long hill_now() { return 0; }
__device__ __forceinline__ void hill_mark(bool, int, int, long long) {}
#endif

// Producer warp w of the width-128 kernel owns pixels [8 w, 8 w + 8) of
// every tile: it loads their raw rows itself and splits them (passes 256 w
// + lane + 32 j of each layout, j < 8, in batches of kSplitBatch whose
// loads are issued before their stores), so the producer's warps never
// wait for each other.
constexpr int kSplitBatch = 4;

template <bool kSecond>
__device__ __forceinline__ void split_batches(const float* xs, unsigned* buf,
                                              int e0) {
#pragma unroll
  for (int i = 0; i < 8; i += kSplitBatch) {
    float4 v[kSplitBatch];
#pragma unroll
    for (int j = 0; j < kSplitBatch; ++j)
      v[j] = split_load<kWideD, kWideTile, kSecond>(xs, e0 + 32 * (i + j));
#pragma unroll
    for (int j = 0; j < kSplitBatch; ++j)
      split_store<kWideD, kWideTile, kSecond>(buf, e0 + 32 * (i + j), v[j]);
  }
}

__device__ __forceinline__ void split_share(const float* xs, unsigned* buf,
                                            int w, int lane) {
  split_batches<false>(xs, buf, 256 * w + lane);
  split_batches<true>(xs, buf, 256 * w + lane);
}

// d = 128 (see the section's comment).  x: [n, 128] rows 16-byte aligned;
// z: [m, 128] float32, Z0 on entry, the result on exit, rows 16-byte
// aligned; partial: [gridDim.x, m, 128] scratch; arrived as above.
// blockDim.x = 128 * ceil(m / 64) consumers + kWideProducers.  Shared
// memory: Z's small part (the consumers' scratch between iterations),
// kWideStages stages of a tile's four split copies, the ring of kWideRaw
// raw tiles, and the stages' mbarriers: full[s] (the producer has split a
// tile into stage s) and empty[s] (every consumer is done with it).  The
// q-th tile of the launch (q = it * mine + k) is loaded two tiles ahead
// into ring slot q % kWideRaw and split into stage q % kWideStages; the
// producer runs on into the next iteration's tiles while the consumers
// reduce.
__global__ void __launch_bounds__(256 + kWideProducers, 1)
hill_tf32_wide_kernel(const float* __restrict__ x, int n, int m, float kappa,
                      int max_iters, float* __restrict__ partial,
                      unsigned* __restrict__ arrived, float* __restrict__ z) {
  constexpr int kD = kWideD;
  constexpr int kPitch = kF32Pitch<kD>;
  constexpr int kRawElems = kWideTile * kPitch;
  constexpr int kStageWords = 4 * kWideTileWords;
  constexpr int kBigS = kWideBigPerGroup;               // S: 16 chunks
  constexpr int kBigW = big_per_group(kWideTile / 8);   // W X: 4 chunks
  static_assert((kD / 8) % kBigS == 0, "S's groups");
  static_assert(kWideRaw == 2 && kWideStages == 2, "loads two tiles ahead");
  extern __shared__ __align__(128) float wide_smem[];
  unsigned* zsm = reinterpret_cast<unsigned*>(wide_smem);
  unsigned* stages = zsm + kWideZWords;
  float* ring = reinterpret_cast<float*>(stages + kWideStages * kStageWords);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(ring + kWideRaw * kRawElems);
  unsigned long long* empty = full + kWideStages;
  const int consumers = blockDim.x - kWideProducers;
  const int mine = tiles_of_block<kWideTile>(n);
  const int total = max_iters * mine;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWideStages; ++s) {
      uoc::mbar_init(full + s, kWideProducers);
      uoc::mbar_init(empty + s, consumers);
    }
  }
  __syncthreads();

  if (static_cast<int>(threadIdx.x) >= consumers) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int t = threadIdx.x - consumers;
    const int w = t / 32, lane = t % 32;  // pixels [8 w, 8 w + 8) of a tile
    const auto load = [&](int q) {
      if (q < total) {
        const int p0 =
            (static_cast<int>(blockIdx.x) + (q % mine) * gridDim.x) *
                kWideTile + 8 * w;
        float* rows = ring + (q % kWideRaw) * kRawElems + 8 * w * kPitch;
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // a row of 512 bytes a step
          const bool ok = p0 + j < n;
          cp_async16(rows + j * kPitch + 4 * lane,
                     ok ? x + static_cast<size_t>(p0 + j) * kD + 4 * lane : x,
                     ok);
        }
      }
      cp_async_commit();
    };
    load(0);
    load(1);
    long long spent[4] = {0, 0, 0, 0};  // with HILL_CLOCKS
    for (int q = 0; q < total; ++q) {
      const long long c0 = hill_now();
      cp_async_wait<1>();  // tile q has landed
      __syncwarp();        // ... for every lane
      const long long c1 = hill_now();
      if (q >= kWideStages)  // tile q - 2 is done with
        uoc::mbar_wait(empty + q % kWideStages,
                       (q / kWideStages - 1) & 1);
      const long long c2 = hill_now();
      split_share(ring + (q % kWideRaw) * kRawElems,
                  stages + (q % kWideStages) * kStageWords, w, lane);
      const long long c3 = hill_now();
      uoc::fence_proxy_async();  // the copies are read by wgmma
      uoc::mbar_arrive(full + q % kWideStages);
      __syncwarp();  // the warp's raw rows of tile q are read
      load(q + kWideRaw);
      spent[0] += c1 - c0;
      spent[1] += c2 - c1;
      spent[2] += c3 - c2;
      spent[3] += hill_now() - c3;
      if ((q + 1) % mine == 0) {  // the iteration's last tile
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hill_mark(t == 0, q / mine, 12 + i, spent[i]);
          spent[i] = 0;
        }
      }
    }
    cp_async_wait<0>();
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;   // this warpgroup's seeds: [64 wg, 64 wg + 64)
  const int r0 = 16 * warp;  // rows of this warp's accumulators
  unsigned barriers = 0;
  // K-chunk kk (8 dims) of this warpgroup's rows of Z's small part, and of
  // a tile's X in the [pixel][dim] layout
  const auto zdesc = [&](int kk) {
    return smem_desc(zsm + (2 * kk * (kMaxSeeds / 8) + 8 * wg) * (kCore / 4),
                     (kMaxSeeds / 8) * kCore, kCore);
  };
  const auto xdesc = [&](const unsigned* p, int kk) {
    return smem_desc(p + 2 * kk * (kWideTile / 8) * (kCore / 4),
                     (kWideTile / 8) * kCore, kCore);
  };
  for (int it = 0; it < max_iters; ++it) {
    hill_mark(threadIdx.x == 0, it, 0, hill_now());
    unsigned zb[kD / 8][4];
    stage_wide_seeds(z, m, r0, lane, consumers, zb, zsm);
    uoc::fence_proxy_async();  // Z's small part is read by wgmma
    bar_sync<2>(consumers);
    long long spent[5] = {0, 0, 0, 0, 0};  // with HILL_CLOCKS
    hill_mark(threadIdx.x == 0, it, 1, hill_now());
    float acc[4][16];  // seeds x dims [32 h, 32 h + 32)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i / 16][i % 16] = 0.0f;

    for (int k = 0; k < mine; ++k) {
      const int q = it * mine + k;
      long long c0 = hill_now();
      uoc::mbar_wait(full + q % kWideStages, (q / kWideStages) & 1);
      long long c1 = hill_now();
      spent[1] += c1 - c0;
      const unsigned* pb = stages + (q % kWideStages) * kStageWords;
      const unsigned* ps = pb + kWideTileWords;      // [pixel][dim] small
      const unsigned* qb = pb + 2 * kWideTileWords;  // [dim][pixel] big
      const unsigned* qs = pb + 3 * kWideTileWords;  // [dim][pixel] small
      // S (64 seeds x 32 pixels) = Z X^T: K = dims, 8 per wgmma
      float s[16], spair[2][16];
      grouped_sum<(kD / 8) / kBigS, false>(
          s, spair, [&](int grp, float (&d)[16]) {
            if (grp == 0) {
#pragma unroll
              for (int kk = 0; kk < kD / 8; ++kk) {
                wgmma_tf32_n32(d, zdesc(kk), xdesc(pb, kk), kk > 0);
                wgmma_tf32_n32(d, zb[kk], xdesc(ps, kk));
              }
            }
#pragma unroll
            for (int j = 0; j < kBigS; ++j) {
              const int kk = grp * kBigS + j;
              wgmma_tf32_n32(d, zb[kk], xdesc(pb, kk), grp == 0 || j > 0);
            }
          });
      c0 = hill_now();
      spent[0] += c0 - c1;
      // W as the A operand over pixel chunks of 8, as in hill_tf32_kernel
      unsigned wb[4][4], ws[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_tf32_rn(expf(kappa * s[4 * kc + (i & 1) * 2 + (i >> 1)]),
                        wb[kc][i], ws[kc][i]);
      c1 = hill_now();
      spent[2] += c1 - c0;
      // acc[h] (64 seeds x 32 dims) += W X_h: K = pixels, 8 per wgmma
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        float pair[2][16];
        grouped_sum<groups_of(kWideTile / 8), true>(
            acc[h], pair, [&](int grp, float (&d)[16]) {
              const auto desc = [&](const unsigned* p, int kc) {
                return smem_desc(
                    p + (2 * kc * (kD / 8) + 4 * h) * (kCore / 4),
                    (kD / 8) * kCore, kCore);
              };
              if (grp == 0) {
#pragma unroll
                for (int kc = 0; kc < 4; ++kc) {
                  wgmma_tf32_n32(d, ws[kc], desc(qb, kc), kc > 0);
                  wgmma_tf32_n32(d, wb[kc], desc(qs, kc));
                }
              }
#pragma unroll
              for (int j = 0; j < kBigW; ++j) {
                const int kc = grp * kBigW + j;
                wgmma_tf32_n32(d, wb[kc], desc(qb, kc), grp == 0 || j > 0);
              }
            });
      }
      pin_registers(wb);
      pin_registers(ws);
      c0 = hill_now();
      spent[3] += c0 - c1;
      uoc::mbar_arrive(empty + q % kWideStages);  // its wgmmas have finished
      spent[4] += hill_now() - c0;
    }
    hill_mark(threadIdx.x == 0, it, 2, hill_now());
#pragma unroll
    for (int i = 0; i < 5; ++i)
      hill_mark(threadIdx.x == 0, it, 7 + i, spent[i]);

    // Z's small part is free: every consumer's S has finished
    bar_sync<2>(consumers);
    store_wide_partial(acc, r0, m, consumers, wide_smem,
                       partial + static_cast<size_t>(blockIdx.x) * m * kD);
    hill_mark(threadIdx.x == 0, it, 3, hill_now());
    consumer_grid_barrier(arrived, ++barriers, consumers);  // partials written
    hill_mark(threadIdx.x == 0, it, 4, hill_now());
    for (int r = blockIdx.x; r < m; r += gridDim.x)
      reduce_row_wide(partial, m, r, consumers, wide_smem, z);
    hill_mark(threadIdx.x == 0, it, 5, hill_now());
    consumer_grid_barrier(arrived, ++barriers, consumers);  // new Z written
    hill_mark(threadIdx.x == 0, it, 6, hill_now());
  }
}

// As hill_tf32_kernel, for bf16 X of width 64 on mma.sync; blockDim.x =
// 64 * ceil(m / 16).  Shared memory: the ring of tiles, the second half's
// sums [16 * groups][kD], the reduction scratch, bf16(Z) [16 * groups][kD
// + 8].
__global__ void __launch_bounds__(kBf16Threads, 1)
hill_bf16_kernel(const __nv_bfloat16* __restrict__ x, int n, int m,
                 float kappa, int max_iters, float* __restrict__ partial,
                 unsigned* __restrict__ arrived, float* __restrict__ z) {
  constexpr int kD = 64;
  constexpr int kPitch = kMmaPitch<kD>;
  constexpr int kStageElems = kHillTile * kPitch;
  extern __shared__ __align__(16) float bf16_smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(bf16_smem);
  float* other = bf16_smem + kStages * kStageElems / 2;
  const int groups = blockDim.x / 64;
  float* red = other + 16 * groups * kD;
  __nv_bfloat16* zs = reinterpret_cast<__nv_bfloat16*>(red + kRedFloats<kD>);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = warp / groups;
  const int r0 = 16 * (warp % groups);
  const int mine = tiles_of_block<kHillTile>(n);
  const int total = max_iters * mine;
  unsigned barriers = 0;

#pragma unroll
  for (int q = 0; q < kStages - 1; ++q)
    issue_load<__nv_bfloat16, kD, kPitch, kStages, kHillTile>(x, n, q, mine,
                                                              total, ring);
  for (int it = 0; it < max_iters; ++it) {
    HillBF16 w;
    w.load_seeds(z, m, r0, lane, zs);
    float acc[kD / 8][4];
#pragma unroll
    for (int t = 0; t < kD / 8; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[t][q] = 0.0f;

    for (int k = 0; k < mine; ++k) {
      const int q = it * mine + k;
      cp_async_wait<kStages - 2>();  // load q has landed
      __syncthreads();  // ... for every thread; tile q-1 is done with
      issue_load<__nv_bfloat16, kD, kPitch, kStages, kHillTile>(
          x, n, q + kStages - 1, mine, total, ring);
      // a warp takes its half of the tile
      w.tile(ring + (q % kStages) * kStageElems, half, lane, kappa, acc);
    }

    float* out = partial + static_cast<size_t>(blockIdx.x) * m * kD;
    // the two halves' sums, added in a fixed order, are the partial
    if (half == 1) store_rows<kD>(acc, r0, 16 * groups, nullptr, other);
    __syncthreads();
    if (half == 0) store_rows<kD>(acc, r0, m, other, out);
    next_seeds<kD>(partial, m, red, z, arrived, barriers);
  }
  cp_async_wait<0>();
}

// bfloat16 at d = 128 (hill_bf16_wide_kernel; see the section's comment):
// pixels per tile, dims per TMA box (one 128-byte swizzled row a pixel),
// the bytes of a box and of a tile, the ring's stages, the tiles a block
// keeps in shared memory for the whole launch, the producer's threads (a
// warpgroup, so that setmaxnreg can give its registers to the consumers:
// the launch gives every thread the kernel's count, 168 at 384 threads,
// and 2 * kBWConsumerRegs + kBWProducerRegs <= 3 * 168).
constexpr int kBWTile = 64;
constexpr int kBWBox = 64;
constexpr int kBWBoxBytes = kBWTile * kBWBox * 2;
constexpr int kBWTileBytes = 2 * kBWBoxBytes;
constexpr int kBWStages = 5;
constexpr int kBWResident = 8;
constexpr int kBWProducer = 128;
constexpr int kBWThreads = 2 * 128 + kBWProducer;
constexpr int kBWProducerRegs = 40;
constexpr int kBWConsumerRegs = 232;

// d (64 x 64, fp32, the m64n64 accumulator layout) += a (64 x 16 bf16
// from registers, the m16n8k16 A layout per warp) * b (16 x 64 bf16,
// K-major in shared memory, described by desc); with accumulate false, d
// = a * b.  Asynchronous, as wgmma_tf32.
__device__ __forceinline__ void wgmma_bf16(float (&d)[32],
                                           const unsigned (&a)[4],
                                           uint64_t desc,
                                           bool accumulate = true) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(static_cast<int>(accumulate)));
}

// d (64 x 128, fp32, the m64n128 accumulator layout) += a (64 x 16 bf16
// from registers) * b (16 x 128 bf16, MN-major in shared memory: the
// transpose flag).  Asynchronous, as wgmma_tf32.
__device__ __forceinline__ void wgmma_bf16_n128_mn(float (&d)[64],
                                                   const unsigned (&a)[4],
                                                   uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The descriptor of an operand in shared memory with the 128-byte swizzle
// (atoms of 8 rows of 128 bytes, 1024-byte aligned): p its start (an
// atom's, or 32 bytes a k-step into a K-major atom), lbo the bytes between
// atoms along M/N (MN-major; unused K-major), sbo the bytes between 8-row
// groups.
__device__ __forceinline__ uint64_t sw128_desc(unsigned p, unsigned lbo,
                                               unsigned sbo) {
  return static_cast<uint64_t>((p >> 4) & 0x3FFFu) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Box {c0 (dims), c1 (pixels)} of the tensor map -> shared memory at dst,
// completing on bar; rows past n land as zeros.
__device__ __forceinline__ void tma_load_box(void* dst, const CUtensorMap* map,
                                             int c0, int c1, void* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// The k-th tile (0 <= k < resident + streamed) that a block sums in
// iteration it, as the block's own tile index i (the tile blockIdx.x + i *
// gridDim.x): its resident tiles 0 .. resident - 1 first, then its
// streamed ones, ascending on even iterations and descending on odd ones.
__device__ __forceinline__ int bw_tile(int it, int k, int resident,
                                       int streamed) {
  if (k < resident) return k;
  const int j = k - resident;
  return resident + ((it & 1) ? streamed - 1 - j : j);
}

// Z [m, 128] float32 -> bf16(Z) rows [r0, r0 + 16) as wgmma A fragments
// per k-chunk of 16 dims (zero past m).  Lane (g, t) loads dims [16 kk +
// 4 t, + 4) of rows r0 + g and r0 + g + 8 (a row's 64 bytes over 4 lanes)
// and takes the pairs that its fragments hold, (2 t, 2 t + 1) and (2 t +
// 8, 2 t + 9), from lanes 4 g + t / 2 and 4 g + 2 + t / 2.
__device__ __forceinline__ void load_wide_bf16_seeds(const float* z, int m,
                                                     int r0, int lane,
                                                     unsigned (&za)[8][4]) {
  const int g = lane >> 2, t = lane & 3;
  float4 v[8][2];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      v[kk][h] = r < m ? __ldcg(reinterpret_cast<const float4*>(
                             z + r * kWideD + 16 * kk + 4 * t))
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  const int lo = 4 * g + t / 2, hi = lo + 2;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned p0 = pack_bf16(v[kk][h].x, v[kk][h].y);
      const unsigned p1 = pack_bf16(v[kk][h].z, v[kk][h].w);
      const unsigned x0 = __shfl_sync(0xFFFFFFFFu, p0, lo);
      const unsigned x1 = __shfl_sync(0xFFFFFFFFu, p1, lo);
      const unsigned y0 = __shfl_sync(0xFFFFFFFFu, p0, hi);
      const unsigned y1 = __shfl_sync(0xFFFFFFFFu, p1, hi);
      za[kk][h] = (t & 1) ? x1 : x0;
      za[kk][2 + h] = (t & 1) ? y1 : y0;
    }
}

// S (64 seeds x 64 pixels) = Z X^T over the tile at shared address xs:
// k-chunk kk is dims [16 kk, 16 kk + 16), 32 bytes into box kk / 4's rows.
__device__ __forceinline__ void bw_similarity(float (&s)[32],
                                              const unsigned (&za)[8][4],
                                              unsigned xs) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_bf16(s, za[kk],
               sw128_desc(xs + (kk / 4) * kBWBoxBytes + (kk % 4) * 32, 0,
                          1024),
               kk > 0);
}

// 2^a on the MUFU (flushes denormal results to 0; at most 2 ulp off).
__device__ __forceinline__ float ex2_approx(float a) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(a));
  return r;
}

// W = bf16(exp(kappa S)) = bf16(2^(k2 S)), k2 = kappa log2(e) rounded to
// float32 once, as the A operand over pixel chunks of 16 (the m64n64
// accumulator's columns 16 kc + (2 t, 2 t + 1, 2 t + 8, 2 t + 9) are the A
// fragment's k columns).
__device__ __forceinline__ void bw_weights(const float (&s)[32], float k2,
                                           unsigned (&w)[4][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[kc][i] = pack_bf16(ex2_approx(k2 * s[8 * kc + 2 * i]),
                           ex2_approx(k2 * s[8 * kc + 2 * i + 1]));
}


// acc (64 seeds x 128 dims) += W X over the tile at xs: k-chunk kc is
// pixels [16 kc, 16 kc + 16), two 8-row groups 1024 bytes apart; its 128
// dims are the two boxes, kBWBoxBytes apart.
__device__ __forceinline__ void bw_accumulate(float (&acc)[64],
                                              const unsigned (&w)[4][4],
                                              unsigned xs) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
    wgmma_bf16_n128_mn(acc, w[kc],
                       sw128_desc(xs + kc * 2048, kBWBoxBytes, 1024));
}

// d = 128, bfloat16 X (see the section's comment).  xmap: X [n, 128] as a
// TMA map of 64 x 64 boxes with the 128-byte swizzle; z: [m, 128] float32,
// Z0 on entry, the result on exit, rows 16-byte aligned; partial:
// [gridDim.x, m, 128] scratch; arrived as above.  blockDim.x = 128 *
// ceil(m / 64) consumers + kBWProducer.  Shared memory (from a 1024-byte
// boundary): the ring of kBWStages tiles, kBWResident resident tiles, the
// reduction's [8][128] floats, the mbarriers: full[s] (a tile has landed
// in stage s), empty[s] (every consumer is done with it), loaded[k]
// (resident tile k has landed, once).  The q-th streamed tile of the
// launch (q = it * streamed + j) goes to stage q % kBWStages; the producer
// runs on into the next iteration's tiles while the consumers reduce.
__global__ void __launch_bounds__(kBWThreads, 1)
hill_bf16_wide_kernel(const __grid_constant__ CUtensorMap xmap, int n, int m,
                      float kappa, int max_iters, float* __restrict__ partial,
                      unsigned* __restrict__ arrived, float* __restrict__ z) {
  extern __shared__ __align__(1024) unsigned char bw_smem[];
  unsigned char* ring = bw_smem + (1024 - smem_addr(bw_smem) % 1024) % 1024;
  unsigned char* resident_tiles = ring + kBWStages * kBWTileBytes;
  float* red =
      reinterpret_cast<float*>(resident_tiles + kBWResident * kBWTileBytes);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(red + 8 * kWideD);
  unsigned long long* empty = full + kBWStages;
  unsigned long long* loaded = empty + kBWStages;
  const int consumers = blockDim.x - kBWProducer;
  const int mine = tiles_of_block<kBWTile>(n);
  const int resident = min(mine, kBWResident);
  const int streamed = mine - resident;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBWStages; ++s) {
      uoc::mbar_init(full + s, 1);
      uoc::mbar_init(empty + s, consumers);
    }
    for (int k = 0; k < kBWResident; ++k) uoc::mbar_init(loaded + k, 1);
  }
  __syncthreads();

  if (static_cast<int>(threadIdx.x) >= consumers) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kBWProducerRegs));
    if (static_cast<int>(threadIdx.x) != consumers) return;
    const auto load = [&](int i, unsigned char* dst, void* bar) {
      const int p0 = (static_cast<int>(blockIdx.x) + i * gridDim.x) * kBWTile;
      uoc::mbar_expect(bar, kBWTileBytes);
      tma_load_box(dst, &xmap, 0, p0, bar);
      tma_load_box(dst + kBWBoxBytes, &xmap, kBWBox, p0, bar);
    };
    for (int k = 0; k < resident; ++k)
      load(k, resident_tiles + k * kBWTileBytes, loaded + k);
    long long spent[2] = {0, 0};  // with HILL_CLOCKS
    for (int q = 0; q < max_iters * streamed; ++q) {
      const int s = q % kBWStages, it = q / streamed;
      const long long c0 = hill_now();
      if (q >= kBWStages)  // the stage's last tile is done with
        uoc::mbar_wait(empty + s, (q / kBWStages - 1) & 1);
      const long long c1 = hill_now();
      load(bw_tile(it, resident + q % streamed, resident, streamed),
           ring + s * kBWTileBytes, full + s);
      spent[0] += c1 - c0;
      spent[1] += hill_now() - c1;
      if ((q + 1) % streamed == 0) {  // the iteration's last tile
        hill_mark(true, it, 12, spent[0]);
        hill_mark(true, it, 13, spent[1]);
        spent[0] = spent[1] = 0;
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kBWConsumerRegs));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * warp;  // rows of this warp; its warpgroup's: warp / 4
  const int g = lane >> 2, t = lane & 3;
  const bool me = threadIdx.x == 0;  // the clocked thread
  const float k2 = kappa * 1.44269504088896341f;  // kappa log2(e)
  unsigned barriers = 0;
  for (int it = 0; it < max_iters; ++it) {
    hill_mark(me, it, 0, hill_now());
    unsigned za[8][4];
    load_wide_bf16_seeds(z, m, r0, lane, za);
    // every register that a wgmma reads is written before the
    // wgmma.fence: one written between the fence and the wgmma makes
    // ptxas serialize the wgmmas
    pin_registers(za);
    hill_mark(me, it, 1, hill_now());
    long long spent[5] = {0, 0, 0, 0, 0};  // with HILL_CLOCKS
    // the k-th tile of this iteration, once it has landed: its address
    const auto tile_at = [&](int k) {
      const long long c0 = hill_now();
      unsigned char* xs;
      if (k < resident) {
        uoc::mbar_wait(loaded + k, 0);
        xs = resident_tiles + k * kBWTileBytes;
      } else {
        const int q = it * streamed + k - resident;
        uoc::mbar_wait(full + q % kBWStages, (q / kBWStages) & 1);
        xs = ring + (q % kBWStages) * kBWTileBytes;
      }
      spent[0] += hill_now() - c0;
      return smem_addr(xs);
    };
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    pin_registers(acc);
    // tile k is done with: free its stage
    const auto release = [&](int k) {
      const long long c0 = hill_now();
      if (k >= resident)
        uoc::mbar_arrive(empty + (it * streamed + k - resident) % kBWStages);
      spent[4] += hill_now() - c0;
    };
    float s[32];
    unsigned w[4][4], next[4][4];
    unsigned xs = tile_at(0);
    wgmma_fence();
    bw_similarity(s, za, xs);
    wgmma_commit();
    wgmma_wait<0>();
    pin_registers(s);
    bw_weights(s, k2, w);
    pin_registers(w);
    // Tile k: the next tile's S is issued before this tile's W X (wc), and
    // the next W (wn) is computed on the CUDA cores while W X runs on the
    // tensor cores.  The loop takes two tiles a turn so that the two W
    // buffers swap roles without a copy: ptxas serializes the wgmmas when
    // a register that one reads may be written while it runs, which a copy
    // between them allowed (see the section's comment).
    const auto step = [&](int k, unsigned (&wc)[4][4], unsigned (&wn)[4][4]) {
      const unsigned xn = tile_at(k + 1);
      const long long c0 = hill_now();
      wgmma_fence();
      bw_similarity(s, za, xn);
      wgmma_commit();
      bw_accumulate(acc, wc, xs);
      wgmma_commit();
      wgmma_wait<1>();  // the next tile's S has finished
      pin_registers(s);
      const long long c1 = hill_now();
      bw_weights(s, k2, wn);
      const long long c2 = hill_now();
      wgmma_wait<0>();  // this tile's W X has finished
      pin_registers(acc);
      pin_registers(wc);
      pin_registers(wn);
      spent[1] += c1 - c0;
      spent[2] += c2 - c1;
      spent[3] += hill_now() - c2;
      release(k);
      xs = xn;
    };
    // the last tile's W X
    const auto last = [&](unsigned (&wc)[4][4]) {
      const long long c0 = hill_now();
      wgmma_fence();
      bw_accumulate(acc, wc, xs);
      wgmma_commit();
      wgmma_wait<0>();
      pin_registers(acc);
      pin_registers(wc);
      spent[3] += hill_now() - c0;
      release(mine - 1);
    };
    int k = 0;
    for (; k + 2 < mine; k += 2) {
      step(k, w, next);
      step(k + 1, next, w);
    }
    if (k + 2 == mine) {
      step(k, w, next);
      last(next);
    } else {
      last(w);
    }
    hill_mark(me, it, 2, hill_now());
#pragma unroll
    for (int i = 0; i < 5; ++i) hill_mark(me, it, 7 + i, spent[i]);

    // the block's partial: rows < m of the accumulators, as float2s
    float* out = partial + static_cast<size_t>(blockIdx.x) * m * kWideD;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h;
        if (r < m)
          *reinterpret_cast<float2*>(out + r * kWideD + 8 * j + 2 * t) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    hill_mark(me, it, 3, hill_now());
    consumer_grid_barrier(arrived, ++barriers, consumers);  // partials written
    hill_mark(me, it, 4, hill_now());
    for (int r = blockIdx.x; r < m; r += gridDim.x)
      reduce_row_wide(partial, m, r, consumers, red, z);
    hill_mark(me, it, 5, hill_now());
    consumer_grid_barrier(arrived, ++barriers, consumers);  // new Z written
    hill_mark(me, it, 6, hill_now());
  }
}

size_t hill_bf16_wide_smem_bytes() {
  return 1024 + static_cast<size_t>(kBWStages + kBWResident) * kBWTileBytes +
         sizeof(float) * 8 * kWideD +
         sizeof(unsigned long long) * (2 * kBWStages + kBWResident);
}

// X [n, 128] (16-byte aligned) as a TMA map of boxes of `box_dims` dims x
// `box_rows` pixels of `bytes`-byte elements of `type`, 128-byte swizzle
// (box_dims * bytes = 128), zeros past n.  The driver's encoder is reached
// through the runtime (no link to libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t wide_rows_map(const void* x, int n, CUtensorMapDataType type,
                          int bytes, int box_dims, int box_rows,
                          CUtensorMap* map) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kWideD),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kWideD) * bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_dims),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, type, 2, const_cast<void*>(x), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// X [n, 128] bf16 as hill_bf16_wide_kernel's map: boxes of 64 x 64.
cudaError_t wide_bf16_map(const void* x, int n, CUtensorMap* map) {
  return wide_rows_map(x, n, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       sizeof(__nv_bfloat16), kBWBox, kBWTile, map);
}

// Bytes of X that hill_bf16_wide_kernel's `grid` blocks keep on chip for
// the whole launch: each block's first kBWResident tiles.
long long wide_bf16_resident_bytes(int n, int grid) {
  const int tiles = (n + kBWTile - 1) / kBWTile;
  long long bytes = 0;
  for (int b = 0; b < grid; ++b) {
    const int mine = (tiles - b + grid - 1) / grid;
    for (int i = 0; i < std::min(mine, kBWResident); ++i)
      bytes += 2LL * kWideD * std::min(kBWTile, n - (b + i * grid) * kBWTile);
  }
  return bytes;
}

// ---------------------------------------------------------------------------
// Hill climbing at d = 256 (hill_simt_kernel<T>, float32 and bfloat16 X):
// the cat fusion of two 128-unit heads.  A simple design on the CUDA cores
// (fp32 FMA), one persistent cooperative launch for all iterations, for up
// to kSimtRows = 64 seed rows a launch (the wrapper runs groups of at most
// 64: split TF32 Z for 128 seeds would take 256 KB of shared memory).
//
// Bound on the H100: 4*m*n*d flops per iteration, 315 GFLOP for 10
// iterations at m = 100, n = 307200 (4.7 ms at 67 TFLOP/s of fp32 FMA),
// against X read once per iteration and group (315 MB float32 at the frame).
//
// Design: one block of 256 threads per SM.  Each iteration the block
// stages the launch's rows of Z in shared memory (bf16 X: rounded to bf16
// and widened, as the plain version rounds Z), then walks its 64-pixel
// tiles (tile blockIdx.x + k * gridDim.x): the tile's X is staged (widened
// to fp32), S = Z X^T is computed as 64 x 64 sums (a thread 4 seeds x 4
// pixels), W = exp(kappa S) (bf16 X: rounded to bf16; 0 past n) goes to
// shared memory, and acc += W X (a thread 16 seeds x 4 dims), each tile's
// sum an FMA chain over its 64 pixels in a fresh accumulator, added to the
// block's running sum.  After a grid barrier, block b reduces seed rows b,
// b + grid, ... over the blocks' partials in block order in fp64 (the same
// result run to run) and normalizes them; a second barrier publishes Z.
//
// S's accuracy: each dot is taken as 8 FMA chains of 32 dims, each chain
// from 0 and added in order to the dot's total.  A chain's rounding errors
// add up to at most 32 u (u = 2^-24) times the sum of its |z_j x_j|, the 7
// adds of the totals to at most 7 u times the sum over all dims, and the
// sum of |z_j x_j| over all dims is at most |z||x| = 1: |S - S_exact| <=
// 39 * 2^-24 = 2.3e-6, below the 2.5e-6 that the split-TF32 design keeps
// at d = 128 (a single 256-long chain, the plain version's arithmetic,
// would allow 256 * 2^-24 = 1.5e-5).
// ---------------------------------------------------------------------------
constexpr int kSimtD = 256;
constexpr int kSimtRows = 64;
constexpr int kSimtTile = 64;
constexpr int kSimtThreads = 256;
constexpr int kSimtChunk = 32;                // dims of one chain of S
constexpr int kSimtPitch = kF32Pitch<kSimtD>;  // floats a row of Z or X
constexpr int kSimtWPitch = kSimtTile + 4;     // floats a row of W

constexpr size_t hill_simt_smem_bytes() {
  return sizeof(float) * ((kSimtRows + kSimtTile) * kSimtPitch +
                          kSimtRows * kSimtWPitch);
}

// Four consecutive elements of x's type at p (8- or 16-byte aligned),
// widened to fp32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(r.x << 16),
                     __uint_as_float(r.x & 0xFFFF0000u),
                     __uint_as_float(r.y << 16),
                     __uint_as_float(r.y & 0xFFFF0000u));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(kSimtThreads, 1)
hill_simt_kernel(const T* __restrict__ x, int n, int m, float kappa,
                 int max_iters, float* __restrict__ partial,
                 unsigned* __restrict__ arrived, float* __restrict__ z) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kVec = kSimtD / 4;  // float4s a row
  extern __shared__ __align__(16) float simt_smem[];
  float* zs = simt_smem;                        // [kSimtRows][kSimtPitch]
  float* xs = zs + kSimtRows * kSimtPitch;      // [kSimtTile][kSimtPitch]
  float* ws = xs + kSimtTile * kSimtPitch;      // [kSimtRows][kSimtWPitch]
  __shared__ double red[kSimtThreads / 32];
  const int t = threadIdx.x;
  // S: pixels sp + 16 i and seeds ss + 16 k (i, k < 4)
  const int sp = t & 15, ss = t >> 4;
  // W X: seeds vs + 4 k (k < 16), dims 4 vj .. 4 vj + 3
  const int vs = t >> 6, vj = t & 63;
  const int tiles = (n + kSimtTile - 1) / kSimtTile;
  unsigned barriers = 0;
  for (int it = 0; it < max_iters; ++it) {
    for (int e = t; e < kSimtRows * kVec; e += kSimtThreads) {
      const int s = e / kVec, j = 4 * (e % kVec);
      float4 v = s < m ? __ldcg(reinterpret_cast<const float4*>(
                             z + static_cast<size_t>(s) * kSimtD + j))
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (kBf16)
        v = make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                        round_bf16(v.w));
      *reinterpret_cast<float4*>(zs + s * kSimtPitch + j) = v;
    }
    float run[16][4];
#pragma unroll
    for (int k = 0; k < 16; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) run[k][c] = 0.0f;
    for (int q = blockIdx.x; q < tiles; q += gridDim.x) {
      __syncthreads();  // Z is staged; the last tile's X and W are done with
      for (int e = t; e < kSimtTile * kVec; e += kSimtThreads) {
        const int p = e / kVec, j = 4 * (e % kVec);
        const int pix = q * kSimtTile + p;
        *reinterpret_cast<float4*>(xs + p * kSimtPitch + j) =
            pix < n ? load4(x + static_cast<size_t>(pix) * kSimtD + j)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      __syncthreads();
      float tot[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) tot[k][i] = 0.0f;
#pragma unroll 1
      for (int c = 0; c < kSimtD; c += kSimtChunk) {
        float part[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[k][i] = 0.0f;
#pragma unroll
        for (int j = c; j < c + kSimtChunk; j += 4) {
          float4 zv[4], xv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            zv[k] = *reinterpret_cast<const float4*>(
                zs + (ss + 16 * k) * kSimtPitch + j);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            xv[i] = *reinterpret_cast<const float4*>(
                xs + (sp + 16 * i) * kSimtPitch + j);
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              part[k][i] = fmaf(zv[k].x, xv[i].x, part[k][i]);
              part[k][i] = fmaf(zv[k].y, xv[i].y, part[k][i]);
              part[k][i] = fmaf(zv[k].z, xv[i].z, part[k][i]);
              part[k][i] = fmaf(zv[k].w, xv[i].w, part[k][i]);
            }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int i = 0; i < 4; ++i) tot[k][i] += part[k][i];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = sp + 16 * i;
          float w = q * kSimtTile + p < n ? expf(kappa * tot[k][i]) : 0.0f;
          if (kBf16) w = round_bf16(w);
          ws[(ss + 16 * k) * kSimtWPitch + p] = w;
        }
      __syncthreads();
      float acc[16][4];
#pragma unroll
      for (int k = 0; k < 16; ++k)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[k][c] = 0.0f;
#pragma unroll 1
      for (int p = 0; p < kSimtTile; p += 4) {
        float4 xv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          xv[u] = *reinterpret_cast<const float4*>(
              xs + (p + u) * kSimtPitch + 4 * vj);
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const float4 w = *reinterpret_cast<const float4*>(
              ws + (vs + 4 * k) * kSimtWPitch + p);
          const float wu[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[k][0] = fmaf(wu[u], xv[u].x, acc[k][0]);
            acc[k][1] = fmaf(wu[u], xv[u].y, acc[k][1]);
            acc[k][2] = fmaf(wu[u], xv[u].z, acc[k][2]);
            acc[k][3] = fmaf(wu[u], xv[u].w, acc[k][3]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 16; ++k)
#pragma unroll
        for (int c = 0; c < 4; ++c) run[k][c] += acc[k][c];
    }
    // this block's partial: rows < m
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int s = vs + 4 * k;
      if (s < m)
        __stcg(reinterpret_cast<float4*>(
                   partial + (static_cast<size_t>(blockIdx.x) * m + s) *
                                 kSimtD + 4 * vj),
               make_float4(run[k][0], run[k][1], run[k][2], run[k][3]));
    }
    uoc::grid_barrier(arrived, ++barriers);  // every partial is written
    // row r: thread t sums dim t over the blocks in order, in fp64
    for (int r = blockIdx.x; r < m; r += gridDim.x) {
      double v = 0.0;
      for (int b = 0; b < static_cast<int>(gridDim.x); ++b)
        v += __ldcg(partial + (static_cast<size_t>(b) * m + r) * kSimtD + t);
      double sq = v * v;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sq += __shfl_xor_sync(0xFFFFFFFFu, sq, off);
      if ((t & 31) == 0) red[t >> 5] = sq;
      __syncthreads();
      double norm = 0.0;
#pragma unroll
      for (int w = 0; w < kSimtThreads / 32; ++w) norm += red[w];
      __syncthreads();  // red is read before the next row writes it
      z[static_cast<size_t>(r) * kSimtD + t] =
          static_cast<float>(v / fmax(sqrt(norm), 1e-12));
    }
    uoc::grid_barrier(arrived, ++barriers);  // the new Z is written
  }
}

size_t hill_tf32_smem_bytes() {
  return sizeof(float) * kTf32Stages * kHillTile * kF32Pitch<64> +
         sizeof(unsigned) * 8 * kHalfWords + sizeof(float) * kRedFloats<64>;
}

size_t hill_tf32_wide_smem_bytes() {
  return sizeof(unsigned) * (kWideZWords + kWideStages * 4 * kWideTileWords) +
         sizeof(float) * kWideRaw * kWideTile * kF32Pitch<kWideD> +
         sizeof(unsigned long long) * 2 * kWideStages;
}

size_t hill_bf16_smem_bytes(int groups) {
  return sizeof(__nv_bfloat16) * kStages * kHillTile * kMmaPitch<64> +
         sizeof(float) * 16 * groups * 64 + sizeof(float) * kRedFloats<64> +
         sizeof(__nv_bfloat16) * 16 * groups * kMmaPitch<64>;
}

// The launch shape: ceil(m/64) warpgroups per block (at d = 128 one
// more, the producer), or for bfloat16 at d = 64 two halves of ceil(m/16)
// warps, as many blocks as can be resident at once (at most one per X
// tile); the tile's pixels.
struct HillPlan {
  int grid, per_sm, threads, tile;
  size_t smem;
  long long x_bytes;         // X held on chip per block
  long long resident_bytes;  // X kept on chip for the whole launch, grid
};

cudaError_t plan_hill_bf16(int dev, int m, HillPlan* p) {
  const int groups = (m + 15) / 16;
  p->threads = 64 * groups;
  p->smem = hill_bf16_smem_bytes(groups);
  p->tile = kHillTile;
  p->x_bytes = 2LL * kStages * kHillTile * 64;  // the ring of tiles
  return uoc::blocks_per_sm<hill_bf16_kernel>(
      dev, p->threads, p->smem, hill_bf16_smem_bytes(kMaxSeeds / 16),
      &p->per_sm);
}

cudaError_t plan_hill_for(int dtype, int n, int m, int d, HillPlan* p) {
  if (d != 64 && d != 128 && d != kSimtD) return cudaErrorInvalidValue;
  if (m > (d == kSimtD ? kSimtRows : kMaxSeeds)) return cudaErrorInvalidValue;
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  p->resident_bytes = 0;
  if (d == kSimtD) {
    p->threads = kSimtThreads;
    p->smem = hill_simt_smem_bytes();
    p->tile = kSimtTile;
    p->x_bytes = 4LL * kSimtTile * d;  // the staged tile, widened to fp32
    err = dtype == uoc::kBF16
              ? uoc::blocks_per_sm<hill_simt_kernel<__nv_bfloat16>>(
                    dev, p->threads, p->smem, p->smem, &p->per_sm)
              : uoc::blocks_per_sm<hill_simt_kernel<float>>(
                    dev, p->threads, p->smem, p->smem, &p->per_sm);
  } else if (dtype == uoc::kBF16 && d == 64) {
    err = plan_hill_bf16(dev, m, p);
  } else if (dtype == uoc::kBF16) {
    // setmaxnreg as for the float32 kernel below
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, hill_bf16_wide_kernel)) !=
        cudaSuccess)
      return err;
    const int groups = (m + 63) / 64;
    if (attr.numRegs * (groups + 1) <
        groups * kBWConsumerRegs + kBWProducerRegs)
      return cudaErrorInvalidConfiguration;
    p->threads = 128 * groups + kBWProducer;
    p->smem = hill_bf16_wide_smem_bytes();
    p->tile = kBWTile;
    // the ring, the resident tiles
    p->x_bytes = static_cast<long long>(kBWStages + kBWResident) *
                 kBWTileBytes;
    err = uoc::blocks_per_sm<hill_bf16_wide_kernel>(dev, p->threads, p->smem,
                                                    p->smem, &p->per_sm);
  } else if (d == 64) {
    p->threads = 128 * ((m + 63) / 64);
    p->smem = hill_tf32_smem_bytes();
    p->tile = kHillTile;
    // the ring of raw tiles, a tile's four split copies
    p->x_bytes = 4LL * (kTf32Stages + 4) * kHillTile * d;
    err = uoc::blocks_per_sm<hill_tf32_kernel>(dev, p->threads, p->smem,
                                               p->smem, &p->per_sm);
  } else {
    // the consumers' setmaxnreg.inc waits for registers that the launch
    // must have given the block: refuse a build that gives fewer
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, hill_tf32_wide_kernel)) !=
        cudaSuccess)
      return err;
    const int groups = (m + 63) / 64;
    if (attr.numRegs * (groups + 1) < groups * kConsumerRegs + kProducerRegs)
      return cudaErrorInvalidConfiguration;
    p->threads = 128 * groups + kWideProducers;
    p->smem = hill_tf32_wide_smem_bytes();
    p->tile = kWideTile;
    // the ring of raw tiles, the stages of four split copies
    p->x_bytes = 4LL * (kWideRaw + 4 * kWideStages) * kWideTile * d;
    err = uoc::blocks_per_sm<hill_tf32_wide_kernel>(dev, p->threads, p->smem,
                                                    p->smem, &p->per_sm);
  }
  if (err != cudaSuccess) return err;
  const int num_tiles = (n + p->tile - 1) / p->tile;
  p->grid = std::max(1, std::min(p->per_sm * sms, num_tiles));
  if (dtype == uoc::kBF16 && d == 128)
    p->resident_bytes = wide_bf16_resident_bytes(n, p->grid);
  return cudaSuccess;
}


// ---------------------------------------------------------------------------
// Connected components over the m converged seeds (reference
// lib/utils/mean_shift.py:41-76).
//
// Replaces _cc_kernel / connected_components_pallas.  Bound on the H100: a
// few KB of Z in and m labels out, and m (m + 1) / 2 dot products of width
// d (0.65 MFLOP at m = 100, d = 64), nanoseconds of bytes and flops; what
// bounds it is latency: one launch, the d-long dependent FMA chains of the
// adjacency, and one dependent merge step for each seed that is still
// unlabeled when its turn comes (about one per cluster).
//
// Design (cc_kernel; at d = 128 cc_cluster_kernel, below, spreads the
// adjacency over a thread-block cluster and keeps this merge): one block
// of 16 warps; Z in dynamic shared memory (kMaxSeeds
// rows of d + 4 floats: 34 KB at d = 64, 66 KB at d = 128, past the 48 KB
// of static shared memory), the adjacency in static (2 KB).
//   Adjacency as bitmasks, each pair computed once.  Row i is four uint32
//   words: bit b of adj[i][w] is set when 0.5 * (1 - z_i . z_j) <= eps for
//   j = 32 w + b < m; bits at or past m stay 0.  Of the 32 x 32 tiles of the
//   matrix only those on or above the diagonal are computed, each in the
//   orientation whose row block holds fewer seeds.  A lane owns one column
//   seed j and keeps 64 of its floats in registers at a time (d / 64
//   passes: at 512 threads a thread holds at most 128 registers); it runs
//   kCCRows rows' chains at once, reading the rows' values as
//   shared-memory broadcasts.
//   A row's word is one __ballot_sync; the lane's own bits over the rows
//   are column j's word of the row block (the mirror, OR-ed in shared
//   memory).  The mirror is exact: every dot is the sequential fp32 fmaf
//   chain over k = 0..d-1, and fmaf(a, b, c) == fmaf(b, a, c) bit for bit,
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
// Z's row pitch in shared memory is kF32Pitch<d> floats: rows stay 16-byte
// aligned, and the 8 lanes of one 16-byte load phase, each reading its own
// row, hit 8 disjoint groups of 4 banks.
constexpr int kCCRows = 8;  // rows of one work item, run as independent chains

// A study build (-DCC_CLOCKS, cc_study.py) records for each CTA c of a
// launch (c < kCCClockCtas; one CTA for cc_kernel): clock64 at its start
// (mark 0), once its rows of Z are staged (1), when warp 0's items are done
// (2), when the adjacency is complete (3: past the block barrier, or the
// cluster's second barrier), after the merge (4) and the output (5); the
// merge steps (6); %globaltimer at the start and at mark 3 (7, 8), which
// every SM shares; cc_cluster_kernel's warp 0 past the cluster's first
// barrier (9) and after its words reached the leader (10); the latest
// warp's items done (11).
constexpr int kCCClockCtas = 8, kCCMarks = 12;
#ifdef CC_CLOCKS
__device__ long long cc_clocks[kCCClockCtas][kCCMarks];
__device__ __forceinline__ long long cc_now() { return clock64(); }
__device__ __forceinline__ long long cc_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
__device__ __forceinline__ void cc_mark(bool me, int cta, int at,
                                        long long value) {
  if (me && cta < kCCClockCtas) cc_clocks[cta][at] = value;
}
__device__ __forceinline__ void cc_mark_latest(int cta, long long value) {
  if ((threadIdx.x & 31) == 0 && cta < kCCClockCtas)
    atomicMax(reinterpret_cast<unsigned long long*>(&cc_clocks[cta][11]),
              static_cast<unsigned long long>(value));
}
#else
__device__ __forceinline__ long long cc_now() { return 0; }
__device__ __forceinline__ long long cc_ns() { return 0; }
__device__ __forceinline__ void cc_mark(bool, int, int, long long) {}
__device__ __forceinline__ void cc_mark_latest(int, long long) {}
#endif

// Rows [r0, r0 + kCCRows) of row block rb (which holds `rows` seeds)
// against the 32 seeds of column block cb: word[r], the same in every lane,
// is row r0 + r's word of block cb (by ballot); the result is the lane's
// column j = 32 cb + lane's bits over these rows (bit r0 + r), its word of
// row block rb in the mirror.
template <int kD, int kPitch = kF32Pitch<kD>>
__device__ __forceinline__ unsigned cc_dots(const float* zs, int m, float eps,
                                            int rb, int rows, int r0, int cb,
                                            unsigned (&word)[kCCRows]) {
  const int lane = threadIdx.x & 31;
  const int j = 32 * cb + lane;
  const float* zj = zs + min(j, m - 1) * kPitch;
  const float* zi[kCCRows];
  float acc[kCCRows];
#pragma unroll
  for (int r = 0; r < kCCRows; ++r) {
    zi[r] = zs + (32 * rb + min(r0 + r, rows - 1)) * kPitch;
    acc[r] = 0.0f;
  }
  // the chains run on over the passes of 64 dims
#pragma unroll
  for (int k0 = 0; k0 < kD; k0 += 64) {
    float col[64];
#pragma unroll
    for (int k = 0; k < 64; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(zj + k0 + k);
      col[k] = v.x;
      col[k + 1] = v.y;
      col[k + 2] = v.z;
      col[k + 3] = v.w;
    }
#pragma unroll
    for (int k = 0; k < 64; k += 4) {
#pragma unroll
      for (int r = 0; r < kCCRows; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(zi[r] + k0 + k);
        acc[r] = fmaf(v.x, col[k], acc[r]);
        acc[r] = fmaf(v.y, col[k + 1], acc[r]);
        acc[r] = fmaf(v.z, col[k + 2], acc[r]);
        acc[r] = fmaf(v.w, col[k + 3], acc[r]);
      }
    }
  }
  unsigned own = 0;
#pragma unroll
  for (int r = 0; r < kCCRows; ++r) {
    const bool in = r0 + r < rows && j < m && 0.5f * (1.0f - acc[r]) <= eps;
    word[r] = __ballot_sync(0xffffffffu, in);
    own |= static_cast<unsigned>(in) << (r0 + r);
  }
  return own;
}

// cc_dots's words into the block's own adjacency (rows of kWords words):
// row r0 + r's word of block cb, and when `mirror` is set each lane's bits
// over these rows, OR-ed into its column's word of block rb.
template <int kD, int kWords, int kPitch = kF32Pitch<kD>>
__device__ __forceinline__ void cc_rows(const float* zs,
                                        unsigned (*adj)[kWords], int m,
                                        float eps, int rb, int rows, int r0,
                                        int cb, bool mirror) {
  const int lane = threadIdx.x & 31;
  unsigned word[kCCRows];
  const unsigned own =
      cc_dots<kD, kPitch>(zs, m, eps, rb, rows, r0, cb, word);
#pragma unroll
  for (int r = 0; r < kCCRows; ++r)
    if (lane == 0 && r0 + r < rows) adj[32 * rb + r0 + r][cb] = word[r];
  if (mirror && own) atomicOr(&adj[32 * cb + lane][rb], own);
}

// The lowest seed whose bit is set in s, or -1; the __ffs are independent,
// so there is no branch.
template <int kWords>
__device__ __forceinline__ int cc_first(const unsigned (&s)[kWords]) {
  int first = -1;
#pragma unroll
  for (int w = kWords - 1; w >= 0; --w) {
    const int f = __ffs(s[w]);
    first = f ? 32 * w + f - 1 : first;
  }
  return first;
}

// The merge, on one warp, over the complete adjacency of rows of kWords
// words (see the note above; lane l holds labels l + 32 q for q < kWords),
// and each seed's label out; returns the merge steps.
template <int kWords>
__device__ __forceinline__ int cc_merge(unsigned (*adj)[kWords], int m,
                                        int* __restrict__ labels) {
  constexpr int kSeeds = 32 * kWords;
  constexpr int kVecs = kWords / 4;  // 16-byte loads a row
  static_assert(kSeeds <= 256, "the keys hold a label in 8 bits");
  const int lane = threadIdx.x & 31;
  // pending: the seeds neither labeled nor visited; labeled: the union of
  // the label masks (both the same in every lane)
  unsigned pending[kWords], labeled[kWords];
  unsigned member[kWords][kWords];  // [q][w]: label lane + 32 q's seeds
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const int left = m - 32 * w;
    pending[w] = left >= 32 ? 0xffffffffu : left > 0 ? (1u << left) - 1u : 0u;
    labeled[w] = 0u;
#pragma unroll
    for (int q = 0; q < kWords; ++q) member[q][w] = 0u;
  }
  const uint4* balls = reinterpret_cast<const uint4*>(&adj[0][0]);
  int num_labels = 0, n_steps = 0;
  int i = 0;  // m >= 1: seed 0 is the first step
  uint4 row[kVecs];
#pragma unroll
  for (int v = 0; v < kVecs; ++v) row[v] = balls[v];
  while (true) {
    unsigned ball[kWords];
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      ball[4 * v] = row[v].x;
      ball[4 * v + 1] = row[v].y;
      ball[4 * v + 2] = row[v].z;
      ball[4 * v + 3] = row[v].w;
    }
    // i and its neighbours leave the pending set, whose lowest seed is the
    // next step (every seed below it is labeled or visited); its row is
    // loaded while this step runs
#pragma unroll
    for (int w = 0; w < kWords; ++w)
      pending[w] &= ~(ball[w] | (w == i >> 5 ? 1u << (i & 31) : 0u));
    const int next = cc_first(pending);
    uint4 next_row[kVecs];
#pragma unroll
    for (int v = 0; v < kVecs; ++v)
      next_row[v] = balls[(next & (kSeeds - 1)) * kVecs + v];
    bool seen = false;  // some neighbour of i is labeled
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      seen |= (ball[w] & labeled[w]) != 0u;
      labeled[w] |= ball[w];
    }
    int label = num_labels;
    if (seen) {
      // the mode of the neighbours' labels, the smallest on a tie (the
      // best count is at least 1); the neighbours leave their labels
      unsigned key = 0;
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        int count = 0;
#pragma unroll
        for (int w = 0; w < kWords; ++w)
          count += __popc(ball[w] & member[q][w]);
        key = max(key, static_cast<unsigned>(count) << 8 |
                           static_cast<unsigned>(255 - lane - 32 * q));
      }
      key = __reduce_max_sync(0xffffffffu, key);
      label = 255 - static_cast<int>(key & 255u);
#pragma unroll
      for (int q = 0; q < kWords; ++q)
#pragma unroll
        for (int w = 0; w < kWords; ++w) member[q][w] &= ~ball[w];
    } else {
      ++num_labels;  // every count is 0: a new label
    }
    const bool mine = (label & 31) == lane;
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      const unsigned take = mine && label >> 5 == q ? 0xffffffffu : 0u;
#pragma unroll
      for (int w = 0; w < kWords; ++w) member[q][w] |= ball[w] & take;
    }
    ++n_steps;
    if (next < 0) break;
    i = next;
#pragma unroll
    for (int v = 0; v < kVecs; ++v) row[v] = next_row[v];
  }

  // Seed 32 w + lane's label, bit by bit: bits 0-4 of a label are its
  // owner's lane, the bits above its slot q.  A seed outside `labeled` is
  // in no label's mask.
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    if (32 * w >= m) break;
    unsigned held = 0u;
#pragma unroll
    for (int q = 0; q < kWords; ++q) held |= member[q][w];
    int label = 0;
#pragma unroll
    for (int p = 0; p < 5; ++p)
      label |= ((__reduce_or_sync(0xffffffffu, lane >> p & 1 ? held : 0u) >>
                 lane) & 1) << p;
#pragma unroll
    for (int p = 0; (1 << p) < kWords; ++p) {
      unsigned slot = 0u;  // the seeds of every label whose slot has bit p
#pragma unroll
      for (int q = 0; q < kWords; ++q)
        if (q >> p & 1) slot |= member[q][w];
      label |= ((__reduce_or_sync(0xffffffffu, slot) >> lane) & 1) << (5 + p);
    }
    if (32 * w + lane < m)
      labels[32 * w + lane] = labeled[w] >> lane & 1 ? label : -1;
  }
  return n_steps;
}

// Z's rows in dynamic shared memory, and the kernel that fits it, for up to
// kSeeds seeds: kMaxSeeds (cc_kernel<64>, the recipes' 100 seeds), or
// kMaxSeedsMany past that, at d = 64 and 128 (cc_kernel<kD, 256>).  At 256
// the rows and the label masks are 8 words: Z's rows take 68 KB at d = 64
// and 132 KB at d = 128, the adjacency 8 KB, up to 36 tiles of 4 items go
// over the 16 warps, and the merge's lane l holds labels l + 32 q, q < 8,
// as 64 registers of masks; the mode's key (count << 8) | (255 - label)
// holds every label below 256, and the steps visit the same seeds in the
// same order, so the labels and the merge steps are the reference loop's.
// A narrower Z comes zero-padded to 64 or 128 columns, which leaves every
// fp32 FMA chain, and so every bit of the adjacency, as it is.
template <int kD, int kSeeds = kMaxSeeds>
constexpr size_t cc_smem_bytes() {
  return sizeof(float) * kSeeds * kF32Pitch<kD>;
}

template <int kD, int kSeeds = kMaxSeeds>
__global__ void __launch_bounds__(kCCThreads)
cc_kernel(const float* __restrict__ z, int m, float eps,
          int* __restrict__ labels, int* __restrict__ steps) {
  constexpr int kWords = kSeeds / 32;
  extern __shared__ __align__(16) float cc_smem[];
  float* zs = cc_smem;  // [kSeeds][kF32Pitch<kD>]
  __shared__ __align__(16) unsigned adj[kSeeds][kWords];
  const int t = threadIdx.x, warp = t >> 5;
  cc_mark(t == 0, 0, 0, cc_now());
  cc_mark(t == 0, 0, 7, cc_ns());

  for (int e = t; e < kSeeds * kWords; e += kCCThreads)
    adj[e / kWords][e % kWords] = 0u;
  for (int e = t; e < m * (kD / 4); e += kCCThreads)
    *reinterpret_cast<float4*>(zs + (e / (kD / 4)) * kF32Pitch<kD> +
                               4 * (e % (kD / 4))) =
        reinterpret_cast<const float4*>(z)[e];
  __syncthreads();
  cc_mark(t == 0, 0, 1, cc_now());

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
          cc_rows<kD>(zs, adj, m, eps, rb, rows, r0, cb, a != c);
    }
  cc_mark(t == 0, 0, 2, cc_now());
  cc_mark_latest(0, cc_now());
  __syncthreads();
  if (warp != 0) return;
  cc_mark(t == 0, 0, 3, cc_now());
  cc_mark(t == 0, 0, 8, cc_ns());
  const int n_steps = cc_merge(adj, m, labels);
  cc_mark(t == 0, 0, 4, cc_now());
  if (t == 0) *steps = n_steps;
  cc_mark(t == 0, 0, 5, cc_now());
  cc_mark(t == 0, 0, 6, n_steps);
}

// ---------------------------------------------------------------------------
// Connected components for up to 512 seeds, at d = 64, 128 and 256
// (cc_wide_kernel<kD>): every launch at d = 256, and past 256 seeds at the
// other widths.  A simple design, cc_kernel's with what does not fit moved:
//   Z is read where it lies, in device memory (512 rows of 256 floats, 512
//   KB, do not fit in shared memory; the reads go through L1 and L2), by
//   cc_dots with a row pitch of d: the same fp32 FMA chains over k = 0..d-1
//   in the same order, so the adjacency and its mirror argument are
//   cc_kernel's.  Rows of 16 words, in dynamic shared memory (32 KB).
//   The merge on one warp, the steps cc_merge's (the lowest pending seed
//   next; a step with no labeled neighbour opens a new label), with the
//   label masks in shared memory ([512][16] words, 32 KB; as registers
//   they would take 256 a lane): lane l counts labels l, l + 32, ... below
//   the labels opened so far, skipping the words where the ball is empty,
//   and the mode's key is (count << 16) | (65535 - label), which holds
//   every count up to 512 and every label below 65536, so the largest key
//   is the largest count and, on a tie, the smallest label.  At the end
//   each label's seeds are read from its mask; a seed in no mask is -1.
// ---------------------------------------------------------------------------
constexpr int kCCWideWords = kMaxSeedsAll / 32;

constexpr size_t cc_wide_smem_bytes() {
  return 2 * sizeof(unsigned) * kMaxSeedsAll * kCCWideWords;
}

template <int kD>
__global__ void __launch_bounds__(kCCThreads)
cc_wide_kernel(const float* __restrict__ z, int m, float eps,
               int* __restrict__ labels, int* __restrict__ steps) {
  constexpr int kWords = kCCWideWords;
  extern __shared__ __align__(16) unsigned cc_wide_smem[];
  unsigned(*adj)[kWords] = reinterpret_cast<unsigned(*)[kWords]>(cc_wide_smem);
  unsigned(*member)[kWords] = reinterpret_cast<unsigned(*)[kWords]>(
      cc_wide_smem + kMaxSeedsAll * kWords);
  __shared__ int lab[kMaxSeedsAll];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  for (int e = t; e < 2 * kMaxSeedsAll * kWords; e += kCCThreads)
    cc_wide_smem[e] = 0u;
  for (int e = t; e < kMaxSeedsAll; e += kCCThreads) lab[e] = -1;
  __syncthreads();

  // cc_kernel's work items, dealt to the warps in turn
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
          cc_rows<kD, kWords, kD>(z, adj, m, eps, rb, rows, r0, cb, a != c);
    }
  __syncthreads();
  if (warp != 0) return;

  // pending: the seeds neither labeled nor visited; labeled: the union of
  // the label masks (both the same in every lane)
  unsigned pending[kWords], labeled[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const int left = m - 32 * w;
    pending[w] = left >= 32 ? 0xffffffffu : left > 0 ? (1u << left) - 1u : 0u;
    labeled[w] = 0u;
  }
  int num_labels = 0, n_steps = 0;
  int i = 0;  // m >= 1: seed 0 is the first step
  while (true) {
    unsigned ball[kWords];
#pragma unroll
    for (int v = 0; v < kWords / 4; ++v) {
      const uint4 r = reinterpret_cast<const uint4*>(adj[i])[v];
      ball[4 * v] = r.x;
      ball[4 * v + 1] = r.y;
      ball[4 * v + 2] = r.z;
      ball[4 * v + 3] = r.w;
    }
    bool seen = false;  // some neighbour of i is labeled
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      pending[w] &= ~(ball[w] | (w == i >> 5 ? 1u << (i & 31) : 0u));
      seen |= (ball[w] & labeled[w]) != 0u;
      labeled[w] |= ball[w];
    }
    int label = num_labels;
    if (seen) {
      // the mode of the neighbours' labels, the smallest on a tie; the
      // neighbours leave their labels
      unsigned key = 0;
      for (int l = lane; l < num_labels; l += 32) {
        int count = 0;
#pragma unroll
        for (int w = 0; w < kWords; ++w)
          if (ball[w] != 0u) count += __popc(ball[w] & member[l][w]);
        key = max(key, static_cast<unsigned>(count) << 16 |
                           static_cast<unsigned>(65535 - l));
      }
      key = __reduce_max_sync(0xffffffffu, key);
      label = 65535 - static_cast<int>(key & 0xFFFFu);
      for (int l = lane; l < num_labels; l += 32)
#pragma unroll
        for (int w = 0; w < kWords; ++w)
          if (ball[w] != 0u) member[l][w] &= ~ball[w];
    } else {
      ++num_labels;  // every count is 0: a new label
    }
    __syncwarp();
    if (lane < kWords) {
      unsigned b = 0u;
#pragma unroll
      for (int w = 0; w < kWords; ++w) b = w == lane ? ball[w] : b;
      member[label][lane] |= b;
    }
    __syncwarp();
    ++n_steps;
    const int next = cc_first(pending);
    if (next < 0) break;
    i = next;
  }
  // each label's seeds from its mask (the masks are disjoint)
  for (int l = lane; l < num_labels; l += 32)
    for (int w = 0; w < kWords; ++w) {
      unsigned bits = member[l][w];
      while (bits) {
        const int b = __ffs(bits) - 1;
        lab[32 * w + b] = l;
        bits &= bits - 1u;
      }
    }
  __syncwarp();
  for (int e = lane; e < m; e += 32) labels[e] = lab[e];
  if (lane == 0) *steps = n_steps;
}

// ---------------------------------------------------------------------------
// Connected components at d = 128: cc_cluster_kernel, a thread-block
// cluster of kCCCluster CTAs (cc_kernel<128>, one block on one SM, spent
// about a third of its time on the adjacency's 128-long chains, which its
// 16 warps took in two rounds: 28 items at m = 100).
//
// Design.  The host deals the items (cc_kernel's, in its order) to the
// cluster's warps: item i to CTA i % kCCCluster's warp i / kCCCluster
// (mod 16), at most 40 items (m = 128) over 128 warps, so each warp runs
// at most one; and it lists for each CTA the rows of Z that its items read
// (CCPlan, built once per m and passed by value).  Each CTA stages only
// those rows, with a thread's loads in flight at once, and runs cc_dots,
// the same fp32 FMA chains over k = 0..127 in the same order: every bit of
// the adjacency, and the mirror argument above, stay as they were.  The
// words go straight into the leader's (CTA 0's) adjacency through
// distributed shared memory: a row's words by st.shared::cluster (each
// word has one writer), the mirror's bits by red.shared::cluster.or.
// Two cluster barriers, each an arrive (release) and a wait (acquire): the
// first orders the leader's zeroing of its adjacency before any write to
// it (a CTA arrives once its rows are staged and waits only when its first
// words are ready, so the chains run across the barrier's latency; it also
// keeps every CTA's shared memory in place for the writes); the second
// orders every CTA's writes before the merge.  No CTA exits before the
// second.  Then the leader's warp 0 runs cc_merge, cc_kernel's merge, on
// the complete adjacency: the labels and the merge steps are cc_kernel's.
// The launch (cudaLaunchKernelEx with the cluster attribute) raises the
// kernel's dynamic shared-memory limit once per device and queries nothing
// else.
// ---------------------------------------------------------------------------
constexpr int kCCCluster = 8;     // CTAs (portable: at most 8)
constexpr int kCCMaxItems = 40;   // m = 128: 10 tiles of 4 items

// Where a launch computes what, for one m: item i is {rb, rows, r0, cb},
// with bit 7 of cb set where the tile is off the diagonal (its mirror is
// written); rows[c] is the set of Z rows that CTA c's items read.
struct CCPlan {
  unsigned rows[kCCCluster][kCCWords];
  unsigned char item[kCCMaxItems][4];
  int items;
};

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of `p` (in this CTA's shared memory) in CTA
// `rank`'s.
__device__ __forceinline__ unsigned cluster_addr(const void* p,
                                                 unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void cluster_store(unsigned addr, unsigned v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}

__device__ __forceinline__ void cluster_or(unsigned addr, unsigned v) {
  asm volatile("red.relaxed.cluster.shared::cluster.or.b32 [%0], %1;\n" ::"r"(
                   addr),
               "r"(v)
               : "memory");
}

// z: [m, 128] float32, rows 16-byte aligned; plan: cc_cluster_plan(m);
// labels, steps as cc_kernel's.  gridDim.x = kCCCluster, one cluster.
__global__ void __launch_bounds__(kCCThreads)
cc_cluster_kernel(const float* __restrict__ z, int m, float eps,
                  const __grid_constant__ CCPlan plan,
                  int* __restrict__ labels, int* __restrict__ steps) {
  constexpr int kD = kWideD;
  constexpr int kPitch = kF32Pitch<kD>;
  extern __shared__ __align__(16) float cc_smem[];
  float* zs = cc_smem;  // [kMaxSeeds][kPitch], the rows of this CTA's items
  __shared__ __align__(16) unsigned adj[kMaxSeeds][kCCWords];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned rank = cluster_rank();
  const int cta = static_cast<int>(rank);
  cc_mark(t == 0, cta, 0, cc_now());
  cc_mark(t == 0, cta, 7, cc_ns());
  static_assert(kCCThreads == kMaxSeeds * kCCWords, "a word a thread");
  if (rank == 0) (&adj[0][0])[t] = 0u;
  // this CTA's rows of Z, every load in flight before the first store
  constexpr int kPer = kMaxSeeds * (kD / 4) / kCCThreads;
  static_assert(kPer * kCCThreads == kMaxSeeds * (kD / 4), "Z");
  float4 v[kPer];
  bool need[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = t + i * kCCThreads, s = e / (kD / 4);
    need[i] = s < m && (plan.rows[cta][s >> 5] >> (s & 31) & 1u);
    if (need[i]) v[i] = reinterpret_cast<const float4*>(z)[e];
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = t + i * kCCThreads, s = e / (kD / 4);
    if (need[i])
      *reinterpret_cast<float4*>(zs + s * kPitch + 4 * (e % (kD / 4))) = v[i];
  }
  __syncthreads();
  cc_mark(t == 0, cta, 1, cc_now());
  cluster_arrive();  // the leader's adjacency is zeroed

  bool waited = false;  // uniform over the warp
  for (int i = cta + kCCCluster * warp; i < plan.items;
       i += kCCCluster * kCCWarps) {
    const int rb = plan.item[i][0], rows = plan.item[i][1];
    const int r0 = plan.item[i][2], cb = plan.item[i][3] & 127;
    const bool mirror = plan.item[i][3] >> 7;
    unsigned word[kCCRows];
    const unsigned own = cc_dots<kD>(zs, m, eps, rb, rows, r0, cb, word);
    if (!waited) {
      cluster_wait();
      waited = true;
      cc_mark(t == 0, cta, 9, cc_now());
    }
#pragma unroll
    for (int r = 0; r < kCCRows; ++r)
      if (lane == r && r0 + r < rows)
        cluster_store(cluster_addr(&adj[32 * rb + r0 + r][cb], 0), word[r]);
    if (mirror && own) cluster_or(cluster_addr(&adj[32 * cb + lane][rb], 0),
                                  own);
    cc_mark(t == 0, cta, 10, cc_now());
  }
  cc_mark(t == 0, cta, 2, cc_now());
  cc_mark_latest(cta, cc_now());
  if (!waited) cluster_wait();
  cluster_arrive();  // this CTA's words are in the leader's adjacency
  cluster_wait();
  cc_mark(t == 0, cta, 3, cc_now());
  cc_mark(t == 0, cta, 8, cc_ns());
  if (rank != 0 || warp != 0) return;
  const int n_steps = cc_merge(adj, m, labels);
  cc_mark(t == 0, 0, 4, cc_now());
  if (t == 0) *steps = n_steps;
  cc_mark(t == 0, 0, 5, cc_now());
  cc_mark(t == 0, 0, 6, n_steps);
}

// The items of cc_kernel's adjacency for m seeds, in its order, and the Z
// rows each of the cluster's CTAs reads (see cc_cluster_kernel).
CCPlan cc_cluster_plan(int m) {
  CCPlan p{};
  const int blocks = (m + 31) / 32;
  const bool short_last = m % 32 != 0;
  auto read = [&](int cta, int s) { p.rows[cta][s >> 5] |= 1u << (s & 31); };
  int item = 0;
  for (int a = 0; a < blocks; ++a)
    for (int c = a; c < blocks; ++c) {
      const bool swap = short_last && c == blocks - 1;
      const int rb = swap ? c : a, cb = swap ? a : c;
      const int rows = std::min(32, m - 32 * rb);
      for (int r0 = 0; r0 < rows; r0 += kCCRows, ++item) {
        const int cta = item % kCCCluster;
        p.item[item][0] = static_cast<unsigned char>(rb);
        p.item[item][1] = static_cast<unsigned char>(rows);
        p.item[item][2] = static_cast<unsigned char>(r0);
        p.item[item][3] = static_cast<unsigned char>(cb | (a != c) << 7);
        for (int r = r0; r < std::min(r0 + kCCRows, rows); ++r)
          read(cta, 32 * rb + r);
        for (int j = 32 * cb; j < std::min(32 * cb + 32, m); ++j)
          read(cta, j);
      }
    }
  p.items = item;
  return p;
}

// ---------------------------------------------------------------------------
// Assignment: each pixel goes to its most similar real seed (first
// occurrence on a tie) and takes seed_labels[closest]; the same sweep counts
// pixels per label and valid-depth pixels per label (the fused depth
// filter).
//
// Replaces _assign_kernel / assign_labels_pallas.  Bound on the H100: one
// read of X (78.6 MB fp32, 39.3 MB bf16 at n = 307200, d = 64; twice that
// at d = 128) against 2*m*n*d flops (3.9 GFLOP at m = 100, d = 64; three
// TF32 products each for fp32 accuracy): bytes-bound in both modes, by a
// factor of about 1.3 at fp32.
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
// labels can change a pixel's label.  The product runs in passes of 64
// dims (8 float32 or 4 bf16 k-chunks): each pass loads and splits its A
// fragments, issues its wgmmas into the same accumulators and waits, so a
// thread holds one pass's fragments, at d = 128 as at d = 64.
//
// At d = 128 each type has a kernel of its own (below), whose warpgroups
// split the work by role instead of by pixels: assign_tf32_wide_kernel
// (Z's split copies take 128 KB, so one block fills an SM) and
// assign_bf16_wide_kernel (A read by wgmma straight from its TMA stage).
//
// The re-check margin (kRecheckMargin<d>).  X and Z rows are unit
// vectors.  Split TF32 drops, per product a_i b_i, small * small (<= 2^-22
// |a_i b_i|) and the truncation of each small part as the tensor cores
// read it (< 2^-21 |a_i b_i| each): < 1.3 * 2^-20 over the dot, since
// sum |a_i b_i| <= |a| |b| = 1.  At d = 64 the accumulator takes 24 wgmma
// steps (8 k-chunks x 3 products); each step truncates its nine terms (the
// accumulator and eight products) two bits below the largest one's last
// and rounds its sum toward zero (the rule whose emulation comes nearest
// the hill climb's results on the H100): < 24 * (9 * 2^-25 + 2^-23).  The
// float32 plain version's own sum of 64 products is within 64 * 2^-24 of
// the exact dot.  So the kernel's S and the plain version's differ by less
// than 1.5e-5 < 2^-16 = kRecheckMargin<64> / 2.  At d = 128 the same
// argument gives 48 steps (16 k-chunks x 3 products, one accumulator over
// both passes), 48 * (9 * 2^-25 + 2^-23) = 1.86e-5, and the plain
// version's 128 * 2^-24 = 7.6e-6: with the split's 1.2e-6 less than 2.8e-5
// < 2^-15 = kRecheckMargin<128> / 2.
// Where b1 - b2 >= kRecheckMargin the plain version's best seed carries
// label l1; the other pixels (b1 - b2 < kRecheckMargin, a tie at b1
// between labels included) are re-checked out of line (recheck): the quad
// recomputes the pixel's similarity to every real seed as the sequential
// fp32 FMA chain over d from 0 (Z = big + small, exact), each thread a
// quarter of the seeds, lowest index on a tie.  bf16 products are exact
// and take 4 steps (8 at d = 128, 17 terms each: 4.1e-6), so the same
// margins hold there (the re-check then uses bf16 X and bf16(Z) widened to
// fp32, as the plain version does).  When every seed carries one label, b2
// stays -inf and nothing is re-checked.
//
// Outputs: one thread per pixel writes its label; per-block int32
// histograms in shared memory take warp-aggregated adds (__match_any_sync
// on the label), and are flushed with one float atomicAdd per label per
// block: sums of integers below 2^24 are exact in float32 and do not
// depend on the order.  The kernel counts the pixels it re-checked.
// ---------------------------------------------------------------------------
// ASSIGN_RECHECK_MARGIN in ops/cuda_mean_shift.py holds the same values.
template <int kD>
constexpr float kRecheckMargin =
    kD == 64 ? 3.0517578125e-05f : 6.103515625e-05f;  // 2^-15, 2^-14

// The launch shape of assign_body for X of type T and width kD (d = 64;
// width 128 has the wide kernels below): two warpgroups a block, threads, pixels per tile (64
// per warpgroup), X tiles in the ring, the row pitch of a tile in shared
// memory, and the dynamic shared bytes (the ring, then Z: float32 its two
// split copies); no setmaxnreg and no tensor map (AssignWideShape has
// both).
template <typename T, int kD>
struct AssignShape {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kThreads = 256;
  static constexpr int kTile = 128;
  static constexpr int kStages = 4;
  static constexpr int kPitch = kF32 ? kF32Pitch<kD> : kMmaPitch<kD>;
  static constexpr size_t kSmem =
      sizeof(T) * kStages * kTile * kPitch +
      (kF32 ? 2 * sizeof(float) : sizeof(T)) * kMaxSeeds * kD;
  static constexpr int kRegs = 0;
  static constexpr bool kTma = false;
};

// Z in shared memory as the B operand, in the seed_word layout.  float32
// keeps a big and a small copy, kMaxSeeds * kD words apart.

// Every thread: Z [m, kD] float32 (16-byte aligned) -> the split copies
// (or bf16(Z)), zero past m.
template <int kD>
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

template <int kD>
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
template <int kD>
__device__ __forceinline__ float seed_value(const unsigned* zs, int s, int j) {
  const int w = seed_word(s, j, 4);
  return __fadd_rn(__uint_as_float(zs[w]),
                   __uint_as_float(zs[kMaxSeeds * kD + w]));
}

template <int kD>
__device__ __forceinline__ float seed_value(const __nv_bfloat16* zs, int s,
                                            int j) {
  return __bfloat162float(zs[seed_word(s, j, 8)]);
}

// The same values from Z [m, kD] float32 in global memory, for X of type
// T: Z itself (float32: big + small is Z exactly), or bf16(Z) widened
// (rounded to nearest even, as stage_assign rounds it).
template <typename T>
struct GlobalSeeds {
  const float* z;
};

template <int kD>
__device__ __forceinline__ float seed_value(const GlobalSeeds<float>* zs,
                                            int s, int j) {
  return zs->z[s * kD + j];
}

template <int kD>
__device__ __forceinline__ float seed_value(
    const GlobalSeeds<__nv_bfloat16>* zs, int s, int j) {
  return __bfloat162float(__float2bfloat16_rn(zs->z[s * kD + j]));
}

// S of the warpgroup's 64 pixels (xs: their rows in the ring) against the
// seeds: acc[nh] holds seeds [64 nh, 64 nh + 64).  Split TF32, the hill
// climb's order: small * big, big * small, big * big per k-chunk of 8;
// one pass per 64 dims.
template <int kD>
__device__ __forceinline__ void assign_product(const float* xs,
                                               const unsigned* zs, int m,
                                               float (&acc)[2][32]) {
  constexpr int kPitch = kF32Pitch<kD>;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const float* xw = xs + (16 * (threadIdx.x / 32 % 4) + g) * kPitch + t;
  const unsigned* zb = zs;
  const unsigned* zsm = zs + kMaxSeeds * kD;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i / 32][i % 32] = 0.0f;
#pragma unroll
  for (int k0 = 0; k0 < kD / 8; k0 += 8) {  // k-chunks [k0, k0 + 8)
    unsigned xb[8][4], xsm[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int c = 8 * (k0 + kk);
      const float a[4] = {xw[c], xw[8 * kPitch + c], xw[c + 4],
                          xw[8 * kPitch + c + 4]};
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(a[q], xb[kk][q], xsm[kk][q]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
        if (nh == 1 && m <= 64) continue;  // uniform over the warpgroup
        const int o =
            (2 * (k0 + kk) * (kMaxSeeds / 8) + 8 * nh) * (kCore / 4);
        const uint64_t db = smem_desc(zb + o, (kMaxSeeds / 8) * kCore, kCore);
        const uint64_t ds =
            smem_desc(zsm + o, (kMaxSeeds / 8) * kCore, kCore);
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
}

// The same for bf16 X: one product per k-chunk of 16.
template <int kD>
__device__ __forceinline__ void assign_product(const __nv_bfloat16* xs,
                                               const __nv_bfloat16* zs, int m,
                                               float (&acc)[2][32]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i / 32][i % 32] = 0.0f;
#pragma unroll
  for (int k0 = 0; k0 < kD / 16; k0 += 4) {  // k-chunks [k0, k0 + 4)
    unsigned xa[4][4];
    load_seed_fragments<kMmaPitch<kD>>(xs + 16 * k0,
                                       16 * (threadIdx.x / 32 % 4), lane, xa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
        if (nh == 1 && m <= 64) continue;
        const int o =
            (2 * (k0 + kk) * (kMaxSeeds / 8) + 8 * nh) * (kCore / 2);
        wgmma_bf16(acc[nh], xa[kk],
                   smem_desc(zs + o, (kMaxSeeds / 8) * kCore, kCore));
      }
    wgmma_commit();
    wgmma_wait();
    pin_registers(acc[0]);
    pin_registers(acc[1]);
    pin_registers(xa);
  }
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

// r and the Best (ob1, ob2, ol1) of a disjoint set of seeds merge: the
// larger b1 wins (r's on a tie); b2 takes the loser's b2 when the labels
// agree and the loser's b1 when they differ.  Exact over the union.
__device__ __forceinline__ void merge_best(Best& r, float ob1, float ob2,
                                           int ol1) {
  const bool other = ob1 > r.b1;
  const float loser = ol1 == r.l1 ? (other ? r.b2 : ob2)
                                  : (other ? r.b1 : ob1);
  r.b2 = fmaxf(other ? ob2 : r.b2, loser);
  if (other) {
    r.b1 = ob1;
    r.l1 = ol1;
  }
}

// The four threads of a quad (disjoint seed sets) merge (merge_best): b1
// and b2 come out the same on all four threads, exact over the quad's seeds
// for the l1 each holds.
__device__ __forceinline__ void merge_quad(Best& r) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float ob1 = __shfl_xor_sync(0xFFFFFFFFu, r.b1, off);
    const float ob2 = __shfl_xor_sync(0xFFFFFFFFu, r.b2, off);
    const int ol1 = __shfl_xor_sync(0xFFFFFFFFu, r.l1, off);
    merge_best(r, ob1, ob2, ol1);
  }
}

// Two passes, for 129 to 256 seeds: kPass 1 and 2 of each assignment
// kernel (kPass 0 is the one pass of m <= 128, the recipes').  A kernel
// holds Z for at most kMaxSeeds seeds in shared memory (the float32 d =
// 128 kernel's split copies take 128 KB of it; 256 seeds would take 256
// KB), so past 128 the launch runs it twice over X, each pass one product
// of at most 128 seed columns on the tensor cores.  Pass 1 takes seeds
// [0, 128) and stores each pixel's quad-merged Best in `part` (b1, b2, l1
// as one float4 a pixel).  Pass 2 takes seeds [128, m) and merges the
// stored Best into its own (merge_best: exact over the union, so b1 - b2
// is what one product over all m seeds would give) before the margin
// test; then as one pass: the re-check (exact_argmax over all m seeds,
// read from Z in global memory through GlobalSeeds), the labels, and
// histograms of up to kMaxSeedsMany labels.  Pass 1 writes no labels and
// no counts.  Every score keeps its kernel's steps and terms, so
// kRecheckMargin<kD> holds as derived; a narrower embedding's zero columns
// add exact zeros to both the products and the re-check's chains.
//
// Past 256 seeds, up to kMaxSeedsAll = 512, the same kernels run
// k = ceil(m / 128) passes: pass 1 over seeds [0, 128) as above, k - 2
// middle passes (kPass 3) over the next 128 seeds each (the launch points z
// and seed_labels at them and passes m = 128), each merging the stored Best
// into its own and storing the result in place (the quad's lanes read a
// pixel's Best before its owner writes it: a __syncwarp between), and a
// last pass (kPass 4) over seeds [128 (k - 1), m) that merges and finishes
// as pass 2 does, with histograms of up to 512 labels.  merge_best is exact
// over disjoint seed sets in any grouping, so the last pass's b1 - b2 is
// what one product over all m seeds would give.

template <int kPass>
constexpr int kHistSeeds = kPass == 2   ? kMaxSeedsMany
                           : kPass == 4 ? kMaxSeedsAll
                                        : kMaxSeeds;
// the passes that merge the stored Best, store theirs, or finish after
// others (re-checking against all m seeds)
template <int kPass>
constexpr bool kMergesPart = kPass == 2 || kPass == 3 || kPass == 4;
template <int kPass>
constexpr bool kStoresPart = kPass == 1 || kPass == 3;
template <int kPass>
constexpr bool kLastOfMany = kPass == 2 || kPass == 4;

// The seeds of one pass: their rows of Z, their labels and their count.
struct PassSeeds {
  const float* z;
  const int* labels;
  int m;
};

template <int kPass, int kD>
__device__ __forceinline__ PassSeeds pass_seeds(const float* z,
                                                const int* labels, int m) {
  if constexpr (kPass == 2) {
    return {z + kMaxSeeds * kD, labels + kMaxSeeds, m - kMaxSeeds};
  } else if constexpr (kPass == 4) {
    const int o = kMaxSeeds * ((m - 1) / kMaxSeeds);
    return {z + static_cast<size_t>(o) * kD, labels + o, m - o};
  } else if constexpr (kPass == 1) {
    return {z, labels, kMaxSeeds};
  } else {
    return {z, labels, m};
  }
}

// Passes 1 and 3: pixel p's Best into part; passes 2, 3 and 4: part's
// into r.
__device__ __forceinline__ void store_part(float4* part, int p,
                                           const Best& r) {
  part[p] = make_float4(r.b1, r.b2, __int_as_float(r.l1), 0.0f);
}

__device__ __forceinline__ void merge_part(const float4* part, int p,
                                           Best& r) {
  const float4 o = part[p];
  merge_best(r, o.x, o.y, __float_as_int(o.z));
}

// The exact argmax for one pixel (xrow: its row in the ring): thread t of
// the quad takes seeds t, t + 4, ... < m, each the fp32 FMA chain over d
// from 0; lowest index on a tie.  Every lane of the warp calls it; a quad
// that passes active = false gets a meaningless seed.
template <int kD, typename T, typename Z>
__device__ __forceinline__ int exact_argmax(const T* xrow, const Z* zs, int m,
                                            bool active, int t) {
  float best = -INFINITY;
  int best_s = kMaxSeeds;
  if (active) {
    for (int s = t; s < m; s += 4) {
      float acc = 0.0f;
#pragma unroll 8
      for (int j = 0; j < kD; ++j)
        acc = fmaf(uoc::to_f32(xrow[j]), seed_value<kD>(zs, s, j), acc);
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
template <typename T, typename Z, int kD, int kPitch>
__device__ __noinline__ int2 recheck(const T* xrow, const Z* zs, int m, int t,
                                     int near, const int* slab,
                                     float* rechecked, int2 l1) {
#pragma unroll 1
  for (int i = 0; i < 2; ++i) {
    const bool mine = (near >> i) & 1;
    if (!__any_sync(0xFFFFFFFFu, mine)) continue;
    const int s = exact_argmax<kD>(xrow + 8 * i * kPitch, zs, m, mine, t);
    if (mine) {
      (i ? l1.y : l1.x) = slab[s];
      if (t == 0) atomicAdd(rechecked, 1.0f);
    }
  }
  return l1;
}

// x: [n, kD] rows 16-byte aligned (float32, or bf16); z: [m, kD]
// float32; seed_labels: [m]; z_valid: [n] or null; labels: [n] out;
// counts: [2 m] float32 (zeroed) += the block's histograms; rechecked: +=
// the pixels this block re-checked (float32, an exact integer below 2^24);
// part: [n] (passes 1 and 2; null in pass 0).  The block's shape is
// AssignShape<T, kD>.
template <typename T, typename Z, int kD, int kPass>
__device__ __forceinline__ void assign_body(
    const T* __restrict__ x, int n, const float* __restrict__ z,
    const int* __restrict__ seed_labels, int m,
    const unsigned char* __restrict__ z_valid, int* __restrict__ labels,
    float* __restrict__ counts, float* __restrict__ rechecked,
    float4* __restrict__ part, T* ring) {
  using Shape = AssignShape<T, kD>;
  constexpr int kPitch = Shape::kPitch;
  constexpr int kTile = Shape::kTile;
  constexpr int kRing = Shape::kStages;
  constexpr int kStageElems = kTile * kPitch;
  constexpr int kHist = kHistSeeds<kPass>;
  const PassSeeds ps = pass_seeds<kPass, kD>(z, seed_labels, m);
  Z* zs = reinterpret_cast<Z*>(ring + kRing * kStageElems);
  __shared__ __align__(16) int slab[kMaxSeeds];
  __shared__ int hist[2][kHist];
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int half = threadIdx.x / 128;            // warpgroup
  const int row = 16 * (threadIdx.x / 32 % 4) + g;  // first pixel of a thread
  const int mine = tiles_of_block<kTile>(n);
  // warpgroup `half` loads rows [64 half, 64 half + 64) of tile q into
  // ring stage q % kRing
  auto issue = [&](int q) {
    if (q < mine)
      issue_rows<T, kD, kPitch>(
          x, n,
          (static_cast<int>(blockIdx.x) + q * gridDim.x) * kTile +
              kHalfTile * half,
          kHalfTile, threadIdx.x % 128, 128,
          ring + (q % kRing) * kStageElems + kHalfTile * half * kPitch);
    cp_async_commit();
  };

#pragma unroll
  for (int q = 0; q < kRing - 1; ++q) issue(q);
  stage_assign<kD>(ps.z, ps.m, zs);
  for (int s = threadIdx.x; s < kHist; s += blockDim.x) {
    if (s < kMaxSeeds) slab[s] = s < ps.m ? ps.labels[s] : 0;
    hist[0][s] = hist[1][s] = 0;
  }
  // Z is read by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  for (int k = 0; k < mine; ++k) {
    // this warpgroup's rows of tile k have landed for all its threads, and
    // its rows of tile k - 1 are done with; the warpgroups do not wait for
    // each other
    cp_async_wait<kRing - 2>();
    if (half == 0)
      bar_sync<1>(128);
    else
      bar_sync<2>(128);
    issue(k + kRing - 1);
    const T* xs = ring + (k % kRing) * kStageElems + kHalfTile * half * kPitch;
    const int p0 = (static_cast<int>(blockIdx.x) + k * gridDim.x) * kTile +
                   kHalfTile * half + row;
    // thread t < 2 of the quad owns pixel p0 + 8t; its validity is loaded
    // before the products, which hide the load
    const int p = p0 + 8 * t;
    const bool owner = t < 2 && p < n;
    const bool valid = owner && (z_valid == nullptr || z_valid[p]);
    float acc[2][32];
    assign_product<kD>(xs, zs, ps.m, acc);
    Best r[2];
    thread_best(acc, t, ps.m, slab, r);
    int near = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      merge_quad(r[i]);
      if constexpr (kMergesPart<kPass>)
        if (p0 + 8 * i < n) merge_part(part, p0 + 8 * i, r[i]);
      if (p0 + 8 * i < n && r[i].b1 - r[i].b2 < kRecheckMargin<kD>)
        near |= 1 << i;
    }
    if constexpr (kStoresPart<kPass>) {
      if constexpr (kPass == 3) __syncwarp();  // every lane has read part
      if (owner) store_part(part, p, t == 0 ? r[0] : r[1]);
      continue;
    }
    int2 l1 = make_int2(r[0].l1, r[1].l1);
    if (__any_sync(0xFFFFFFFFu, near != 0)) {
      if constexpr (kLastOfMany<kPass>) {
        const GlobalSeeds<T> all{z};
        l1 = recheck<T, GlobalSeeds<T>, kD, kPitch>(
            xs + row * kPitch, &all, m, t, near, seed_labels, rechecked, l1);
      } else {
        l1 = recheck<T, Z, kD, kPitch>(xs + row * kPitch, zs, m, t, near,
                                       slab, rechecked, l1);
      }
    }

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
  if constexpr (kStoresPart<kPass>) return;
  __syncthreads();
  for (int s = threadIdx.x; s < m; s += blockDim.x) {
    if (hist[0][s]) atomicAdd(&counts[s], static_cast<float>(hist[0][s]));
    if (hist[1][s])
      atomicAdd(&counts[m + s], static_cast<float>(hist[1][s]));
  }
}

template <int kD, int kPass = 0>
__global__ void __launch_bounds__(AssignShape<float, kD>::kThreads, 1)
assign_tf32_kernel(const float* __restrict__ x, int n,
                   const float* __restrict__ z,
                   const int* __restrict__ seed_labels, int m,
                   const unsigned char* __restrict__ z_valid,
                   int* __restrict__ labels, float* __restrict__ counts,
                   float* __restrict__ rechecked, float4* __restrict__ part) {
  extern __shared__ __align__(128) float assign_f32_smem[];
  assign_body<float, unsigned, kD, kPass>(x, n, z, seed_labels, m, z_valid,
                                          labels, counts, rechecked, part,
                                          assign_f32_smem);
}

template <int kD, int kPass = 0>
__global__ void __launch_bounds__(AssignShape<__nv_bfloat16, kD>::kThreads, 2)
assign_bf16_kernel(const __nv_bfloat16* __restrict__ x, int n,
                   const float* __restrict__ z,
                   const int* __restrict__ seed_labels, int m,
                   const unsigned char* __restrict__ z_valid,
                   int* __restrict__ labels, float* __restrict__ counts,
                   float* __restrict__ rechecked, float4* __restrict__ part) {
  extern __shared__ __align__(128) __nv_bfloat16 assign_bf16_smem[];
  assign_body<__nv_bfloat16, __nv_bfloat16, kD, kPass>(
      x, n, z, seed_labels, m, z_valid, labels, counts, rechecked, part,
      assign_bf16_smem);
}

// ---------------------------------------------------------------------------
// float32 at d = 128: assign_tf32_wide_kernel, the parity assignment of the
// RGB-D cat fusion's embeddings (it replaced assign_tf32_kernel<128>, which
// ran one warpgroup a block through every step in series).
//
// Bound on the H100: 2*m*n*d flops three times over (the split's products:
// 23.6 GFLOP at m = 100, n = 307200: 0.048 ms at 495 TFLOP/s of TF32; 0.050
// ms for the 104 seed columns that the kernel computes) against one read
// of X (157 MB, 0.047 ms at 3.35 TB/s): bound by the tensor cores and the
// bytes about equally.
//
// Design, by what it buys:
//  - Overlap.  The block is two consumer warpgroups and one producer
//    warpgroup (kAWThreads), one block an SM.  The producer's first thread
//    loads the block's 64-pixel tiles in order by TMA, each as four boxes
//    of 64 pixels x 32 dims (128-byte rows, 128-byte swizzle), into a ring
//    of kAWStages stages.  Consumer c takes the block's tiles c, c + 2, ...,
//    so one warpgroup's CUDA-core work (the A split, thread_best,
//    merge_quad, the histograms, a rare re-check) runs while the other's
//    wgmmas run.  Within a tile a consumer splits the first 64 dims' A
//    fragments, issues their wgmmas, splits the other 64 dims' while those
//    run, releases the stage (the tile is in registers) and issues the
//    rest: the producer can refill a stage about as soon as it landed.
//  - Turns.  The consumers issue their tiles' wgmmas strictly in tile
//    order, each tile's two passes back to back (named barriers
//    kAWTurnBar + c): left free, the two fell into step, each one's
//    second pass queued behind the other's first, and the tensor cores
//    idled while both ran their CUDA-core work (on the H100 at the frame
//    0.0816 ms free, 0.0748 in turns; 224^2 0.0195 -> 0.0173).  A
//    re-check now delays the other consumer's next issue too (random unit
//    vectors at 224^2, 86 re-checked pixels: 0.052 ms free, 0.063 in
//    turns); chip_smoke.py's clustered inputs re-check no pixel.
//  - Tensor work.  Each k-chunk's product is one wgmma m64nNk8 over the
//    seeds, N = kN, the seed columns: 104 for m <= 104 (the recipes' 100
//    seeds), else 128, a kernel each, picked by the launch's plan: one
//    instruction where assign_tf32_kernel<128> issued an n64 product per
//    64 seeds, and 19% fewer columns at m = 100 (on the H100 at the
//    480x640 frame 0.137 ms with two n64 products, 0.101 with one n128,
//    0.092-0.101 with n104; a branch on m inside one kernel read 0.111).
//    The m64nN accumulator layout is the m64n128 one's first N / 8
//    8-column blocks, so acc[2][32] and thread_best serve every kN.
//  - Handshakes.  Tile k lands in stage k % kAWStages and completes
//    full[k % kAWStages][k % kAWConsumers], the barrier of its stage and
//    its consumer:
//    a consumer then waits on every phase of its own barriers in order
//    (with one barrier a stage, a consumer sees every other phase of it,
//    and a parity wait can pass on a phase two behind).  empty[s] counts
//    the four warps of the tile's consumer; the producer waits on each of
//    its phases in order.
//  - Fixed cost.  The consumers stage Z's split copies once, with a
//    thread's 16 float4 loads and its seed label's in flight at once (a
//    loop whose loads went one after another took 5.6-8.3 us a block on
//    the H100; now 3.7-6.2), while the producer's first loads are in
//    flight; the histograms are flushed once a block.
//  - Re-checks.  A re-check runs exact_argmax as assign_body's does, on
//    its pixel's row in global memory (the stage may hold another tile by
//    then).
//  - Registers.  setmaxnreg gives the consumers kAWConsumerRegs (acc 64,
//    two sets of one pass's split fragments 128) and the producer
//    kAWProducerRegs; 2 * 232 + 40 <= 3 * 168.
// Shared memory, all of it dynamic (static arrays cost 2,048 bytes where
// they hold 1,536), from a 1024-byte boundary, which the swizzle needs:
// the ring, 3 x 32 KB (stage s at 32 KB s, box b of it at 8 KB b); Z big,
// then Z small, 64 KB each (seed_word layout, as assign_body's); slab and
// hist[2]; the mbarriers full[3][2] and empty[3]: 1024 + 229,376 + 1,536 +
// 72 = 232,008 bytes of the 232,448 a block may have.
// Each pixel's S is summed exactly as assign_tf32_kernel summed it (the
// same split, the same 48 wgmma steps into each accumulator element in
// the same order: small * big, big * small, big * big per k-chunk,
// k-chunks in order; the n-extent changes no element's terms), so
// kRecheckMargin<128>'s derivation above holds as it stands:
// |S_kernel - S_plain| < 1.86e-5 + 7.6e-6 + 1.2e-6 < 2.8e-5 < 2^-15.
// The A fragment of row r (= 16 w + g, or + 8), k-chunk c, k index t (+ 4)
// is dim 8 c + t (+ 4): in box c / 4, 16-byte chunk 2 (c % 4) (+ 1) of
// the row, which the swizzle moves to chunk (2 (c % 4) (+ 1)) ^ (r % 8) =
// ... ^ g: a warp's 32 loads of one k index hit 32 distinct banks.
// ---------------------------------------------------------------------------
constexpr int kAWTile = 64;                              // pixels per tile
constexpr int kAWBox = 32;                               // dims per box
constexpr int kAWBoxBytes = kAWTile * kAWBox * 4;        // 8 KB
constexpr int kAWTileBytes = (kWideD / kAWBox) * kAWBoxBytes;  // 32 KB
constexpr int kAWStages = 3;
constexpr int kAWConsumers = 2;                          // warpgroups
constexpr int kAWConsumerThreads = 128 * kAWConsumers;
constexpr int kAWThreads = kAWConsumerThreads + 128;     // + the producer
constexpr int kAWProducerRegs = 40;
constexpr int kAWConsumerRegs = 232;
// named barriers: 1 spans the consumers; kAWTurnBar + c is consumer c's
// turn to issue
constexpr int kAWTurnBar = 2;
static_assert(kAWTurnBar + kAWConsumers <= 16, "named barriers");
// tile k completes full[k % stages][k % kAWConsumers]: a barrier's tiles
// are kAWPeriod<stages> apart
template <int kStages>
constexpr int kAWPeriod = std::lcm(kStages, kAWConsumers);
static_assert(kAWConsumerThreads >= kMaxSeeds, "a seed's label a thread");
static_assert(kAWConsumers * 128 * kAWConsumerRegs + 128 * kAWProducerRegs <=
                  65536, "registers");

// assign_tf32_wide_kernel's block, with AssignShape's members: threads,
// pixels per tile, stages of the ring and dynamic shared bytes (the layout
// above); and the registers its setmaxnreg hands out, which the launch
// must have given the block.  Pass 2's histograms of 256 labels (1 KB
// more) leave no room for a third stage: its ring has two (200,240 bytes),
// as pass 4's of 512 labels (202,288 bytes).
template <int kPass = 0>
struct AssignWideShape {
  static constexpr int kThreads = kAWThreads;
  static constexpr int kTile = kAWTile;
  static constexpr int kStages = kLastOfMany<kPass> ? 2 : kAWStages;
  static constexpr size_t kSmem =
      1024 + static_cast<size_t>(kStages) * kAWTileBytes +
      2 * sizeof(unsigned) * kMaxSeeds * kWideD +
      sizeof(int) * (kMaxSeeds + 2 * kHistSeeds<kPass>) +
      sizeof(unsigned long long) * kStages * (kAWConsumers + 1);
  static constexpr int kRegs =
      kAWConsumerThreads * kAWConsumerRegs + 128 * kAWProducerRegs;
  static constexpr bool kTma = true;  // X by the tensor map, then the rows
};

// A study build (-DASSIGN_CLOCKS, assign_study.py) records for each block
// of assign_tf32_wide_kernel (and of assign_bf16_wide_kernel, below, whose
// consumers' first parts are the claim with the wait for the tile, then
// the wgmmas' issue and the wgmmas to their end): consumer thread 0's
// clock64 at its start,
// after Z is staged, after its tiles and after the histograms' flush
// (marks 0-3); the producer thread's cycles in the wait for free stages
// and its tiles (4, 5); the dynamic shared memory's address (6); for each
// consumer c (up to 4), its first thread's clock after its tiles (8 + c)
// and its cycles summed over its tiles in the wait for a tile, the A split
// (both passes, with the first pass's wgmma issue), the wgmmas from the
// second pass's issue to their end, thread_best and merge_quad, the
// re-check and the labels and histograms (marks 12 + 6 c .. 17 + 6 c).
constexpr int kAssignClockBlocks = 160, kAssignMarks = 36;
#ifdef ASSIGN_CLOCKS
__device__ long long assign_clocks[kAssignClockBlocks][kAssignMarks];
__device__ __forceinline__ long long aw_now() { return clock64(); }
__device__ __forceinline__ void aw_mark(bool me, int at, long long value) {
  if (me && blockIdx.x < kAssignClockBlocks)
    assign_clocks[blockIdx.x][at] = value;
}
#else
__device__ __forceinline__ long long aw_now() { return 0; }
__device__ __forceinline__ void aw_mark(bool, int, long long) {}
#endif

// The consumers (thread tid of kAWConsumerThreads): Z [m, 128] float32
// (16-byte aligned) -> its split copies in the seed_word layout, zero past
// m, as stage_assign writes them, with a thread's 16 loads in flight at
// once (a warp: 8 rows of 64 bytes a load, 8 rows of 16 bytes a store
// phase, on distinct banks).
__device__ __forceinline__ void stage_wide_assign(const float* __restrict__ z,
                                                  int m, unsigned* zs,
                                                  int tid) {
  constexpr int kPer = kMaxSeeds * kWideD / 4 / kAWConsumerThreads;
  static_assert(kPer * kAWConsumerThreads == kMaxSeeds * kWideD / 4, "Z");
  float4 v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kAWConsumerThreads;
    const int s = 8 * (e / (8 * (kWideD / 4))) + e % 8;
    const int j = 4 * ((e / 8) % (kWideD / 4));
    v[i] = s < m ? *reinterpret_cast<const float4*>(z + s * kWideD + j)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kAWConsumerThreads;
    const int s = 8 * (e / (8 * (kWideD / 4))) + e % 8;
    const int j = 4 * ((e / 8) % (kWideD / 4));
    uint4 b, sm;
    split_tf32(v[i].x, b.x, sm.x);
    split_tf32(v[i].y, b.y, sm.y);
    split_tf32(v[i].z, b.z, sm.z);
    split_tf32(v[i].w, b.w, sm.w);
    const int w = seed_word(s, j, 4);
    *reinterpret_cast<uint4*>(zs + w) = b;
    *reinterpret_cast<uint4*>(zs + kMaxSeeds * kWideD + w) = sm;
  }
}

// The split A fragments of k-chunks [8 pass, 8 pass + 8) of the rows row
// and row + 8 (g = row % 8) of a landed tile (see the note above).
__device__ __forceinline__ void wide_fragments(const float* tile, int pass,
                                               int row, int g, int t,
                                               unsigned (&xb)[8][4],
                                               unsigned (&xsm)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int c = 8 * pass + kk;
    const float* r = tile + (c / 4) * (kAWBoxBytes / 4) + row * kAWBox + t;
    const int lo = ((2 * (c % 4)) ^ g) * 4, hi = ((2 * (c % 4) + 1) ^ g) * 4;
    const float a[4] = {r[lo], r[8 * kAWBox + lo], r[hi],
                        r[8 * kAWBox + hi]};
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(a[q], xb[kk][q], xsm[kk][q]);
  }
}

// acc's first 52 registers (the m64n104 accumulator layout: the m64n128
// layout's first 13 8-column blocks, seeds [0, 104)) += a * b; as
// wgmma_tf32.
__device__ __forceinline__ void wgmma_tf32_n104(float (&acc)[2][32],
                                               const unsigned (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51"
      "}, {%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
      : "+f"(acc[0][0]), "+f"(acc[0][1]), "+f"(acc[0][2]), "+f"(acc[0][3]),
        "+f"(acc[0][4]), "+f"(acc[0][5]), "+f"(acc[0][6]), "+f"(acc[0][7]),
        "+f"(acc[0][8]), "+f"(acc[0][9]), "+f"(acc[0][10]), "+f"(acc[0][11]),
        "+f"(acc[0][12]), "+f"(acc[0][13]), "+f"(acc[0][14]), "+f"(acc[0][15]),
        "+f"(acc[0][16]), "+f"(acc[0][17]), "+f"(acc[0][18]), "+f"(acc[0][19]),
        "+f"(acc[0][20]), "+f"(acc[0][21]), "+f"(acc[0][22]), "+f"(acc[0][23]),
        "+f"(acc[0][24]), "+f"(acc[0][25]), "+f"(acc[0][26]), "+f"(acc[0][27]),
        "+f"(acc[0][28]), "+f"(acc[0][29]), "+f"(acc[0][30]), "+f"(acc[0][31]),
        "+f"(acc[1][0]), "+f"(acc[1][1]), "+f"(acc[1][2]), "+f"(acc[1][3]),
        "+f"(acc[1][4]), "+f"(acc[1][5]), "+f"(acc[1][6]), "+f"(acc[1][7]),
        "+f"(acc[1][8]), "+f"(acc[1][9]), "+f"(acc[1][10]), "+f"(acc[1][11]),
        "+f"(acc[1][12]), "+f"(acc[1][13]), "+f"(acc[1][14]), "+f"(acc[1][15]),
        "+f"(acc[1][16]), "+f"(acc[1][17]), "+f"(acc[1][18]), "+f"(acc[1][19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// acc (the m64n128 accumulator layout, seeds [0, 128)) += a * b; as
// wgmma_tf32.
__device__ __forceinline__ void wgmma_tf32_n128(float (&acc)[2][32],
                                               const unsigned (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(acc[0][0]), "+f"(acc[0][1]), "+f"(acc[0][2]), "+f"(acc[0][3]),
        "+f"(acc[0][4]), "+f"(acc[0][5]), "+f"(acc[0][6]), "+f"(acc[0][7]),
        "+f"(acc[0][8]), "+f"(acc[0][9]), "+f"(acc[0][10]), "+f"(acc[0][11]),
        "+f"(acc[0][12]), "+f"(acc[0][13]), "+f"(acc[0][14]), "+f"(acc[0][15]),
        "+f"(acc[0][16]), "+f"(acc[0][17]), "+f"(acc[0][18]), "+f"(acc[0][19]),
        "+f"(acc[0][20]), "+f"(acc[0][21]), "+f"(acc[0][22]), "+f"(acc[0][23]),
        "+f"(acc[0][24]), "+f"(acc[0][25]), "+f"(acc[0][26]), "+f"(acc[0][27]),
        "+f"(acc[0][28]), "+f"(acc[0][29]), "+f"(acc[0][30]), "+f"(acc[0][31]),
        "+f"(acc[1][0]), "+f"(acc[1][1]), "+f"(acc[1][2]), "+f"(acc[1][3]),
        "+f"(acc[1][4]), "+f"(acc[1][5]), "+f"(acc[1][6]), "+f"(acc[1][7]),
        "+f"(acc[1][8]), "+f"(acc[1][9]), "+f"(acc[1][10]), "+f"(acc[1][11]),
        "+f"(acc[1][12]), "+f"(acc[1][13]), "+f"(acc[1][14]), "+f"(acc[1][15]),
        "+f"(acc[1][16]), "+f"(acc[1][17]), "+f"(acc[1][18]), "+f"(acc[1][19]),
        "+f"(acc[1][20]), "+f"(acc[1][21]), "+f"(acc[1][22]), "+f"(acc[1][23]),
        "+f"(acc[1][24]), "+f"(acc[1][25]), "+f"(acc[1][26]), "+f"(acc[1][27]),
        "+f"(acc[1][28]), "+f"(acc[1][29]), "+f"(acc[1][30]), "+f"(acc[1][31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The first kN / 2 registers of acc (seeds [0, kN)) += a * b: one wgmma
// m64nNk8, N = kN (104 or 128).
template <int kN>
__device__ __forceinline__ void wgmma_tf32_seeds(float (&acc)[2][32],
                                                 const unsigned (&a)[4],
                                                 uint64_t desc) {
  static_assert(kN == 104 || kN == 128, "seed columns");
  if constexpr (kN == 104)
    wgmma_tf32_n104(acc, a, desc);
  else
    wgmma_tf32_n128(acc, a, desc);
}

// acc += the pass's products against seeds [0, kN): per k-chunk small *
// big, big * small, big * big, as assign_product.
template <int kN>
__device__ __forceinline__ void wide_product(const unsigned* zs, int pass,
                                             const unsigned (&xb)[8][4],
                                             const unsigned (&xsm)[8][4],
                                             float (&acc)[2][32]) {
  const unsigned* zsm = zs + kMaxSeeds * kWideD;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int o = 2 * (8 * pass + kk) * (kMaxSeeds / 8) * (kCore / 4);
    const uint64_t db = smem_desc(zs + o, (kMaxSeeds / 8) * kCore, kCore);
    const uint64_t ds = smem_desc(zsm + o, (kMaxSeeds / 8) * kCore, kCore);
    wgmma_tf32_seeds<kN>(acc, xsm[kk], db);
    wgmma_tf32_seeds<kN>(acc, xb[kk], ds);
    wgmma_tf32_seeds<kN>(acc, xb[kk], db);
  }
}

// thread_best over the kN / 8 blocks of 8 seeds that the kernel computes
// (m <= kN), a count known at compile time: every block's labels are
// loaded up front and no loop waits on a branch on m; seeds at or past m
// score -inf.  The same b1, l1 and b2 as thread_best.
template <int kN>
__device__ __forceinline__ void thread_best_wide(float (&acc)[2][32], int t,
                                                 int m, const int* slab,
                                                 Best (&r)[2]) {
  constexpr int kBlocks = kN / 8;
  auto score = [&](int i, int blk, int e) -> float& {
    return acc[blk / 8][4 * (blk % 8) + 2 * i + e];
  };
  const int2* lab2 = reinterpret_cast<const int2*>(slab + 2 * t);
  int2 lb[kBlocks];
#pragma unroll
  for (int blk = 0; blk < kBlocks; ++blk) lb[blk] = lab2[4 * blk];
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
  for (int blk = 0; blk < kBlocks; ++blk)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool real = 8 * blk + 2 * t + e < m;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!real) score(i, blk, e) = -INFINITY;
        const int c = (2 * blk + e) % 4;
        if (score(i, blk, e) > b[i][c]) {
          b[i][c] = score(i, blk, e);
          l[i][c] = e ? lb[blk].y : lb[blk].x;
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
  for (int blk = 0; blk < kBlocks; ++blk)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if ((e ? lb[blk].y : lb[blk].x) != r[i].l1) {
          const int c = (2 * blk + e) % 4;
          b[i][c] = fmaxf(b[i][c], score(i, blk, e));
        }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    r[i].b2 = fmaxf(fmaxf(b[i][0], b[i][1]), fmaxf(b[i][2], b[i][3]));
}

// xmap: X [n, 128] float32 (16-byte aligned) as boxes of 32 dims x 64
// pixels, 128-byte swizzle, zeros past n; x: the same rows (the re-check
// reads them); the rest as assign_body's, m <= kN (a pass's seeds).
// blockDim.x = kAWThreads.
template <int kN, int kPass = 0>
__global__ void __launch_bounds__(kAWThreads, 1)
assign_tf32_wide_kernel(const __grid_constant__ CUtensorMap xmap,
                        const float* __restrict__ x, int n,
                        const float* __restrict__ z,
                        const int* __restrict__ seed_labels, int m,
                        const unsigned char* __restrict__ z_valid,
                        int* __restrict__ labels, float* __restrict__ counts,
                        float* __restrict__ rechecked,
                        float4* __restrict__ part) {
  constexpr int kD = kWideD;
  constexpr int kStages = AssignWideShape<kPass>::kStages;
  constexpr int kPeriod = kAWPeriod<kStages>;
  constexpr int kHist = kHistSeeds<kPass>;
  const PassSeeds ps = pass_seeds<kPass, kD>(z, seed_labels, m);
  extern __shared__ __align__(1024) unsigned char aw_smem[];
  unsigned char* ring = aw_smem + (1024 - smem_addr(aw_smem) % 1024) % 1024;
  unsigned* zs = reinterpret_cast<unsigned*>(ring + kStages * kAWTileBytes);
  int* slab = reinterpret_cast<int*>(zs + 2 * kMaxSeeds * kD);
  auto* hist = reinterpret_cast<int(*)[kHist]>(slab + kMaxSeeds);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(slab + kMaxSeeds + 2 * kHist);
  unsigned long long* empty = full + kStages * kAWConsumers;
  const int mine = tiles_of_block<kAWTile>(n);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      for (int c = 0; c < kAWConsumers; ++c)
        uoc::mbar_init(full + kAWConsumers * s + c, 1);
      uoc::mbar_init(empty + s, 4);  // the warps of the tile's consumer
    }
  }
  __syncthreads();

  if (static_cast<int>(threadIdx.x) >= kAWConsumerThreads) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kAWProducerRegs));
    if (static_cast<int>(threadIdx.x) != kAWConsumerThreads) return;
    long long waited = 0;  // with ASSIGN_CLOCKS
    for (int k = 0; k < mine; ++k) {
      const int s = k % kStages;
      const long long c0 = aw_now();
      if (k >= kStages)  // the stage's last tile is in its registers
        uoc::mbar_wait(empty + s, (k / kStages - 1) & 1);
      waited += aw_now() - c0;
      void* bar = full + kAWConsumers * s + k % kAWConsumers;
      const int p0 = (static_cast<int>(blockIdx.x) + k * gridDim.x) * kAWTile;
      uoc::mbar_expect(bar, kAWTileBytes);
#pragma unroll
      for (int b = 0; b < kD / kAWBox; ++b)
        tma_load_box(ring + s * kAWTileBytes + b * kAWBoxBytes, &xmap,
                     b * kAWBox, p0, bar);
    }
    aw_mark(true, 4, waited);
    aw_mark(true, 5, mine);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kAWConsumerRegs));
  const int tid = threadIdx.x;
  const int wg = tid / 128, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int row = 16 * (tid / 32 % 4) + g;  // first pixel of a thread
  const bool me = tid % 128 == 0;           // a consumer's clocked thread
  aw_mark(tid == 0, 0, aw_now());
  aw_mark(tid == 0, 6, smem_addr(aw_smem));
  // seed tid's label, loaded beside Z
  const int label = tid < ps.m ? ps.labels[tid] : 0;
  stage_wide_assign(ps.z, ps.m, zs, tid);
  if (tid < kMaxSeeds) slab[tid] = label;
  if constexpr (kHist > kAWConsumerThreads) {
    for (int s = tid; s < kHist; s += kAWConsumerThreads)
      hist[0][s] = hist[1][s] = 0;
  } else if (tid < kHist) {
    hist[0][tid] = hist[1][tid] = 0;
  }
  uoc::fence_proxy_async();  // Z is read by wgmma (the async proxy)
  bar_sync<1>(kAWConsumerThreads);
  aw_mark(tid == 0, 1, aw_now());

  long long spent[6] = {0, 0, 0, 0, 0, 0};  // with ASSIGN_CLOCKS
  for (int k = wg; k < mine; k += kAWConsumers) {
    const int s = k % kStages;
    const int p0 =
        (static_cast<int>(blockIdx.x) + k * gridDim.x) * kAWTile + row;
    // thread t < 2 of the quad owns pixel p0 + 8t; its validity is loaded
    // before the products, which hide the load
    const int p = p0 + 8 * t;
    const bool owner = t < 2 && p < n;
    const bool valid = owner && (z_valid == nullptr || z_valid[p]);
    long long c0 = aw_now();
    uoc::mbar_wait(full + kAWConsumers * s + wg, (k / kPeriod) & 1);
    long long c1 = aw_now();
    spent[0] += c1 - c0;
    const float* tile =
        reinterpret_cast<const float*>(ring + s * kAWTileBytes);
    float acc[2][32];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i / 32][i % 32] = 0.0f;
    // two sets of split fragments: pass 1's are split while pass 0's
    // wgmmas run (one set, with a wait between the passes, read 0.092 ms
    // at the frame against 0.081 on the H100)
    unsigned xb[2][8][4], xs[2][8][4];
    wide_fragments(tile, 0, row, g, t, xb[0], xs[0]);
    // the consumers issue their tiles' wgmmas in turns: tile k's after
    // tile k - 1's, its two passes back to back
    if (k > 0) named_sync(kAWTurnBar + wg, 128 * 2);
    wgmma_fence();
    wide_product<kN>(zs, 0, xb[0], xs[0], acc);
    wgmma_commit();
    wide_fragments(tile, 1, row, g, t, xb[1], xs[1]);
    __syncwarp();
    if (lane == 0) uoc::mbar_arrive(empty + s);  // the tile is in registers
    c0 = aw_now();
    spent[1] += c0 - c1;
    wgmma_fence();
    wide_product<kN>(zs, 1, xb[1], xs[1], acc);
    wgmma_commit();
    if (k + 1 < mine)  // tile k + 1's turn
      named_arrive(kAWTurnBar + (wg + 1) % kAWConsumers, 128 * 2);
    wgmma_wait();
    pin_registers(acc[0]);
    pin_registers(acc[1]);
    pin_registers(xb);
    pin_registers(xs);
    c1 = aw_now();
    spent[2] += c1 - c0;

    Best r[2];
    thread_best_wide<kN>(acc, t, ps.m, slab, r);
    int near = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      merge_quad(r[i]);
      if constexpr (kMergesPart<kPass>)
        if (p0 + 8 * i < n) merge_part(part, p0 + 8 * i, r[i]);
      if (p0 + 8 * i < n && r[i].b1 - r[i].b2 < kRecheckMargin<kD>)
        near |= 1 << i;
    }
    if constexpr (kStoresPart<kPass>) {
      if constexpr (kPass == 3) __syncwarp();  // every lane has read part
      if (owner) store_part(part, p, t == 0 ? r[0] : r[1]);
      continue;
    }
    c0 = aw_now();
    spent[3] += c0 - c1;
    int2 l1 = make_int2(r[0].l1, r[1].l1);
    if (__any_sync(0xFFFFFFFFu, near != 0)) {
      if constexpr (kLastOfMany<kPass>) {
        const GlobalSeeds<float> all{z};
        l1 = recheck<float, GlobalSeeds<float>, kD, kD>(
            x + static_cast<size_t>(p0) * kD, &all, m, t, near, seed_labels,
            rechecked, l1);
      } else {
        l1 = recheck<float, unsigned, kD, kD>(
            x + static_cast<size_t>(p0) * kD, zs, m, t, near, slab,
            rechecked, l1);
      }
    }
    c1 = aw_now();
    spent[4] += c1 - c0;

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
    spent[5] += aw_now() - c1;
  }
  aw_mark(tid == 0, 2, aw_now());
  aw_mark(me, 8 + wg, aw_now());
#pragma unroll
  for (int i = 0; i < 6; ++i) aw_mark(me, 12 + 6 * wg + i, spent[i]);
  if constexpr (kStoresPart<kPass>) return;
  bar_sync<1>(kAWConsumerThreads);
  for (int s = tid; s < m; s += kAWConsumerThreads) {
    if (hist[0][s]) atomicAdd(&counts[s], static_cast<float>(hist[0][s]));
    if (hist[1][s])
      atomicAdd(&counts[m + s], static_cast<float>(hist[1][s]));
  }
  aw_mark(tid == 0, 3, aw_now());
}

// ---------------------------------------------------------------------------
// bfloat16 at d = 128: assign_bf16_wide_kernel, the fast mode's assignment
// of the RGB-D cat fusion's embeddings (it replaced assign_bf16_kernel<128>,
// assign_body at width 128: two warpgroups a block, each waiting on its own
// half of 128-pixel tiles in a cp.async ring of two, A through registers by
// ldmatrix, two n64 products at m = 100, and a warpgroup's argmax never
// beside its own wgmmas).
//
// Bound on the H100: one read of X (78.6 MB at n = 307200: 0.024 ms at
// 3.35 TB/s) against 2*m*n*d flops (7.9 GFLOP at m = 100: 0.008 ms at 989
// TFLOP/s of bf16): bound by the bytes.
//
// Design: assign_tf32_wide_kernel's producer, TMA tiles and one product a
// k-chunk, without the split, and with more warps for the CUDA-core work.
//  - Tiles.  The producer warp's first thread loads the block's 64-pixel
//    tiles in order by TMA, each as two boxes of 64 pixels x 64 dims
//    (128-byte rows, the 128-byte swizzle; hill_bf16_wide_kernel's map),
//    16 KB a tile, into a ring of kABStages stages: tile k in stage k %
//    kABStages, completing full[s]; it reloads a stage once empty[s] has
//    the four warps of the consumer that took its last tile.
//  - Claims.  Three consumer warpgroups claim the block's tiles in order
//    from a shared counter (atomicAdd by a consumer's leader), so one that
//    is slow on a tile (a re-check) holds up no other.  A claim waits
//    until the producer has issued the tile's load (issued): full[s] has
//    then completed the phases of the stage's earlier tiles, and the
//    parity (k / kABStages) & 1 names tile k's own phase.  (Without that
//    wait, a claim could run a whole ring ahead of a tile still in flight
//    and pass on the phase before it.)
//  - Tensor work.  Each 16-dim k-chunk is one wgmma m64nNk16, N = kN (104
//    for m <= 104, else 128; the plan picks the kernel).  A is read
//    straight from the swizzled stage by a shared-memory descriptor (bf16
//    wgmma takes A from shared memory; nothing is split or staged in
//    registers), B is bf16(Z), staged once a block in the seed_word
//    layout, with a thread's loads and its seed label's in flight at once
//    while the first tiles load.  A stage is released as soon as its wgmma
//    group completes.
//  - thread_best_wide, merge_quad, the histograms and the flush once a
//    block are the float32 kernel's.  The re-check is exact_argmax on the
//    pixel's bf16 row in global memory against bf16(Z) widened to fp32, as
//    assign_body's bf16 re-check and the plain version compute it.
//  - Why three claiming consumers.  The float32 kernel's two consumers in
//    turns read 0.0425 ms at the 480x640 frame on the H100: the tensor
//    work is a tenth of the float32 kernel's, so the consumers' CUDA-core
//    work (thread_best_wide, merge_quad, the histograms: about 700
//    instructions a warp a tile) bounds it, and a re-check in one consumer
//    held up the other's turn (random unit vectors: 0.279 ms, the
//    assign_body kernel 0.172).  Three consumers read 0.037-0.038; a fourth
//    (with the producer's loads taken over by the consumers) helps random
//    inputs at the frame but reads 0.5-0.8 us slower at the crops.
//  - Registers: 416 threads, at most 152 registers a thread (the kernel
//    takes 118-119), no setmaxnreg, no spills.
// The margin.  Each pixel's S is 8 wgmma steps into one accumulator (the 8
// k-chunks in order), each summing 16 exact bf16 products and the
// accumulator: the steps and terms that the bf16 bound above counts at d =
// 128 (the n-extent changes no element's terms; two n64 products made the
// same 8 steps), so it holds as it stands: 8 steps of 17 terms, 4.1e-6,
// and the plain version's 128 * 2^-24 = 7.6e-6, below 2^-15 =
// kRecheckMargin<128> / 2.
// Shared memory, all of it dynamic, from a 1024-byte boundary (the
// swizzle's): the ring, kABStages x 16 KB (stage s at 16 KB s, box b of it
// at 8 KB b); bf16(Z), 32 KB; slab and hist[2]; next, issued and the
// claims; the mbarriers full[6] and empty[6]: 1024 + 98,304 + 32,768 +
// 1,536 + 32 + 96 = 133,760 bytes.  Two blocks would fit in shared memory
// with a ring of four, not in registers (2 x 416 threads x 118).
// The A operand of k-chunk c is dims [16 c, 16 c + 16): in box c / 4, 32
// bytes (c % 4) into each pixel's 128-byte row; the descriptor's start
// address carries that offset and the swizzle moves each 16-byte chunk by
// the row's index within its 8-row group, as in hill_bf16_wide_kernel.
// ---------------------------------------------------------------------------
constexpr int kABStages = 6;
constexpr int kABConsumers = 3;                          // warpgroups
constexpr int kABConsumerThreads = 128 * kABConsumers;
constexpr int kABThreads = kABConsumerThreads + 32;      // + the producer
// named barrier 1 spans the consumers, kABBar + c consumer c's four warps
constexpr int kABBar = 2;
static_assert(kABBar + kABConsumers <= 16, "named barriers");
static_assert(kABConsumerThreads >= kMaxSeeds, "a seed's label a thread");

template <int kPass = 0>
struct AssignBF16WideShape {
  static constexpr int kThreads = kABThreads;
  static constexpr int kTile = kBWTile;
  static constexpr int kStages = kABStages;
  static constexpr size_t kSmem =
      1024 + static_cast<size_t>(kABStages) * kBWTileBytes +
      sizeof(__nv_bfloat16) * kMaxSeeds * kWideD +
      sizeof(int) * (kMaxSeeds + 2 * kHistSeeds<kPass>) +
      sizeof(int) * (2 * kABConsumers + 2) +
      sizeof(unsigned long long) * 2 * kABStages;
  static constexpr int kRegs = 0;
  static constexpr bool kTma = true;
};

// The consumers (thread tid of kABConsumerThreads): Z [m, 128] float32
// (16-byte aligned) -> bf16(Z) in the seed_word layout, zero past m, as
// stage_assign writes it, with a thread's loads in flight at once (a
// warp: 8 rows of 64 bytes a load; a store phase, 8 rows of 8 bytes on
// distinct banks).
__device__ __forceinline__ void stage_wide_bf16_assign(
    const float* __restrict__ z, int m, __nv_bfloat16* zs, int tid) {
  constexpr int kAll = kMaxSeeds * kWideD / 4;
  constexpr int kPer = (kAll + kABConsumerThreads - 1) / kABConsumerThreads;
  float4 v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kABConsumerThreads;
    const int s = 8 * (e / (8 * (kWideD / 4))) + e % 8;
    const int j = 4 * ((e / 8) % (kWideD / 4));
    v[i] = e < kAll && s < m
               ? *reinterpret_cast<const float4*>(z + s * kWideD + j)
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kABConsumerThreads;
    const int s = 8 * (e / (8 * (kWideD / 4))) + e % 8;
    const int j = 4 * ((e / 8) % (kWideD / 4));
    if (e < kAll)
      *reinterpret_cast<uint2*>(zs + seed_word(s, j, 8)) =
          make_uint2(pack_bf16(v[i].x, v[i].y), pack_bf16(v[i].z, v[i].w));
  }
}

// acc's first 52 registers (the m64n104 accumulator layout: the m64n128
// layout's first 13 8-column blocks, seeds [0, 104)) = acc (or 0 where
// accumulate is false) + a * b: a (64 pixels x 16 dims bf16) and b (16 dims
// x 104 seeds bf16), both K-major in shared memory (adesc, bdesc).
// Asynchronous, as wgmma_tf32.
__device__ __forceinline__ void wgmma_bf16_ss_n104(float (&acc)[2][32],
                                                  uint64_t adesc,
                                                  uint64_t bdesc,
                                                  bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51"
      "}, %52, %53, p, 1, 1, 0, 0;\n}\n"
      : "+f"(acc[0][0]), "+f"(acc[0][1]), "+f"(acc[0][2]), "+f"(acc[0][3]),
        "+f"(acc[0][4]), "+f"(acc[0][5]), "+f"(acc[0][6]), "+f"(acc[0][7]),
        "+f"(acc[0][8]), "+f"(acc[0][9]), "+f"(acc[0][10]), "+f"(acc[0][11]),
        "+f"(acc[0][12]), "+f"(acc[0][13]), "+f"(acc[0][14]), "+f"(acc[0][15]),
        "+f"(acc[0][16]), "+f"(acc[0][17]), "+f"(acc[0][18]), "+f"(acc[0][19]),
        "+f"(acc[0][20]), "+f"(acc[0][21]), "+f"(acc[0][22]), "+f"(acc[0][23]),
        "+f"(acc[0][24]), "+f"(acc[0][25]), "+f"(acc[0][26]), "+f"(acc[0][27]),
        "+f"(acc[0][28]), "+f"(acc[0][29]), "+f"(acc[0][30]), "+f"(acc[0][31]),
        "+f"(acc[1][0]), "+f"(acc[1][1]), "+f"(acc[1][2]), "+f"(acc[1][3]),
        "+f"(acc[1][4]), "+f"(acc[1][5]), "+f"(acc[1][6]), "+f"(acc[1][7]),
        "+f"(acc[1][8]), "+f"(acc[1][9]), "+f"(acc[1][10]), "+f"(acc[1][11]),
        "+f"(acc[1][12]), "+f"(acc[1][13]), "+f"(acc[1][14]), "+f"(acc[1][15]),
        "+f"(acc[1][16]), "+f"(acc[1][17]), "+f"(acc[1][18]), "+f"(acc[1][19])
      : "l"(adesc), "l"(bdesc), "r"(static_cast<int>(accumulate)));
}

// acc's first 64 registers (the m64n128 accumulator layout: the m64n128
// layout's first 16 8-column blocks, seeds [0, 128)) = acc (or 0 where
// accumulate is false) + a * b: a (64 pixels x 16 dims bf16) and b (16 dims
// x 128 seeds bf16), both K-major in shared memory (adesc, bdesc).
// Asynchronous, as wgmma_tf32.
__device__ __forceinline__ void wgmma_bf16_ss_n128(float (&acc)[2][32],
                                                  uint64_t adesc,
                                                  uint64_t bdesc,
                                                  bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(acc[0][0]), "+f"(acc[0][1]), "+f"(acc[0][2]), "+f"(acc[0][3]),
        "+f"(acc[0][4]), "+f"(acc[0][5]), "+f"(acc[0][6]), "+f"(acc[0][7]),
        "+f"(acc[0][8]), "+f"(acc[0][9]), "+f"(acc[0][10]), "+f"(acc[0][11]),
        "+f"(acc[0][12]), "+f"(acc[0][13]), "+f"(acc[0][14]), "+f"(acc[0][15]),
        "+f"(acc[0][16]), "+f"(acc[0][17]), "+f"(acc[0][18]), "+f"(acc[0][19]),
        "+f"(acc[0][20]), "+f"(acc[0][21]), "+f"(acc[0][22]), "+f"(acc[0][23]),
        "+f"(acc[0][24]), "+f"(acc[0][25]), "+f"(acc[0][26]), "+f"(acc[0][27]),
        "+f"(acc[0][28]), "+f"(acc[0][29]), "+f"(acc[0][30]), "+f"(acc[0][31]),
        "+f"(acc[1][0]), "+f"(acc[1][1]), "+f"(acc[1][2]), "+f"(acc[1][3]),
        "+f"(acc[1][4]), "+f"(acc[1][5]), "+f"(acc[1][6]), "+f"(acc[1][7]),
        "+f"(acc[1][8]), "+f"(acc[1][9]), "+f"(acc[1][10]), "+f"(acc[1][11]),
        "+f"(acc[1][12]), "+f"(acc[1][13]), "+f"(acc[1][14]), "+f"(acc[1][15]),
        "+f"(acc[1][16]), "+f"(acc[1][17]), "+f"(acc[1][18]), "+f"(acc[1][19]),
        "+f"(acc[1][20]), "+f"(acc[1][21]), "+f"(acc[1][22]), "+f"(acc[1][23]),
        "+f"(acc[1][24]), "+f"(acc[1][25]), "+f"(acc[1][26]), "+f"(acc[1][27]),
        "+f"(acc[1][28]), "+f"(acc[1][29]), "+f"(acc[1][30]), "+f"(acc[1][31])
      : "l"(adesc), "l"(bdesc), "r"(static_cast<int>(accumulate)));
}

// The first kN / 2 registers of acc (seeds [0, kN)) = the product of
// k-chunk 0 (accumulate false) or acc + it: one wgmma m64nNk16, N = kN.
template <int kN>
__device__ __forceinline__ void wgmma_bf16_seeds(float (&acc)[2][32],
                                                 uint64_t adesc,
                                                 uint64_t bdesc,
                                                 bool accumulate) {
  static_assert(kN == 104 || kN == 128, "seed columns");
  if constexpr (kN == 104)
    wgmma_bf16_ss_n104(acc, adesc, bdesc, accumulate);
  else
    wgmma_bf16_ss_n128(acc, adesc, bdesc, accumulate);
}

// xmap: X [n, 128] bfloat16 (16-byte aligned) as boxes of 64 dims x 64
// pixels, 128-byte swizzle, zeros past n; x: the same rows (the re-check
// reads them); the rest as assign_body's, m <= kN (a pass's seeds).
// blockDim.x = kABThreads.
template <int kN, int kPass = 0>
__global__ void __launch_bounds__(kABThreads, 1)
assign_bf16_wide_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __nv_bfloat16* __restrict__ x, int n,
                        const float* __restrict__ z,
                        const int* __restrict__ seed_labels, int m,
                        const unsigned char* __restrict__ z_valid,
                        int* __restrict__ labels, float* __restrict__ counts,
                        float* __restrict__ rechecked,
                        float4* __restrict__ part) {
  constexpr int kD = kWideD;
  constexpr int kHist = kHistSeeds<kPass>;
  const PassSeeds ps = pass_seeds<kPass, kD>(z, seed_labels, m);
  extern __shared__ __align__(1024) unsigned char ab_smem[];
  unsigned char* ring = ab_smem + (1024 - smem_addr(ab_smem) % 1024) % 1024;
  __nv_bfloat16* zs =
      reinterpret_cast<__nv_bfloat16*>(ring + kABStages * kBWTileBytes);
  int* slab = reinterpret_cast<int*>(zs + kMaxSeeds * kD);
  auto* hist = reinterpret_cast<int(*)[kHist]>(slab + kMaxSeeds);
  // the next tile to claim; the tiles whose loads the producer has issued;
  // each consumer's claims (two alternating slots: a slot is rewritten only
  // after its readers passed the next claim's barrier)
  int* next = slab + kMaxSeeds + 2 * kHist;
  volatile int* issued = next + 1;
  int* claim = next + 2;
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(claim + 2 * kABConsumers);
  unsigned long long* empty = full + kABStages;
  const int mine = tiles_of_block<kBWTile>(n);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kABStages; ++s) {
      uoc::mbar_init(full + s, 1);
      uoc::mbar_init(empty + s, 4);  // the warps of the tile's consumer
    }
    *next = 0;
    *issued = 0;
  }
  __syncthreads();

  if (static_cast<int>(threadIdx.x) >= kABConsumerThreads) {  // producer
    if (static_cast<int>(threadIdx.x) != kABConsumerThreads) return;
    long long waited = 0;  // with ASSIGN_CLOCKS
    for (int k = 0; k < mine; ++k) {
      const int s = k % kABStages;
      const long long c0 = aw_now();
      if (k >= kABStages)  // the stage's last tile's wgmmas are done
        uoc::mbar_wait(empty + s, (k / kABStages - 1) & 1);
      waited += aw_now() - c0;
      const int p0 = (static_cast<int>(blockIdx.x) + k * gridDim.x) * kBWTile;
      uoc::mbar_expect(full + s, kBWTileBytes);
#pragma unroll
      for (int b = 0; b < kD / kBWBox; ++b)
        tma_load_box(ring + s * kBWTileBytes + b * kBWBoxBytes, &xmap,
                     b * kBWBox, p0, full + s);
      __threadfence_block();
      *issued = k + 1;
    }
    aw_mark(true, 4, waited);
    aw_mark(true, 5, mine);
    return;
  }

  const int tid = threadIdx.x;
  const int wg = tid / 128, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int row = 16 * (tid / 32 % 4) + g;  // first pixel of a thread
  const bool me = tid % 128 == 0;           // a consumer's leader
  aw_mark(tid == 0, 0, aw_now());
  aw_mark(tid == 0, 6, smem_addr(ab_smem));
  // seed tid's label, loaded beside Z
  const int label = tid < ps.m ? ps.labels[tid] : 0;
  stage_wide_bf16_assign(ps.z, ps.m, zs, tid);
  if (tid < kMaxSeeds) slab[tid] = label;
  if constexpr (kHist > kABConsumerThreads) {
    for (int s = tid; s < kHist; s += kABConsumerThreads)
      hist[0][s] = hist[1][s] = 0;
  } else if (tid < kHist) {
    hist[0][tid] = hist[1][tid] = 0;
  }
  uoc::fence_proxy_async();  // Z is read by wgmma (the async proxy)
  bar_sync<1>(kABConsumerThreads);
  aw_mark(tid == 0, 1, aw_now());
  // B of k-chunk c: its two core-matrix columns of bf16(Z), seeds from 0
  const unsigned zaddr = smem_addr(zs);
  auto bdesc = [&](int c) {
    return static_cast<uint64_t>(((zaddr + c * 4096) >> 4) & 0x3FFFu) |
           (static_cast<uint64_t>((kMaxSeeds / 8) * kCore >> 4) << 16) |
           (static_cast<uint64_t>(kCore >> 4) << 32);
  };

  long long spent[6] = {0, 0, 0, 0, 0, 0};  // with ASSIGN_CLOCKS
  for (int q = 0;; ++q) {
    // the consumer's leader claims the block's next tile, and waits until
    // the producer has issued its load: the stage's barrier has then
    // completed the phases of the stage's earlier tiles, so the parity below
    // names this tile's phase and not one two phases back
    long long c0 = aw_now();
    if (me) {
      const int kk = atomicAdd(next, 1);
      if (kk < mine)
        while (*issued <= kk) {
        }
      claim[2 * wg + (q & 1)] = kk;
    }
    named_sync(kABBar + wg, 128);
    const int k = claim[2 * wg + (q & 1)];
    if (k >= mine) break;
    const int s = k % kABStages;
    const int p0 =
        (static_cast<int>(blockIdx.x) + k * gridDim.x) * kBWTile + row;
    // thread t < 2 of the quad owns pixel p0 + 8t; its validity is loaded
    // before the products, which hide the load
    const int p = p0 + 8 * t;
    const bool owner = t < 2 && p < n;
    const bool valid = owner && (z_valid == nullptr || z_valid[p]);
    uoc::mbar_wait(full + s, (k / kABStages) & 1);
    long long c1 = aw_now();
    spent[0] += c1 - c0;
    const unsigned tile = smem_addr(ring + s * kBWTileBytes);
    float acc[2][32];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kD / 16; ++c)
      wgmma_bf16_seeds<kN>(
          acc, sw128_desc(tile + (c / 4) * kBWBoxBytes + (c % 4) * 32, 0,
                          1024),
          bdesc(c), c > 0);
    wgmma_commit();
    c0 = aw_now();
    spent[1] += c0 - c1;
    wgmma_wait();
    pin_registers(acc[0]);
    pin_registers(acc[1]);
    __syncwarp();
    if (lane == 0) uoc::mbar_arrive(empty + s);  // its wgmmas are done
    c1 = aw_now();
    spent[2] += c1 - c0;

    Best r[2];
    thread_best_wide<kN>(acc, t, ps.m, slab, r);
    int near = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      merge_quad(r[i]);
      if constexpr (kMergesPart<kPass>)
        if (p0 + 8 * i < n) merge_part(part, p0 + 8 * i, r[i]);
      if (p0 + 8 * i < n && r[i].b1 - r[i].b2 < kRecheckMargin<kD>)
        near |= 1 << i;
    }
    if constexpr (kStoresPart<kPass>) {
      if constexpr (kPass == 3) __syncwarp();  // every lane has read part
      if (owner) store_part(part, p, t == 0 ? r[0] : r[1]);
      continue;
    }
    c0 = aw_now();
    spent[3] += c0 - c1;
    int2 l1 = make_int2(r[0].l1, r[1].l1);
    if (__any_sync(0xFFFFFFFFu, near != 0)) {
      if constexpr (kLastOfMany<kPass>) {
        const GlobalSeeds<__nv_bfloat16> all{z};
        l1 = recheck<__nv_bfloat16, GlobalSeeds<__nv_bfloat16>, kD, kD>(
            x + static_cast<size_t>(p0) * kD, &all, m, t, near, seed_labels,
            rechecked, l1);
      } else {
        l1 = recheck<__nv_bfloat16, __nv_bfloat16, kD, kD>(
            x + static_cast<size_t>(p0) * kD, zs, m, t, near, slab,
            rechecked, l1);
      }
    }
    c1 = aw_now();
    spent[4] += c1 - c0;

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
    spent[5] += aw_now() - c1;
  }
  aw_mark(tid == 0, 2, aw_now());
  aw_mark(me, 8 + wg, aw_now());
#pragma unroll
  for (int i = 0; i < 6; ++i) aw_mark(me, 12 + 6 * wg + i, spent[i]);
  if constexpr (kStoresPart<kPass>) return;
  bar_sync<1>(kABConsumerThreads);
  for (int s = tid; s < m; s += kABConsumerThreads) {
    if (hist[0][s]) atomicAdd(&counts[s], static_cast<float>(hist[0][s]));
    if (hist[1][s])
      atomicAdd(&counts[m + s], static_cast<float>(hist[1][s]));
  }
  aw_mark(tid == 0, 3, aw_now());
}

// The launch: the kernel (and its name, for assign_labels_config), its
// Shape's block, as many blocks as fit on the card at once (at most one
// per X tile), and whether it takes X's tensor map before its arguments.
// ---------------------------------------------------------------------------
// The assignment at d = 256 (assign_exact_kernel<T, kD>, instantiated at
// kD = 256; up to 512 seeds).  A simple design on the CUDA cores that
// needs no re-check: every score is the exact argmax's own arithmetic, the
// sequential fp32 FMA chain over j = 0..d-1 of X (bf16 widened) and Z
// (float32, or bf16(Z) widened), as the wgmma kernels' re-check computes it
// (exact_argmax), so no margin is derived for it.
//
// Bound on the H100: one read of X (315 MB float32 at the frame, d = 256)
// against 2*m*n*d flops (15.7 GFLOP at m = 100; 80.5 at m = 512).
//
// Design: one persistent launch (no grid barrier), a block of 256 threads
// per SM walking its 128-pixel tiles.  A tile's X is staged in shared
// memory (widened to fp32); the seeds are staged kAXGroup at a time; the
// two threads of a pixel (t and t + 128) take 16 seeds of each group each,
// as 16 independent chains, reading each seed's 4 values a step as one
// broadcast and the pixel's as one 16-byte load.  A thread keeps its
// pixel's best score and seed (strictly larger wins, so the lowest seed on
// a tie), the pair merges through shared memory (the lower seed on a tie),
// and the pixel's first thread writes its label and adds it to the block's
// histograms of up to 512 labels (warp-aggregated adds), flushed with one
// float atomicAdd per label per block.  Every pixel is counted as
// re-checked: its argmax is the exact one.
// ---------------------------------------------------------------------------
constexpr int kAXThreads = 256;
constexpr int kAXTile = 128;  // pixels a tile: two threads a pixel
constexpr int kAXGroup = 32;  // seeds staged at a time
constexpr int kAXHalf = kAXGroup / 2;

template <typename T, int kD>
struct AssignExactShape {
  static constexpr bool kTma = false;
  static constexpr int kThreads = kAXThreads;
  static constexpr int kTile = kAXTile;
  static constexpr int kStages = 1;
  static constexpr int kPitch = kF32Pitch<kD>;
  static constexpr size_t kSmem =
      sizeof(float) * (kAXTile * kPitch + kAXGroup * kD);
  static constexpr int kRegs = 0;
};

template <typename T, int kD>
__global__ void __launch_bounds__(kAXThreads, 1)
assign_exact_kernel(const T* __restrict__ x, int n,
                    const float* __restrict__ z,
                    const int* __restrict__ seed_labels, int m,
                    const unsigned char* __restrict__ z_valid,
                    int* __restrict__ labels, float* __restrict__ counts,
                    float* __restrict__ rechecked, float4* __restrict__) {
  constexpr int kPitch = AssignExactShape<T, kD>::kPitch;
  constexpr int kVec = kD / 4;
  extern __shared__ __align__(16) float ax_smem[];
  float* xs = ax_smem;                  // [kAXTile][kPitch]
  float* zs = xs + kAXTile * kPitch;    // [kAXGroup][kD]
  __shared__ int slab[kMaxSeedsAll];
  __shared__ int hist[2][kMaxSeedsAll];
  __shared__ float other_b[kAXTile];
  __shared__ int other_s[kAXTile];
  const int t = threadIdx.x, lane = t & 31;
  const int p = t % kAXTile, h = t / kAXTile;
  for (int e = t; e < m; e += kAXThreads) {
    slab[e] = seed_labels[e];
    hist[0][e] = hist[1][e] = 0;
  }
  const int tiles = (n + kAXTile - 1) / kAXTile;
  int done = 0;  // this block's pixels
  for (int q = blockIdx.x; q < tiles; q += gridDim.x) {
    __syncthreads();  // the last tile's X and its pair exchange are done
    for (int e = t; e < kAXTile * kVec; e += kAXThreads) {
      const int r = e / kVec, j = 4 * (e % kVec);
      const int pix = q * kAXTile + r;
      *reinterpret_cast<float4*>(xs + r * kPitch + j) =
          pix < n ? load4(x + static_cast<size_t>(pix) * kD + j)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    float best = -INFINITY;
    int best_s = kMaxSeedsAll;
    for (int g0 = 0; g0 < m; g0 += kAXGroup) {
      __syncthreads();  // X is staged; the last group is done with
      for (int e = t; e < kAXGroup * kVec; e += kAXThreads) {
        const int sd = e / kVec, j = 4 * (e % kVec);
        float4 v = g0 + sd < m
                       ? *reinterpret_cast<const float4*>(
                             z + static_cast<size_t>(g0 + sd) * kD + j)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (sizeof(T) == 2)
          v = make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                          round_bf16(v.w));
        *reinterpret_cast<float4*>(zs + sd * kD + j) = v;
      }
      __syncthreads();
      float acc[kAXHalf];
#pragma unroll
      for (int c = 0; c < kAXHalf; ++c) acc[c] = 0.0f;
      const float* zh = zs + h * kAXHalf * kD;
#pragma unroll 2
      for (int j = 0; j < kD; j += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + p * kPitch + j);
#pragma unroll
        for (int c = 0; c < kAXHalf; ++c) {
          const float4 zv = *reinterpret_cast<const float4*>(zh + c * kD + j);
          acc[c] = fmaf(xv.x, zv.x, acc[c]);
          acc[c] = fmaf(xv.y, zv.y, acc[c]);
          acc[c] = fmaf(xv.z, zv.z, acc[c]);
          acc[c] = fmaf(xv.w, zv.w, acc[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kAXHalf; ++c) {
        const int sd = g0 + h * kAXHalf + c;
        if (sd < m && acc[c] > best) {
          best = acc[c];
          best_s = sd;
        }
      }
    }
    if (h == 1) {
      other_b[p] = best;
      other_s[p] = best_s;
    }
    __syncthreads();
    if (h == 0) {
      const float ob = other_b[p];
      const int os = other_s[p];
      if (ob > best || (ob == best && os < best_s)) best_s = os;
      const int pix = q * kAXTile + p;
      int key = -1, vkey = -1;
      if (pix < n) {
        const int lab = slab[best_s];
        labels[pix] = lab;
        ++done;
        if (lab >= 0 && lab < m) {
          key = lab;
          if (z_valid == nullptr || z_valid[pix]) vkey = lab;
        }
      }
      const unsigned same = __match_any_sync(0xFFFFFFFFu, key);
      if (key >= 0 && lane == __ffs(same) - 1)
        atomicAdd(&hist[0][key], __popc(same));
      const unsigned vsame = __match_any_sync(0xFFFFFFFFu, vkey);
      if (vkey >= 0 && lane == __ffs(vsame) - 1)
        atomicAdd(&hist[1][vkey], __popc(vsame));
    }
  }
  done = __reduce_add_sync(0xFFFFFFFFu, done);
  if (lane == 0 && done) atomicAdd(rechecked, static_cast<float>(done));
  __syncthreads();
  for (int e = t; e < m; e += kAXThreads) {
    if (hist[0][e]) atomicAdd(&counts[e], static_cast<float>(hist[0][e]));
    if (hist[1][e]) atomicAdd(&counts[m + e], static_cast<float>(hist[1][e]));
  }
}

struct AssignPlan {
  const void* kernel;
  const char* name;
  bool tma;
  int grid, per_sm, threads, tile, stages;
  size_t smem;
};

// The assignment at width d runs on assign_exact_kernel: at d = 256 (past
// 256 seeds the other widths run their kernels in passes).
bool assign_exact(int d) { return d == 256; }

template <typename Shape, auto kKernel>
cudaError_t plan_assign(int dev, int n, const char* name, int (&cache)[2],
                        AssignPlan* p) {
  p->kernel = reinterpret_cast<const void*>(kKernel);
  p->name = name;
  p->tma = Shape::kTma;
  p->threads = Shape::kThreads;
  p->tile = Shape::kTile;
  p->stages = Shape::kStages;
  p->smem = Shape::kSmem;
  if (cache[1] == 0) {
    // a block whose setmaxnreg.inc waits for registers that the launch
    // must have given it: refuse a build that gives fewer
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kKernel);
    if (err != cudaSuccess) return err;
    if (attr.numRegs * Shape::kThreads < Shape::kRegs)
      return cudaErrorInvalidConfiguration;
    int per_sm, sms;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = uoc::blocks_per_sm<kKernel>(dev, p->threads, p->smem, p->smem,
                                      &per_sm);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache[0] = per_sm;
    cache[1] = sms;
  }
  p->per_sm = cache[0];
  const int num_tiles = (n + p->tile - 1) / p->tile;
  p->grid = std::max(1, std::min(cache[0] * cache[1], num_tiles));
  return cudaSuccess;
}

// The one place that picks the assignment kernel: by dtype, width and (at
// d = 128) the seed columns that cover m, 104 for the recipes' 100 seeds;
// past 128 seeds the kernel of the width and dtype in two passes (pass 1
// or 2; 0 is the one pass of m <= 128), 128 seed columns each at d = 128,
// and past 256 in ceil(m / 128) (pass 1, then 3 for each middle pass, then
// 4); at d = 256 assign_exact_kernel in one pass (pass 0).  The plans of a
// launch in passes carry the name of every pass kind.
// One pass kind's plan of the kernel family of dtype and width d (64 or
// 128), its cache slot and the launch's name.
template <int kPass>
cudaError_t plan_pass(int dtype, int d, int dev, int n, const char* name,
                      int (&cache)[2], AssignPlan* p) {
  if (dtype == uoc::kBF16)
    return d == 64
               ? plan_assign<AssignShape<__nv_bfloat16, 64>,
                             assign_bf16_kernel<64, kPass>>(dev, n, name,
                                                            cache, p)
               : plan_assign<AssignBF16WideShape<kPass>,
                             assign_bf16_wide_kernel<128, kPass>>(
                     dev, n, name, cache, p);
  return d == 64 ? plan_assign<AssignShape<float, 64>,
                               assign_tf32_kernel<64, kPass>>(dev, n, name,
                                                              cache, p)
                 : plan_assign<AssignWideShape<kPass>,
                               assign_tf32_wide_kernel<128, kPass>>(
                       dev, n, name, cache, p);
}

cudaError_t plan_assign_for(int dtype, int n, int d, int m, int pass,
                            AssignPlan* p) {
  // {blocks per SM, SMs} per device and kernel, found at the first call
  // (0: not yet): the launch asks for its plan on every call
  constexpr int kDevices = 64;
  static int cached[kDevices][24][2] = {};
  if (d != 64 && d != 128 && d != 256) return cudaErrorInvalidValue;
  if (m < 1 || m > kMaxSeedsAll || pass < 0 || pass > 4)
    return cudaErrorInvalidValue;
  const bool exact = assign_exact(d);
  // the pass kinds of m seeds: 0 alone; 1, 2; or 1, 3, 4
  const bool fits = exact || m <= kMaxSeeds
                        ? pass == 0
                        : m <= kMaxSeedsMany ? pass == 1 || pass == 2
                                             : pass == 1 || pass >= 3;
  if (!fits) return cudaErrorInvalidValue;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  auto& c = cached[dev];
  if (exact)
    return dtype == uoc::kBF16
               ? plan_assign<AssignExactShape<__nv_bfloat16, 256>,
                             assign_exact_kernel<__nv_bfloat16, 256>>(
                     dev, n, "assign_exact_kernel<bf16, 256>", c[14], p)
               : plan_assign<AssignExactShape<float, 256>,
                             assign_exact_kernel<float, 256>>(
                     dev, n, "assign_exact_kernel<float, 256>", c[15], p);
  if (pass != 0) {
    // the family: bf16 64, bf16 128, float32 64, float32 128
    const int f = 2 * (dtype != uoc::kBF16) + (d == 128);
    static constexpr const char* kTwo[4] = {
        "assign_bf16_kernel<64, 1> + assign_bf16_kernel<64, 2>",
        "assign_bf16_wide_kernel<128, 1> + assign_bf16_wide_kernel<128, 2>",
        "assign_tf32_kernel<64, 1> + assign_tf32_kernel<64, 2>",
        "assign_tf32_wide_kernel<128, 1> + assign_tf32_wide_kernel<128, 2>"};
    static constexpr const char* kMany[4] = {
        "assign_bf16_kernel<64, 1> + assign_bf16_kernel<64, 3> + "
        "assign_bf16_kernel<64, 4>",
        "assign_bf16_wide_kernel<128, 1> + assign_bf16_wide_kernel<128, 3> + "
        "assign_bf16_wide_kernel<128, 4>",
        "assign_tf32_kernel<64, 1> + assign_tf32_kernel<64, 3> + "
        "assign_tf32_kernel<64, 4>",
        "assign_tf32_wide_kernel<128, 1> + assign_tf32_wide_kernel<128, 3> + "
        "assign_tf32_wide_kernel<128, 4>"};
    const char* name = m <= kMaxSeedsMany ? kTwo[f] : kMany[f];
    switch (pass) {
      case 1:
        return plan_pass<1>(dtype, d, dev, n, name, c[6 + 2 * f], p);
      case 2:
        return plan_pass<2>(dtype, d, dev, n, name, c[7 + 2 * f], p);
      case 3:
        return plan_pass<3>(dtype, d, dev, n, name, c[16 + f], p);
      default:
        return plan_pass<4>(dtype, d, dev, n, name, c[20 + f], p);
    }
  }
  if (dtype == uoc::kBF16) {
    if (d == 64)
      return plan_assign<AssignShape<__nv_bfloat16, 64>,
                         assign_bf16_kernel<64>>(
          dev, n, "assign_bf16_kernel<64>", c[0], p);
    return m <= 104
               ? plan_assign<AssignBF16WideShape<>,
                             assign_bf16_wide_kernel<104>>(
                     dev, n, "assign_bf16_wide_kernel<104>", c[1], p)
               : plan_assign<AssignBF16WideShape<>,
                             assign_bf16_wide_kernel<128>>(
                     dev, n, "assign_bf16_wide_kernel<128>", c[5], p);
  }
  if (d == 64)
    return plan_assign<AssignShape<float, 64>, assign_tf32_kernel<64>>(
        dev, n, "assign_tf32_kernel<64>", c[2], p);
  return m <= 104
             ? plan_assign<AssignWideShape<>, assign_tf32_wide_kernel<104>>(
                   dev, n, "assign_tf32_wide_kernel<104>", c[3], p)
             : plan_assign<AssignWideShape<>, assign_tf32_wide_kernel<128>>(
                   dev, n, "assign_tf32_wide_kernel<128>", c[4], p);
}

// One pass's launch on `s`: the tensor map of X first where the plan's
// kernel takes one.
cudaError_t launch_assign(const AssignPlan& p, const void* x, int dtype,
                          int n, const float* z, const int* seed_labels,
                          int m, const unsigned char* z_valid, int* labels,
                          float* counts, float4* part, cudaStream_t s) {
  float* rechecked = counts + 2 * m;
  cudaError_t err;
  if (p.tma) {
    // the map goes into the kernel's parameters by value
    CUtensorMap map;
    err = dtype == uoc::kBF16
              ? wide_bf16_map(x, n, &map)
              : wide_rows_map(x, n, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                              sizeof(float), kAWBox, kAWTile, &map);
    if (err != cudaSuccess) return err;
    void* argv[] = {&map, &x, &n, &z, &seed_labels, &m,
                    &z_valid, &labels, &counts, &rechecked, &part};
    err = cudaLaunchKernel(p.kernel, dim3(p.grid), dim3(p.threads), argv,
                           p.smem, s);
  } else {
    void* argv[] = {&x, &n, &z, &seed_labels, &m,
                    &z_valid, &labels, &counts, &rechecked, &part};
    err = cudaLaunchKernel(p.kernel, dim3(p.grid), dim3(p.threads), argv,
                           p.smem, s);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

// The pass kind of the last pass of m seeds of width d: 0 for one pass,
// 2 after one pass, 4 after two or more.
int last_pass(int d, int m) {
  if (assign_exact(d) || m <= kMaxSeeds) return 0;
  return m <= kMaxSeedsMany ? 2 : 4;
}

}  // namespace

// The launch configuration uoc_hill_climb uses for n pixels and m seeds of
// width d (64, 128 or 256; any other width, or more than 128 seeds, 64 at
// d = 256, returns cudaErrorInvalidValue): out = [grid, blocks per SM,
// threads per block, dynamic shared bytes, bytes of X held on chip per
// block, bytes of X the grid keeps on chip for the whole launch (bfloat16
// at d = 128; 0 for the other kernels)].
extern "C" int uoc_hill_climb_plan(int dtype, int n, int m, int d,
                                   long long* out) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  HillPlan p;
  const cudaError_t err = plan_hill_for(dtype, n, m, d, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.grid;
  out[1] = p.per_sm;
  out[2] = p.threads;
  out[3] = static_cast<long long>(p.smem);
  out[4] = p.x_bytes;
  out[5] = p.resident_bytes;
  return 0;
}

// x: [n, d] row-major float32 or bfloat16 (d = 64, 128 or 256), rows
// 16-byte aligned; z0: [m, d] float32; partial: [grid, m, d] float32
// scratch with the grid of uoc_hill_climb_plan; arrived: one uint32
// scratch (the grid barrier's counter, zero-filled here); z: [m, d]
// float32 out, rows 16-byte aligned.  m <= 128 (64 at d = 256).  One
// cooperative launch on `stream` runs all iterations; a grid that cannot
// be resident at once is refused by the launch.
extern "C" int uoc_hill_climb(const void* x, int dtype, int n, int d,
                              const float* z0, int m, float kappa,
                              int max_iters, float* partial, unsigned* arrived,
                              float* z, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(x) || misaligned(z))
    return static_cast<int>(cudaErrorMisalignedAddress);
  HillPlan p;
  cudaError_t err = plan_hill_for(dtype, n, m, d, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  err = cudaMemcpyAsync(z, z0, sizeof(float) * m * d,
                        cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaMemsetAsync(arrived, 0, sizeof(*arrived), s)) != cudaSuccess)
    return static_cast<int>(err);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* xf = static_cast<const float*>(x);
  if (d == kSimtD) {
    err = dtype == uoc::kBF16
              ? uoc::launch_cooperative(hill_simt_kernel<__nv_bfloat16>,
                                        p.grid, p.threads, p.smem, s, xb, n,
                                        m, kappa, max_iters, partial, arrived,
                                        z)
              : uoc::launch_cooperative(hill_simt_kernel<float>, p.grid,
                                        p.threads, p.smem, s, xf, n, m, kappa,
                                        max_iters, partial, arrived, z);
  } else if (dtype == uoc::kBF16 && d == 128) {
    // the map goes into the kernel's parameters by value
    CUtensorMap map;
    if ((err = wide_bf16_map(x, n, &map)) != cudaSuccess)
      return static_cast<int>(err);
    void* argv[] = {&map, &n, &m, &kappa, &max_iters, &partial, &arrived, &z};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(hill_bf16_wide_kernel), dim3(p.grid),
        dim3(p.threads), argv, p.smem, s);
  } else if (dtype == uoc::kBF16)
    err = uoc::launch_cooperative(hill_bf16_kernel, p.grid, p.threads, p.smem,
                                  s, xb, n, m, kappa, max_iters, partial,
                                  arrived, z);
  else
    err = d == 64 ? uoc::launch_cooperative(hill_tf32_kernel, p.grid,
                                            p.threads, p.smem, s, xf, n, m,
                                            kappa, max_iters, partial,
                                            arrived, z)
                  : uoc::launch_cooperative(hill_tf32_wide_kernel, p.grid,
                                            p.threads, p.smem, s, xf, n, m,
                                            kappa, max_iters, partial,
                                            arrived, z);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

#ifdef HILL_CLOCKS
// The study build's clocks of the last launch at d = 128:
// [160][16][16] int64 (see hill_mark).
extern "C" int uoc_hill_clocks(long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, hill_clocks, sizeof(hill_clocks)));
}
#endif

namespace {

// cc_kernel<kD, kMaxSeedsMany> for m in 129..256 on `s`, its dynamic
// shared-memory limit raised once per device.
template <int kD>
cudaError_t launch_cc_many(const float* z, int m, float epsilon, int* labels,
                           int* steps, cudaStream_t s) {
  constexpr int kDevices = 64;
  static bool raised[kDevices] = {};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(
        cc_kernel<kD, kMaxSeedsMany>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(cc_smem_bytes<kD, kMaxSeedsMany>()));
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  cc_kernel<kD, kMaxSeedsMany>
      <<<1, kCCThreads, cc_smem_bytes<kD, kMaxSeedsMany>(), s>>>(
          z, m, epsilon, labels, steps);
  return cudaGetLastError();
}

// cc_wide_kernel<kD> for d = 256, and for 257..512 seeds at the other
// widths, on `s`, its dynamic shared-memory limit raised once per device.
template <int kD>
cudaError_t launch_cc_wide(const float* z, int m, float epsilon, int* labels,
                           int* steps, cudaStream_t s) {
  constexpr int kDevices = 64;
  static bool raised[kDevices] = {};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(cc_wide_kernel<kD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(cc_wide_smem_bytes()));
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  cc_wide_kernel<kD><<<1, kCCThreads, cc_wide_smem_bytes(), s>>>(
      z, m, epsilon, labels, steps);
  return cudaGetLastError();
}

// The connected components of m seeds of width d run on cc_wide_kernel.
bool cc_wide(int m, int d) { return d == 256 || m > kMaxSeedsMany; }

// Whether uoc_connected_components takes m seeds of width d.
bool cc_takes(int m, int d) {
  return m >= 1 && m <= kMaxSeedsAll && (d == 64 || d == 128 || d == 256);
}

// cc_kernel's work items for m seeds (one per kCCRows rows of each tile on
// or above the diagonal).
int cc_items(int m) {
  const int blocks = (m + 31) / 32;
  int items = 0;
  for (int a = 0; a < blocks; ++a)
    for (int c = a; c < blocks; ++c) {
      const bool swap = m % 32 != 0 && c == blocks - 1;
      const int rows = std::min(32, m - 32 * (swap ? c : a));
      items += (rows + kCCRows - 1) / kCCRows;
    }
  return items;
}

}  // namespace

// z: [m, d] float32 (d = 64, 128 or 256), rows 16-byte aligned; labels:
// [m] int32 out; steps: one int32 out, the merge steps taken (the seeds
// still unlabeled when their turn came).  1 <= m <= 512.  One launch on
// `stream`: cc_kernel<64> at d = 64, cc_cluster_kernel (one cluster of
// kCCCluster CTAs) at d = 128; for 129..256 seeds cc_kernel<d, 256>; at d
// = 256, and past 256 seeds, cc_wide_kernel<d>.
extern "C" int uoc_connected_components(const float* z, int m, int d,
                                        float epsilon, int* labels,
                                        int* steps, void* stream) {
  if (!cc_takes(m, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(z)) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cc_wide(m, d))
    return static_cast<int>(
        d == 64    ? launch_cc_wide<64>(z, m, epsilon, labels, steps, s)
        : d == 128 ? launch_cc_wide<128>(z, m, epsilon, labels, steps, s)
                   : launch_cc_wide<256>(z, m, epsilon, labels, steps, s));
  if (m > kMaxSeeds)
    return static_cast<int>(
        d == 64 ? launch_cc_many<64>(z, m, epsilon, labels, steps, s)
                : launch_cc_many<128>(z, m, epsilon, labels, steps, s));
  if (d == 64) {
    cc_kernel<64><<<1, kCCThreads, cc_smem_bytes<64>(), s>>>(z, m, epsilon,
                                                             labels, steps);
    return static_cast<int>(cudaGetLastError());
  }
  // past 48 KB of dynamic shared memory: the kernel's limit is raised once
  // per device; the plan is built once per m
  constexpr int kDevices = 64;
  static bool raised[kDevices] = {};
  static CCPlan plans[kMaxSeeds + 1];
  static bool planned[kMaxSeeds + 1] = {};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(cc_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(cc_smem_bytes<128>()));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[dev] = true;
  }
  if (!planned[m]) {
    plans[m] = cc_cluster_plan(m);
    planned[m] = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCCCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCCCluster);
  config.blockDim = dim3(kCCThreads);
  config.dynamicSmemBytes = cc_smem_bytes<128>();
  config.stream = s;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, cc_cluster_kernel, z, m, epsilon,
                           plans[m], labels, steps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The launch uoc_connected_components makes for m seeds of width d (64,
// 128 or 256; any other width, or m outside [1, 512], returns
// cudaErrorInvalidValue): out = [CTAs (the cluster's at d = 128), threads
// per CTA, dynamic shared bytes, the adjacency's work items, the most Z
// rows a CTA stages (0 for cc_wide_kernel, which reads Z in place)].
extern "C" int uoc_connected_components_plan(int m, int d, long long* out) {
  if (!cc_takes(m, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (cc_wide(m, d)) {
    out[0] = 1;
    out[1] = kCCThreads;
    out[2] = static_cast<long long>(cc_wide_smem_bytes());
    out[3] = cc_items(m);
    out[4] = 0;
    return 0;
  }
  if (m > kMaxSeeds) {
    out[0] = 1;
    out[1] = kCCThreads;
    out[2] = static_cast<long long>(
        d == 64 ? cc_smem_bytes<64, kMaxSeedsMany>()
                : cc_smem_bytes<128, kMaxSeedsMany>());
    out[3] = cc_items(m);
    out[4] = m;
    return 0;
  }
  const CCPlan p = cc_cluster_plan(m);
  int most = m;
  if (d == 128) {
    most = 0;
    for (int c = 0; c < kCCCluster; ++c) {
      int rows = 0;
      for (int w = 0; w < kCCWords; ++w)
        rows += __builtin_popcount(p.rows[c][w]);
      most = std::max(most, rows);
    }
  }
  out[0] = d == 64 ? 1 : kCCCluster;
  out[1] = kCCThreads;
  out[2] = static_cast<long long>(d == 64 ? cc_smem_bytes<64>()
                                          : cc_smem_bytes<128>());
  out[3] = p.items;
  out[4] = most;
  return 0;
}

// The name of the kernel that uoc_connected_components launches for m
// seeds of width d; null for another width or m outside [1, 512].
extern "C" const char* uoc_connected_components_kernel(int m, int d) {
  if (!cc_takes(m, d)) return nullptr;
  if (cc_wide(m, d))
    return d == 64    ? "cc_wide_kernel<64>"
           : d == 128 ? "cc_wide_kernel<128>"
                      : "cc_wide_kernel<256>";
  if (m > kMaxSeeds)
    return d == 64 ? "cc_kernel<64, 256>" : "cc_kernel<128, 256>";
  return d == 64 ? "cc_kernel<64>" : "cc_cluster_kernel";
}

#ifdef CC_CLOCKS
// The study build's clocks of the last connected-components launch:
// [kCCClockCtas][kCCMarks] int64 (see cc_mark), zeroed by
// uoc_cc_clocks_reset.
extern "C" int uoc_cc_clocks(long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, cc_clocks, sizeof(cc_clocks)));
}

extern "C" int uoc_cc_clocks_reset() {
  static const long long zero[kCCClockCtas][kCCMarks] = {};
  return static_cast<int>(cudaMemcpyToSymbol(cc_clocks, zero, sizeof(zero)));
}

// cc_kernel, one block, at either width: at d = 128 the design that
// cc_cluster_kernel replaced, for the study's clocks beside it.
extern "C" int uoc_cc_one_block(const float* z, int m, int d, float epsilon,
                                int* labels, int* steps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) {
    cc_kernel<64><<<1, kCCThreads, cc_smem_bytes<64>(), s>>>(z, m, epsilon,
                                                             labels, steps);
  } else {
    const cudaError_t err = cudaFuncSetAttribute(
        cc_kernel<128>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(cc_smem_bytes<128>()));
    if (err != cudaSuccess) return static_cast<int>(err);
    cc_kernel<128><<<1, kCCThreads, cc_smem_bytes<128>(), s>>>(
        z, m, epsilon, labels, steps);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif


// The launch configuration uoc_assign_labels (m <= 128; at d = 256
// assign_exact_kernel's) or uoc_assign_labels_passes (129..512 at d = 64
// and 128: the last pass's; the first and middle passes differ only in the
// float32 d = 128 ring, three stages) uses for n pixels and m seeds of
// width d (64, 128 or 256; any other width, or m outside [1, 512], returns
// cudaErrorInvalidValue): out = [grid, blocks per SM, threads per block,
// dynamic shared bytes, bytes of X held on chip per block (its ring of
// tiles), the ring's stages, pixels per tile].
extern "C" int uoc_assign_labels_plan(int dtype, int n, int m, int d,
                                      long long* out) {
  AssignPlan p;
  const bool exact = assign_exact(d);
  const cudaError_t err =
      plan_assign_for(dtype, n, d, m, last_pass(d, m), &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.grid;
  out[1] = p.per_sm;
  out[2] = p.threads;
  out[3] = static_cast<long long>(p.smem);
  // assign_exact_kernel stages X widened to fp32
  out[4] = (dtype == uoc::kBF16 && !exact ? 2LL : 4LL) * p.stages * p.tile *
           d;
  out[5] = p.stages;
  out[6] = p.tile;
  return 0;
}

#ifdef ASSIGN_CLOCKS
// The study build's clocks of the last width-128 assignment launch:
// [kAssignClockBlocks][kAssignMarks] int64 (see aw_mark).
extern "C" int uoc_assign_clocks(long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, assign_clocks, sizeof(assign_clocks)));
}

// The host's microseconds per encode of the tensor map that
// uoc_assign_labels builds at every float32 d = 128 call (X [n, 128] at
// x), the mean over reps encodes; -1 if one fails.
extern "C" double uoc_assign_map_us(const void* x, int n, int reps) {
  CUtensorMap map;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i)
    if (wide_rows_map(x, n, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float),
                      kAWBox, kAWTile, &map) != cudaSuccess)
      return -1.0;
  const std::chrono::duration<double, std::micro> spent =
      std::chrono::steady_clock::now() - t0;
  return spent.count() / reps;
}
#endif

// x: [n, d] row-major float32 or bfloat16 (d = 64 or 128), rows 16-byte
// aligned; z: [m, d] float32, 16-byte aligned; seed_labels: [m] int32;
// z_valid: [n] bytes (0 or 1) or null (every pixel valid); labels: [n]
// int32 out; counts: [2 m + 1] float32 out, zero-filled here: pixels per
// label, valid pixels per label, then the count of re-checked pixels.
// 1 <= m <= 128, or at d = 256 up to 512 (past 128 at d = 64 and 128:
// uoc_assign_labels_passes), n < 2^24 (the float counts stay exact).  One
// launch on `stream`.
extern "C" int uoc_assign_labels(const void* x, int dtype, int n, int d,
                                 const float* z, const int* seed_labels,
                                 int m, const unsigned char* z_valid,
                                 int* labels, float* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || (m > kMaxSeeds && !assign_exact(d)) || n >= (1 << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(x) || misaligned(z))
    return static_cast<int>(cudaErrorMisalignedAddress);
  AssignPlan p;
  cudaError_t err = plan_assign_for(dtype, n, d, m, 0, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaMemsetAsync(counts, 0, sizeof(float) * (2 * m + 1), s)) !=
      cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(launch_assign(p, x, dtype, n, z, seed_labels, m,
                                        z_valid, labels, counts, nullptr, s));
}

// uoc_assign_labels for 129 <= m <= 512 seeds at d = 64 and 128:
// ceil(m / 128) launches on `stream`, pass 1 against seeds [0, 128), a
// middle pass against each next 128 (z and seed_labels advanced to them,
// m = 128) and the last pass against the rest (see the notes on passes
// above); part: [n] float4 (16 bytes a pixel, 16-byte aligned), the Best
// that each pass leaves for the next.
extern "C" int uoc_assign_labels_passes(
    const void* x, int dtype, int n, int d, const float* z,
    const int* seed_labels, int m, const unsigned char* z_valid, int* labels,
    float* counts, void* part, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= kMaxSeeds || m > kMaxSeedsAll || assign_exact(d) ||
      n >= (1 << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(x) || misaligned(z) || misaligned(part))
    return static_cast<int>(cudaErrorMisalignedAddress);
  AssignPlan first, middle, last;
  const int passes = (m + kMaxSeeds - 1) / kMaxSeeds;
  cudaError_t err = plan_assign_for(dtype, n, d, m, 1, &first);
  if (err == cudaSuccess && passes > 2)
    err = plan_assign_for(dtype, n, d, m, 3, &middle);
  if (err == cudaSuccess) err = plan_assign_for(dtype, n, d, m,
                                                last_pass(d, m), &last);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaMemsetAsync(counts, 0, sizeof(float) * (2 * m + 1), s)) !=
      cudaSuccess)
    return static_cast<int>(err);
  float4* best = static_cast<float4*>(part);
  err = launch_assign(first, x, dtype, n, z, seed_labels, m, z_valid, labels,
                      counts, best, s);
  for (int j = 1; err == cudaSuccess && j + 1 < passes; ++j)
    err = launch_assign(middle, x, dtype, n,
                        z + static_cast<size_t>(j) * kMaxSeeds * d,
                        seed_labels + j * kMaxSeeds, kMaxSeeds, z_valid,
                        labels, counts, best, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_assign(last, x, dtype, n, z, seed_labels, m,
                                        z_valid, labels, counts, best, s));
}

// The name of the kernel that uoc_assign_labels launches for these
// arguments, as "assign_tf32_wide_kernel<104>" (past 128 seeds at d = 64
// and 128 every pass kind's of uoc_assign_labels_passes); null where the
// plan fails (a width other than 64, 128 or 256, m outside [1, 512]).
extern "C" const char* uoc_assign_labels_kernel(int dtype, int n, int m,
                                                int d) {
  AssignPlan p;
  return plan_assign_for(dtype, n, d, m, last_pass(d, m) ? 1 : 0, &p) ==
                 cudaSuccess
             ? p.name
             : nullptr;
}
