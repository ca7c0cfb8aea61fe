// All-pairs softened gravity as two matrix products on the tensor cores.
//
// Replaces particle_sim_tpu/ops/pairwise_pallas.py:_kernel_mxu (built by
// _build_mxu, entry pairwise_accel_mxu): the experimental matrix-unit
// formulation of the O(N^2) force,
//   r2[i, j] = -2 xi.xj + (|xi|^2 + eps^2) + |xj|^2      (product 1)
//   W[i, j]  = rsqrt(r2)^3
//   S[c, i]  = sum_j gv[j] [x, y, z, 1][c, j] W[i, j]    (product 2, c < 4)
//   a[c, i]  = S[c, i] - xi[c, i] S[3, i]
// with gv[j] = G * (j_base + j < n_active) from the wrapper
// (ops/pairwise_cuda.py:pairwise_accel_mxu). A masked source (gv = 0) gets
// |xj|^2 + MASK_BIG, so w ~ 1e-45, and a zero B row: it adds exactly 0.
//
// What bounds it on the H100: operations. Per pair one MUFU rsqrt (16 per
// SM per clock: 1.03 ms at 65,536^2 and 1.98 GHz) is the floor. Beside it
// this design issues per pair 1 mma.sync share (4 a 16 x 8 tile: k4 + k8
// for r^2, two k8 for S), the cube (2 FMUL), W's TF32 split (LOP, FADD)
// and ~0.2 shared loads (chip_smoke.py phase 14 prints the SASS mix). On
// the H100 mma.sync (TF32 m16n8k8) and MUFU each complete ~0.5 warp
// instruction a clock an SM, and together ~0.4 of each
// (tools/pairwise_mxu_variants.py measures both): that mix alone is
// ~1.29 ms at 65,536^2.
//
// Design. A warp owns MXU_MTILES row tiles of 16 receivers (2: 32; 256 a
// block); the block stages MXU_TJ sources at a time in shared memory,
// already split into TF32 parts and laid out in fragment order, and every
// warp sweeps them in steps of 8 (a 16 x 8 tile of pairs a step and row
// tile; two tiles share each B fragment):
//   * Accuracy first. The expanded r^2 cancels terms of size |x|^2 (2,500
//     at radius 50) down to eps^2 = 0.25, and a = S[:3] - xi S[3] cancels
//     terms of size G w |x|: in f32, as in the JAX kernel and the plain
//     version, that is ~0.1 relative error at 65,536 filled-sphere
//     particles. Both cancellations are translation invariant, so the
//     block works in coordinates centred on its receivers' mean (far
//     outliers left out), and the wrapper hands it receivers in
//     Hilbert-curve order (the order array: a block's receivers form a
//     compact region): |x - centre| drops from ~50 to ~10. S is summed as
//     an unevaluated (hi, lo) pair.
//   * Product 1 gives r^2 itself, with no FP32 add a pair: K is widened
//     so that |xj|^2 rides in the tensor cores too, and the accumulator
//     starts from |xi|^2 + eps^2 (an f32 C operand, free in mma.sync).
//     Slot k of A (receiver) and B (source):
//       0-2:  (-2x)_hi . x_hi      3-5: (-2x)_hi . x_lo
//       6-8:  (-2x)_lo . x_hi      (3xTF32 of -2 xi.xj: hi.hi + hi.lo + lo.hi)
//       9-11: 1 . |xj|^2 parts     (three TF32 parts hold an f32 exactly)
//     one m16n8k8 (slots 0-7) and one m16n8k4 (8-11) a tile. The B
//     fragment of a step is one 16-byte shared load a thread (a source's
//     slots are stored in fragment order).
//   * TF32 splits (split2): hi rounded to TF32 by bit arithmetic, lo =
//     x - hi passed raw (mma.sync reads a TF32 operand's top 19 bits). W =
//     rsqrt(r2)^3 stays in registers and its hi is truncated instead
//     (split2_w: LOP, FADD, one instruction less a pair, at ~5e-4 more
//     error; truncating every hi triples the error).
//   * The accumulator layout of product 1 (thread: rows g, g+8; columns
//     2t, 2t+1) is not the A layout of product 2 (columns t, t+4), but
//     the sum over j does not care about the order of j: column 2t is read
//     as k = t and 2t + 1 as k = t + 4, and B is stored with the same
//     permutation. No shuffle and no trip through shared memory.
//   * Product 2: two m16n8k8 (W_hi and W_lo) against B = [X_hi | X_lo]
//     (columns 0-3 the hi parts of the four rows gv [x, y, z, 1], 4-7
//     their lo parts), accumulated in the mma's own accumulator over a
//     chain of MXU_ACC_CHAIN steps, then added into the stage's sum by a
//     rounded FP32 add; two accumulators take turns, each added while the
//     other takes its chain, so the add does not wait for the mma. The
//     stage's sum joins the (hi, lo) total by a two-sum. The tensor cores
//     truncate when they accumulate: longer chains are faster and less
//     accurate (a whole 32-step stage misses phase 14's bars). One
//     16-byte shared load feeds two steps.
//   * One stage buffer, two barriers a stage (a second buffer measured no
//     faster at 2 row tiles; PERF.md section 6 keeps the numbers of the
//     designs not taken).
//   * The epilogue a = S[:3] - xi S[3] is fused: two shuffles bring S's hi
//     and lo columns and S[3] together; an fma cancels the hi parts. It
//     writes receiver order[i] directly (no un-permutation pass).
// Ragged edges: receivers past ni compute on x = 0 and are not written;
// sources past nj are staged as masked ones.
//
// The -D knobs below are numeric tuning values for the design probe
// (tools/pairwise_mxu_variants.py); the package builds the defaults.
#include "common.cuh"

#ifndef MXU_WARPS
#define MXU_WARPS 8           // warps a block
#endif
#ifndef MXU_MTILES
#define MXU_MTILES 2          // 16-receiver row tiles a warp (1 or 2)
#endif
#ifndef MXU_TJ
#define MXU_TJ 256            // sources a shared-memory stage
#endif
#ifndef MXU_UNROLL
#define MXU_UNROLL 1          // unroll of the sweep over chains
#endif
#ifndef MXU_MIN_BLOCKS
#define MXU_MIN_BLOCKS 2      // __launch_bounds__' blocks an SM
#endif
#ifndef MXU_ACC_CHAIN
#define MXU_ACC_CHAIN 4       // steps product 2 accumulates in the mma
#endif                        // before an FP32 add into the stage sum

#define MXU_THREADS (32 * MXU_WARPS)
#define MXU_ROWS (16 * MXU_MTILES * MXU_WARPS)   // receivers a block
#define MXU_MASK_BIG 1e30f
// a stage: product 1's B, 16 words a source; product 2's B, 8 a source
#define MXU_B1_WORDS (16 * MXU_TJ)
#define MXU_STAGE_WORDS (24 * MXU_TJ)
#define MXU_SMEM_BYTES (4 * MXU_STAGE_WORDS)
// #pragma unroll with a macro's value
#define MXU_PRAGMA(x) _Pragma(#x)
#define MXU_UNROLL_BY(n) MXU_PRAGMA(unroll n)

static_assert(MXU_MTILES == 1 || MXU_MTILES == 2, "1 or 2 row tiles");
// 16-source trips (two steps) a chain of the mma accumulator
#define MXU_TRIPS (MXU_ACC_CHAIN / 2)

static_assert(MXU_ACC_CHAIN >= 2 && MXU_ACC_CHAIN % 2 == 0, "chain: even");
static_assert(MXU_TJ % (32 * MXU_TRIPS) == 0,
              "a stage holds whole pairs of chains");
static_assert(MXU_THREADS >= MXU_ROWS, "a thread a receiver at most");

namespace {

// hi = x rounded to TF32 by bit arithmetic (to nearest), low 13 bits zero
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo as two TF32 operands: hi = x rounded (IADD, LOP), lo = x -
// hi (exact in f32, one FADD) passed raw: the tensor cores keep its top
// 10 mantissa bits, so x is held to ~2^-21. The staged and receiver terms.
__device__ __forceinline__ void split2(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// W's split in the sweep: hi = x truncated (LOP), lo = x - hi raw; one
// instruction less than split2, but lo is twice as large and of x's sign
__device__ __forceinline__ void split2_w(float x, uint32_t& hi,
                                         uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// hi + lo (an f32 pair) as three TF32 parts: 32 significant bits, so an
// f32 value is held exactly
__device__ __forceinline__ void split3(float hi, float lo, uint32_t p[3]) {
  p[0] = tf32_bits(hi);
  const float r = __fadd_rn(__fsub_rn(hi, __uint_as_float(p[0])), lo);
  p[1] = tf32_bits(r);
  p[2] = __float_as_uint(__fsub_rn(r, __uint_as_float(p[1])));
}

// (hi, lo) += x, the rounding error of hi + x kept in lo (Knuth's two-sum).
__device__ __forceinline__ void two_sum(float& hi, float& lo, float x) {
  const float s = __fadd_rn(hi, x);
  const float bb = __fsub_rn(s, hi);
  const float e = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bb)), __fsub_rn(x, bb));
  hi = s;
  lo = __fadd_rn(lo, e);
}

// |v|^2 of a 3-vector as a (hi, lo) pair: exact squares by fma.
__device__ __forceinline__ void norm2(const float v[3], float& hi,
                                      float& lo) {
  hi = 0.0f;
  lo = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float p = __fmul_rn(v[c], v[c]);
    two_sum(hi, lo, p);
    lo = __fadd_rn(lo, __fmaf_rn(v[c], v[c], -p));
  }
}

// The sum of v over the block's threads, in a fixed order, returned to
// every thread (part: MXU_WARPS floats of shared memory, one use each).
__device__ __forceinline__ float block_sum(float v, float* part) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  }
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < MXU_WARPS; ++w) total = __fadd_rn(total, part[w]);
  return total;
}

// D = A(16x4, row) B(4x8, col) + C, TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_k4(float d[4], uint32_t a0, uint32_t a1,
                                       uint32_t b0, const float c[4]) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(c[0]), "f"(c[1]), "f"(c[2]),
        "f"(c[3]));
}

// D (+)= A(16x8, row) B(8x8, col), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_k8(float d[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// product 2's A from product 1's accumulator layout: element (row, 2t) is
// (row, k = t), (row, 2t + 1) is (row, k = t + 4)
__device__ __forceinline__ void mma_w(float d[4], const uint32_t w[4],
                                      uint32_t b0, uint32_t b1) {
  const uint32_t a[4] = {w[0], w[2], w[1], w[3]};
  mma_k8(d, a, b0, b1);
}

// Product 1's K slots (A: receiver, B: source):
//   0-2: (-2x)_hi . x_hi   3-5: (-2x)_hi . x_lo   6-8: (-2x)_lo . x_hi
//   9-11: 1 . |xj|^2 parts (|xi|^2 + eps^2 is the accumulator's start
//   value, an f32 C operand)
// slots 12-15 are 0

// value of slot s of a source's product-1 B column
__device__ __forceinline__ uint32_t b1_slot(int s, const uint32_t vh[3],
                                            const uint32_t vl[3],
                                            const uint32_t x2[3]) {
  if (s < 3) return vh[s];
  if (s < 6) return vl[s - 3];
  if (s < 9) return vh[s - 6];
  if (s < 12) return x2[s - 9];
  return 0u;
}

// value of slot s of a receiver's product-1 A row; s is a run-time value
// (it depends on the lane), so every slot is formed and one selected
__device__ __forceinline__ uint32_t a1_slot(int s, const uint32_t mh[3],
                                            const uint32_t ml[3]) {
  uint32_t v = 0u;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const uint32_t slot = q < 3 ? mh[q] : q < 6 ? mh[q - 3]
                        : q < 9 ? ml[q - 6] : q < 12 ? 0x3F800000u : 0u;
    v = q == s ? slot : v;
  }
  return v;
}

// Fill one stage from sources j0 .. j0 + MXU_TJ - 1 (centred on ctr).
// Product 1's B: source k's 16 slots at words 16k .. 16k + 15, slot
// t + 4m at word 4t + m, so lane (g, t) of a step reads its four slots
// (t, t + 4 of the m16n8k8, t + 8 of the m16n8k4, t + 12 zero) as one
// uint4.
// Product 2's B: row n (0-3 hi, 4-7 lo of gv [x, y, z, 1]), sources in
// groups of 16 (two steps): source 8s + 2t + e of group q at word
// (8q + n) 16 + 4t + 2s + e, so lane (g, t) reads both steps' (k = t,
// k = t + 4) pairs as one uint4.
__device__ __forceinline__ void fill_stage(
    uint32_t* __restrict__ st, const float* __restrict__ xj,
    const float* __restrict__ gv, int j0, int nj, const float ctr[3]) {
  uint32_t* b2 = st + MXU_B1_WORDS;
  for (int k = threadIdx.x; k < MXU_TJ; k += MXU_THREADS) {
    const int j = j0 + k;
    const bool in = j < nj;
    float v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[c] = in ? __fsub_rn(__ldg(xj + (size_t)c * nj + j), ctr[c]) : 0.0f;
    }
    const float w = in ? __ldg(gv + j) : 0.0f;
    float hi, lo;
    norm2(v, hi, lo);
    if (w == 0.0f) hi = __fadd_rn(hi, MXU_MASK_BIG);
    uint32_t vh[3], vl[3], x2[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) split2(v[c], vh[c], vl[c]);
    split3(hi, lo, x2);
    uint4* dst = reinterpret_cast<uint4*>(st + 16 * k);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      dst[t] = make_uint4(b1_slot(t, vh, vl, x2), b1_slot(t + 4, vh, vl, x2),
                          b1_slot(t + 8, vh, vl, x2),
                          b1_slot(t + 12, vh, vl, x2));
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int c = 0; c < 3; ++c) split2(__fmul_rn(w, v[c]), ah[c], al[c]);
    split2(w, ah[3], al[3]);
    const int o = k & 15, t = (o & 7) >> 1;
    uint32_t* col = b2 + (k >> 4) * 128 + 4 * t + 2 * (o >> 3) + (o & 1);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      col[n * 16] = ah[n];
      col[(n + 4) * 16] = al[n];
    }
  }
}

// product 1 of one row tile and step: r^2 for rows g, g + 8 x columns 2t,
// 2t + 1 (bp: the step's four B slots of this lane)
__device__ __forceinline__ void product1(float d[4], const uint32_t a1[2][4],
                                         const float c1[4], uint4 bp) {
  mma_k4(d, a1[1][0], a1[1][1], bp.z, c1);
  mma_k8(d, a1[0], bp.x, bp.y);
}

__global__ void __launch_bounds__(MXU_THREADS, MXU_MIN_BLOCKS)
    pairwise_mxu_kernel(const float* __restrict__ xi,
                        const int* __restrict__ order,
                        const float* __restrict__ xj,
                        const float* __restrict__ gv,
                        const float* __restrict__ eps_sq_p,
                        const float* __restrict__ box, float* __restrict__ out,
                        int ni, int nj) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ float s_red[5][MXU_WARPS];

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int base = blockIdx.x * MXU_ROWS;
  const int row0 = base + (threadIdx.x >> 5) * 16 * MXU_MTILES;
  const float eps_sq = __ldg(eps_sq_p);

  // the centre: the mean of the block's receivers that lie inside the
  // inlier box (the mean of all of them if none does), so padding parked
  // far from the cloud cannot drag it away while a block that spans two
  // clumps still sits between them; the sums run in a fixed order, so the
  // result does not change from run to run
  const int me = threadIdx.x;
  const int nb = min(MXU_ROWS, ni - base);
  float p[3] = {0.0f, 0.0f, 0.0f};
  bool inlier = me < nb;
  if (me < nb) {
    const int src = __ldg(order + base + me);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      p[c] = __ldg(xi + (size_t)c * ni + src);
      inlier = inlier && p[c] >= __ldg(box + c) &&
               p[c] <= __ldg(box + 3 + c);
    }
  }
  // n_in is the same in every thread, so all take the same branch
  const float n_in = block_sum(inlier ? 1.0f : 0.0f, s_red[0]);
  const bool use =
      n_in > 0.0f ? inlier : me < nb && isfinite(p[0] + p[1] + p[2]);
  const float n_use =
      n_in > 0.0f ? n_in : block_sum(use ? 1.0f : 0.0f, s_red[1]);
  float ctr[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float sum = block_sum(use ? p[c] : 0.0f, s_red[2 + c]);
    ctr[c] = n_use > 0.0f ? __fdiv_rn(sum, n_use) : 0.0f;
  }

  // rows g and g + 8 of each of this warp's row tiles: the receiver's
  // index, its centred coordinates, and product 1's A fragments (slots t,
  // t + 4 for the m16n8k8 in a1[m][0], t + 8 for the m16n8k4 in
  // a1[m][1][0..1])
  int dst[MXU_MTILES][2];
  float xr[MXU_MTILES][2][3];
  uint32_t a1[MXU_MTILES][2][4];
  float c1[MXU_MTILES][4];  // |xi|^2 + eps^2, product 1's C
#pragma unroll
  for (int m = 0; m < MXU_MTILES; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + 16 * m + g + 8 * r;
      dst[m][r] = i < ni ? __ldg(order + i) : -1;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        xr[m][r][c] = i < ni ? __fsub_rn(__ldg(xi + (size_t)c * ni +
                                               dst[m][r]), ctr[c])
                             : 0.0f;
      }
      float hi, lo;
      norm2(xr[m][r], hi, lo);
      two_sum(hi, lo, eps_sq);
      uint32_t mh[3], ml[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        split2(-2.0f * xr[m][r][c], mh[c], ml[c]);
      }
      c1[m][2 * r] = c1[m][2 * r + 1] = __fadd_rn(hi, lo);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a1[m][h][r] = a1_slot(t + 8 * h, mh, ml);
        a1[m][h][2 + r] = a1_slot(t + 4 + 8 * h, mh, ml);
      }
    }
  }

  // S's running sum as an unevaluated pair (s_run + s_err), in the
  // accumulator layout of product 2 (4 a row tile)
  float s_run[MXU_MTILES][4], s_err[MXU_MTILES][4];
#pragma unroll
  for (int m = 0; m < MXU_MTILES; ++m) {
#pragma unroll
    for (int q = 0; q < 4; ++q) s_run[m][q] = s_err[m][q] = 0.0f;
  }
  for (int j0 = 0; j0 < nj; j0 += MXU_TJ) {
    __syncthreads();  // the previous stage is consumed
    fill_stage(smem, xj, gv, j0, nj, ctr);
    __syncthreads();
    const uint32_t* b1 = smem + 16 * g + 4 * t;
    const uint32_t* b2 = smem + MXU_B1_WORDS + 16 * g + 4 * t;

    // the stage's sum (rounded f32 adds) and the mma's own accumulators,
    // which take a chain of MXU_ACC_CHAIN steps before they are added in;
    // two take turns, and each is added in while the other takes its
    // chain, so the add does not wait for the mma
    float tile[MXU_MTILES][4], acc[2][MXU_MTILES][4];
#pragma unroll
    for (int m = 0; m < MXU_MTILES; ++m) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        tile[m][q] = acc[0][m][q] = acc[1][m][q] = 0.0f;
      }
    }
    auto flush = [&](int a) {
#pragma unroll
      for (int m = 0; m < MXU_MTILES; ++m) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          tile[m][q] = __fadd_rn(tile[m][q], acc[a][m][q]);
          acc[a][m][q] = 0.0f;
        }
      }
    };
    // one chain: MXU_TRIPS trips of two 8-source steps from source c0,
    // product 2 into acc[a]
    auto chain = [&](int c0, int a) {
#pragma unroll
      for (int tr = 0; tr < MXU_TRIPS; ++tr) {
        const int k0 = c0 + 16 * tr;
        const uint4 bb = *reinterpret_cast<const uint4*>(b2 + 8 * k0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint4 bp =
              *reinterpret_cast<const uint4*>(b1 + 16 * (k0 + 8 * h));
          const uint32_t c0_ = h ? bb.z : bb.x, c1_ = h ? bb.w : bb.y;
#pragma unroll
          for (int m = 0; m < MXU_MTILES; ++m) {
            float d[4];
            product1(d, a1[m], c1[m], bp);
            uint32_t wh[4], wl[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              float inv;
              asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(d[q]));
              split2_w(__fmul_rn(__fmul_rn(inv, inv), inv), wh[q], wl[q]);
            }
            // product 2: B = the source rows at the same j
            mma_w(acc[a][m], wh, c0_, c1_);
            mma_w(acc[a][m], wl, c0_, c1_);
          }
        }
      }
    };
    MXU_UNROLL_BY(MXU_UNROLL)
    for (int c0 = 0; c0 < MXU_TJ; c0 += 32 * MXU_TRIPS) {
      chain(c0, 0);
      flush(1);
      chain(c0 + 16 * MXU_TRIPS, 1);
      flush(0);
    }
    flush(1);
#pragma unroll
    for (int m = 0; m < MXU_MTILES; ++m) {
#pragma unroll
      for (int q = 0; q < 4; ++q) two_sum(s_run[m][q], s_err[m][q], tile[m][q]);
    }
  }

  // rows g (q = 0, 1) and g + 8 (q = 2, 3) at columns 2t, 2t + 1; columns
  // 0-3 are W . X_hi, 4-7 W . X_lo: lane t + 2's sums join lane t's
  // low part, so lane t = 0 holds S[0], S[1] and t = 1 S[2], S[3] as
  // (hi, lo) pairs
  const int src = (lane & ~3) | 1;
#pragma unroll
  for (int m = 0; m < MXU_MTILES; ++m) {
    float s_lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float other = __fadd_rn(
          __shfl_xor_sync(0xFFFFFFFFu, s_run[m][q], 2),
          __shfl_xor_sync(0xFFFFFFFFu, s_err[m][q], 2));
      s_lo[q] = __fadd_rn(s_err[m][q], other);
    }
    const float s3h[2] = {__shfl_sync(0xFFFFFFFFu, s_run[m][1], src),
                          __shfl_sync(0xFFFFFFFFu, s_run[m][3], src)};
    const float s3l[2] = {__shfl_sync(0xFFFFFFFFu, s_lo[1], src),
                          __shfl_sync(0xFFFFFFFFu, s_lo[3], src)};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = dst[m][r];
      if (i < 0) continue;
      // a[c] = S[c] - x[c] S[3]: the fma cancels the hi parts exactly
      auto put = [&](int c, int q) {
        const float x = xr[m][r][c];
        out[(size_t)c * ni + i] =
            __fadd_rn(__fmaf_rn(-x, s3h[r], s_run[m][q]),
                      __fsub_rn(s_lo[q], __fmul_rn(x, s3l[r])));
      };
      if (t == 0) {
        put(0, 2 * r);
        put(1, 2 * r + 1);
      } else if (t == 1) {
        put(2, 2 * r);
      }
    }
  }
}

}  // namespace

// xi: float32[3, ni] receivers; order: int32[ni], a permutation of the
// receivers (Hilbert order is the accurate one: block k takes receivers
// order[k MXU_ROWS ...] and writes their rows of out); xj: float32[3, nj]
// sources; gv: float32[nj] G * valid; eps_sq: float32[1] on the device;
// box: float32[6], the inlier box (lo xyz, hi xyz) for the block centres;
// out: float32[3, ni], in the receivers' own order.
PSIM_EXPORT int psim_pairwise_mxu(const float* xi, const int* order,
                                  const float* xj, const float* gv,
                                  const float* eps_sq, const float* box,
                                  float* out, int ni, int nj,
                                  cudaStream_t stream) {
  const int blocks = (ni + MXU_ROWS - 1) / MXU_ROWS;
  if (blocks > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        pairwise_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MXU_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    pairwise_mxu_kernel<<<blocks, MXU_THREADS, MXU_SMEM_BYTES, stream>>>(
        xi, order, xj, gv, eps_sq, box, out, ni, nj);
  }
  return (int)cudaGetLastError();
}

// The kernel's resources on the current device: info[0] registers a
// thread, [1] shared memory a block (bytes, static + dynamic), [2] blocks
// an SM that fit, [3] threads a block, [4] local memory a thread (bytes:
// spills), [5] receivers a block.
PSIM_EXPORT int psim_pairwise_mxu_occupancy(int* info) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, pairwise_mxu_kernel);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(pairwise_mxu_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MXU_SMEM_BYTES);
  }
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, pairwise_mxu_kernel, MXU_THREADS, MXU_SMEM_BYTES);
  }
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes + MXU_SMEM_BYTES;
  info[2] = blocks;
  info[3] = MXU_THREADS;
  info[4] = (int)a.localSizeBytes;
  info[5] = MXU_ROWS;
  return (int)err;
}
