// All-pairs softened gravity as two matrix products on the tensor cores.
//
// Replaces particle_sim_tpu/ops/pairwise_pallas.py:_kernel_mxu (built by
// _build_mxu, entry pairwise_accel_mxu): the experimental matrix-unit
// formulation of the O(N^2) force,
//   r2[i, j] = -2 xi.xj + (|xi|^2 + eps^2) + |xj|^2      (product 1, K = 3)
//   W[i, j]  = rsqrt(r2)^3
//   S[c, i]  = sum_j gv[j] [x, y, z, 1][c, j] W[i, j]    (product 2, c < 4)
//   a[c, i]  = S[c, i] - xi[c, i] S[3, i]
// with gv[j] = G * (j_base + j < n_active) from the wrapper
// (ops/pairwise_cuda.py:pairwise_accel_mxu). A masked source (gv = 0) gets
// |xj|^2 + MASK_BIG, so w ~ 1e-45 (0 under ftz), and a zero B row: it adds
// exactly 0.
//
// What bounds it on the H100: operations. Per pair one MUFU rsqrt (16 per
// SM per clock: 1.03 ms at 65,536^2 and 1.98 GHz), a handful of FP32/INT
// instructions (the adds into r2, the cube, the TF32 split of w), and the
// tensor-core work: 4 mma.sync (three m16n8k8, one m16n8k4, TF32) for
// every 16 x 8 pairs (chip_smoke.py phase 14 prints both bounds).
//
// Design. One warp owns 16 receivers; 8 warps a block (128 receivers).
// The block stages 256 sources at a time in shared memory, already split
// into TF32 (hi, lo) pairs, and every warp sweeps them in steps of 8 (one
// 16 x 8 tile of pairs a step):
//   * Accuracy first. The expanded r^2 cancels terms of size |x|^2 (2,500
//     at radius 50) down to eps^2 = 0.25, and a = S[:3] - xi S[3] cancels
//     terms of size G w |x| (~1,000 for the self pair): in f32, as in the
//     JAX kernel and the plain version, that is ~0.1 relative error (1e-2
//     floor) at 65,536 filled-sphere particles. Both cancellations are
//     translation invariant, so the block works in coordinates centred on
//     its receivers' mean (far outliers left out), and the wrapper hands
//     it receivers in Hilbert-curve order (a block's receivers form a
//     compact region): |x - centre| drops from ~50 to ~10. |x|^2 terms are carried as (hi,
//     lo) pairs (exact squares by fma), the large terms of r^2 are added
//     first, and S is summed as an unevaluated (hi, lo) pair.
//   * Product 1: m16n8k8 with A = [xi_hi | xi_lo] (k = component, k + 4 =
//     its lo part) and B = [xj_lo ; xj_hi] gives the cross terms; m16n8k4
//     adds xi_hi . xj_hi in its own accumulator. This 3xTF32 split (hi.hi +
//     hi.lo + lo.hi) is the counterpart of Precision.HIGHEST: single-pass
//     TF32 (10 mantissa bits) misses the JAX bar by far.
//   * r2, rsqrt and the cube stay in registers. The accumulator layout of
//     product 1 (thread: rows g, g+8; columns 2t, 2t+1) is not the A
//     layout of product 2 (columns t, t+4), but the sum over j does not
//     care about the order of j: column 2t is read as k = t and 2t + 1 as
//     k = t + 4, and B is loaded with the same permutation. No shuffle and
//     no trip through shared memory.
//   * Product 2: two m16n8k8 (W_hi and W_lo) against B = [X_hi | X_lo]
//     (columns 0-3 the hi parts of the four rows gv [x, y, z, 1], 4-7
//     their lo parts): all four hi/lo cross products in two instructions,
//     and the N = 8 tile has no dead columns.
//   * S accumulates across the j loop inside the warp (the TPU carried it
//     in out_ref from one grid step to the next; Hopper blocks run in no
//     order). Every step's products start from a zero accumulator and are
//     added with rounded FP32 adds (the tensor cores truncate when they
//     accumulate, and 8,192 chained steps biased S measurably); each
//     stage's sum joins the (hi, lo) total by a two-sum.
//   * The epilogue a = S[:3] - xi S[3] is fused: two shuffles bring S's hi
//     and lo columns and S[3] together; an fma cancels the hi parts.
// Ragged edges: receivers past ni compute on x = 0 and are not written;
// sources past nj are staged as masked ones.
#include "common.cuh"

#define MX_WARPS 8
#define MX_ROWS (16 * MX_WARPS)  // receivers a block
#define MX_TJ 256                // sources a shared-memory stage
#define MX_LD (MX_TJ + 8)        // plane stride, 8 mod 32 words: the
                                 // fragment loads hit 32 distinct banks
#define MX_MASK_BIG 1e30f

namespace {

// TF32 (hi, lo) split: hi = x rounded to nearest (ties away) to 10 mantissa
// bits, lo = the rest rounded the same way. mma.sync ignores the low 13
// bits of a TF32 operand, so they are cleared here.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(__fsub_rn(x, __uint_as_float(hi)));
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
// every thread (part: MX_WARPS floats of shared memory, one use each).
__device__ __forceinline__ float block_sum(float v, float* part) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  }
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < MX_WARPS; ++w) total = __fadd_rn(total, part[w]);
  return total;
}

// D += A(16x8, row) B(8x8, col), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_k8(float d[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// D += A(16x4, row) B(4x8, col), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_k4(float d[4], uint32_t a0, uint32_t a1,
                                       uint32_t b0) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__global__ void __launch_bounds__(MX_WARPS * 32) pairwise_mxu_kernel(
    const float* __restrict__ xi, const float* __restrict__ xj,
    const float* __restrict__ gv, const float* __restrict__ eps_sq_p,
    const float* __restrict__ box, float* __restrict__ out, int ni,
    int nj) {
  // product 1's B: [0] hi, [1] lo of the centred source components (row 3
  // = 0); |xj - centre|^2 as (hi, lo)
  __shared__ __align__(16) uint32_t s_b[2][4][MX_LD];
  __shared__ __align__(16) float s_x2[2][MX_LD];
  // product 2's B: rows 0-3 hi, 4-7 lo of gv [x, y, z, 1] (centred)
  __shared__ __align__(16) uint32_t s_aug[8][MX_LD];
  __shared__ float s_red[5][MX_WARPS];

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * MX_ROWS + (threadIdx.x >> 5) * 16;
  const float eps_sq = __ldg(eps_sq_p);

  // the centre: the mean of the block's receivers that lie inside the
  // inlier box (the mean of all of them if none does), so padding parked
  // far from the cloud cannot drag it away while a block that spans two
  // clumps still sits between them; the sums run in a fixed order, so the
  // result does not change from run to run
  const int me = threadIdx.x;
  const int nb = min(MX_ROWS, ni - (int)blockIdx.x * MX_ROWS);
  float p[3] = {0.0f, 0.0f, 0.0f};
  bool inlier = me < nb;
  if (me < nb) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      p[c] = __ldg(xi + (size_t)c * ni + blockIdx.x * MX_ROWS + me);
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

  // rows g and g + 8 of this warp's 16 receivers: centred coordinates,
  // |xi|^2 + eps^2 as (hi, lo), and product 1's A fragment (k = t:
  // component t of -2 xi, 0 for t = 3)
  float xr[2][3], xi2h[2], xi2l[2];
  uint32_t ah[2], al[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + g + 8 * r;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      xr[r][c] = i < ni ? __fsub_rn(__ldg(xi + (size_t)c * ni + i), ctr[c])
                        : 0.0f;
    }
    norm2(xr[r], xi2h[r], xi2l[r]);
    two_sum(xi2h[r], xi2l[r], eps_sq);
    const float comp = t == 0 ? xr[r][0] : (t == 1 ? xr[r][1] : xr[r][2]);
    split_tf32(t < 3 ? -2.0f * comp : 0.0f, ah[r], al[r]);
  }

  // S's running sum as an unevaluated pair (s_run + s_err)
  float s_run[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float s_err[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int j0 = 0; j0 < nj; j0 += MX_TJ) {
    __syncthreads();  // the previous stage is consumed
    for (int k = threadIdx.x; k < MX_TJ; k += MX_WARPS * 32) {
      const int j = j0 + k;
      const bool in = j < nj;
      float v[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        v[c] = in ? __fsub_rn(__ldg(xj + (size_t)c * nj + j), ctr[c]) : 0.0f;
        split_tf32(v[c], s_b[0][c][k], s_b[1][c][k]);
      }
      s_b[0][3][k] = 0u;
      s_b[1][3][k] = 0u;
      const float w = in ? __ldg(gv + j) : 0.0f;
      float hi, lo;
      norm2(v, hi, lo);
      s_x2[0][k] = w == 0.0f ? __fadd_rn(hi, MX_MASK_BIG) : hi;
      s_x2[1][k] = lo;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        split_tf32(__fmul_rn(w, v[c]), s_aug[c][k], s_aug[4 + c][k]);
      }
      split_tf32(w, s_aug[3][k], s_aug[7][k]);
    }
    __syncthreads();

    float s_tile[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
    for (int k0 = 0; k0 < MX_TJ; k0 += 8) {
      // product 1: -2 xi.xj for rows g, g+8 x columns 2t, 2t+1
      const uint32_t bh = s_b[0][t][k0 + g];
      const uint32_t bl = s_b[1][t][k0 + g];
      float d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float d2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_k8(d2, ah[0], ah[1], al[0], al[1], bl, bh);  // hi.lo + lo.hi
      mma_k4(d1, ah[0], ah[1], bh);                     // hi.hi
      const float2 x2h =
          *reinterpret_cast<const float2*>(&s_x2[0][k0 + 2 * t]);
      const float2 x2l =
          *reinterpret_cast<const float2*>(&s_x2[1][k0 + 2 * t]);
      uint32_t wh[4], wl[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // the large terms first: -2 xi.xj + |xi|^2 + |xj|^2 cancel to r^2
        const float r2 = __fadd_rn(
            __fadd_rn(__fadd_rn(d1[q], xi2h[q >> 1]),
                      (q & 1) ? x2h.y : x2h.x),
            __fadd_rn(__fadd_rn(d2[q], xi2l[q >> 1]),
                      (q & 1) ? x2l.y : x2l.x));
        float inv;
        asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(r2));
        split_tf32(__fmul_rn(__fmul_rn(inv, inv), inv), wh[q], wl[q]);
      }
      // product 2: W's accumulator element (row, 2t) is A's (row, k = t),
      // (row, 2t + 1) is (row, k = t + 4); B = the source rows at the same j
      const uint2 b = *reinterpret_cast<const uint2*>(&s_aug[g][k0 + 2 * t]);
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_k8(d, wh[0], wh[2], wh[1], wh[3], b.x, b.y);
      mma_k8(d, wl[0], wl[2], wl[1], wl[3], b.x, b.y);
#pragma unroll
      for (int q = 0; q < 4; ++q) s_tile[q] = __fadd_rn(s_tile[q], d[q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) two_sum(s_run[q], s_err[q], s_tile[q]);
  }

  // rows g (q = 0, 1) and g + 8 (q = 2, 3) at columns 2t, 2t + 1; columns
  // 0-3 are W . X_hi, 4-7 W . X_lo: lane t + 2's sums join lane t's
  // low part, so lane t = 0 holds S[0], S[1] and t = 1 S[2], S[3] as
  // (hi, lo) pairs
  float s_lo[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float other = __fadd_rn(
        __shfl_xor_sync(0xFFFFFFFFu, s_run[q], 2),
        __shfl_xor_sync(0xFFFFFFFFu, s_err[q], 2));
    s_lo[q] = __fadd_rn(s_err[q], other);
  }
  const int src = (lane & ~3) | 1;
  const float s3h[2] = {__shfl_sync(0xFFFFFFFFu, s_run[1], src),
                        __shfl_sync(0xFFFFFFFFu, s_run[3], src)};
  const float s3l[2] = {__shfl_sync(0xFFFFFFFFu, s_lo[1], src),
                        __shfl_sync(0xFFFFFFFFu, s_lo[3], src)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + g + 8 * r;
    if (i >= ni) continue;
    // a[c] = S[c] - x[c] S[3]: the fma cancels the hi parts exactly
    auto put = [&](int c, int q) {
      const float x = xr[r][c];
      out[(size_t)c * ni + i] =
          __fadd_rn(__fmaf_rn(-x, s3h[r], s_run[q]),
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

}  // namespace

// xi: float32[3, ni] receivers (any order; Hilbert order is the
// accurate one); xj: float32[3, nj] sources; gv: float32[nj] G * valid; eps_sq:
// float32[1] on the device; box: float32[6], the inlier box (lo xyz, hi
// xyz) for the block centres; out: float32[3, ni].
PSIM_EXPORT int psim_pairwise_mxu(const float* xi, const float* xj,
                                  const float* gv, const float* eps_sq,
                                  const float* box, float* out, int ni,
                                  int nj, cudaStream_t stream) {
  const int blocks = (ni + MX_ROWS - 1) / MX_ROWS;
  if (blocks > 0) {
    pairwise_mxu_kernel<<<blocks, MX_WARPS * 32, 0, stream>>>(
        xi, xj, gv, eps_sq, box, out, ni, nj);
  }
  return (int)cudaGetLastError();
}
