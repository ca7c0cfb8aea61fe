// Design probe of the tensor-core all-pairs force
// (ops/pairwise_cuda.py:pairwise_accel_mxu): the package's kernel
// (csrc/pairwise_mxu.cu, included with the numeric -D knobs that
// pairwise_mxu_variants.py passes) and the earlier kernel, verbatim, as
// variant 0 (receivers pre-gathered in Hilbert order; r^2 from two
// products and five FP32 adds a pair, W split by bit arithmetic, an FP32
// add a pair into the stage sum, one stage buffer). Built by
// tools/pairwise_mxu_variants.py (chip_smoke.py builds its first config to
// time variant 0), not by the package; on no path. Variant (e), product 1
// on wgmma, is built where the config defines MXU_WG.
#include "../csrc/pairwise_mxu.cu"

namespace v0 {

// ---- variant 0: the earlier kernel, verbatim (its exported launcher is
// ---- probe_v0_mxu below)
#define MX_WARPS 8
#define MX_ROWS (16 * MX_WARPS)  // receivers a block
#define MX_TJ 256                // sources a shared-memory stage
#define MX_LD (MX_TJ + 8)        // plane stride, 8 mod 32 words: the
                                 // fragment loads hit 32 distinct banks
#define MX_MASK_BIG 1e30f


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

}  // namespace v0

// variant 0's launcher: xi float32[3, ni] receivers (any order; Hilbert
// order is the accurate one); xj: float32[3, nj] sources; gv: float32[nj]
// G * valid; eps_sq: float32[1] on the device; box: float32[6], the
// inlier box (lo xyz, hi xyz) for the block centres; out: float32[3, ni].
PSIM_EXPORT int probe_v0_mxu(const float* xi, const float* xj,
                             const float* gv, const float* eps_sq,
                             const float* box, float* out, int ni, int nj,
                             cudaStream_t stream) {
  const int blocks = (ni + MX_ROWS - 1) / MX_ROWS;
  if (blocks > 0) {
    v0::pairwise_mxu_kernel<<<blocks, MX_WARPS * 32, 0, stream>>>(
        xi, xj, gv, eps_sq, box, out, ni, nj);
  }
  return (int)cudaGetLastError();
}

// variant 0's resources, as psim_pairwise_mxu_occupancy reports the
// package kernel's
PSIM_EXPORT int probe_v0_occupancy(int* info) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, v0::pairwise_mxu_kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, v0::pairwise_mxu_kernel, MX_WARPS * 32, 0);
  }
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = blocks;
  info[3] = MX_WARPS * 32;
  info[4] = (int)a.localSizeBytes;
  info[5] = MX_ROWS;
  return (int)err;
}

#if defined(MXU_WG)
static_assert(MXU_MTILES == 1 && MXU_WARPS % 4 == 0,
              "variant (e): one row tile a warp, whole warpgroups");
// ---- variant (e): product 1 on wgmma (asynchronous, a warpgroup a 64
// ---- receivers, B read from shared memory), product 2 on mma.sync as in
// ---- the package's kernel. Built where the config defines MXU_WG.
namespace wg {

#define WG_N 32  // sources a product-1 wgmma (m64n32k8), a chunk

// shared-memory matrix descriptor, K-major, no swizzle: 8-row x 16-byte
// core matrices, 128 B apart along K (LBO), 512 B apart along N (SBO)
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(512 >> 4) << 32);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void keep(float (&d)[16]) {
#pragma unroll
  for (int q = 0; q < 16; ++q) asm volatile("" : "+f"(d[q])::"memory");
}

// D (+)= A(64x8, registers) B(8x32, shared), TF32, f32 accumulate
__device__ __forceinline__ void mma_n32(float (&d)[16], const uint32_t a[4],
                                        uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// Product 1's K is 16 here (wgmma takes k8 steps): slots 0-8 as in the
// package's kernel, 9-11 (|xi|^2 + eps^2 parts) . 1, 12-14 1 . |xj|^2
// parts, 15 zero; the accumulator starts from 0.
__device__ __forceinline__ uint32_t b1_slot16(int s, const uint32_t vh[3],
                                              const uint32_t vl[3],
                                              const uint32_t x2[3]) {
  if (s < 3) return vh[s];
  if (s < 6) return vl[s - 3];
  if (s < 9) return vh[s - 6];
  if (s < 12) return 0x3F800000u;  // 1.0f
  if (s < 15) return x2[s - 12];
  return 0u;
}

// slot s (a run-time value) of a receiver's product-1 A row
__device__ __forceinline__ uint32_t a1_slot16(int s, const uint32_t mh[3],
                                              const uint32_t ml[3],
                                              const uint32_t x2[3]) {
  uint32_t v = 0u;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const uint32_t slot = q < 3 ? mh[q] : q < 6 ? mh[q - 3]
                        : q < 9 ? ml[q - 6] : q < 12 ? x2[q - 9]
                        : q < 15 ? 0x3F800000u : 0u;
    v = q == s ? slot : v;
  }
  return v;
}

// the package's fill_stage with product 1's B in core-matrix order:
// source j, slot s at word (j / 8) 128 + (s / 4) 32 + (j % 8) 4 + s % 4
__device__ __forceinline__ void fill(uint32_t* __restrict__ st,
                                     const float* __restrict__ xj,
                                     const float* __restrict__ gv, int j0,
                                     int nj, const float ctr[3]) {
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
    uint32_t* row = st + (k >> 3) * 128 + (k & 7) * 4;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      *reinterpret_cast<uint4*>(row + 32 * kc) =
          make_uint4(b1_slot16(4 * kc, vh, vl, x2),
                     b1_slot16(4 * kc + 1, vh, vl, x2),
                     b1_slot16(4 * kc + 2, vh, vl, x2),
                     b1_slot16(4 * kc + 3, vh, vl, x2));
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
  // the stores reach the tensor cores' (async) proxy before the barrier
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__global__ void __launch_bounds__(MXU_THREADS, 2)
    wg_kernel(const float* __restrict__ xi, const int* __restrict__ order,
              const float* __restrict__ xj, const float* __restrict__ gv,
              const float* __restrict__ eps_sq_p,
              const float* __restrict__ box, float* __restrict__ out, int ni,
              int nj) {
  extern __shared__ __align__(128) uint32_t smem[];
  __shared__ float s_red[5][MXU_WARPS];

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int base = blockIdx.x * MXU_ROWS;
  const int row0 = base + (threadIdx.x >> 5) * 16;
  const float eps_sq = __ldg(eps_sq_p);

  // the block centre, as the package's kernel takes it
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

  int dst[2];
  float xr[2][3];
  uint32_t a1[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + g + 8 * r;
    dst[r] = i < ni ? __ldg(order + i) : -1;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      xr[r][c] = i < ni ? __fsub_rn(__ldg(xi + (size_t)c * ni + dst[r]),
                                    ctr[c])
                        : 0.0f;
    }
    float hi, lo;
    norm2(xr[r], hi, lo);
    two_sum(hi, lo, eps_sq);
    uint32_t mh[3], ml[3], x2[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) split2(-2.0f * xr[r][c], mh[c], ml[c]);
    split3(hi, lo, x2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a1[h][r] = a1_slot16(t + 8 * h, mh, ml, x2);
      a1[h][2 + r] = a1_slot16(t + 4 + 8 * h, mh, ml, x2);
    }
  }

  float s_run[4] = {0.0f, 0.0f, 0.0f, 0.0f}, s_err[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  fill(smem, xj, gv, 0, nj, ctr);
  int stage = 0;
  for (int j0 = 0; j0 < nj; j0 += MXU_TJ, stage ^= 1) {
    __syncthreads();
    uint32_t* st = smem + stage * MXU_STAGE_WORDS;
    if (j0 + MXU_TJ < nj) {
      fill(smem + (stage ^ 1) * MXU_STAGE_WORDS, xj, gv, j0 + MXU_TJ, nj,
           ctr);
    }
    const uint32_t b1s =
        static_cast<uint32_t>(__cvta_generic_to_shared(st));
    const uint32_t* b2 = st + MXU_B1_WORDS + 16 * g + 4 * t;
    float tile[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    float dA[16], dB[16];
    // product 1 of chunk c (sources 32c ..): r^2, 64 receivers x 32
    auto issue = [&](float (&d)[16], int c) {
      fence();
      mma_n32(d, a1[0], desc(b1s + c * (WG_N / 8) * 512), 0);
      mma_n32(d, a1[1], desc(b1s + c * (WG_N / 8) * 512 + 256), 1);
      commit();
    };
    // product 2 of chunk c from its r^2 (four 8-source steps), into acc[a]
    auto take = [&](float (&d)[16], int c, int a) {
      keep(d);
#pragma unroll
      for (int hs = 0; hs < 2; ++hs) {
        const int k0 = c * WG_N + 16 * hs;
        const uint4 bb = *reinterpret_cast<const uint4*>(b2 + 8 * k0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int jj = 2 * hs + h;
          uint32_t wh[4], wl[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float inv;
            asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(d[4 * jj + q]));
            split2_w(__fmul_rn(__fmul_rn(inv, inv), inv), wh[q], wl[q]);
          }
          const uint32_t c0 = h ? bb.z : bb.x, c1 = h ? bb.w : bb.y;
          mma_w(acc[a], wh, c0, c1);
          mma_w(acc[a], wl, c0, c1);
        }
      }
    };
    // a chain of two chunks (8 steps) in one accumulator, added into the
    // stage sum while the other accumulator takes the next chain
    auto flush = [&](int a) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        tile[q] = __fadd_rn(tile[q], acc[a][q]);
        acc[a][q] = 0.0f;
      }
    };
    constexpr int kChunks = MXU_TJ / WG_N;
    static_assert(kChunks % 4 == 0, "whole pairs of chains a stage");
    issue(dA, 0);
#pragma unroll 1
    for (int c = 0; c < kChunks; c += 4) {
      issue(dB, c + 1);
      wait<1>();
      take(dA, c, 0);
      issue(dA, c + 2);
      wait<1>();
      take(dB, c + 1, 0);
      flush(1);
      issue(dB, c + 3);
      wait<1>();
      take(dA, c + 2, 1);
      if (c + 4 < kChunks) {
        issue(dA, c + 4);
        wait<1>();
      } else {
        wait<0>();
      }
      take(dB, c + 3, 1);
      flush(0);
    }
    flush(1);
#pragma unroll
    for (int q = 0; q < 4; ++q) two_sum(s_run[q], s_err[q], tile[q]);
  }

  const int src = (lane & ~3) | 1;
  float s_lo[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float other = __fadd_rn(__shfl_xor_sync(0xFFFFFFFFu, s_run[q], 2),
                                  __shfl_xor_sync(0xFFFFFFFFu, s_err[q], 2));
    s_lo[q] = __fadd_rn(s_err[q], other);
  }
  const float s3h[2] = {__shfl_sync(0xFFFFFFFFu, s_run[1], src),
                        __shfl_sync(0xFFFFFFFFu, s_run[3], src)};
  const float s3l[2] = {__shfl_sync(0xFFFFFFFFu, s_lo[1], src),
                        __shfl_sync(0xFFFFFFFFu, s_lo[3], src)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = dst[r];
    if (i < 0) continue;
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

}  // namespace wg

// variant (e)'s launcher, psim_pairwise_mxu's arguments
PSIM_EXPORT int probe_wg_mxu(const float* xi, const int* order,
                             const float* xj, const float* gv,
                             const float* eps_sq, const float* box,
                             float* out, int ni, int nj,
                             cudaStream_t stream) {
  const int blocks = (ni + MXU_ROWS - 1) / MXU_ROWS;
  const int smem = 4 * MXU_STAGE_WORDS * 2;
  if (blocks > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        wg::wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    wg::wg_kernel<<<blocks, MXU_THREADS, smem, stream>>>(
        xi, order, xj, gv, eps_sq, box, out, ni, nj);
  }
  return (int)cudaGetLastError();
}

PSIM_EXPORT int probe_wg_occupancy(int* info) {
  const int smem = 4 * MXU_STAGE_WORDS * 2;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, wg::wg_kernel);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        wg::wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, wg::wg_kernel, MXU_THREADS, smem);
  }
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes + smem;
  info[2] = blocks;
  info[3] = MXU_THREADS;
  info[4] = (int)a.localSizeBytes;
  info[5] = MXU_ROWS;
  return (int)err;
}
#endif

// ---- pipe rates: how many mma.sync (TF32 m16n8k8, m16n8k4) and MUFU
// ---- rsqrt an SM completes a clock, alone and mixed as the sweep mixes
// ---- them (4 mma and 4 rsqrt a thread a 16 x 8 tile). Every warp runs 8
// ---- independent chains, so the pipes, not their latencies, set the time.
namespace rate {

template <int kKind>  // 0 k8, 1 k4, 2 rsqrt, 3 k8 + rsqrt, 4 a pair's
                      // FP32 chain, 5 the chain + k8
__global__ void __launch_bounds__(256) rate_kernel(float* out, int iters) {
  const uint32_t a[4] = {threadIdx.x, threadIdx.x ^ 5u, threadIdx.x * 3u,
                         threadIdx.x + 7u};
  float d[8][4];
  float r[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    r[u] = 1.0f + u;
#pragma unroll
    for (int q = 0; q < 4; ++q) d[u][q] = 0.0f;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (kKind == 0 || kKind == 3) mma_k8(d[u], a, a[u & 3], a[(u + 1) & 3]);
      if (kKind == 1) mma_k4(d[u], a[0], a[1], a[u & 3], d[u]);
      if (kKind == 2 || kKind == 3) {
        float inv;
        asm volatile("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(r[u]));
        r[u] = inv;
      }
      if (kKind == 4 || kKind == 5) {
        // the sweep's per-pair arithmetic: rsqrt, the cube, W's split;
        // the next r depends on both parts
        float inv;
        asm volatile("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(r[u]));
        uint32_t hi, lo;
        split2_w(__fmul_rn(__fmul_rn(inv, inv), inv), hi, lo);
        r[u] = __fadd_rn(__uint_as_float(hi), __uint_as_float(lo) + 1.0f);
        if (kKind == 5) mma_k8(d[u], a, hi, lo);
      }
    }
  }
  float sum = 0.0f;
#pragma unroll
  for (int u = 0; u < 8; ++u) sum += r[u] + d[u][0] + d[u][1] + d[u][2] + d[u][3];
  if (sum == 12345.0f) out[threadIdx.x] = sum;  // keeps the work alive
}

}  // namespace rate

// kind: 0 mma k8, 1 mma k4, 2 rsqrt, 3 mma k8 + rsqrt (1:1 as in the
// sweep), 4 a pair's FP32 chain (rsqrt, cube, W's split), 5 that chain +
// mma k8; blocks of 256 threads, iters trips of 8 of each a thread
PSIM_EXPORT int probe_rate(int kind, int blocks, int iters, float* out,
                           cudaStream_t stream) {
  switch (kind) {
    case 0: rate::rate_kernel<0><<<blocks, 256, 0, stream>>>(out, iters); break;
    case 1: rate::rate_kernel<1><<<blocks, 256, 0, stream>>>(out, iters); break;
    case 2: rate::rate_kernel<2><<<blocks, 256, 0, stream>>>(out, iters); break;
    case 3: rate::rate_kernel<3><<<blocks, 256, 0, stream>>>(out, iters); break;
    case 4: rate::rate_kernel<4><<<blocks, 256, 0, stream>>>(out, iters); break;
    default: rate::rate_kernel<5><<<blocks, 256, 0, stream>>>(out, iters);
  }
  return (int)cudaGetLastError();
}
