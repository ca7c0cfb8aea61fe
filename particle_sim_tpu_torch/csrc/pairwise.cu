// All-pairs softened gravity on the CUDA cores: register-blocked receivers,
// a deterministic split of the sources, asynchronous double-buffered
// tiles, live counts read on the device.
//
// Replaces particle_sim_tpu/ops/pairwise_pallas.py:_kernel (a (TI, TJ)
// VPU broadcast tile per grid step, j minor, with the (TI, 3) output block
// resident in VMEM across the whole j sweep).
//
// What it computes (one template, two instantiations):
//   pairwise_kernel<false>:
//     out[i] = sum_j gv[j] (x_j - x_i) rsqrt(|x_j - x_i|^2 + eps_a^2)^3
//   pairwise_kernel<true> (pmx's correction, ops/pmx.py):
//     out[i] = sum_j gv[j] (x_j - x_i) (inv_a^3 - inv_b^3),
//     inv_a = rsqrt(r0^2 + eps_a^2), inv_b = rsqrt(r0^2 + eps_b^2)
// for receivers x_i = xi[i, 0:3] (i < n_i) and sources x_j = xj[0:3, j]
// (j < n_j); gv[j] = G * (j_base + j < n_active) * m_j is built by the
// wrapper (ops/pairwise_cuda.py), so the O(N^2) loop carries no mask
// arithmetic. Receivers at or past n_i get exactly 0.
//
// What bounds it on the H100: operations; the bytes are O(N) against
// O(N^2) work. A pair of <false> costs 12 FP32 instructions (3 sub; r2 as
// 3 fma, eps^2 the first addend; 3 mul for w = gv * inv^3; 3 fma into the
// sum), 18 flops counting an fma as 2, and one MUFU rsqrt: at 65,536^2
// 1.154 ms at the 67 TFLOP/s peak, 1.538 ms at the FP32 issue rate (half
// the instructions are not fmas) and 1.025 ms at the rsqrt rate (16 per
// SM and clock). A pair of <true> costs 15 FP32 instructions (rb = ra +
// (eps_b^2 - eps_a^2); the cubes' difference as 2 mul, a negated mul and
// an fma; w = gv * that), 22 flops, and two rsqrt: the rsqrt rate binds.
// chip_smoke.py phase 10 prints the bounds.
//
// Design (GPU Gems 3 ch. 31, arXiv 0706.3060, reworked for Hopper):
//  - Each thread owns PW_R receivers (strided by the block's thread count)
//    and keeps their sums in registers: one broadcast shared-memory float4
//    (x, y, z, gv) feeds PW_R pairs, so the load is 1 / PW_R of an issue
//    slot a pair. Each receiver's sum runs in j-ascending order.
//  - The grid is (receiver blocks, S source slices). A slice sweeps its
//    share of the live tiles; with S > 1 each slice writes its partial sums
//    into an f32[S, Ni, 3] scratch and slice_sum_kernel adds them in slice
//    order. No atomics: the same inputs give the same bits on every launch.
//    The wrapper picks S from Ni and the SM count so that a small Ni still
//    fills the card.
//  - Source tiles of PW_TJ points are staged by cp.async (the three
//    coordinate planes and gv, 4 bytes each, into float4 slots) into a
//    double buffer: tile t + 1 arrives while tile t is swept, one barrier
//    a tile. Slots past n_j are zero-filled by the copy (a NaN there is
//    never read) and add exactly 0 (gv = 0; r2 >= eps^2 > 0 keeps the
//    weight finite), so every tile, ragged or not, runs the one unrolled
//    loop.
//  - n_i and n_j are int32 device pointers (NULL: the host shapes ni, nj).
//    A block whose receivers all lie at or past n_i writes zeros and
//    returns; the tiles end at the last one that holds a source below n_j,
//    and the slices divide those live tiles among themselves. Nothing is
//    read back to the host.
// The earlier design (one receiver a thread, one block a 256 receivers,
// no split, synchronous tile loads) is variant 0 of
// tools/pairwise_variants.cu; chip_smoke.py phase 10 times both in turns.
#include "common.cuh"

#ifndef PW_R
#define PW_R 4              // receivers a thread (tools/pairwise_variants.py
#endif                      // timed 2 and 4: 4 is faster, PERF.md row 5)
#ifndef PW_THREADS
#define PW_THREADS 128      // threads a block
#endif
#ifndef PW_TJ
#define PW_TJ 256           // sources a tile: 4 KB a buffer
#endif
#ifndef PW_UNROLL
#define PW_UNROLL 16        // sources a step of the unrolled sweep
#endif
#ifndef PW_MIN_BLOCKS
#define PW_MIN_BLOCKS 4     // resident blocks an SM the registers allow
#endif
// receivers a block and sources a tile: ops/pairwise_cuda.py's
// RECEIVERS_PER_BLOCK and SOURCE_TILE, from which it picks the split
#define PW_BI (PW_THREADS * PW_R)
#define PW_SUM_THREADS 256
// #pragma unroll with a macro's value
#define PW_PRAGMA(x) _Pragma(#x)
#define PW_UNROLL_BY(n) PW_PRAGMA(unroll n)

static_assert(PW_TJ % PW_THREADS == 0, "a tile is whole rounds of threads");

namespace {

// 4 bytes global -> shared, asynchronous; src_bytes 0 zero-fills the slot
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float rsqrt_ftz(float r2) {
  // rsqrtf without flush-to-zero wraps the MUFU op in two rescaling
  // multiplies for subnormal inputs; r2 >= eps^2 is never subnormal for a
  // softening above ~1e-19, so the bare approximate op (same 2 ulp) does
  float inv;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(r2));
  return inv;
}

// stage tile t (sources t * PW_TJ ...) into buf: slot k = (x, y, z, gv) of
// source j, zeros for j >= nj_live
__device__ __forceinline__ void stage(float4* buf,
                                      const float* __restrict__ xj,
                                      const float* __restrict__ gv, int t,
                                      int nj, int nj_live) {
#pragma unroll
  for (int q = 0; q < PW_TJ / PW_THREADS; ++q) {
    const int k = q * PW_THREADS + threadIdx.x;
    const int j = t * PW_TJ + k;
    const int live = j < nj_live;
    const size_t jj = live ? (size_t)j : 0;
    const int b = live ? 4 : 0;
    float* slot = reinterpret_cast<float*>(buf + k);
    cp_async4(slot, xj + jj, b);
    cp_async4(slot + 1, xj + (size_t)nj + jj, b);
    cp_async4(slot + 2, xj + 2 * (size_t)nj + jj, b);
    cp_async4(slot + 3, gv + jj, b);
  }
  cp_async_commit();
}

template <bool DIFF>
__global__ void __launch_bounds__(PW_THREADS, PW_MIN_BLOCKS) pairwise_kernel(
    const float* __restrict__ xi, const float* __restrict__ xj,
    const float* __restrict__ gv, const float* __restrict__ eps_sq_p,
    const int* __restrict__ n_i_p, const int* __restrict__ n_j_p,
    float* __restrict__ out, int ni, int nj) {
  __shared__ __align__(16) float4 tile[2][PW_TJ];
  const int ni_live = n_i_p ? min(max(__ldg(n_i_p), 0), ni) : ni;
  const int nj_live = n_j_p ? min(max(__ldg(n_j_p), 0), nj) : nj;
  // slice s of gridDim.y writes its own plane of the scratch (or out)
  float* __restrict__ dst = out + (size_t)blockIdx.y * ni * 3;
  const int i_base = blockIdx.x * PW_BI + threadIdx.x;
  if (blockIdx.x * PW_BI >= ni_live) {
#pragma unroll
    for (int r = 0; r < PW_R; ++r) {
      const int i = i_base + r * PW_THREADS;
      if (i < ni) {
        dst[3 * (size_t)i] = 0.0f;
        dst[3 * (size_t)i + 1] = 0.0f;
        dst[3 * (size_t)i + 2] = 0.0f;
      }
    }
    return;
  }
  const float eps_a = __ldg(eps_sq_p);
  const float eps_d = DIFF ? __ldg(eps_sq_p + 1) - eps_a : 0.0f;
  float x[PW_R], y[PW_R], z[PW_R], ax[PW_R], ay[PW_R], az[PW_R];
#pragma unroll
  for (int r = 0; r < PW_R; ++r) {
    const int i = i_base + r * PW_THREADS;
    const bool live = i < ni_live;
    x[r] = live ? xi[3 * (size_t)i] : 0.0f;
    y[r] = live ? xi[3 * (size_t)i + 1] : 0.0f;
    z[r] = live ? xi[3 * (size_t)i + 2] : 0.0f;
    ax[r] = ay[r] = az[r] = 0.0f;
  }
  // this slice's share of the live tiles
  const int tiles = (nj_live + PW_TJ - 1) / PW_TJ;
  const int per = (tiles + gridDim.y - 1) / gridDim.y;
  const int t0 = min(tiles, (int)blockIdx.y * per);
  const int t1 = min(tiles, t0 + per);
  if (t0 < t1) stage(tile[0], xj, gv, t0, nj, nj_live);
  for (int t = t0; t < t1; ++t) {
    cp_async_wait_all();
    // tile t is in; every thread is done with tile t - 1, whose buffer the
    // next stage overwrites
    __syncthreads();
    if (t + 1 < t1) stage(tile[(t + 1 - t0) & 1], xj, gv, t + 1, nj, nj_live);
    const float4* __restrict__ tl = tile[(t - t0) & 1];
    PW_UNROLL_BY(PW_UNROLL)
    for (int k = 0; k < PW_TJ; ++k) {
      const float4 s = tl[k];
#pragma unroll
      for (int r = 0; r < PW_R; ++r) {
        const float dx = s.x - x[r];
        const float dy = s.y - y[r];
        const float dz = s.z - z[r];
        const float ra = eps_a + dx * dx + dy * dy + dz * dz;  // 3 fma
        const float ia = rsqrt_ftz(ra);
        float w;
        if (DIFF) {
          const float ib = rsqrt_ftz(ra + eps_d);
          w = s.w * fmaf(-ib * ib, ib, ia * ia * ia);
        } else {
          w = s.w * (ia * ia * ia);
        }
        ax[r] += w * dx;
        ay[r] += w * dy;
        az[r] += w * dz;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < PW_R; ++r) {
    const int i = i_base + r * PW_THREADS;
    if (i < ni) {
      const bool live = i < ni_live;
      dst[3 * (size_t)i] = live ? ax[r] : 0.0f;
      dst[3 * (size_t)i + 1] = live ? ay[r] : 0.0f;
      dst[3 * (size_t)i + 2] = live ? az[r] : 0.0f;
    }
  }
}

// out[k] = part[0][k] + part[1][k] + ... in slice order (n3 = 3 ni)
__global__ void __launch_bounds__(PW_SUM_THREADS) slice_sum_kernel(
    const float* __restrict__ part, float* __restrict__ out, int n3,
    int slices) {
  const int k = blockIdx.x * PW_SUM_THREADS + threadIdx.x;
  if (k >= n3) return;
  float a = part[k];
  for (int s = 1; s < slices; ++s) a += part[(size_t)s * n3 + k];
  out[k] = a;
}

template <bool DIFF>
int launch(const float* xi, const float* xj, const float* gv,
           const float* eps_sq, const int* n_i, const int* n_j, float* out,
           float* partial, int ni, int nj, int slices, cudaStream_t stream) {
  const int blocks = (ni + PW_BI - 1) / PW_BI;
  if (blocks == 0) return (int)cudaGetLastError();
  if (slices < 1 || (slices > 1 && partial == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  float* dst = slices > 1 ? partial : out;
  pairwise_kernel<DIFF><<<dim3(blocks, slices), PW_THREADS, 0, stream>>>(
      xi, xj, gv, eps_sq, n_i, n_j, dst, ni, nj);
  if (slices > 1) {
    const int n3 = 3 * ni;
    slice_sum_kernel<<<(n3 + PW_SUM_THREADS - 1) / PW_SUM_THREADS,
                       PW_SUM_THREADS, 0, stream>>>(partial, out, n3, slices);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// xi: float32[ni, 3] receivers; xj: float32[3, nj] source planes;
// gv: float32[nj] source weights; eps_sq: float32[1] (eps_a^2), or [2]
// (eps_a^2, eps_b^2) with diff; n_i, n_j: int32[1] live counts on the
// device, or NULL for ni, nj; out: float32[ni, 3]; partial: float32[slices,
// ni, 3] scratch (unused, may be NULL, when slices is 1); diff: 0 for
// pairwise_kernel<false>, 1 for <true>.
PSIM_EXPORT int psim_pairwise(const float* xi, const float* xj,
                              const float* gv, const float* eps_sq,
                              const int* n_i, const int* n_j, float* out,
                              float* partial, int ni, int nj, int slices,
                              int diff, cudaStream_t stream) {
  return diff ? launch<true>(xi, xj, gv, eps_sq, n_i, n_j, out, partial, ni,
                             nj, slices, stream)
              : launch<false>(xi, xj, gv, eps_sq, n_i, n_j, out, partial, ni,
                              nj, slices, stream);
}
