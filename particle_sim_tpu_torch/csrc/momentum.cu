// The PM momentum clean's sums: the live mass-weighted sums of the
// acceleration and the weight, and their mean, in one launch.
//
// Replaces no TPU kernel: the JAX package takes these sums in plain jnp
// (ops/pm.py momentum_clean); the port's plain version, ops/pm.py
// momentum_mean, makes elementwise passes over f32[3, N] and two
// reductions. csrc/step.cu's kicked form subtracts the mean; this kernel
// only reads. Its grid instance (psim_momentum_sums_grid) takes the same
// sums from the deposit and the interleaved grid, G^3 cells in place of N
// particles, for the PM gather's kicked instance (csrc/pm.cu).
//
// What bounds it on the H100: device-memory bandwidth. A particle is read
// once: its three accelerations (12 B), its live flag (1 B, or none when
// liveness is i < n_active) and its mass (4 B, or none), for 4 products
// and 4 adds. At 16,777,216 particles with a live mask and masses that is
// 285 MB, 0.085 ms at 3.35 TB/s.
//
// Design: a grid-stride loop (256 threads a block, the grid fixed by n
// alone) accumulates each thread's four sums in float64; the block sums
// its threads in a fixed tree and writes its partials; the last block to
// finish (a counter in device memory, which that block sets back to 0)
// sums the partials in block order and writes
//
//     out[0..3] = (float)(sum w a_x, sum w a_y, sum w a_z, sum w)
//     out[4..6] = out[0..2] / max(out[3], 1e-12)
//
// the mean formed from the float32 sums as ops/pm.py forms it, so a mesh
// that all-reduces out[0..3] (parallel/) and divides gets the same bits at
// world size 1. The order of every sum depends on n alone: two launches on
// the same input give the same bits. Each weight is live * mass in
// float32 as the plain version forms it; the products and sums are in
// float64, more accurate than torch.sum's float32 tree.
#include "common.cuh"

namespace {

constexpr int MS_THREADS = 256;
constexpr int MS_WARPS = MS_THREADS / 32;

// The block's sum of the four per-thread values, in a fixed order; the
// result is in thread 0's v.
__device__ __forceinline__ void block_sum4(double v[4], double (*smem)[4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) smem[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      double t = smem[0][k];
      for (int w = 1; w < MS_WARPS; ++w) t += smem[w][k];
      v[k] = t;
    }
  }
}

// kGrid: the grid instance. acc is then the interleaved f32[n, 4] grid (x,
// y, z, pad a cell; n = G^3 cells), `masses` the deposit rho (f32[n]), the
// weight of cell i, and live / n_active are unused.
template <bool kGrid>
__global__ void __launch_bounds__(MS_THREADS) momentum_sums_kernel(
    const float* __restrict__ acc, int64_t n, const uint8_t* __restrict__ live,
    const int* __restrict__ n_active, const float* __restrict__ masses,
    double* __restrict__ partials, unsigned int* __restrict__ counter,
    float* __restrict__ out) {
  __shared__ double smem[MS_WARPS][4];
  __shared__ bool last;
  const int64_t n_live =
      kGrid || live != nullptr ? n : (int64_t)__ldg(n_active);
  double v[4] = {0.0, 0.0, 0.0, 0.0};
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float w, a[3];
    if constexpr (kGrid) {
      w = __ldg(masses + i);
      const float4 c = __ldg(reinterpret_cast<const float4*>(acc) + i);
      a[0] = c.x; a[1] = c.y; a[2] = c.z;
    } else {
      const bool on = live != nullptr ? __ldg(live + i) != 0 : i < n_live;
      w = on ? 1.0f : 0.0f;
      if (masses != nullptr) w = __fmul_rn(w, __ldg(masses + i));
      a[0] = __ldg(acc + i); a[1] = __ldg(acc + n + i);
      a[2] = __ldg(acc + 2 * n + i);
    }
    const double wd = (double)w;
    v[0] += (double)a[0] * wd;
    v[1] += (double)a[1] * wd;
    v[2] += (double)a[2] * wd;
    v[3] += wd;
  }
  block_sum4(v, smem);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) partials[4 * blockIdx.x + k] = v[k];
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: each thread sums the partials of blocks t, t + 256, ...
  // in order, then the block's fixed tree
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = 0.0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += MS_THREADS) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] += __ldcg(partials + 4 * b + k);
  }
  __syncthreads();  // smem is reused
  block_sum4(v, smem);
  if (threadIdx.x == 0) {
    const float s0 = (float)v[0], s1 = (float)v[1], s2 = (float)v[2];
    const float c = (float)v[3];
    // torch.clamp_min(c, 1e-12): a NaN weight stays NaN
    const float d = c < 1e-12f ? 1e-12f : c;
    out[0] = s0; out[1] = s1; out[2] = s2; out[3] = c;
    out[4] = __fdiv_rn(s0, d);
    out[5] = __fdiv_rn(s1, d);
    out[6] = __fdiv_rn(s2, d);
    *counter = 0u;
  }
}

unsigned sum_blocks(int64_t n, int max_blocks) {
  int64_t blocks = (n + MS_THREADS - 1) / MS_THREADS;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  return (unsigned)blocks;
}

}  // namespace

// acc: float32[3, n] contiguous. live: bool[n], or NULL for i < *n_active
// (int32). masses: float32[n] or NULL (1). partials: float64[4 *
// max_blocks] scratch; counter: one uint32, 0 before the launch and 0
// after it. out: float32[7] (sums, weight, mean). Every pointer is device
// memory; the grid is min(ceil(n / 256), max_blocks) blocks.
PSIM_EXPORT int psim_momentum_sums(const float* acc, int64_t n,
                                   const uint8_t* live, const int* n_active,
                                   const float* masses, double* partials,
                                   unsigned int* counter, int max_blocks,
                                   float* out, cudaStream_t stream) {
  momentum_sums_kernel<false><<<sum_blocks(n, max_blocks), MS_THREADS, 0,
                                stream>>>(acc, n, live, n_active, masses,
                                          partials, counter, out);
  return (int)cudaGetLastError();
}

// The same sums from the grids: grid4 the interleaved float32[cells, 4]
// acceleration grid (16-byte aligned), rho the float32[cells] deposit it
// was solved from; out[0..3] = (sum rho a_x, sum rho a_y, sum rho a_z, sum
// rho), out[4..6] the mean. Equal, in exact arithmetic, to
// psim_momentum_sums of the field gathered from grid4 with rho's weights
// (csrc/pm.cu: deposit and gather share their corner weights); the order of
// every sum depends on cells alone. The rest as psim_momentum_sums.
PSIM_EXPORT int psim_momentum_sums_grid(const float* grid4, const float* rho,
                                        int64_t cells, double* partials,
                                        unsigned int* counter, int max_blocks,
                                        float* out, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(grid4) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  momentum_sums_kernel<true><<<sum_blocks(cells, max_blocks), MS_THREADS, 0,
                               stream>>>(grid4, cells, nullptr, nullptr, rho,
                                         partials, counter, out);
  return (int)cudaGetLastError();
}
