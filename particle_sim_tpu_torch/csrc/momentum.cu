// The PM momentum clean's sums: the live mass-weighted sums of the
// acceleration and the weight, and their mean, in one launch.
//
// Replaces no TPU kernel: the JAX package takes these sums in plain jnp
// (ops/pm.py momentum_clean); the port's plain version, ops/pm.py
// momentum_mean, makes elementwise passes over f32[3, N] and two
// reductions. csrc/step.cu's kicked form subtracts the mean; this kernel
// only reads.
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

__global__ void __launch_bounds__(MS_THREADS) momentum_sums_kernel(
    const float* __restrict__ acc, int64_t n, const uint8_t* __restrict__ live,
    const int* __restrict__ n_active, const float* __restrict__ masses,
    double* __restrict__ partials, unsigned int* __restrict__ counter,
    float* __restrict__ out) {
  __shared__ double smem[MS_WARPS][4];
  __shared__ bool last;
  const int64_t n_live = live == nullptr ? (int64_t)__ldg(n_active) : n;
  double v[4] = {0.0, 0.0, 0.0, 0.0};
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const bool on = live != nullptr ? __ldg(live + i) != 0 : i < n_live;
    float w = on ? 1.0f : 0.0f;
    if (masses != nullptr) w = __fmul_rn(w, __ldg(masses + i));
    const double wd = (double)w;
    v[0] += (double)__ldg(acc + i) * wd;
    v[1] += (double)__ldg(acc + n + i) * wd;
    v[2] += (double)__ldg(acc + 2 * n + i) * wd;
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
  int64_t blocks = (n + MS_THREADS - 1) / MS_THREADS;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  momentum_sums_kernel<<<(unsigned)blocks, MS_THREADS, 0, stream>>>(
      acc, n, live, n_active, masses, partials, counter, out);
  return (int)cudaGetLastError();
}
