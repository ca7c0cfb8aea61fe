// The refinement windows' bookkeeping (ops/pm2.py window_pass): one pass
// over every slot a window. A pass finishes the window's origin in
// registers from the sums the pass before it left, tests each slot's
// membership, writes the member mask and reduces the members' mass-weighted
// position sums for the next window's origin.
//
// Replaces no TPU kernel: the JAX package computes the origins and masks in
// plain jnp (ops/pm2.py _nested_wmins, _in_window; ops/pmx.py
// window_origin), and so do the port's plain versions, which build an
// f32[3, N] compare pair, an `all`, an `and`, the weights, the products and
// two sums a window, two to four times a step. Here a window is one launch.
//
// What bounds it on the H100: device-memory bandwidth. A slot is read once
// (its position, 12 B; its live flag, 1 B; its mass, 4 B, or none) and its
// mask written (1 B, or none): 14-18 B a slot and launch, 0.076-0.090 ms at
// 16,777,216 at 3.35 TB/s.
//
// Design: as csrc/momentum.cu's sums. A grid-stride loop (256 threads a
// block, the grid fixed by n alone) accumulates each thread's five sums in
// float64 (sum w x, sum w y, sum w z, sum w, the member count); the block
// sums its threads in a fixed tree and writes its partials; the last block
// to finish (a counter in device memory, which that block sets back to 0)
// sums the partials in block order and writes the four float32 sums and the
// int32 count. The order of every sum depends on n alone, so two launches on
// one input give the same bits. Each weight is member * mass in float32 and
// every slot's products are added, as the plain version forms them (a NaN
// position anywhere poisons the sums there too).
//
// The origin is finished by every thread from four float32 sums and the
// parent window's origin, in the plain version's float32 operations:
//
//     o = sums[0..2] / max(sums[3], 1e-12) - half     (tracked), or static
//     o = min(max(o, parent + clamp_lo), parent + clamp_hi)  (nested)
//
// and block 0 writes it. Membership: live && lo <= x < lo + extent on every
// axis, lo = o + shrink. A mesh all-reduces the four sums between two
// launches (parallel/), so world size 1 gives the same bits.
#include "common.cuh"

namespace {

constexpr int WP_THREADS = 256;
constexpr int WP_WARPS = WP_THREADS / 32;
constexpr int WP_SUMS = 5;

struct WindowArgs {
  float static_min[3];  // the origin when sums_in is NULL
  float half;           // half the window: a tracked origin is c - half
  float clamp_lo;       // clamp into [parent + clamp_lo, parent + clamp_hi]
  float clamp_hi;
  float shrink;         // the mask: [o + shrink, o + shrink + extent)
  float extent;
};

// The block's sum of the per-thread values, in a fixed order; the result is
// in thread 0's v.
__device__ __forceinline__ void block_sum(double v[WP_SUMS],
                                          double (*smem)[WP_SUMS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < WP_SUMS; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < WP_SUMS; ++k) smem[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < WP_SUMS; ++k) {
      double t = smem[0][k];
      for (int w = 1; w < WP_WARPS; ++w) t += smem[w][k];
      v[k] = t;
    }
  }
}

__device__ __forceinline__ void finish_origin(const WindowArgs& a,
                                              const float* __restrict__ sums_in,
                                              const float* __restrict__ parent,
                                              float o[3]) {
  if (sums_in != nullptr) {
    const float tot = __ldg(sums_in + 3);
    // torch.clamp_min(tot, 1e-12): a NaN weight stays NaN
    const float d = tot < 1e-12f ? 1e-12f : tot;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = __fsub_rn(__fdiv_rn(__ldg(sums_in + k), d), a.half);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) o[k] = a.static_min[k];
  }
  if (parent != nullptr) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float p = __ldg(parent + k);
      const float lo = __fadd_rn(p, a.clamp_lo);
      const float hi = __fadd_rn(p, a.clamp_hi);
      // torch.clamp: max with lo, then min with hi; NaN stays NaN
      if (o[k] < lo) o[k] = lo;
      if (o[k] > hi) o[k] = hi;
    }
  }
}

// origin NULL: no window (the members are the live slots). sums_out and
// count NULL: no reduction. mask NULL: no mask written. With neither a mask
// nor a reduction the grid is one block, which only writes the origin.
__global__ void __launch_bounds__(WP_THREADS) window_pass_kernel(
    const float* __restrict__ pos, int64_t n, const uint8_t* __restrict__ live,
    const float* __restrict__ masses, const float* __restrict__ sums_in,
    const float* __restrict__ parent, float* __restrict__ origin,
    uint8_t* __restrict__ mask, float* __restrict__ sums_out,
    int* __restrict__ count, double* __restrict__ partials,
    unsigned int* __restrict__ counter, WindowArgs a) {
  __shared__ double smem[WP_WARPS][WP_SUMS];
  __shared__ bool last;
  const bool window = origin != nullptr;
  float lo[3] = {0.0f, 0.0f, 0.0f}, hi[3] = {0.0f, 0.0f, 0.0f};
  if (window) {
    float o[3];
    finish_origin(a, sums_in, parent, o);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      origin[0] = o[0]; origin[1] = o[1]; origin[2] = o[2];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = __fadd_rn(o[k], a.shrink);
      hi[k] = __fadd_rn(lo[k], a.extent);
    }
  }
  const bool reduce = sums_out != nullptr || count != nullptr;
  if (!reduce && mask == nullptr) return;
  double v[WP_SUMS] = {0.0, 0.0, 0.0, 0.0, 0.0};
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float x = __ldg(pos + i), y = __ldg(pos + n + i),
                z = __ldg(pos + 2 * n + i);
    bool on = __ldg(live + i) != 0;
    if (window) {
      on = on && x >= lo[0] && x < hi[0] && y >= lo[1] && y < hi[1] &&
           z >= lo[2] && z < hi[2];
    }
    if (mask != nullptr) mask[i] = on ? 1 : 0;
    if (reduce) {
      float w = on ? 1.0f : 0.0f;
      if (masses != nullptr) w = __fmul_rn(w, __ldg(masses + i));
      const double wd = (double)w;
      v[0] += (double)x * wd;
      v[1] += (double)y * wd;
      v[2] += (double)z * wd;
      v[3] += wd;
      v[4] += on ? 1.0 : 0.0;
    }
  }
  if (!reduce) return;
  block_sum(v, smem);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < WP_SUMS; ++k) partials[WP_SUMS * blockIdx.x + k] = v[k];
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: each thread sums the partials of blocks t, t + 256, ...
  // in order, then the block's fixed tree
#pragma unroll
  for (int k = 0; k < WP_SUMS; ++k) v[k] = 0.0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += WP_THREADS) {
#pragma unroll
    for (int k = 0; k < WP_SUMS; ++k) v[k] += __ldcg(partials + WP_SUMS * b + k);
  }
  __syncthreads();  // smem is reused
  block_sum(v, smem);
  if (threadIdx.x == 0) {
    if (sums_out != nullptr) {
      sums_out[0] = (float)v[0]; sums_out[1] = (float)v[1];
      sums_out[2] = (float)v[2]; sums_out[3] = (float)v[3];
    }
    if (count != nullptr) *count = (int)v[4];
    *counter = 0u;
  }
}

}  // namespace

// One window's pass over pos, float32[3, n] contiguous. live: bool[n].
// masses: float32[n] or NULL (1). sums_in: float32[4] (sum m x, sum m y,
// sum m z, sum m over the parent's members) for a tracked origin, NULL for
// the static one (sx, sy, sz). parent: the parent window's float32[3]
// origin to clamp into, or NULL. origin: float32[3] out, or NULL for no
// window (the members are the live slots). mask: bool[n] out or NULL.
// sums_out: float32[4] out (this window's members' sums) or NULL. count:
// int32 out (its members) or NULL. partials: float64[5 * max_blocks]
// scratch; counter: one uint32, 0 before the launch and 0 after it. Every
// pointer is device memory; the grid is min(ceil(n / 256), max_blocks)
// blocks, one when neither a mask nor a sum is asked for.
PSIM_EXPORT int psim_window_pass(
    const float* pos, int64_t n, const uint8_t* live, const float* masses,
    const float* sums_in, const float* parent, float* origin, uint8_t* mask,
    float* sums_out, int* count, double* partials, unsigned int* counter,
    int max_blocks, float sx, float sy, float sz, float half, float clamp_lo,
    float clamp_hi, float shrink, float extent, cudaStream_t stream) {
  const WindowArgs a = {{sx, sy, sz}, half, clamp_lo, clamp_hi, shrink,
                        extent};
  int64_t blocks = 1;
  if (mask != nullptr || sums_out != nullptr || count != nullptr) {
    blocks = (n + WP_THREADS - 1) / WP_THREADS;
    if (blocks > max_blocks) blocks = max_blocks;
    if (blocks < 1) blocks = 1;
  }
  window_pass_kernel<<<(unsigned)blocks, WP_THREADS, 0, stream>>>(
      pos, n, live, masses, sums_in, parent, origin, mask, sums_out, count,
      partials, counter, a);
  return (int)cudaGetLastError();
}
