// Sorted-deposit rasterizer: per-tile sums of key-sorted f32 points.
//
// Replaces particle_sim_tpu/render/raster_sorted.py:_kernel (per entry of a
// (tile, chunk) table, deposit a 512-point chunk of the key-sorted points
// into its 8x128 framebuffer tile through a separable one-hot bf16 matmul,
// accumulating in f32 over revisited tiles).
//
// What it computes: for every 8x128 framebuffer tile t, the f32 sum of the
// (r*w, g*w, b*w) payload of the sorted points whose key lies in
// [t*1024, (t+1)*1024), at pixel key - t*1024. Points of other tiles and
// the sentinel key (n_tiles*1024: draws nothing) contribute nothing.
//
// What bounds it on the H100: bytes moved. Each point's key and rgb (16 B)
// is read once and the framebuffer (12 B a pixel) written once: 293 MB at
// 16M points @ 1920x1080 (0.0876 ms at 3.35 TB/s), 27 MB at 1M @ 1280x720
// (8 us). The one-hot matmul exists on the TPU because its scatter is
// serial; Hopper has atomics, so the contract is kept and the matmul is
// not.
//
// Design: the work is split by points, not by tiles. The earlier kernel
// (tools/raster_variants.cu, variant 0) ran one block per tile, so the
// heaviest tile (4.6x the mean at 16M) bounded it and every empty tile cost
// a block with a 12 KB shared accumulator. Here cudaMemsetAsync zeroes the
// frame, and each warp takes one group of 128 of the live points
// [offsets[0], offsets[n_tiles]) (one block per 1,024 points; the
// hardware balances the blocks, which measured 4 % faster at 16M than a
// grid-stride loop over as many blocks as fit): each lane takes 4
// consecutive points through one 16-byte load of the key and of each
// colour plane (scalar loads where n or a pointer is not 16-byte
// aligned), and tile_runs.cuh's deposit_quad sums each
// pixel's points in registers and shuffles and adds the sum to the frame
// once with red.global.add.f32 (the frame sits in L2). The other offsets
// are not read, so a wrong offsets[0] or offsets[n_tiles] shows as a
// mismatch against the plain version. The f32 sum order follows the runs
// and the atomics and is not fixed. The payload is f32, not the
// bf16-packed words of raster_compact.cu's deposit, so this is its own
// entry point.
#include "tile_runs.cuh"

// blocks an SM of the grid (grid_blocks): -1, a warp a group of 128 points
#ifndef SD_BLOCKS_PER_SM
#define SD_BLOCKS_PER_SM -1
#endif

namespace {

template <bool VEC>
__global__ void __launch_bounds__(RD_THREADS) sorted_deposit_kernel(
    const int* __restrict__ key, const float* __restrict__ rgb,
    const int* __restrict__ offsets, float* __restrict__ out, int n,
    int n_tiles) {
  const int beg = max(__ldg(offsets), 0);
  const int end = min(__ldg(offsets + n_tiles), n);
  const RedSink sink{out, n_tiles * TILE_PX};
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * (RD_THREADS / 32);
  // units of RD_GROUPS 128-point groups, aligned at multiples of 128 so
  // that the 16-byte loads are aligned
  const int span = RD_GROUPS * 128;
  for (int u = beg / span + blockIdx.x * (RD_THREADS / 32) + threadIdx.x / 32;
       u * span < end; u += stride) {
    int k[RD_GROUPS][4];
    float r[RD_GROUPS][4], g[RD_GROUPS][4], b[RD_GROUPS][4];
#pragma unroll
    for (int q = 0; q < RD_GROUPS; ++q) {
      const int i0 = u * span + q * 128 + 4 * lane;
      if (VEC && i0 + 3 < n) {
        const int4 kv = __ldg(reinterpret_cast<const int4*>(key + i0));
        const float4 rv = __ldg(reinterpret_cast<const float4*>(rgb + i0));
        const float4 gv =
            __ldg(reinterpret_cast<const float4*>(rgb + (size_t)n + i0));
        const float4 bv =
            __ldg(reinterpret_cast<const float4*>(rgb + 2 * (size_t)n + i0));
        k[q][0] = kv.x; k[q][1] = kv.y; k[q][2] = kv.z; k[q][3] = kv.w;
        r[q][0] = rv.x; r[q][1] = rv.y; r[q][2] = rv.z; r[q][3] = rv.w;
        g[q][0] = gv.x; g[q][1] = gv.y; g[q][2] = gv.z; g[q][3] = gv.w;
        b[q][0] = bv.x; b[q][1] = bv.y; b[q][2] = bv.z; b[q][3] = bv.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = i0 + j;
          const bool in = i < n;
          k[q][j] = in ? __ldg(key + i) : -1;
          r[q][j] = in ? __ldg(rgb + i) : 0.0f;
          g[q][j] = in ? __ldg(rgb + (size_t)n + i) : 0.0f;
          b[q][j] = in ? __ldg(rgb + 2 * (size_t)n + i) : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // outside the live slice: masked
        const int i = i0 + j;
        if (i < beg || i >= end) {
          k[q][j] = -1;
          r[q][j] = g[q][j] = b[q][j] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < RD_GROUPS; ++q)
      deposit_quad(k[q], r[q], g[q], b[q], sink);
  }
}

}  // namespace

// key: int32[n] sorted tile keys; rgb: float32[3, n] payload planes in key
// order; offsets: int32[n_tiles + 1], the live points are [offsets[0],
// offsets[n_tiles]); out: float32[n_tiles, 3, 8, 128], zeroed here first.
PSIM_EXPORT int psim_sorted_deposit(const int* key, const float* rgb,
                                    const int* offsets, float* out, int n,
                                    int n_tiles, cudaStream_t stream) {
  if (n_tiles <= 0) return 0;
  const cudaError_t z = cudaMemsetAsync(
      out, 0, (size_t)n_tiles * 3 * TILE_PX * sizeof(float), stream);
  if (z != cudaSuccess) return (int)z;
  if (n > 0) {
    const bool vec = RD_VEC && n % 4 == 0 && aligned16(key) && aligned16(rgb);
    auto kernel = vec ? sorted_deposit_kernel<true>
                      : sorted_deposit_kernel<false>;
    int blocks = 0;
    const cudaError_t e = grid_blocks(
        kernel, (n + RD_GROUPS * 128 - 1) / (RD_GROUPS * 128),
        SD_BLOCKS_PER_SM, &blocks);
    if (e != cudaSuccess) return (int)e;
    kernel<<<blocks, RD_THREADS, 0, stream>>>(key, rgb, offsets, out, n,
                                              n_tiles);
  }
  return (int)cudaGetLastError();
}
