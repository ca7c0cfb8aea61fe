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
// is read once and the framebuffer (12 B a pixel) written once: at 1M
// points @ 1280x720 about 27 MB, ~8 us at 3.35 TB/s. The one-hot matmul
// exists on the TPU because its scatter is serial; Hopper has
// shared-memory atomics, so the contract is kept and the matmul is not.
//
// Design: one block per tile with a 12 KB shared accumulator (3 x 1024
// f32). The block reads its slice [offsets[t], offsets[t+1]) of the sorted
// arrays (the wrapper finds the slices with one torch.searchsorted), and
// the tile is written once (empty tiles as zeros). Because the slice is
// sorted, neighbouring points mostly share a pixel: had each lane of a
// warp taken the next point, the lanes' shared-memory atomics would hit
// the same address and serialise. So each thread takes a run of SD_RUN
// consecutive points, sums the points of one pixel in registers, and
// makes one atomicAdd per pixel it meets in the run; the lanes of a warp
// are SD_RUN points apart and mostly on different pixels. A point outside
// the tile (which only a wrong offset could put in the slice) is skipped,
// so the result never depends on it. The f32 sum order follows the runs
// and the atomics and is not fixed. The payload is f32, not the
// bf16-packed words of raster_compact.cu's deposit, so this is its own
// entry point.
#include "common.cuh"

#define TILE_PX 1024  // 8 x 128 pixels per framebuffer tile
#define SD_THREADS 256
#define SD_RUN 8      // consecutive sorted points per thread and round

namespace {

__device__ __forceinline__ void flush(float* acc, int local, float r,
                                      float g, float b) {
  if (local >= 0 && local < TILE_PX) {
    atomicAdd(&acc[local], r);
    atomicAdd(&acc[TILE_PX + local], g);
    atomicAdd(&acc[2 * TILE_PX + local], b);
  }
}

__global__ void __launch_bounds__(SD_THREADS) sorted_deposit_kernel(
    const int* __restrict__ key, const float* __restrict__ rgb,
    const int* __restrict__ offsets, float* __restrict__ out, int n) {
  __shared__ float acc[3 * TILE_PX];
  const int tile = blockIdx.x;
  for (int k = threadIdx.x; k < 3 * TILE_PX; k += SD_THREADS) acc[k] = 0.0f;
  __syncthreads();

  const int beg = __ldg(offsets + tile);
  const int end = __ldg(offsets + tile + 1);
  const int base = tile * TILE_PX;
  for (int run = beg + threadIdx.x * SD_RUN; run < end;
       run += SD_THREADS * SD_RUN) {
    const int stop = min(run + SD_RUN, end);
    int cur = __ldg(key + run) - base;
    float r = 0.0f, g = 0.0f, b = 0.0f;
    for (int e = run; e < stop; ++e) {
      const int local = __ldg(key + e) - base;
      if (local != cur) {  // a new pixel: hand the finished one over
        flush(acc, cur, r, g, b);
        cur = local;
        r = g = b = 0.0f;
      }
      r += __ldg(rgb + e);
      g += __ldg(rgb + n + e);
      b += __ldg(rgb + 2 * (size_t)n + e);
    }
    flush(acc, cur, r, g, b);
  }
  __syncthreads();

  float* o = out + (size_t)tile * 3 * TILE_PX;
  for (int k = threadIdx.x; k < 3 * TILE_PX; k += SD_THREADS) o[k] = acc[k];
}

}  // namespace

// key: int32[n] sorted tile keys; rgb: float32[3, n] payload planes in key
// order; offsets: int32[n_tiles + 1], tile t owns [offsets[t],
// offsets[t+1]); out: float32[n_tiles, 3, 8, 128].
PSIM_EXPORT int psim_sorted_deposit(const int* key, const float* rgb,
                                    const int* offsets, float* out, int n,
                                    int n_tiles, cudaStream_t stream) {
  if (n_tiles > 0) {
    sorted_deposit_kernel<<<n_tiles, SD_THREADS, 0, stream>>>(key, rgb,
                                                              offsets, out, n);
  }
  return (int)cudaGetLastError();
}
