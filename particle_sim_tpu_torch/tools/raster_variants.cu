// Design probe of the two frame deposits (render/raster_sorted.py,
// render/raster_compact.py): the earlier kernels, verbatim, as variant 0,
// the package's kernels (csrc/raster_sorted.cu, the deposit of
// csrc/raster_compact.cu, included with the -D knobs of tile_runs.cuh that
// raster_variants.py passes), and a shared-memory alternative: each block
// merges the runs that fall in a window of tiles in shared memory before
// they reach the frame, instead of sending every run to the frame's
// atomics. Built by tools/raster_variants.py (chip_smoke.py builds its
// first config to time variant 0), not by the package; on no path.
#include "../csrc/raster_sorted.cu"
#include "../csrc/raster_compact.cu"

#ifndef RV_WINDOW
#define RV_WINDOW 2  // tiles in a block's shared-memory window
#endif
#define RV_SLICE_GROUPS 4  // 128-point groups a warp of the window kernels

namespace v0 {

// ---- variant 0: the earlier sorted deposit (one block per tile), verbatim
#define SD_THREADS 256
#define SD_RUN 8      // consecutive sorted points per thread and round

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

// ---- variant 0: the earlier compact deposit (one block per tile), verbatim
__global__ void __launch_bounds__(CHUNK) deposit_kernel(
    const int* __restrict__ table, const int* __restrict__ offsets,
    const int* __restrict__ key, const int* __restrict__ rg,
    const int* __restrict__ bw, float* __restrict__ out, int s_last) {
  __shared__ float acc[3 * TILE_PX];
  const int tile = blockIdx.x;
  for (int k = threadIdx.x; k < 3 * TILE_PX; k += blockDim.x) acc[k] = 0.0f;
  __syncthreads();

  const int beg = __ldg(offsets + tile);
  const int end = __ldg(offsets + tile + 1);
  const int base = tile * TILE_PX;
  for (int e = beg; e < end; ++e) {
    const int w = __ldg(table + e);
    if (w & F_BIT) continue;  // zeroing visit: nothing to add
    const int s = min(w & S_MASK, s_last);
    const size_t off = (size_t)s * CHUNK;
    for (int j = threadIdx.x; j < CHUNK; j += blockDim.x) {
      const int local = __ldg(key + off + j) - base;
      if (local >= 0 && local < TILE_PX) {
        const unsigned rgw = (unsigned)__ldg(rg + off + j);
        const unsigned bwd = (unsigned)__ldg(bw + off + j);
        atomicAdd(&acc[local], __uint_as_float(rgw << 16));
        atomicAdd(&acc[TILE_PX + local], __uint_as_float(rgw & 0xFFFF0000u));
        atomicAdd(&acc[2 * TILE_PX + local], __uint_as_float(bwd << 16));
      }
    }
  }
  __syncthreads();

  float* o = out + (size_t)tile * 3 * TILE_PX;
  for (int k = threadIdx.x; k < 3 * TILE_PX; k += blockDim.x) o[k] = acc[k];
}

}  // namespace v0

namespace {

// A sink that adds a pixel's sum in the block's shared window when the
// pixel lies in it, and to the frame otherwise.
struct WindowSink {
  float* win;  // [3][RV_WINDOW * TILE_PX]
  int lo;      // first key of the window
  float* out;
  int limit;
  __device__ __forceinline__ void operator()(int key, float r, float g,
                                             float b) const {
    const unsigned p = (unsigned)(key - lo);
    if (p < (unsigned)(RV_WINDOW * TILE_PX) && key < limit) {
      atomicAdd(win + p, r);
      atomicAdd(win + RV_WINDOW * TILE_PX + p, g);
      atomicAdd(win + 2 * RV_WINDOW * TILE_PX + p, b);
    } else {
      red_pixel(out, key, limit, r, g, b);
    }
  }
};

__device__ __forceinline__ void flush_window(const float* win, int lo,
                                             float* out, int limit) {
  __syncthreads();
  for (int p = threadIdx.x; p < RV_WINDOW * TILE_PX; p += RD_THREADS) {
    const float r = win[p], g = win[RV_WINDOW * TILE_PX + p],
                b = win[2 * RV_WINDOW * TILE_PX + p];
    if (r != 0.0f || g != 0.0f || b != 0.0f) red_pixel(out, lo + p, limit, r, g, b);
  }
}

// The sorted deposit with a shared window: block b takes the points
// [b * S, (b + 1) * S), S = 8 warps x RV_SLICE_GROUPS groups, the window
// starting at the tile of its first live point.
__global__ void __launch_bounds__(RD_THREADS) sorted_window_kernel(
    const int* __restrict__ key, const float* __restrict__ rgb,
    const int* __restrict__ offsets, float* __restrict__ out, int n,
    int n_tiles) {
  __shared__ float win[3 * RV_WINDOW * TILE_PX];
  const int beg = max(__ldg(offsets), 0);
  const int end = min(__ldg(offsets + n_tiles), n);
  const int span = (RD_THREADS / 32) * RV_SLICE_GROUPS * 128;
  const int s0 = max(blockIdx.x * span, beg);
  if (s0 >= end) return;
  for (int p = threadIdx.x; p < 3 * RV_WINDOW * TILE_PX; p += RD_THREADS)
    win[p] = 0.0f;
  __syncthreads();
  const int lo = (__ldg(key + s0) >> 10) * TILE_PX;
  const WindowSink sink{win, lo, out, n_tiles * TILE_PX};
  const int lane = threadIdx.x & 31;
  for (int q = 0; q < RV_SLICE_GROUPS; ++q) {
    const int i0 = blockIdx.x * span
        + ((threadIdx.x / 32) * RV_SLICE_GROUPS + q) * 128 + 4 * lane;
    int k[4];
    float r[4], g[4], b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j;
      const bool in = i >= beg && i < end;
      k[j] = in ? __ldg(key + i) : -1;
      r[j] = in ? __ldg(rgb + i) : 0.0f;
      g[j] = in ? __ldg(rgb + (size_t)n + i) : 0.0f;
      b[j] = in ? __ldg(rgb + 2 * (size_t)n + i) : 0.0f;
    }
    deposit_quad(k, r, g, b, sink);
  }
  flush_window(win, lo, out, n_tiles * TILE_PX);
}

// The compact deposit with a shared window: block b takes the units
// [8b, 8b + 8) (one warp each, as the package's kernel with one group a
// unit), the window starting at the tile of its first unit's entry.
__global__ void __launch_bounds__(RD_THREADS) compact_window_kernel(
    const int* __restrict__ table, const int* __restrict__ offsets,
    const int* __restrict__ key, const int* __restrict__ rg,
    const int* __restrict__ bw, float* __restrict__ out, int n_tiles,
    int s_last, int n_entries) {
  __shared__ float win[3 * RV_WINDOW * TILE_PX];
  const int units = min(__ldg(offsets + n_tiles), n_entries) * (CHUNK / 128);
  const int u0 = blockIdx.x * (RD_THREADS / 32);
  if (u0 >= units) return;
  for (int p = threadIdx.x; p < 3 * RV_WINDOW * TILE_PX; p += RD_THREADS)
    win[p] = 0.0f;
  __syncthreads();
  const int lo = ((__ldg(table + u0 / (CHUNK / 128)) >> T_SHIFT) & MAX_TILES)
      * TILE_PX;
  const WindowSink sink{win, lo, out, n_tiles * TILE_PX};
  const int u = u0 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int w = u < units ? __ldg(table + u / (CHUNK / 128)) : F_BIT;
  if (!(w & F_BIT)) {
    const int base = ((w >> T_SHIFT) & MAX_TILES) * TILE_PX;
    const size_t i0 = (size_t)min(w & S_MASK, s_last) * CHUNK
        + (size_t)(u % (CHUNK / 128)) * 128 + 4 * lane;
    const int4 kv = __ldg(reinterpret_cast<const int4*>(key + i0));
    const int kr[4] = {kv.x, kv.y, kv.z, kv.w};
    bool in[4];
    bool any = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      in[j] = (unsigned)(kr[j] - base) < (unsigned)TILE_PX;
      any |= in[j];
    }
    int4 a = make_int4(0, 0, 0, 0), c = make_int4(0, 0, 0, 0);
    if (any) {
      a = __ldg(reinterpret_cast<const int4*>(rg + i0));
      c = __ldg(reinterpret_cast<const int4*>(bw + i0));
    }
    const unsigned c0[4] = {(unsigned)a.x, (unsigned)a.y, (unsigned)a.z,
                            (unsigned)a.w};
    const unsigned c1[4] = {(unsigned)c.x, (unsigned)c.y, (unsigned)c.z,
                            (unsigned)c.w};
    int kk[4];
    float r[4], g[4], b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kk[j] = in[j] ? kr[j] : -1;
      r[j] = in[j] ? __uint_as_float(c0[j] << 16) : 0.0f;
      g[j] = in[j] ? __uint_as_float(c0[j] & 0xFFFF0000u) : 0.0f;
      b[j] = in[j] ? __uint_as_float(c1[j] << 16) : 0.0f;
    }
    deposit_quad(kk, r, g, b, sink);
  }
  flush_window(win, lo, out, n_tiles * TILE_PX);
}

}  // namespace

// variant 0, the earlier launches: one block per tile, no memset
PSIM_EXPORT int probe_v0_sorted(const int* key, const float* rgb,
                                const int* offsets, float* out, int n,
                                int n_tiles, cudaStream_t stream) {
  v0::sorted_deposit_kernel<<<n_tiles, SD_THREADS, 0, stream>>>(
      key, rgb, offsets, out, n);
  return (int)cudaGetLastError();
}

PSIM_EXPORT int probe_v0_deposit(const int* table, const int* offsets,
                                 const int* key, const int* rg, const int* b,
                                 float* out, int n_tiles, int n_chunks,
                                 cudaStream_t stream) {
  v0::deposit_kernel<<<n_tiles, CHUNK, 0, stream>>>(table, offsets, key, rg,
                                                    b, out, n_chunks - 1);
  return (int)cudaGetLastError();
}

// the shared-window alternatives: memset, then one block a slice
PSIM_EXPORT int probe_window_sorted(const int* key, const float* rgb,
                                    const int* offsets, float* out, int n,
                                    int n_tiles, cudaStream_t stream) {
  const cudaError_t z = cudaMemsetAsync(
      out, 0, (size_t)n_tiles * 3 * TILE_PX * sizeof(float), stream);
  if (z != cudaSuccess) return (int)z;
  const int span = (RD_THREADS / 32) * RV_SLICE_GROUPS * 128;
  if (n > 0) {
    sorted_window_kernel<<<(n + span - 1) / span, RD_THREADS, 0, stream>>>(
        key, rgb, offsets, out, n, n_tiles);
  }
  return (int)cudaGetLastError();
}

PSIM_EXPORT int probe_window_deposit(const int* table, const int* offsets,
                                     const int* key, const int* rg,
                                     const int* b, float* out, int n_tiles,
                                     int n_chunks, int n_entries,
                                     cudaStream_t stream) {
  const cudaError_t z = cudaMemsetAsync(
      out, 0, (size_t)n_tiles * 3 * TILE_PX * sizeof(float), stream);
  if (z != cudaSuccess) return (int)z;
  const long long units = (long long)n_entries * (CHUNK / 128);
  if (units > 0) {
    compact_window_kernel<<<(int)((units + 7) / 8), RD_THREADS, 0, stream>>>(
        table, offsets, key, rg, b, out, n_tiles, n_chunks - 1, n_entries);
  }
  return (int)cudaGetLastError();
}
