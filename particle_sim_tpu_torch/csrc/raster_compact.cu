// The two kernels of the compaction rasterizer (render/raster_compact.py).
//
// Point words, as the plain pipeline builds them:
//   key: tile * 1024 + (row * 128 + lane) inside the 8x128 framebuffer
//        tile, or the sentinel n_tiles * 1024 for a point that draws nothing
//   rg:  bf16 bits of premultiplied red (low half) and green (high half)
//   b:   bf16 bits of premultiplied blue (low half)
// Points come in 512-point chunks.
#include "common.cuh"

#define CHUNK 512
#define TILE_PX 1024          // 8 x 128 pixels per framebuffer tile
#define S_MASK ((1 << 17) - 1)  // chunk slice field of a pair-table word
#define F_BIT (1 << 17)       // first-visit (PAD) flag of a pair-table word

namespace {

// ---------------------------------------------------------------------------
// Visibility compaction.
//
// Replaces the kernel built by particle_sim_tpu/render/raster_compact.py:
// _make_compact (a Pallas copy of the kept 512-point chunks, steered by a
// prefetched kept-chunk list, into a static bucket).
//
// What bounds it on the H100: device-memory bandwidth; it is a copy of
// 3 words per point, with no arithmetic. Design: one block per output
// chunk, 128 threads each moving one 16-byte int4 of each word plane, so a
// warp reads and writes 512 contiguous bytes per plane. kept_n is read from
// device memory, so the launch needs no host read; output chunks at or past
// kept_n get the sentinel key and zero colour.
__global__ void __launch_bounds__(CHUNK / 4) compact_kernel(
    const int4* __restrict__ key, const int4* __restrict__ rg,
    const int4* __restrict__ bw, const int* __restrict__ kept_list,
    const int* __restrict__ kept_n, int4* __restrict__ okey,
    int4* __restrict__ org, int4* __restrict__ ob, int sentinel) {
  const int i = blockIdx.x;
  const size_t dst = (size_t)i * (CHUNK / 4) + threadIdx.x;
  if (i < __ldg(kept_n)) {
    const size_t src = (size_t)__ldg(kept_list + i) * (CHUNK / 4) + threadIdx.x;
    okey[dst] = key[src];
    org[dst] = rg[src];
    ob[dst] = bw[src];
  } else {
    okey[dst] = make_int4(sentinel, sentinel, sentinel, sentinel);
    org[dst] = make_int4(0, 0, 0, 0);
    ob[dst] = make_int4(0, 0, 0, 0);
  }
}

// ---------------------------------------------------------------------------
// Tile deposit.
//
// Replaces particle_sim_tpu/render/raster_compact.py:_deposit_kernel (per
// (tile, chunk) pair of the tile-major table: unpack the bf16 colour and
// deposit the chunk's points that fall in the 8x128 tile through a
// separable one-hot bf16 matmul, accumulating in f32).
//
// The contract is kept, not the matmul: tile planes f32[n_tiles, 3, 8, 128]
// equal to the sum, over each tile's table entries, of the entry chunk's
// points whose key falls in that tile, colour unpacked from the bf16 words.
// The one-hot matmul exists because TPU scatter is serial; Hopper has
// shared-memory atomics.
//
// What bounds it on the H100: reading the chunk words of every pair (12 B
// per point per visit) and the shared-memory atomic rate on deep pixels.
// Design: one block per framebuffer tile with a 12 KB shared accumulator
// (3 x 1024 f32). The block walks its slice [offsets[t], offsets[t+1]) of
// the tile-major table; each thread takes points of the chunk, skips those
// whose local index falls outside the tile (a chunk may spill into
// neighbouring tiles, and sentinel keys fall past every tile) and adds the
// colour with shared-memory atomicAdd. The accumulator starts at zero, so
// the first-visit (PAD) entries have nothing left to do and are skipped.
// Every tile is written once, empty tiles as zeros. The f32 sum order
// follows the atomics and is not fixed.
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

}  // namespace

// key, rg, b: int32[n] (n a multiple of 512, 16-byte aligned);
// kept_list: int32[n / 512]; kept_n: int32[1] on the device;
// okey, org, ob: int32[bucket] outputs (bucket a multiple of 512).
PSIM_EXPORT int psim_compact(const int* key, const int* rg, const int* b,
                             const int* kept_list, const int* kept_n,
                             int* okey, int* org, int* ob, int bucket,
                             int sentinel, cudaStream_t stream) {
  const int blocks = bucket / CHUNK;
  if (blocks > 0) {
    compact_kernel<<<blocks, CHUNK / 4, 0, stream>>>(
        (const int4*)key, (const int4*)rg, (const int4*)b, kept_list, kept_n,
        (int4*)okey, (int4*)org, (int4*)ob, sentinel);
  }
  return (int)cudaGetLastError();
}

// table: int32 tile-major pair table; offsets: int32[n_tiles + 1] (tile t
// owns table[offsets[t]:offsets[t+1]]); key, rg, b: int32[n_chunks * 512];
// out: float32[n_tiles, 3, 8, 128].
PSIM_EXPORT int psim_deposit(const int* table, const int* offsets,
                             const int* key, const int* rg, const int* b,
                             float* out, int n_tiles, int n_chunks,
                             cudaStream_t stream) {
  if (n_tiles > 0) {
    deposit_kernel<<<n_tiles, CHUNK, 0, stream>>>(table, offsets, key, rg, b,
                                                  out, n_chunks - 1);
  }
  return (int)cudaGetLastError();
}
