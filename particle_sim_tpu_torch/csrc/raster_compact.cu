// The two kernels of the compaction rasterizer (render/raster_compact.py).
//
// Point words, as the plain pipeline builds them:
//   key: tile * 1024 + (row * 128 + lane) inside the 8x128 framebuffer
//        tile, or the sentinel n_tiles * 1024 for a point that draws nothing
//   rg:  bf16 bits of premultiplied red (low half) and green (high half)
//   b:   bf16 bits of premultiplied blue (low half)
// Points come in 512-point chunks.
#include "tile_runs.cuh"

#define CHUNK 512
#define S_MASK ((1 << 17) - 1)  // chunk slice field of a pair-table word
#define F_BIT (1 << 17)       // first-visit (PAD) flag of a pair-table word
#define T_SHIFT 18            // tile field of a pair-table word
#define MAX_TILES ((1 << 13) - 1)
// blocks an SM of the deposit's grid (grid_blocks): 0, as many as fit
#ifndef CD_BLOCKS_PER_SM
#define CD_BLOCKS_PER_SM 0
#endif

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
// equal to the sum, over the table's entries, of the entry chunk's points
// whose key falls in the entry's tile, colour unpacked from the bf16
// words. The one-hot matmul exists because TPU scatter is serial; Hopper
// has atomics.
//
// What bounds it on the H100: bytes moved, each bucket point's 12 B read
// once and the frame's 12 B a pixel written once (0.0675 ms at 16M @
// 1920x1080 at 3.35 TB/s).
//
// Design: the work is split by table entries, not by tiles. The earlier
// kernel (tools/raster_variants.cu, variant 0) ran one 512-thread block
// per tile that walked the tile's entries in series, 149 of them in the
// heaviest 16M tile, read all 512 points of each chunk and made one shared
// atomic per point, colliding on the deep pixels. Here cudaMemsetAsync
// zeroes the frame, and the warps of a grid of as many blocks as fit on
// the card stride over units of (entry, 128-point group of its chunk) for
// the entries [0, offsets[n_tiles]) of the table: the tiles' entries run
// in parallel. (The host knows only the table's capacity, several times
// the entries in use; a block per 8 units of the capacity measured 2 %
// faster at 16M but 32 % slower on a frame of one contended tile.)
// A warp reads the entry's word (tile from the word, as the TPU kernel
// takes it; a first-visit entry has nothing to add) and its group's keys
// through 16-byte loads. Keys ascend within a chunk (chunks are slices of
// sorted segments), so the entry's in-tile points are one run of the
// chunk: a group without any is skipped after its keys, and a lane loads
// the two colour words only for its 4 points when one is inside. The
// bf16 colour is unpacked in registers, points outside the tile are
// masked, and tile_runs.cuh's deposit_quad sums each pixel's points in
// registers and shuffles and adds the sum to the frame once with
// red.global.add.f32. The f32 sum order follows the runs and the atomics
// and is not fixed.
template <bool VEC>
__global__ void __launch_bounds__(RD_THREADS) deposit_kernel(
    const int* __restrict__ table, const int* __restrict__ offsets,
    const int* __restrict__ key, const int* __restrict__ rg,
    const int* __restrict__ bw, float* __restrict__ out, int n_tiles,
    int s_last, int n_entries) {
  const int units = min(__ldg(offsets + n_tiles), n_entries)
      * (CHUNK / (RD_GROUPS * 128));
  const RedSink sink{out, n_tiles * TILE_PX};
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * (RD_THREADS / 32);
  for (int u = blockIdx.x * (RD_THREADS / 32) + threadIdx.x / 32; u < units;
       u += stride) {
    const int e = u / (CHUNK / (RD_GROUPS * 128));
    const int w = __ldg(table + e);
    if (w & F_BIT) continue;  // zeroing visit: nothing to add
    const int base = ((w >> T_SHIFT) & MAX_TILES) * TILE_PX;
    const size_t off = (size_t)min(w & S_MASK, s_last) * CHUNK
        + (size_t)(u % (CHUNK / (RD_GROUPS * 128))) * (RD_GROUPS * 128);
    int k[RD_GROUPS][4];
    bool in[RD_GROUPS][4];
    bool any = false;
#pragma unroll
    for (int q = 0; q < RD_GROUPS; ++q) {
      const size_t i0 = off + q * 128 + 4 * lane;
      if (VEC) {
        const int4 kv = __ldg(reinterpret_cast<const int4*>(key + i0));
        k[q][0] = kv.x; k[q][1] = kv.y; k[q][2] = kv.z; k[q][3] = kv.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) k[q][j] = __ldg(key + i0 + j);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        in[q][j] = (unsigned)(k[q][j] - base) < (unsigned)TILE_PX;
        any |= in[q][j];
      }
    }
    if (!__any_sync(FULL_WARP, any)) continue;
#pragma unroll
    for (int q = 0; q < RD_GROUPS; ++q) {
      const size_t i0 = off + q * 128 + 4 * lane;
      unsigned c0[4] = {0u, 0u, 0u, 0u}, c1[4] = {0u, 0u, 0u, 0u};
      if (in[q][0] | in[q][1] | in[q][2] | in[q][3]) {
        if (VEC) {
          const int4 a = __ldg(reinterpret_cast<const int4*>(rg + i0));
          const int4 c = __ldg(reinterpret_cast<const int4*>(bw + i0));
          c0[0] = a.x; c0[1] = a.y; c0[2] = a.z; c0[3] = a.w;
          c1[0] = c.x; c1[1] = c.y; c1[2] = c.z; c1[3] = c.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            c0[j] = (unsigned)__ldg(rg + i0 + j);
            c1[j] = (unsigned)__ldg(bw + i0 + j);
          }
        }
      }
      int kk[4];
      float r[4], g[4], b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = in[q][j] ? k[q][j] : -1;
        r[j] = in[q][j] ? __uint_as_float(c0[j] << 16) : 0.0f;
        g[j] = in[q][j] ? __uint_as_float(c0[j] & 0xFFFF0000u) : 0.0f;
        b[j] = in[q][j] ? __uint_as_float(c1[j] << 16) : 0.0f;
      }
      deposit_quad(kk, r, g, b, sink);
    }
  }
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

// table: int32[n_entries] tile-major pair table, entries [0,
// offsets[n_tiles]) are visited; offsets: int32[n_tiles + 1]; key, rg, b: int32[n_chunks * 512];
// out: float32[n_tiles, 3, 8, 128], zeroed here first.
PSIM_EXPORT int psim_deposit(const int* table, const int* offsets,
                             const int* key, const int* rg, const int* b,
                             float* out, int n_tiles, int n_chunks,
                             int n_entries, cudaStream_t stream) {
  if (n_tiles <= 0) return 0;
  const cudaError_t z = cudaMemsetAsync(
      out, 0, (size_t)n_tiles * 3 * TILE_PX * sizeof(float), stream);
  if (z != cudaSuccess) return (int)z;
  if (n_entries > 0 && n_chunks > 0) {
    const bool vec = RD_VEC && aligned16(key) && aligned16(rg) && aligned16(b);
    auto kernel = vec ? deposit_kernel<true> : deposit_kernel<false>;
    int blocks = 0;
    const cudaError_t e = grid_blocks(
        kernel, (long long)n_entries * (CHUNK / (RD_GROUPS * 128)),
        CD_BLOCKS_PER_SM, &blocks);
    if (e != cudaSuccess) return (int)e;
    kernel<<<blocks, RD_THREADS, 0, stream>>>(
        table, offsets, key, rg, b, out, n_tiles, n_chunks - 1, n_entries);
  }
  return (int)cudaGetLastError();
}
