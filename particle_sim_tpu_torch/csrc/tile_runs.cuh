// Device code shared by the two frame deposits (raster_sorted.cu and the
// deposit of raster_compact.cu): summing runs of sorted points into the
// tile planes f32[n_tiles, 3, 8, 128] with as few atomics as the runs
// allow.
//
// A warp works on a group of 128 consecutive points, lane l on points
// 4l..4l+3, whose keys ascend along the group. A point's key is its pixel
// in the frame (tile * 1024 + row * 128 + lane inside the tile); a key
// outside [0, limit) draws nothing, and a masked point carries key -1 and
// a zero payload. Points of one pixel are then adjacent: the lane sums its
// own runs in registers, a segmented shuffle scan keyed by the pixel joins
// the runs that cross lanes, and each pixel's sum leaves the warp once, as
// three red.global.add.f32 into the frame (which the caller zeroed).
#pragma once

#include "common.cuh"

#define TILE_PX 1024           // 8 x 128 pixels per framebuffer tile
#define FULL_WARP 0xffffffffu

// Tuning knobs (tools/raster_variants.py builds the kernels with others):
// RD_GROUPS 128-point groups a warp loads before it sums them; RD_VEC
// 16-byte loads where the arrays allow them. Each kernel's grid has its
// own knob (SD_BLOCKS_PER_SM, CD_BLOCKS_PER_SM; see grid_blocks).
#ifndef RD_GROUPS
#define RD_GROUPS 1
#endif
#ifndef RD_VEC
#define RD_VEC 1
#endif
#define RD_THREADS 256

namespace {

// Add (r, g, b) to pixel `key` when it is one of the frame's pixels. The
// result is unused, so each atomicAdd compiles to a RED.
__device__ __forceinline__ void red_pixel(float* out, int key, int limit,
                                          float r, float g, float b) {
  if (key >= 0 && key < limit) {
    float* o = out + (size_t)(key >> 10) * (3 * TILE_PX) + (key & (TILE_PX - 1));
    atomicAdd(o, r);
    atomicAdd(o + TILE_PX, g);
    atomicAdd(o + 2 * TILE_PX, b);
  }
}

// Where deposit_quad sends a pixel's sum: straight to the frame.
struct RedSink {
  float* out;
  int limit;
  __device__ __forceinline__ void operator()(int key, float r, float g,
                                             float b) const {
    red_pixel(out, key, limit, r, g, b);
  }
};

// Deposit one lane's four points of its warp's group: each pixel's sum
// goes to sink(key, r, g, b) once. All 32 lanes call it (the scan
// shuffles over the full warp). Keys must ascend along the group
// apart from masked points (key -1, zero payload): a pixel's points then
// stay contiguous, so two lanes whose last keys are equal hold one run
// between them, which is what the scan tests.
template <class Sink>
__device__ __forceinline__ void deposit_quad(const int (&k)[4],
                                             const float (&r)[4],
                                             const float (&g)[4],
                                             const float (&b)[4],
                                             const Sink& sink) {
  const int lane = threadIdx.x & 31;
  // runs inside the lane: the first (head) may continue the previous
  // lane's last run, the last (tail) the next lane's first; runs between
  // them are whole pixels of this lane alone and go out at once
  float cr = r[0], cg = g[0], cb = b[0];
  float hr = 0.0f, hg = 0.0f, hb = 0.0f;
  bool split = false;  // the lane holds more than one run
  int cur = k[0];
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    if (k[j] != cur) {
      if (split) {
        sink(cur, cr, cg, cb);
      } else {
        hr = cr; hg = cg; hb = cb;
        split = true;
      }
      cur = k[j];
      cr = r[j]; cg = g[j]; cb = b[j];
    } else {
      cr += r[j]; cg += g[j]; cb += b[j];
    }
  }
  // segmented inclusive scan of the tail runs over the lanes, keyed by the
  // tail's pixel: lane l ends with the sum of its pixel's points in lanes
  // <= l (a split lane's tail starts in the lane, so no earlier lane's
  // last key equals it)
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int pk = __shfl_up_sync(FULL_WARP, cur, d);
    const float pr = __shfl_up_sync(FULL_WARP, cr, d);
    const float pg = __shfl_up_sync(FULL_WARP, cg, d);
    const float pb = __shfl_up_sync(FULL_WARP, cb, d);
    if (lane >= d && pk == cur) {
      cr += pr; cg += pg; cb += pb;
    }
  }
  const int prev_k = __shfl_up_sync(FULL_WARP, cur, 1);
  const float prev_r = __shfl_up_sync(FULL_WARP, cr, 1);
  const float prev_g = __shfl_up_sync(FULL_WARP, cg, 1);
  const float prev_b = __shfl_up_sync(FULL_WARP, cb, 1);
  const int next_k0 = __shfl_down_sync(FULL_WARP, k[0], 1);
  if (split) {  // the head closes the run the lanes before it carried
    if (lane > 0 && prev_k == k[0]) {
      hr += prev_r; hg += prev_g; hb += prev_b;
    }
    sink(k[0], hr, hg, hb);
  }
  // the tail goes out unless the next lane's first point continues it
  if (lane == 31 || next_k0 != cur) sink(cur, cr, cg, cb);
}

// Blocks of RD_THREADS threads for a kernel that strides over `units`
// units of work, one warp a unit. blocks_per_sm < 0: one block per
// RD_THREADS / 32 units, so each warp takes one unit and the hardware
// balances the blocks; 0: as many blocks as fit on the card at once (a
// grid-stride loop; a block more an SM would run in a second wave); > 0:
// at most that many an SM. Never more blocks than the work needs.
template <class Kernel>
cudaError_t grid_blocks(Kernel kernel, long long units, int blocks_per_sm,
                        int* blocks) {
  const long long warps = RD_THREADS / 32;
  long long b = (units + warps - 1) / warps;
  if (blocks_per_sm >= 0) {
    int dev = 0, sms = 0, fit = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel,
                                                        RD_THREADS, 0);
    if (e != cudaSuccess) return e;
    if (blocks_per_sm > 0 && blocks_per_sm < fit) fit = blocks_per_sm;
    const long long cap = (long long)sms * (fit > 0 ? fit : 1);
    if (b > cap) b = cap;
  }
  *blocks = (int)(b > 0 ? b : 1);
  return cudaSuccess;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace
