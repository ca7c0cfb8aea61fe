// The receivers' preparation for the tensor-core force
// (csrc/pairwise_mxu.cu): their Hilbert-curve keys (the receiver order)
// and the inlier box of the block centres.
//
// Part of the port of particle_sim_tpu/ops/pairwise_pallas.py:_kernel_mxu
// (row 8 of the TPU kernel table): the wrapper
// (ops/pairwise_cuda.py:pairwise_accel_mxu) sorts (key, index) with the
// radix kernels and hands the permutation to the force kernel, so that a
// block's receivers form a compact region. The plain version is
// ops/pairwise_cuda.py:hilbert_keys; this kernel gives its keys bit for
// bit: the same f32 quantisation (nan_to_num, (p - lo) / span * top
// rounded op by op, clamped, truncated as .to(torch.int32)), then
// Skilling's transpose form ("Programming the Hilbert curve", AIP Conf.
// Proc. 707, 2004) in int32 and the bit interleave.
//
// What bounds it on the H100: bytes (12 read and 4 written a point,
// ~0.3 us at 65,536); one thread a point, ~100 integer instructions each.
//
// The inlier box (plain version ops/pairwise_cuda.py:inlier_box): the
// median of each coordinate -/+ 8 times its median absolute deviation
// over an evenly strided sample of <= ~8k points, bit for bit. One block:
// each median is an exact radix select (four 8-bit digits, most
// significant first, over the order-preserving integer image of the
// floats), the three coordinates side by side (a warp scans each
// coordinate's 256-bin histogram), the sample read once into registers.
// What bounds it: its 24 barriers and the scans between them; the plain
// version's dozen launches took 0.054 ms at 65,536.
#include "common.cuh"

#include <float.h>

#define HK_THREADS 256

namespace {

// the 10 low bits of v moved to every third bit
__device__ __forceinline__ int spread_bits(int v) {
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  return (v | (v << 2)) & 0x09249249;
}

// torch.nan_to_num with its defaults
__device__ __forceinline__ float nan_to_num(float v) {
  return isnan(v) ? 0.0f : isinf(v) ? copysignf(FLT_MAX, v) : v;
}

__global__ void __launch_bounds__(HK_THREADS) hilbert_keys_kernel(
    const float* __restrict__ p, const float* __restrict__ box,
    int* __restrict__ key, int n, int bits) {
  const int i = blockIdx.x * HK_THREADS + threadIdx.x;
  if (i >= n) return;
  const int top = (1 << bits) - 1;
  const float ftop = (float)top;
  int x[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float lo = __ldg(box + c);
    const float span = fmaxf(__fsub_rn(__ldg(box + 3 + c), lo), 1e-30f);
    const float v = nan_to_num(__ldg(p + (size_t)c * n + i));
    const float q = __fmul_rn(__fdiv_rn(__fsub_rn(v, lo), span), ftop);
    x[c] = __float2int_rz(fminf(fmaxf(q, 0.0f), ftop));
  }
  // undo the excess work
  for (int bit = 1 << (bits - 1); bit > 1; bit >>= 1) {
    const int low = bit - 1;
    if (x[0] & bit) x[0] ^= low;
#pragma unroll
    for (int c = 1; c < 3; ++c) {
      if (x[c] & bit) {
        x[0] ^= low;
      } else {
        const int t = (x[0] ^ x[c]) & low;
        x[0] ^= t;
        x[c] ^= t;
      }
    }
  }
  x[1] ^= x[0];  // Gray encode
  x[2] ^= x[1];
  int t = 0;
  for (int bit = 1 << (bits - 1); bit > 1; bit >>= 1) {
    if (x[2] & bit) t ^= bit - 1;
  }
  // interleave, high bits first: bit b of x[c] to bit 3b + 2 - c
  key[i] = (spread_bits(x[0] ^ t) << 2) | (spread_bits(x[1] ^ t) << 1) |
           spread_bits(x[2] ^ t);
}

// float -> uint32 with the same order (-0 below +0), and back
__device__ __forceinline__ uint32_t ordered(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float unordered(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

#define IB_THREADS 1024
#define IB_PER 8  // sample points a thread: count < 8,192

// the k-th smallest (0-based) of v[c][r] (point threadIdx.x + r IB_THREADS
// < count) for c = 0, 1, 2 at once; every thread gets the three results
__device__ __forceinline__ void select3(const float v[3][IB_PER], int count,
                                        int k, float out[3]) {
  __shared__ uint32_t hist[3][256];
  __shared__ uint32_t s_prefix[3];
  __shared__ int s_k[3];
  uint32_t key[3][IB_PER];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int r = 0; r < IB_PER; ++r) key[c][r] = ordered(v[c][r]);
  }
  if (threadIdx.x < 3) {
    s_prefix[threadIdx.x] = 0u;
    s_k[threadIdx.x] = k;
  }
  uint32_t mask = 0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < 3 * 256; b += IB_THREADS) {
      hist[b >> 8][b & 255] = 0u;
    }
    __syncthreads();  // the histogram is zero, the prefix is in
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const uint32_t prefix = s_prefix[c];
#pragma unroll
      for (int r = 0; r < IB_PER; ++r) {
        if (threadIdx.x + r * IB_THREADS < count &&
            (key[c][r] & mask) == prefix) {
          atomicAdd(&hist[c][(key[c][r] >> shift) & 255u], 1u);
        }
      }
    }
    __syncthreads();
    // warp c finds the digit of coordinate c: lane l holds bins 8l ..
    // 8l + 7; an inclusive scan of the lanes' sums finds the lane whose
    // bins hold the k-th key, which walks its own bins
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp < 3) {
      // read before the shuffles: no lane writes s_k until all have read
      const uint32_t kk = (uint32_t)s_k[warp];
      const uint32_t prefix = s_prefix[warp];
      uint32_t own = 0u;
#pragma unroll
      for (int b = 0; b < 8; ++b) own += hist[warp][8 * lane + b];
      uint32_t incl = own;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t up = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl += up;
      }
      const uint32_t below = incl - own;
      if (below <= kk && kk < incl) {
        uint32_t cum = below;
        int digit = 8 * lane;
        for (int b = 0; b < 8; ++b) {
          const uint32_t h = hist[warp][8 * lane + b];
          if (kk < cum + h) {
            digit = 8 * lane + b;
            break;
          }
          cum += h;
        }
        s_prefix[warp] = prefix | ((uint32_t)digit << shift);
        s_k[warp] = (int)(kk - cum);
      }
    }
    mask |= 255u << shift;
    __syncthreads();  // the new prefix is in; the histogram may be reused
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = unordered(s_prefix[c]);
  __syncthreads();  // every thread has read the results
}

__global__ void __launch_bounds__(IB_THREADS) inlier_box_kernel(
    const float* __restrict__ p, int n, int stride, int count,
    float* __restrict__ box) {
  const int k = (count - 1) / 2;  // torch.median: the lower middle value
  // the sample in registers, read once
  float v[3][IB_PER];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int r = 0; r < IB_PER; ++r) {
      const int i = threadIdx.x + r * IB_THREADS;
      v[c][r] = i < count
                    ? nan_to_num(__ldg(p + (size_t)c * n + (size_t)i * stride))
                    : 0.0f;
    }
  }
  float med[3], mad[3];
  select3(v, count, k, med);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int r = 0; r < IB_PER; ++r) v[c][r] = fabsf(__fsub_rn(v[c][r], med[c]));
  }
  select3(v, count, k, mad);
  if (threadIdx.x < 3) {
    const int c = threadIdx.x;
    const float m = c == 0 ? med[0] : c == 1 ? med[1] : med[2];
    const float d = __fmul_rn(8.0f, c == 0 ? mad[0] : c == 1 ? mad[1] : mad[2]);
    box[c] = __fsub_rn(m, d);
    box[3 + c] = __fadd_rn(m, d);
  }
}

}  // namespace

// p: float32[3, n] points; box: float32[6] out, (lo xyz, hi xyz) of the
// inlier box over the points i * stride, i < count (1 <= count < 8,192).
PSIM_EXPORT int psim_inlier_box(const float* p, int n, int stride, int count,
                                float* box, cudaStream_t stream) {
  inlier_box_kernel<<<1, IB_THREADS, 0, stream>>>(p, n, stride, count, box);
  return (int)cudaGetLastError();
}

// p: float32[3, n] points; box: float32[6], (min xyz, max xyz) of
// nan_to_num(p) over all points; key: int32[n]; bits: 1-10 (2^bits cells
// an axis).
PSIM_EXPORT int psim_hilbert_keys(const float* p, const float* box, int* key,
                                  int n, int bits, cudaStream_t stream) {
  if (n > 0) {
    hilbert_keys_kernel<<<(n + HK_THREADS - 1) / HK_THREADS, HK_THREADS, 0,
                          stream>>>(p, box, key, n, bits);
  }
  return (int)cudaGetLastError();
}
