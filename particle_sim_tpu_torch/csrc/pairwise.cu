// All-pairs softened gravity: the classic shared-memory tiled N-body sum.
//
// Replaces particle_sim_tpu/ops/pairwise_pallas.py:_kernel (a (TI, TJ)
// VPU broadcast tile per grid step, j minor, with the (TI, 3) output block
// resident in VMEM across the whole j sweep).
//
// What it computes:
//   out[i] = sum_j gv[j] * (x_j - x_i) * rsqrt(|x_j - x_i|^2 + eps^2)^3
// for receivers x_i = xi[i, 0:3] and sources x_j = xj[0:3, j]; gv[j] =
// G * (j_base + j < n_active) * m_j is built by the wrapper
// (ops/pairwise_cuda.py), so the O(N^2) loop carries no mask arithmetic.
//
// What bounds it on the H100: operations; the bytes are O(N) against O(N^2)
// work. A pair costs 12 FP32 instructions (3 sub; r2 as 3 fma, the
// softening as the first addend; 3 mul for w = gv * inv^3; 3 fma into the
// sum), i.e. 18 flops counting an fma as 2 (the JAX cost estimate books
// 20), and one MUFU rsqrt. Half the instructions are not fmas, so the FP32
// issue rate (128 per SM per clock) binds before the flop peak: at
// 65,536^2 pairs about 1.54 ms at 67 TFLOP/s, against 1.15 ms for the
// flops alone and 1.03 ms for the rsqrt rate (16 per SM per clock).
// chip_smoke.py phase 10 prints the three.
//
// Design (GPU Gems 3 ch. 31, arXiv 0706.3060): one thread owns one receiver
// and keeps its sum in registers; the block stages TILE sources as float4
// (x, y, z, gv) in shared memory, every thread sweeps the tile (a broadcast
// read: all lanes hit the same word), and the block walks all of j. The
// TPU's sequential j grid with a resident output block becomes this loop
// inside the thread, so no atomics and no second pass are needed; ragged
// edges are handled by the tile's valid count. One launch, one block per
// 256 receivers: at 65,536 receivers that is 256 blocks for 132 SMs
// (~15.5 resident warps per SM of 64); splitting j across blocks to raise
// the occupancy is left to a later change. The sum order is j ascending
// within each thread (the plain version reduces in torch's order, so the
// two agree to a tolerance, not bit for bit).
#include "common.cuh"

#define PW_TILE 256

namespace {

__device__ __forceinline__ void accumulate(const float4 s, float x, float y,
                                           float z, float eps_sq, float& ax,
                                           float& ay, float& az) {
  const float dx = s.x - x;
  const float dy = s.y - y;
  const float dz = s.z - z;
  const float r2 = eps_sq + dx * dx + dy * dy + dz * dz;  // 3 fma
  // rsqrtf without flush-to-zero wraps the MUFU op in two rescaling
  // multiplies for subnormal inputs; r2 >= eps^2 is never subnormal for a
  // softening above ~1e-19, so the bare approximate op (same 2 ulp) does
  float inv;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(r2));
  const float w = s.w * (inv * inv * inv);
  ax += w * dx;
  ay += w * dy;
  az += w * dz;
}

__global__ void __launch_bounds__(PW_TILE) pairwise_kernel(
    const float* __restrict__ xi, const float* __restrict__ xj,
    const float* __restrict__ gv, const float* __restrict__ eps_sq_p,
    float* __restrict__ out, int ni, int nj) {
  __shared__ float4 tile[PW_TILE];
  const int i = blockIdx.x * PW_TILE + threadIdx.x;
  const float eps_sq = __ldg(eps_sq_p);
  float x = 0.0f, y = 0.0f, z = 0.0f;
  if (i < ni) {
    x = xi[3 * (size_t)i];
    y = xi[3 * (size_t)i + 1];
    z = xi[3 * (size_t)i + 2];
  }
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  for (int j0 = 0; j0 < nj; j0 += PW_TILE) {
    const int j = j0 + threadIdx.x;
    if (j < nj) {
      tile[threadIdx.x] = make_float4(__ldg(xj + j), __ldg(xj + nj + j),
                                      __ldg(xj + 2 * (size_t)nj + j),
                                      __ldg(gv + j));
    }
    __syncthreads();
    const int m = min(PW_TILE, nj - j0);
    if (m == PW_TILE) {
#pragma unroll 8
      for (int k = 0; k < PW_TILE; ++k) {
        accumulate(tile[k], x, y, z, eps_sq, ax, ay, az);
      }
    } else {
      for (int k = 0; k < m; ++k) {
        accumulate(tile[k], x, y, z, eps_sq, ax, ay, az);
      }
    }
    __syncthreads();
  }
  if (i < ni) {
    out[3 * (size_t)i] = ax;
    out[3 * (size_t)i + 1] = ay;
    out[3 * (size_t)i + 2] = az;
  }
}

}  // namespace

// xi: float32[ni, 3] receivers; xj: float32[3, nj] source planes;
// gv: float32[nj] source weights; eps_sq: float32[1] on the device;
// out: float32[ni, 3].
PSIM_EXPORT int psim_pairwise(const float* xi, const float* xj,
                              const float* gv, const float* eps_sq,
                              float* out, int ni, int nj,
                              cudaStream_t stream) {
  const int blocks = (ni + PW_TILE - 1) / PW_TILE;
  if (blocks > 0) {
    pairwise_kernel<<<blocks, PW_TILE, 0, stream>>>(xi, xj, gv, eps_sq, out,
                                                    ni, nj);
  }
  return (int)cudaGetLastError();
}
