// Design probe of the direct all-pairs force
// (ops/pairwise_cuda.py:pairwise_accel, pairwise_accel_diff): the
// package's kernel (csrc/pairwise.cu, included with the numeric -D knobs
// that pairwise_variants.py passes: PW_R, PW_THREADS, PW_TJ, PW_UNROLL,
// PW_MIN_BLOCKS) and the earlier kernel, verbatim, as variant 0: one
// receiver a thread, one block a 256 receivers, every source swept by
// every block, tiles loaded with plain loads between two barriers.
// Built by tools/pairwise_variants.py (chip_smoke.py builds its first
// config to time variant 0), not by the package; on no path.
#include "../csrc/pairwise.cu"

namespace v0 {

// ---- variant 0: the earlier kernel, verbatim (its exported launcher is
// ---- probe_v0_pairwise below)
#define PW_TILE 256

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

}  // namespace v0

// variant 0's launcher, the earlier psim_pairwise: xi float32[ni, 3]
// receivers; xj float32[3, nj] source planes; gv float32[nj] source
// weights; eps_sq float32[1] on the device; out float32[ni, 3]
PSIM_EXPORT int probe_v0_pairwise(const float* xi, const float* xj,
                                  const float* gv, const float* eps_sq,
                                  float* out, int ni, int nj,
                                  cudaStream_t stream) {
  const int blocks = (ni + PW_TILE - 1) / PW_TILE;
  if (blocks > 0) {
    v0::pairwise_kernel<<<blocks, PW_TILE, 0, stream>>>(xi, xj, gv, eps_sq,
                                                        out, ni, nj);
  }
  return (int)cudaGetLastError();
}

// int32[8] out: registers, static shared bytes, resident blocks an SM,
// threads a block, local (spill) bytes, receivers a block, receivers a
// thread, sources a tile; of the package's pairwise_kernel<diff != 0> as
// this config builds it
PSIM_EXPORT int probe_pkg_occupancy(int diff, int* info) {
  const void* fn = diff ? (const void*)pairwise_kernel<true>
                        : (const void*)pairwise_kernel<false>;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                        PW_THREADS, 0);
  }
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = blocks;
  info[3] = PW_THREADS;
  info[4] = (int)a.localSizeBytes;
  info[5] = PW_BI;
  info[6] = PW_R;
  info[7] = PW_TJ;
  return (int)err;
}

// variant 0's resources, as probe_pkg_occupancy reports the package
// kernel's (int32[8])
PSIM_EXPORT int probe_v0_occupancy(int* info) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, v0::pairwise_kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, v0::pairwise_kernel, PW_TILE, 0);
  }
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = blocks;
  info[3] = PW_TILE;
  info[4] = (int)a.localSizeBytes;
  info[5] = PW_TILE;
  info[6] = 1;
  info[7] = PW_TILE;
  return (int)err;
}
