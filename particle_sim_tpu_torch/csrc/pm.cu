// Particle-mesh CIC deposit and gather, sort-free: one thread per particle.
//
// Replaces particle_sim_tpu/ops/pm_pallas.py:_deposit_kernel (:247),
// _deposit_kernel_mass (:253) and _gather_kernel (:259). Those kernels sort
// the particles by cell first, because TPU scatter is serial, and then build
// bf16 one-hot matmuls per (grid tile, chunk, corner family) from a pair
// table, with CIC fractions quantised to 10 bits and a second sort (with a
// shared-exponent pack) to bring the accelerations back to particle order.
// The H100 has fast float atomics in L2, so none of that is carried over:
//
//   deposit: rho[iz, iy, ix] += m * wx * wy * wz over the 8 CIC corners,
//            one atomicAdd each, into a zeroed f32[G, G, G] grid;
//   gather:  out[c, i] = sum over the 8 corners of wx * wy * wz * grid[c, ...]
//            for the 3 acceleration grids (or the one potential grid of the
//            diagnostics), written in the original order.
//
// What it computes is the plain version's function (ops/pm.py
// cell_coords_dyn + cic_weights + cic_deposit_ref / cic_gather_ref):
//   c = (pos - box_min) / cell        (IEEE division, as the plain version)
//   isolated: c = min(max(c, 0), hi)  with hi = float32(G - 1) - 1e-3
//   periodic: c = min(c mod G, hi)    with hi = float32(G) - 1e-3, and the
//             upper corner of the last cell wraps to cell 0
//   i0 = floor(c), f = c - i0, weights (1 - f, f) per axis
// The clamp constant comes from the wrapper (pm.clamp_limit), computed as
// the plain version computes it. Every weight product is rounded in the
// plain version's order with __fmul_rn / __fadd_rn (no fma contraction), so
// the weights are bit-identical and the gather, which sums the corners in
// the plain version's order, is bit-identical too; the deposit's sums come
// in atomic order, so it agrees to float32 summation order. Deposit and
// gather share cic_setup, so their weights are identical, which is what
// momentum conservation needs.
//
// Dead particles (i >= n_active, or live[i] == 0 when a live mask is given)
// deposit nothing and gather exactly 0. A non-finite acceleration grid comes
// out non-finite, per component, at every particle that reads it. A
// non-finite position gives NaN weights (loud); its cell index is clamped
// onto the grid so no access leaves it (float-to-int conversion of NaN
// gives 0 in PTX).
//
// What bounds it on the H100: bytes. The deposit reads 12 B of position a
// particle (+4 B of mass) and writes the 4*G^3 B grid; the gather reads 12 B
// of position and the 12*G^3 B of grids and writes 12 B a particle. At
// G = 128 the grid (8 MB) and the three acceleration grids (24 MB) stay in
// the 50 MB L2, so the 8 atomics and 24 reads a particle are L2 traffic.
// Atomics on one address serialise: a collapsed cloud, many particles in a
// few cells, is the deposit's worst case (chip_smoke.py times both).
#include "common.cuh"

#define PM_BLOCK 256

namespace {

struct Cic {
  int lo[3];   // lower corner cell per axis (x, y, z)
  int hi[3];   // upper corner cell per axis, wrapped in periodic mode
  float f[3];  // fractional offsets
};

__device__ __forceinline__ Cic cic_setup(const float* __restrict__ pos,
                                         size_t n, size_t i,
                                         const float* __restrict__ box_min,
                                         float cell, int g, float hi,
                                         bool periodic) {
  Cic r;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float c = __fdiv_rn(__fsub_rn(__ldg(pos + a * n + i), __ldg(box_min + a)),
                        cell);
    if (periodic) {
      // torch.remainder / jnp.mod: fmod, then shift a negative rest by G
      float m = fmodf(c, (float)g);
      if (m < 0.0f) m = __fadd_rn(m, (float)g);
      c = m > hi ? hi : m;  // NaN stays NaN
    } else {
      c = c < 0.0f ? 0.0f : c;
      c = c > hi ? hi : c;
    }
    const float fl = floorf(c);
    int k = (int)fl;
    k = min(max(k, 0), g - 1);
    int k1 = k + 1;
    if (k1 >= g) k1 = periodic ? 0 : g - 1;
    r.lo[a] = k;
    r.hi[a] = k1;
    r.f[a] = __fsub_rn(c, fl);
  }
  return r;
}

__device__ __forceinline__ bool alive(int i, const int* __restrict__ n_active,
                                      const uint8_t* __restrict__ live) {
  return live != nullptr ? __ldg(live + i) != 0 : i < __ldg(n_active);
}

template <bool kMass>
__global__ void __launch_bounds__(PM_BLOCK) pm_deposit_kernel(
    const float* __restrict__ pos, int n, const int* __restrict__ n_active,
    const uint8_t* __restrict__ live, const float* __restrict__ masses,
    const float* __restrict__ box_min, const float* __restrict__ cell_p,
    int g, float hi, int periodic, float* __restrict__ rho) {
  const int i = blockIdx.x * PM_BLOCK + threadIdx.x;
  if (i >= n || !alive(i, n_active, live)) return;
  const Cic c = cic_setup(pos, (size_t)n, (size_t)i, box_min, __ldg(cell_p),
                          g, hi, periodic != 0);
  const float m = kMass ? __ldg(masses + i) : 1.0f;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {  // (cz, cy, cx), cx fastest
    const int cz = corner >> 2, cy = (corner >> 1) & 1, cx = corner & 1;
    const float wx = cx ? c.f[0] : __fsub_rn(1.0f, c.f[0]);
    const float wy = cy ? c.f[1] : __fsub_rn(1.0f, c.f[1]);
    const float wz = cz ? c.f[2] : __fsub_rn(1.0f, c.f[2]);
    // m * wx * wy * wz, left to right; m * wx == wx for unit masses
    const float w = __fmul_rn(__fmul_rn(kMass ? __fmul_rn(m, wx) : wx, wy),
                              wz);
    const int ix = cx ? c.hi[0] : c.lo[0];
    const int iy = cy ? c.hi[1] : c.lo[1];
    const int iz = cz ? c.hi[2] : c.lo[2];
    atomicAdd(rho + ((size_t)iz * g + iy) * g + ix, w);
  }
}

template <int C>
__global__ void __launch_bounds__(PM_BLOCK) pm_gather_kernel(
    const float* __restrict__ grids, const float* __restrict__ pos, int n,
    const int* __restrict__ n_active, const uint8_t* __restrict__ live,
    const float* __restrict__ box_min, const float* __restrict__ cell_p,
    int g, float hi, int periodic, float* __restrict__ out) {
  const int i = blockIdx.x * PM_BLOCK + threadIdx.x;
  if (i >= n) return;
  float acc[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;
  if (alive(i, n_active, live)) {
    const Cic c = cic_setup(pos, (size_t)n, (size_t)i, box_min,
                            __ldg(cell_p), g, hi, periodic != 0);
    const size_t g3 = (size_t)g * g * g;
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
      const int cz = corner >> 2, cy = (corner >> 1) & 1, cx = corner & 1;
      const float wx = cx ? c.f[0] : __fsub_rn(1.0f, c.f[0]);
      const float wy = cy ? c.f[1] : __fsub_rn(1.0f, c.f[1]);
      const float wz = cz ? c.f[2] : __fsub_rn(1.0f, c.f[2]);
      const float w = __fmul_rn(__fmul_rn(wx, wy), wz);
      const int ix = cx ? c.hi[0] : c.lo[0];
      const int iy = cy ? c.hi[1] : c.lo[1];
      const int iz = cz ? c.hi[2] : c.lo[2];
      const size_t k = ((size_t)iz * g + iy) * g + ix;
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        acc[ch] = __fadd_rn(acc[ch], __fmul_rn(w, __ldg(grids + ch * g3 + k)));
    }
  }
#pragma unroll
  for (int ch = 0; ch < C; ++ch) out[ch * (size_t)n + i] = acc[ch];
}

}  // namespace

// pos: float32[3, n] planes; n_active: int32[1]; live: uint8[n] or NULL
// (NULL: i < n_active); masses: float32[n] or NULL (unit masses);
// box_min: float32[3]; cell: float32[1] (all on the device); hi: the
// clamp limit; periodic: 0/1; rho: float32[g, g, g], zeroed by the caller.
PSIM_EXPORT int psim_pm_deposit(const float* pos, int n, const int* n_active,
                                const uint8_t* live, const float* masses,
                                const float* box_min, const float* cell,
                                int g, float hi, int periodic, float* rho,
                                cudaStream_t stream) {
  const int blocks = (n + PM_BLOCK - 1) / PM_BLOCK;
  if (blocks > 0) {
    if (masses != nullptr) {
      pm_deposit_kernel<true><<<blocks, PM_BLOCK, 0, stream>>>(
          pos, n, n_active, live, masses, box_min, cell, g, hi, periodic,
          rho);
    } else {
      pm_deposit_kernel<false><<<blocks, PM_BLOCK, 0, stream>>>(
          pos, n, n_active, live, masses, box_min, cell, g, hi, periodic,
          rho);
    }
  }
  return (int)cudaGetLastError();
}

// grids: float32[channels, g, g, g] with channels 1 (a potential) or 3 (the
// acceleration components); out: float32[channels, n]; the rest as above.
PSIM_EXPORT int psim_pm_gather(const float* grids, int channels,
                               const float* pos, int n, const int* n_active,
                               const uint8_t* live, const float* box_min,
                               const float* cell, int g, float hi,
                               int periodic, float* out,
                               cudaStream_t stream) {
  if (channels != 1 && channels != 3) return (int)cudaErrorInvalidValue;
  const int blocks = (n + PM_BLOCK - 1) / PM_BLOCK;
  if (blocks > 0) {
    if (channels == 3) {
      pm_gather_kernel<3><<<blocks, PM_BLOCK, 0, stream>>>(
          grids, pos, n, n_active, live, box_min, cell, g, hi, periodic, out);
    } else {
      pm_gather_kernel<1><<<blocks, PM_BLOCK, 0, stream>>>(
          grids, pos, n, n_active, live, box_min, cell, g, hi, periodic, out);
    }
  }
  return (int)cudaGetLastError();
}
