// Candidate designs of the particle-mesh CIC deposit and gather
// (csrc/pm.cu), built apart from the package's library and timed in turns
// with the package's own kernels on the same inputs by pm_variants.py.
// Variant 0 of each is the earlier design (one thread a particle; 8 scalar
// atomicAdd a particle; 24 scalar loads from three planar grids), kept here
// under another name so that the earlier and the current design run in one
// process on one card. The designs that won (deposit: 5 and a block merge
// in shared memory; gather: 8 float4 loads from the interleaved grid) are
// csrc/pm.cu's and are not repeated here.
//
// Deposit variants (probe_deposit):
//   0  one thread a particle, 8 scalar atomicAdd (the earlier design)
//   1  warp-aggregated: __match_any_sync on the lower corner's cell, the
//      group's 8 corner weights summed by a shuffle tree, one scalar atomic
//      per corner per group
//   2  no aggregation; each x-neighbour pair of corners as one float2
//      atomicAdd when the pair is contiguous and 8-byte aligned
//   3  1 and 2
//   4  no aggregation; each x pair as one float4 atomicAdd (zeros in the
//      other two lanes) when the pair lies inside one aligned 16 B chunk
//   5  1 and 4
// Gather variants (probe_gather), grids f32[3, G, G, G] planar (0, 1) or
// f32[G, G, G, 4] interleaved (3-5):
//   0  24 scalar loads from the planes (the earlier design)
//   1  the same loads, summed without weights (what the loads alone cost)
//   3  8 float4 loads, two particles a thread
//   4  8 float4 loads, summed without weights
//   5  the particle's setup and output only: no grid load
#include "../csrc/common.cuh"

#define VB 256
#define FULL 0xffffffffu

namespace {

struct Cic {
  int lo[3];
  int hi[3];
  float f[3];
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
      float m = fmodf(c, (float)g);
      if (m < 0.0f) m = __fadd_rn(m, (float)g);
      c = m > hi ? hi : m;
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

// -- deposit ---------------------------------------------------------------------
template <bool kMass>
__global__ void __launch_bounds__(VB) dep_v0(
    const float* __restrict__ pos, int n, const int* __restrict__ n_active,
    const uint8_t* __restrict__ live, const float* __restrict__ masses,
    const float* __restrict__ box_min, const float* __restrict__ cell_p,
    int g, float hi, int periodic, float* __restrict__ rho) {
  const int i = blockIdx.x * VB + threadIdx.x;
  if (i >= n || !alive(i, n_active, live)) return;
  const Cic c = cic_setup(pos, (size_t)n, (size_t)i, box_min, __ldg(cell_p),
                          g, hi, periodic != 0);
  const float m = kMass ? __ldg(masses + i) : 1.0f;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const int cz = corner >> 2, cy = (corner >> 1) & 1, cx = corner & 1;
    const float wx = cx ? c.f[0] : __fsub_rn(1.0f, c.f[0]);
    const float wy = cy ? c.f[1] : __fsub_rn(1.0f, c.f[1]);
    const float wz = cz ? c.f[2] : __fsub_rn(1.0f, c.f[2]);
    const float w = __fmul_rn(__fmul_rn(kMass ? __fmul_rn(m, wx) : wx, wy),
                              wz);
    const int ix = cx ? c.hi[0] : c.lo[0];
    const int iy = cy ? c.hi[1] : c.lo[1];
    const int iz = cz ? c.hi[2] : c.lo[2];
    atomicAdd(rho + ((size_t)iz * g + iy) * g + ix, w);
  }
}

// Sum w[8] over the lanes of `peers` (the calling lane's group) by a
// shuffle tree; every lane of the warp calls it. True on the group's
// lowest lane, which then holds the group's sums.
__device__ __forceinline__ bool group_sum(unsigned peers, float w[8]) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = peers & ((1u << lane) - 1u);
  unsigned rank = __popc(lower);
  unsigned rest = peers & ~lower & ~(1u << lane);   // the higher peers
  while (__any_sync(FULL, rest != 0u)) {
    const int next = __ffs(rest) - 1;
    const int src = next < 0 ? lane : next;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float t = __shfl_sync(FULL, w[k], src);
      if (next >= 0) w[k] = __fadd_rn(w[k], t);
    }
    rest &= ~__ballot_sync(FULL, rank & 1u);   // odd ranks were taken
    rank >>= 1;
  }
  return lower == 0u;
}

// the 8 corners' atomics; kVec 1: scalars, 2: float2 x pairs, 4: float4
// x pairs
template <int kVec>
__device__ __forceinline__ void emit(float* __restrict__ rho, const Cic& c,
                                     int g, const float w[8]) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {   // (cz, cy); corners 2p (cx 0), 2p + 1
    const int cz = p >> 1, cy = p & 1;
    const int iy = cy ? c.hi[1] : c.lo[1];
    const int iz = cz ? c.hi[2] : c.lo[2];
    const size_t row = ((size_t)iz * g + iy) * g;
    const size_t k0 = row + c.lo[0], k1 = row + c.hi[0];
    const float a = w[2 * p], b = w[2 * p + 1];
    if (kVec == 2 && k1 == k0 + 1 && (k0 & 1) == 0) {
      atomicAdd(reinterpret_cast<float2*>(rho + k0), make_float2(a, b));
    } else if (kVec == 4 && k1 == k0 + 1 && (k0 & 3) != 3) {
      const int r = (int)(k0 & 3);
      const float4 v = make_float4(r == 0 ? a : 0.0f,
                                   r == 0 ? b : r == 1 ? a : 0.0f,
                                   r == 1 ? b : r == 2 ? a : 0.0f,
                                   r == 2 ? b : 0.0f);
      atomicAdd(reinterpret_cast<float4*>(rho + (k0 - r)), v);
    } else {
      atomicAdd(rho + k0, a);
      atomicAdd(rho + k1, b);
    }
  }
}

template <bool kMass, bool kAgg, int kVec>
__global__ void __launch_bounds__(VB) dep_var(
    const float* __restrict__ pos, int n, const int* __restrict__ n_active,
    const uint8_t* __restrict__ live, const float* __restrict__ masses,
    const float* __restrict__ box_min, const float* __restrict__ cell_p,
    int g, float hi, int periodic, float* __restrict__ rho) {
  const int i = blockIdx.x * VB + threadIdx.x;
  const bool on = i < n && alive(i, n_active, live);
  if (!kAgg && !on) return;
  Cic c = {};
  float w[8];
  int key = -1;   // dead lanes group among themselves and add nothing
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = 0.0f;
  if (on) {
    c = cic_setup(pos, (size_t)n, (size_t)i, box_min, __ldg(cell_p), g, hi,
                  periodic != 0);
    const float m = kMass ? __ldg(masses + i) : 1.0f;
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
      const int cz = corner >> 2, cy = (corner >> 1) & 1, cx = corner & 1;
      const float wx = cx ? c.f[0] : __fsub_rn(1.0f, c.f[0]);
      const float wy = cy ? c.f[1] : __fsub_rn(1.0f, c.f[1]);
      const float wz = cz ? c.f[2] : __fsub_rn(1.0f, c.f[2]);
      w[corner] = __fmul_rn(__fmul_rn(kMass ? __fmul_rn(m, wx) : wx, wy),
                            wz);
    }
    key = (c.lo[2] * g + c.lo[1]) * g + c.lo[0];
  }
  if (kAgg) {
    const unsigned peers = __match_any_sync(FULL, key);
    if (!group_sum(peers, w) || key < 0) return;
  }
  emit<kVec>(rho, c, g, w);
}

// -- gather ---------------------------------------------------------------------------
template <bool kLoadsOnly>
__global__ void __launch_bounds__(VB) gat_planar(
    const float* __restrict__ grids, const float* __restrict__ pos, int n,
    const int* __restrict__ n_active, const uint8_t* __restrict__ live,
    const float* __restrict__ box_min, const float* __restrict__ cell_p,
    int g, float hi, int periodic, float* __restrict__ out) {
  const int i = blockIdx.x * VB + threadIdx.x;
  if (i >= n) return;
  float acc[3] = {0.0f, 0.0f, 0.0f};
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
      for (int ch = 0; ch < 3; ++ch) {
        const float v = __ldg(grids + ch * g3 + k);
        acc[ch] = kLoadsOnly ? acc[ch] + v
                             : __fadd_rn(acc[ch], __fmul_rn(w, v));
      }
    }
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) out[ch * (size_t)n + i] = acc[ch];
}

// kMode 0: the gather; 1: the loads summed without weights; 2: no grid
// load (the weights' sum is written)
template <int P, int kMode>
__global__ void __launch_bounds__(VB) gat_il(
    const float4* __restrict__ grid4, const float* __restrict__ pos, int n,
    const int* __restrict__ n_active, const uint8_t* __restrict__ live,
    const float* __restrict__ box_min, const float* __restrict__ cell_p,
    int g, float hi, int periodic, float* __restrict__ out) {
  const int base = blockIdx.x * (VB * P) + threadIdx.x;
  const float cell = __ldg(cell_p);
  Cic c[P];
  bool on[P];
  float acc[P][3];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = base + p * VB;
    on[p] = i < n && alive(i, n_active, live);
    acc[p][0] = acc[p][1] = acc[p][2] = 0.0f;
    if (on[p])
      c[p] = cic_setup(pos, (size_t)n, (size_t)i, box_min, cell, g, hi,
                       periodic != 0);
  }
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const int cz = corner >> 2, cy = (corner >> 1) & 1, cx = corner & 1;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (!on[p]) continue;
      const float wx = cx ? c[p].f[0] : __fsub_rn(1.0f, c[p].f[0]);
      const float wy = cy ? c[p].f[1] : __fsub_rn(1.0f, c[p].f[1]);
      const float wz = cz ? c[p].f[2] : __fsub_rn(1.0f, c[p].f[2]);
      const float w = __fmul_rn(__fmul_rn(wx, wy), wz);
      if (kMode == 2) {
        acc[p][0] = __fadd_rn(acc[p][0], w);
        continue;
      }
      const int ix = cx ? c[p].hi[0] : c[p].lo[0];
      const int iy = cy ? c[p].hi[1] : c[p].lo[1];
      const int iz = cz ? c[p].hi[2] : c[p].lo[2];
      const float4 v = __ldg(grid4 + ((size_t)iz * g + iy) * g + ix);
      if (kMode == 1) {
        acc[p][0] += v.x;
        acc[p][1] += v.y;
        acc[p][2] += v.z;
      } else {
        acc[p][0] = __fadd_rn(acc[p][0], __fmul_rn(w, v.x));
        acc[p][1] = __fadd_rn(acc[p][1], __fmul_rn(w, v.y));
        acc[p][2] = __fadd_rn(acc[p][2], __fmul_rn(w, v.z));
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = base + p * VB;
    if (i >= n) continue;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out[ch * (size_t)n + i] = acc[p][ch];
  }
}

template <bool kAgg, int kVec>
void launch_dep(bool mass, int blocks, cudaStream_t s, const float* pos,
                int n, const int* na, const uint8_t* live, const float* m,
                const float* bmin, const float* cell, int g, float hi,
                int periodic, float* rho) {
  if (mass)
    dep_var<true, kAgg, kVec><<<blocks, VB, 0, s>>>(
        pos, n, na, live, m, bmin, cell, g, hi, periodic, rho);
  else
    dep_var<false, kAgg, kVec><<<blocks, VB, 0, s>>>(
        pos, n, na, live, m, bmin, cell, g, hi, periodic, rho);
}

}  // namespace

// Arguments as psim_pm_deposit's (csrc/pm.cu), after the variant number.
PSIM_EXPORT int probe_deposit(int variant, const float* pos, int n,
                              const int* n_active, const uint8_t* live,
                              const float* masses, const float* box_min,
                              const float* cell, int g, float hi,
                              int periodic, float* rho, cudaStream_t stream) {
  const int blocks = (n + VB - 1) / VB;
  if (blocks == 0) return 0;
  const bool mass = masses != nullptr;
  switch (variant) {
    case 0:
      if (mass)
        dep_v0<true><<<blocks, VB, 0, stream>>>(pos, n, n_active, live, masses,
                                                box_min, cell, g, hi,
                                                periodic, rho);
      else
        dep_v0<false><<<blocks, VB, 0, stream>>>(pos, n, n_active, live,
                                                 masses, box_min, cell, g, hi,
                                                 periodic, rho);
      break;
    case 1:
      launch_dep<true, 1>(mass, blocks, stream, pos, n, n_active, live,
                          masses, box_min, cell, g, hi, periodic, rho);
      break;
    case 2:
      launch_dep<false, 2>(mass, blocks, stream, pos, n, n_active, live,
                           masses, box_min, cell, g, hi, periodic, rho);
      break;
    case 3:
      launch_dep<true, 2>(mass, blocks, stream, pos, n, n_active, live,
                          masses, box_min, cell, g, hi, periodic, rho);
      break;
    case 4:
      launch_dep<false, 4>(mass, blocks, stream, pos, n, n_active, live,
                           masses, box_min, cell, g, hi, periodic, rho);
      break;
    case 5:
      launch_dep<true, 4>(mass, blocks, stream, pos, n, n_active, live,
                          masses, box_min, cell, g, hi, periodic, rho);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// grids: f32[3, g, g, g] for variants 0-1, f32[g, g, g, 4] for 3-5; out:
// f32[3, n]; the rest as psim_pm_gather's.
PSIM_EXPORT int probe_gather(int variant, const float* grids, const float* pos,
                             int n, const int* n_active, const uint8_t* live,
                             const float* box_min, const float* cell, int g,
                             float hi, int periodic, float* out,
                             cudaStream_t stream) {
  const int blocks = (n + VB - 1) / VB;
  const int blocks2 = (n + 2 * VB - 1) / (2 * VB);
  if (blocks == 0) return 0;
  const float4* g4 = reinterpret_cast<const float4*>(grids);
  switch (variant) {
    case 0:
      gat_planar<false><<<blocks, VB, 0, stream>>>(
          grids, pos, n, n_active, live, box_min, cell, g, hi, periodic, out);
      break;
    case 1:
      gat_planar<true><<<blocks, VB, 0, stream>>>(
          grids, pos, n, n_active, live, box_min, cell, g, hi, periodic, out);
      break;
    case 3:
      gat_il<2, 0><<<blocks2, VB, 0, stream>>>(
          g4, pos, n, n_active, live, box_min, cell, g, hi, periodic, out);
      break;
    case 4:
      gat_il<1, 1><<<blocks, VB, 0, stream>>>(
          g4, pos, n, n_active, live, box_min, cell, g, hi, periodic, out);
      break;
    case 5:
      gat_il<1, 2><<<blocks, VB, 0, stream>>>(
          g4, pos, n, n_active, live, box_min, cell, g, hi, periodic, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
