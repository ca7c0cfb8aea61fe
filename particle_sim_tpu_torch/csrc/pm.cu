// Particle-mesh CIC deposit and gather, sort-free: one thread per particle.
//
// Replaces particle_sim_tpu/ops/pm_pallas.py:_deposit_kernel (:247),
// _deposit_kernel_mass (:253) and _gather_kernel (:259). Those kernels sort
// the particles by cell first, because TPU scatter is serial, and then build
// bf16 one-hot matmuls per (grid tile, chunk, corner family) from a pair
// table, with CIC fractions quantised to 10 bits and a second sort (with a
// shared-exponent pack) to bring the accelerations back to particle order.
// The H100 has float atomics in L2, so none of that is carried over:
//
//   deposit: rho[iz, iy, ix] += m * wx * wy * wz over the 8 CIC corners
//            into a zeroed f32[G, G, G] grid;
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
// the plain version's order, is bit-identical too. The deposit's sums come
// in another order (a pre-sum, then atomics), so it agrees to float32
// summation order. Deposit and gather share cic_setup, so their weights are
// identical, which is what momentum conservation needs.
//
// Dead particles (i >= n_active, or live[i] == 0 when a live mask is given)
// deposit nothing and gather exactly 0. A non-finite acceleration grid comes
// out non-finite, per component, at every particle that reads it. A
// non-finite position gives NaN weights (loud); its cell index is clamped
// onto the grid so no access leaves it (float-to-int conversion of NaN
// gives 0 in PTX).
//
// What bounds them on the H100 (measured by tools/pm_variants.py, which
// times the earlier one-atomic-a-corner, one-load-a-plane design beside
// this one):
//
// deposit: L2 atomic operations. At G = 128 the grid (8 MB) lives in the
//   50 MB L2 and the kernel's time grows with the count of atomic
//   operations, not their bytes (8, 6 and 5 operations a particle took
//   0.116, 0.089 and 0.075 ms at 1M), and operations on one address form
//   one serial chain (a collapsed cloud, ~80k contributions in one cell).
//   So it issues fewer of them:
//   - the two x-neighbour corners (ix, ix + 1) go as one float4 atomicAdd
//     (zeros in the other two lanes) when they lie in one aligned 16-byte
//     word, as they do for 3 of 4 lower cells: 5 operations a particle on
//     average instead of 8;
//   - the lanes of a warp whose lower cell is the same (__match_any_sync
//     on it; the 8 corners follow from it) sum their 8 corner weights by a
//     shuffle tree, and one lane adds the group's sums;
//   - a block in which some warp found such a group merges its warps'
//     groups in a shared-memory table keyed by the cell before its atomics.
//     A block of spread particles finds none and skips the table, so the
//     spread case pays one match and two votes a warp.
// deposit of cell-sorted input (pm_deposit_kernel_sorted, the persistent
//   state's; psim_pm_deposit_sorted): the bytes, 17 a particle and the grid,
//   take 0.0876 ms at 16M; the loads, cic_setup's three IEEE divisions and the
//   weights alone took 0.170 ms. pm_deposit_kernel, timed with parts of it
//   taken out at the persistent 16M states of the main path (--pm-persist
//   --central-mass 1000; the first frame / step 40 / step 150, ms): whole
//   0.432 / 0.460 / 0.715, setup only 0.170, + match and tree 0.196 / 0.196 /
//   0.197, + the table without its grid atomics 0.327 / 0.332 / 0.409. So the
//   table's zeroing, barriers and flush cost ~0.13 ms on any input and the
//   grid atomics the rest, growing with the cells a block meets. The state is
//   not long runs of one cell for long: one frame after a repair each cell's
//   particles are in slot order, but those that cross into a neighbour cell
//   stay where they were, so the runs go from 46,168 at the first frame to
//   7.3M ten steps later, and a block of 256 slots meets 2 to 52 cells (3.4M
//   (block, cell) pairs at step 150). A design that sums runs of one cell in
//   registers and a warp scan took 0.18 ms at the first frame and 4.3 ms at
//   step 150 (a run of 1.4 slots is an atomic a slot); warp-private tables
//   without float atomics 0.27 / 0.32 / 0.84. This one keeps the warp step and
//   the block table and spreads their cost: a block takes two rounds of 256
//   slots (all loads first), zeroes its 512-slot table once for both, flushes
//   only the slots a cell took (a list), and skips the x pairs whose two
//   weights are 0 (the lower faces of a cloud clamped onto the box: f = 0
//   there): 0.333 / 0.338 / 0.474 ms, 0.447 a step over a 200-step run against
//   0.692 (chip_smoke.py phase 19 times it).
// gather: load requests. One thread a particle reads 8 corners of 3
//   components. With three planar grids that is 24 scalar loads, each its
//   own L1/L2 sector request (neighbouring threads hit unrelated cells), and
//   the loads alone took 0.060 of the kernel's 0.070 ms at 1M. The solve
//   writes the acceleration grids interleaved instead, f32[G, G, G, 4]
//   (x, y, z, pad; pm.interleaved_view), so a corner is one 16-byte load
//   and the two x neighbours share a 32-byte sector: 8 loads a particle.
//   Dense planes (the potential, C = 1, and the periodic 'exact' solve's
//   output) keep the scalar loads.
// gather, kicked (psim_pm_gather_kick, the single-level PM step's tail on
//   the interleaved grids; ops/pm_cuda.py): device-memory bandwidth. The
//   tail was three passes over a gathered f32[3, N] field: the gather wrote
//   it, the momentum sums read it back, the kicked step read it a third
//   time (1.76 GB a step at 16M). The mean needs no particle: deposit and
//   gather share their weights, so sum_i w_i a(x_i) = sum_c rho_c a_c, and
//   csrc/momentum.cu takes it from rho and the grid (42 MB at G = 128).
//   Given the mean first, the gather's thread cleans, scales and kicks its
//   particle and takes the attractor step in registers; the field is never
//   written. A particle moves 49 B (pos and vel read and written, the live
//   mask) and its 8 corners from L2: 0.85 GB at 16M.
#include "attractor.cuh"

#define PM_BLOCK 256
#define FULL_WARP 0xffffffffu
// shared-memory merge table of the deposit: more slots than a block has
// particles, so an insertion always finds its cell or a free slot
#define PM_SLOTS 512
// the deposit of cell-sorted input: rounds of PM_BLOCK slots a block (as
// many particles as PM_SLOTS), and the longest probe of its table before
// a cell goes to the grid at once
#define PM_SORTED_ROUNDS 2
#define PM_SORTED_PROBES 64

namespace {

struct Cic {
  int lo[3];   // lower corner cell per axis (x, y, z)
  int hi[3];   // upper corner cell per axis, wrapped in periodic mode
  float f[3];  // fractional offsets
};

__device__ __forceinline__ int upper_cell(int k, int g, bool periodic) {
  return k + 1 < g ? k + 1 : periodic ? 0 : g - 1;
}

// The CIC cell and fractions of the position p (x, y, z).
__device__ __forceinline__ Cic cic_of(const float (&p)[3],
                                      const float* __restrict__ box_min,
                                      float cell, int g, float hi,
                                      bool periodic) {
  Cic r;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float c = __fdiv_rn(__fsub_rn(p[a], __ldg(box_min + a)), cell);
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
    r.lo[a] = k;
    r.hi[a] = upper_cell(k, g, periodic);
    r.f[a] = __fsub_rn(c, fl);
  }
  return r;
}

// cic_of the particle i of the f32[3, n] planes
__device__ __forceinline__ Cic cic_setup(const float* __restrict__ pos,
                                         size_t n, size_t i,
                                         const float* __restrict__ box_min,
                                         float cell, int g, float hi,
                                         bool periodic) {
  const float p[3] = {__ldg(pos + i), __ldg(pos + n + i),
                      __ldg(pos + 2 * n + i)};
  return cic_of(p, box_min, cell, g, hi, periodic);
}

// the corners of a lower cell's flat index, as cic_setup forms them
__device__ __forceinline__ Cic cic_of_cell(int key, int g, bool periodic) {
  Cic c = {};
  const int lo[3] = {key % g, (key / g) % g, key / (g * g)};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    c.lo[a] = lo[a];
    c.hi[a] = upper_cell(lo[a], g, periodic);
  }
  return c;
}

__device__ __forceinline__ bool alive(int i, const int* __restrict__ n_active,
                                      const uint8_t* __restrict__ live) {
  return live != nullptr ? __ldg(live + i) != 0 : i < __ldg(n_active);
}

// The CIC weight of each corner (cz, cy, cx), cx fastest: m * wx * wy * wz
// (wx * wy * wz with kMass false), left to right.
template <bool kMass>
__device__ __forceinline__ void corner_weights(const Cic& c, float m,
                                               float w[8]) {
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const int cz = corner >> 2, cy = (corner >> 1) & 1, cx = corner & 1;
    const float wx = cx ? c.f[0] : __fsub_rn(1.0f, c.f[0]);
    const float wy = cy ? c.f[1] : __fsub_rn(1.0f, c.f[1]);
    const float wz = cz ? c.f[2] : __fsub_rn(1.0f, c.f[2]);
    w[corner] = __fmul_rn(__fmul_rn(kMass ? __fmul_rn(m, wx) : wx, wy), wz);
  }
}

// Sum w[8] over the lanes of `peers` (the calling lane's group) by a
// shuffle tree: each round a lane of even rank takes the sums of the next
// remaining peer, and the odd ranks drop out. Every lane of the warp calls
// it. True on the group's lowest lane, which then holds the group's sums.
__device__ __forceinline__ bool group_sum(unsigned peers, float w[8]) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = peers & ((1u << lane) - 1u);
  unsigned rank = __popc(lower);
  unsigned rest = peers & ~lower & ~(1u << lane);   // the higher peers
  while (__any_sync(FULL_WARP, rest != 0u)) {
    const int next = __ffs(rest) - 1;
    const int src = next < 0 ? lane : next;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float t = __shfl_sync(FULL_WARP, w[k], src);
      if (next >= 0) w[k] = __fadd_rn(w[k], t);
    }
    rest &= ~__ballot_sync(FULL_WARP, rank & 1u);
    rank >>= 1;
  }
  return lower == 0u;
}

// The 8 corners' atomics. An x pair (ix, ix + 1) inside one aligned
// 16-byte word goes as one float4 reduction (rho is 16-byte aligned; the
// other two lanes add +0, which changes no value), any other as two
// scalars (the word's last lane, or the periodic seam's wrap). kSkipZero:
// no atomic for an x pair whose two weights are 0 (a cloud clamped onto
// a lower face of the box has f = 0 there, so half its corners weigh 0).
template <bool kSkipZero = false>
__device__ __forceinline__ void add_corners(float* __restrict__ rho,
                                            const Cic& c, int g,
                                            const float w[8]) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {   // (cz, cy); its corners 2p (cx 0), 2p + 1
    const int iy = (p & 1) ? c.hi[1] : c.lo[1];
    const int iz = (p >> 1) ? c.hi[2] : c.lo[2];
    const size_t row = ((size_t)iz * g + iy) * g;
    const size_t k0 = row + c.lo[0], k1 = row + c.hi[0];
    const float a = w[2 * p], b = w[2 * p + 1];
    if (kSkipZero && a == 0.0f && b == 0.0f) continue;
    const int r = (int)(k0 & 3);
    if (k1 == k0 + 1 && r != 3) {
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

template <bool kMass>
__global__ void __launch_bounds__(PM_BLOCK) pm_deposit_kernel(
    const float* __restrict__ pos, int n, const int* __restrict__ n_active,
    const uint8_t* __restrict__ live, const float* __restrict__ masses,
    const float* __restrict__ box_min, const float* __restrict__ cell_p,
    int g, float hi, int periodic, float* __restrict__ rho) {
  __shared__ int slot_cell[PM_SLOTS];
  __shared__ float slot_w[8][PM_SLOTS];
  const int i = blockIdx.x * PM_BLOCK + threadIdx.x;
  // every thread runs to the end: the warp and block votes need them all
  const bool on = i < n && alive(i, n_active, live);
  Cic c = {};
  float w[8] = {};
  int cell = -1;   // dead lanes group among themselves and add nothing
  if (on) {
    c = cic_setup(pos, (size_t)n, (size_t)i, box_min, __ldg(cell_p), g, hi,
                  periodic != 0);
    corner_weights<kMass>(c, kMass ? __ldg(masses + i) : 1.0f, w);
    cell = (c.lo[2] * g + c.lo[1]) * g + c.lo[0];
  }
  const unsigned peers = __match_any_sync(FULL_WARP, cell);
  const bool grouped = cell >= 0 && __popc(peers) > 1;
  const bool adds = group_sum(peers, w) && cell >= 0;
  if (!__syncthreads_or(grouped)) {
    if (adds) add_corners(rho, c, g, w);
    return;
  }
  for (int s = threadIdx.x; s < PM_SLOTS; s += PM_BLOCK) {
    slot_cell[s] = -1;
#pragma unroll
    for (int k = 0; k < 8; ++k) slot_w[k][s] = 0.0f;
  }
  __syncthreads();
  if (adds) {
    unsigned s = ((unsigned)cell * 2654435761u) >> 23;   // 9 bits
    for (;;) {
      const int prev = atomicCAS(&slot_cell[s], -1, cell);
      if (prev == -1 || prev == cell) break;
      s = (s + 1) & (PM_SLOTS - 1);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) atomicAdd(&slot_w[k][s], w[k]);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < PM_SLOTS; s += PM_BLOCK) {
    const int key = slot_cell[s];
    if (key < 0) continue;
    float ws[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) ws[k] = slot_w[k][s];
    add_corners(rho, cic_of_cell(key, g, periodic != 0), g, ws);
  }
}

// The deposit of cell-sorted input (the persistent state's slots,
// ops/pm_persist.py; the note at the top says why this design): the sums
// of pm_deposit_kernel, for any order. A block takes PM_SORTED_ROUNDS
// rounds of PM_BLOCK consecutive slots and loads them all first; a round
// is pm_deposit_kernel's warp step (the lanes of one lower cell summed by
// the shuffle tree), its leaders add into the block's table, and the
// table goes to the grid once, after the last round, over the slots a
// cell took (the list `used`) and without the x pairs whose two weights
// are 0. A cell the table cannot place goes to the grid at once.
template <bool kMass>
__global__ void __launch_bounds__(PM_BLOCK) pm_deposit_kernel_sorted(
    const float* __restrict__ pos, int n, const int* __restrict__ n_active,
    const uint8_t* __restrict__ live, const float* __restrict__ masses,
    const float* __restrict__ box_min, const float* __restrict__ cell_p,
    int g, float hi, int periodic, float* __restrict__ rho) {
  __shared__ int slot_cell[PM_SLOTS];
  __shared__ float slot_w[8][PM_SLOTS];
  __shared__ int used[PM_SLOTS];
  __shared__ int n_used;
  const bool per = periodic != 0;
  const float cell = __ldg(cell_p);
  float p[PM_SORTED_ROUNDS][3], m[PM_SORTED_ROUNDS];
  bool on[PM_SORTED_ROUNDS];
#pragma unroll
  for (int j = 0; j < PM_SORTED_ROUNDS; ++j) {
    const int i = (blockIdx.x * PM_SORTED_ROUNDS + j) * PM_BLOCK + threadIdx.x;
    const bool in = i < n;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      p[j][a] = in ? __ldg(pos + (size_t)a * n + i) : 0.0f;
    m[j] = kMass && in ? __ldg(masses + i) : 1.0f;
    on[j] = in && alive(i, n_active, live);
  }
  for (int s = threadIdx.x; s < PM_SLOTS; s += PM_BLOCK) {
    slot_cell[s] = -1;
#pragma unroll
    for (int k = 0; k < 8; ++k) slot_w[k][s] = 0.0f;
  }
  if (threadIdx.x == 0) n_used = 0;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < PM_SORTED_ROUNDS; ++j) {
    Cic c = {};
    float w[8] = {};
    int key = -1;   // dead lanes group among themselves and add nothing
    if (on[j]) {
      c = cic_of(p[j], box_min, cell, g, hi, per);
      corner_weights<kMass>(c, m[j], w);
      key = (c.lo[2] * g + c.lo[1]) * g + c.lo[0];
    }
    const unsigned peers = __match_any_sync(FULL_WARP, key);
    if (!group_sum(peers, w) || key < 0) continue;
    unsigned s = ((unsigned)key * 2654435761u) >> 23;   // 9 bits
    int probe = 0;
    for (; probe < PM_SORTED_PROBES; ++probe) {
      const int prev = atomicCAS(&slot_cell[s], -1, key);
      if (prev == -1) used[atomicAdd(&n_used, 1)] = s;
      if (prev == -1 || prev == key) break;
      s = (s + 1) & (PM_SLOTS - 1);
    }
    if (probe < PM_SORTED_PROBES) {
#pragma unroll
      for (int k = 0; k < 8; ++k) atomicAdd(&slot_w[k][s], w[k]);
    } else {
      add_corners<true>(rho, c, g, w);
    }
  }
  __syncthreads();
  for (int u = threadIdx.x; u < n_used; u += PM_BLOCK) {
    const int s = used[u];
    float ws[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) ws[k] = slot_w[k][s];
    add_corners<true>(rho, cic_of_cell(slot_cell[s], g, per), g, ws);
  }
}

// dense planes f32[C, G, G, G]: one scalar load a corner and plane
template <int C>
__global__ void __launch_bounds__(PM_BLOCK) pm_gather_planar_kernel(
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
    float w[8];
    corner_weights<false>(c, 1.0f, w);
    const size_t g3 = (size_t)g * g * g;
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
      const int ix = (corner & 1) ? c.hi[0] : c.lo[0];
      const int iy = ((corner >> 1) & 1) ? c.hi[1] : c.lo[1];
      const int iz = (corner >> 2) ? c.hi[2] : c.lo[2];
      const size_t k = ((size_t)iz * g + iy) * g + ix;
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        acc[ch] = __fadd_rn(acc[ch],
                            __fmul_rn(w[corner], __ldg(grids + ch * g3 + k)));
    }
  }
#pragma unroll
  for (int ch = 0; ch < C; ++ch) out[ch * (size_t)n + i] = acc[ch];
}

// What the gather's kicked instance reads and writes besides the grid: the
// step's planes, which are also its positions, and what csrc/step.cu's
// kicked form reads for the PM step's tail.
struct GatherKick {
  float* pos;              // f32[3, n], read and written in place
  float* vel;              // f32[3, n], read and written in place
  const float* params;     // f32[16] (core/params.py slots)
  const float* mean;       // f32[3]: the live mass-weighted mean of a
  const float* scale;      // the scale: *scale, or with cell
  const float* cell;       //   *scale / (cell^2); NULL: a static box
};

// The trilinear sum of the interleaved grid at the corners of c, in the
// plain version's order, added into (ax, ay, az).
__device__ __forceinline__ void gather_corners(
    const float4* __restrict__ grid4, const Cic& c, int g, float& ax,
    float& ay, float& az) {
  float w[8];
  corner_weights<false>(c, 1.0f, w);
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const int ix = (corner & 1) ? c.hi[0] : c.lo[0];
    const int iy = ((corner >> 1) & 1) ? c.hi[1] : c.lo[1];
    const int iz = (corner >> 2) ? c.hi[2] : c.lo[2];
    const float4 v = __ldg(grid4 + ((size_t)iz * g + iy) * g + ix);
    ax = __fadd_rn(ax, __fmul_rn(w[corner], v.x));
    ay = __fadd_rn(ay, __fmul_rn(w[corner], v.y));
    az = __fadd_rn(az, __fmul_rn(w[corner], v.z));
  }
}

// interleaved f32[G, G, G, 4] (x, y, z, pad): one 16-byte load a corner.
// kKick: the PM step's tail in the same thread, from the gathered a in
// registers and in csrc/step.cu's order, a = (a - mean) * live, a = scale
// * a, vel += a * dt, then the attractor step (csrc/attractor.cuh), pos
// and vel written in place through k; `pos` and `out` are unused then.
// The two instances keep separate bodies: with one body the gather's
// instance took 34 registers for 32 and ran 18 % slower at 16M.
template <bool kKick>
__global__ void __launch_bounds__(PM_BLOCK) pm_gather_interleaved_kernel(
    const float4* __restrict__ grid4, const float* __restrict__ pos, int n,
    const int* __restrict__ n_active, const uint8_t* __restrict__ live,
    const float* __restrict__ box_min, const float* __restrict__ cell_p,
    int g, float hi, int periodic, float* __restrict__ out, GatherKick k) {
  const int i = blockIdx.x * PM_BLOCK + threadIdx.x;
  if (i >= n) return;
  if constexpr (!kKick) {
    float ax = 0.0f, ay = 0.0f, az = 0.0f;
    if (alive(i, n_active, live)) {
      const Cic c = cic_setup(pos, (size_t)n, (size_t)i, box_min,
                              __ldg(cell_p), g, hi, periodic != 0);
      gather_corners(grid4, c, g, ax, ay, az);
    }
    out[i] = ax;
    out[(size_t)n + i] = ay;
    out[2 * (size_t)n + i] = az;
  } else {
    // every slot is stepped, and its planes are written: plain loads
    const size_t nn = (size_t)n;
    float p[3] = {k.pos[i], k.pos[nn + i], k.pos[2 * nn + i]};
    float ax = 0.0f, ay = 0.0f, az = 0.0f;
    const bool on = alive(i, n_active, live);
    if (on) {
      const Cic c = cic_of(p, box_min, __ldg(cell_p), g, hi, periodic != 0);
      gather_corners(grid4, c, g, ax, ay, az);
    }
    const StepScalars s = load_scalars(k.params);
    const float lv = on ? 1.0f : 0.0f;
    ax = __fmul_rn(__fsub_rn(ax, __ldg(k.mean)), lv);
    ay = __fmul_rn(__fsub_rn(ay, __ldg(k.mean + 1)), lv);
    az = __fmul_rn(__fsub_rn(az, __ldg(k.mean + 2)), lv);
    float scale = __ldg(k.scale);
    if (k.cell != nullptr) {
      const float cl = __ldg(k.cell);
      scale = __fdiv_rn(scale, __fmul_rn(cl, cl));
    }
    ax = __fmul_rn(scale, ax);
    ay = __fmul_rn(scale, ay);
    az = __fmul_rn(scale, az);
    float vx = k.vel[i], vy = k.vel[nn + i], vz = k.vel[2 * nn + i];
    vx = __fadd_rn(vx, __fmul_rn(ax, s.dt));
    vy = __fadd_rn(vy, __fmul_rn(ay, s.dt));
    vz = __fadd_rn(vz, __fmul_rn(az, s.dt));
    attractor(p[0], p[1], p[2], vx, vy, vz, s, __ldg(k.params + P_DRAGGING));
    k.pos[i] = p[0]; k.pos[nn + i] = p[1]; k.pos[2 * nn + i] = p[2];
    k.vel[i] = vx; k.vel[nn + i] = vy; k.vel[2 * nn + i] = vz;
  }
}

}  // namespace

// pos: float32[3, n] planes; n_active: int32[1]; live: uint8[n] or NULL
// (NULL: i < n_active); masses: float32[n] or NULL (unit masses);
// box_min: float32[3]; cell: float32[1] (all on the device); hi: the
// clamp limit; periodic: 0/1; rho: float32[g, g, g], zeroed by the caller
// and 16-byte aligned; g^3 < 2^31.
PSIM_EXPORT int psim_pm_deposit(const float* pos, int n, const int* n_active,
                                const uint8_t* live, const float* masses,
                                const float* box_min, const float* cell,
                                int g, float hi, int periodic, float* rho,
                                cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(rho) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
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

// psim_pm_deposit for cell-sorted input (pm_deposit_kernel_sorted): the
// same arguments and the same sums for any order, fast on the persistent
// state's slots.
PSIM_EXPORT int psim_pm_deposit_sorted(const float* pos, int n,
                                       const int* n_active,
                                       const uint8_t* live,
                                       const float* masses,
                                       const float* box_min,
                                       const float* cell, int g, float hi,
                                       int periodic, float* rho,
                                       cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(rho) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long per_block = (long long)PM_BLOCK * PM_SORTED_ROUNDS;
  const int blocks = (int)((n + per_block - 1) / per_block);
  if (blocks > 0) {
    if (masses != nullptr) {
      pm_deposit_kernel_sorted<true><<<blocks, PM_BLOCK, 0, stream>>>(
          pos, n, n_active, live, masses, box_min, cell, g, hi, periodic,
          rho);
    } else {
      pm_deposit_kernel_sorted<false><<<blocks, PM_BLOCK, 0, stream>>>(
          pos, n, n_active, live, masses, box_min, cell, g, hi, periodic,
          rho);
    }
  }
  return (int)cudaGetLastError();
}

// grids: float32[channels, g, g, g] planes with channels 1 (a potential) or
// 3 (the acceleration components), or with interleaved = 1 the three
// acceleration grids as float32[g, g, g, 4], 16-byte aligned; out:
// float32[channels, n]; the rest as above.
PSIM_EXPORT int psim_pm_gather(const float* grids, int channels,
                               int interleaved, const float* pos, int n,
                               const int* n_active, const uint8_t* live,
                               const float* box_min, const float* cell, int g,
                               float hi, int periodic, float* out,
                               cudaStream_t stream) {
  if (channels != 1 && channels != 3) return (int)cudaErrorInvalidValue;
  if (interleaved && (channels != 3 ||
                      reinterpret_cast<uintptr_t>(grids) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + PM_BLOCK - 1) / PM_BLOCK;
  if (blocks > 0) {
    if (interleaved) {
      pm_gather_interleaved_kernel<false><<<blocks, PM_BLOCK, 0, stream>>>(
          reinterpret_cast<const float4*>(grids), pos, n, n_active, live,
          box_min, cell, g, hi, periodic, out, GatherKick{});
    } else if (channels == 3) {
      pm_gather_planar_kernel<3><<<blocks, PM_BLOCK, 0, stream>>>(
          grids, pos, n, n_active, live, box_min, cell, g, hi, periodic, out);
    } else {
      pm_gather_planar_kernel<1><<<blocks, PM_BLOCK, 0, stream>>>(
          grids, pos, n, n_active, live, box_min, cell, g, hi, periodic, out);
    }
  }
  return (int)cudaGetLastError();
}

// The PM step's tail from the interleaved grids, in one launch (the
// gather's kicked instance): the gather of psim_pm_gather with
// interleaved = 1 at pos, then a = (a - mean) * live, a = scale * a (scale
// = *scale_g, or *scale_g / (*scale_cell)^2 when scale_cell is given),
// vel += a * dt and one attractor step with params (float32[16]), pos and
// vel (float32[3, n] contiguous) updated in place; the same bits as
// psim_pm_gather, then psim_kick_step with the same mean. mean: float32[3];
// the rest as psim_pm_gather's; every pointer is device memory.
PSIM_EXPORT int psim_pm_gather_kick(const float* grids, float* pos,
                                    float* vel, int n, const int* n_active,
                                    const uint8_t* live,
                                    const float* box_min, const float* cell,
                                    int g, float hi, int periodic,
                                    const float* params, const float* mean,
                                    const float* scale_g,
                                    const float* scale_cell,
                                    cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(grids) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + PM_BLOCK - 1) / PM_BLOCK;
  if (blocks > 0) {
    pm_gather_interleaved_kernel<true><<<blocks, PM_BLOCK, 0, stream>>>(
        reinterpret_cast<const float4*>(grids), nullptr, n, n_active, live,
        box_min, cell, g, hi, periodic, nullptr,
        GatherKick{pos, vel, params, mean, scale_g, scale_cell});
  }
  return (int)cudaGetLastError();
}
