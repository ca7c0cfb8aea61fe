// Fused attractor step: one thread per particle over the SoA planes.
//
// Replaces particle_sim_tpu/ops/step_pallas.py:_kernel (the Pallas kernel
// built by _build, one fused attractor step with optional in-kernel
// substeps, written in place through input_output_aliases).
//
// What bounds it on the H100: device-memory bandwidth. A particle-step
// reads 6 floats and writes 6 (48 B) for about 30 flops and one rsqrt, far
// below the card's flop-per-byte balance. The design therefore does the
// least memory traffic the contract allows: each particle's six values are
// read once, stepped `substeps` times in registers, and written once in
// place over the same planes (so K substeps cost one round trip, as the
// TPU kernel's VMEM-resident substep loop did). Loads and stores of
// neighbouring threads hit neighbouring addresses in each plane.
//
// The kicked form (psim_kick_step, one step) is the tail of the
// interaction solvers (the single-level PM step on interleaved grids ends
// in csrc/pm.cu's kicked gather instead, which applies the same
// operations): it also reads an acceleration f32[3, n] and adds
// acc * dt to the velocity before the attractor (physics.py
// kick_and_step_planes). For the particle mesh it first applies the
// momentum clean and the acceleration's scale (the plain version:
// ops/pm.py momentum_clean, then g * acc):
//
//     a = (acc - mean) * live      (mean: csrc/momentum.cu's f32[3])
//     a = scale * a                (scale = g, or g / (cell * cell))
//     vel = vel + a * dt
//
// in that order, each operation rounded once. Reading the acceleration
// here costs 12 B a particle (13 with a live mask); the plain version's
// passes read and write f32[3, n] about eight times.
//
// The 16 parameters, the mean, the scale and the live count are read from
// device memory, never passed as host scalars: a parameter edit changes no
// launch argument, and the launch can later be captured in a CUDA graph.
//
// Numerics: the attractor (csrc/attractor.cuh, shared with the PM gather's
// kicked instance in csrc/pm.cu) transcribes ops/physics.py:attractor_step
// in the same order, each operation rounded once; so are the clean, the
// scale and the kick here.
#include "attractor.cuh"

namespace {

// What the kicked form reads besides the planes; a NULL pointer leaves its
// operation out.
struct Kick {
  const float* acc;        // f32[3, n]
  const float* mean;       // f32[3]: the clean (with live / n_active)
  const uint8_t* live;     // bool[n]; NULL: i < *n_active
  const int* n_active;
  const float* g;          // the scale: *g, or with cell *g / (cell^2)
  const float* cell;
};

template <bool KICK>
__global__ void __launch_bounds__(256) step_kernel(
    float* __restrict__ pos, float* __restrict__ vel,
    const float* __restrict__ params, int64_t n, int substeps, Kick k) {
  const StepScalars s = load_scalars(params);
  const float dragging = __ldg(params + P_DRAGGING);
  float m0 = 0.0f, m1 = 0.0f, m2 = 0.0f, scale = 1.0f;
  int64_t n_live = n;
  if (KICK) {
    if (k.mean != nullptr) {
      m0 = __ldg(k.mean);
      m1 = __ldg(k.mean + 1);
      m2 = __ldg(k.mean + 2);
      if (k.live == nullptr) n_live = (int64_t)__ldg(k.n_active);
    }
    if (k.g != nullptr) {
      scale = __ldg(k.g);
      if (k.cell != nullptr) {
        const float c = __ldg(k.cell);
        scale = __fdiv_rn(scale, __fmul_rn(c, c));
      }
    }
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float px = pos[i], py = pos[n + i], pz = pos[2 * n + i];
    float vx = vel[i], vy = vel[n + i], vz = vel[2 * n + i];
    if (KICK) {
      float ax = __ldg(k.acc + i), ay = __ldg(k.acc + n + i),
            az = __ldg(k.acc + 2 * n + i);
      if (k.mean != nullptr) {
        const bool on = k.live != nullptr ? k.live[i] != 0 : i < n_live;
        const float lv = on ? 1.0f : 0.0f;
        ax = __fmul_rn(__fsub_rn(ax, m0), lv);
        ay = __fmul_rn(__fsub_rn(ay, m1), lv);
        az = __fmul_rn(__fsub_rn(az, m2), lv);
      }
      if (k.g != nullptr) {
        ax = __fmul_rn(scale, ax);
        ay = __fmul_rn(scale, ay);
        az = __fmul_rn(scale, az);
      }
      vx = __fadd_rn(vx, __fmul_rn(ax, s.dt));
      vy = __fadd_rn(vy, __fmul_rn(ay, s.dt));
      vz = __fadd_rn(vz, __fmul_rn(az, s.dt));
    }
    for (int j = 0; j < substeps; ++j) {
      attractor(px, py, pz, vx, vy, vz, s, dragging);
    }
    pos[i] = px; pos[n + i] = py; pos[2 * n + i] = pz;
    vel[i] = vx; vel[n + i] = vy; vel[2 * n + i] = vz;
  }
}

// grid-stride: enough resident blocks to fill 132 SMs, no more
unsigned step_blocks(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t max_blocks = 132 * 16;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  return (unsigned)blocks;
}

}  // namespace

// pos, vel: float32[3, n] contiguous, updated in place.
// params:   float32[16] on the device (core/params.py slots).
PSIM_EXPORT int psim_step(float* pos, float* vel, const float* params,
                          int64_t n, int substeps, cudaStream_t stream) {
  const int threads = 256;
  step_kernel<false><<<step_blocks(n, threads), threads, 0, stream>>>(
      pos, vel, params, n, substeps, Kick{});
  return (int)cudaGetLastError();
}

// One step kicked by acc (float32[3, n] contiguous): vel += a * dt, then
// the attractor, in place. mean (float32[3]) or NULL: a = (acc - mean) *
// live first, live from `live` (bool[n]) or else i < *n_active (int32).
// g (float32) or NULL: a = scale * a, scale = *g, or *g / (*cell)^2 when
// cell is given. Every pointer is device memory.
PSIM_EXPORT int psim_kick_step(float* pos, float* vel, const float* params,
                               int64_t n, const float* acc, const float* mean,
                               const uint8_t* live, const int* n_active,
                               const float* g, const float* cell,
                               cudaStream_t stream) {
  const int threads = 256;
  step_kernel<true><<<step_blocks(n, threads), threads, 0, stream>>>(
      pos, vel, params, n, 1, Kick{acc, mean, live, n_active, g, cell});
  return (int)cudaGetLastError();
}
