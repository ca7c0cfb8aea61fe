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
// The 16 parameters are read from a device tensor, never passed as host
// scalars: a parameter edit changes no launch argument, and the launch can
// later be captured in a CUDA graph.
//
// Numerics: the arithmetic transcribes ops/physics.py:attractor_step in the
// same order. Each multiply/add is an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn) so nvcc cannot contract a*b+c into an
// FMA; the plain PyTorch version evaluates one rounded operation per op,
// and this keeps the kernel on the same rounding. The reciprocal square
// root is rsqrtf, the same function torch.rsqrt evaluates on a CUDA tensor.
#include "common.cuh"

namespace {

struct StepScalars {
  float dt, g_dt, damping, mx, my, mz, reach_sq, inv_reach, kick;
};

__device__ __forceinline__ StepScalars load_scalars(const float* __restrict__ p) {
  StepScalars s;
  const float dt = __ldg(p + P_DT);
  const float reach = __fmul_rn(__ldg(p + P_MOUSE_RADIUS), 2.0f);
  s.dt = dt;
  s.g_dt = __fmul_rn(__ldg(p + P_GRAVITY), dt);
  s.damping = __ldg(p + P_DAMPING);
  s.mx = __ldg(p + P_MOUSE_X);
  s.my = __ldg(p + P_MOUSE_Y);
  s.mz = __ldg(p + P_MOUSE_Z);
  s.reach_sq = __fmul_rn(reach, reach);
  s.inv_reach = __fdiv_rn(1.0f, reach);
  s.kick = __fmul_rn(__fmul_rn(__ldg(p + P_MOUSE_FORCE), 2.0f), dt);
  return s;
}

__device__ __forceinline__ void attractor(
    float& px, float& py, float& pz, float& vx, float& vy, float& vz,
    const StepScalars& s, float dragging) {
  // 1. gravity (y only)
  vy = __fsub_rn(vy, s.g_dt);
  // 2. mouse attractor around one rsqrt
  const float dx = __fsub_rn(s.mx, px);
  const float dy = __fsub_rn(s.my, py);
  const float dz = __fsub_rn(s.mz, pz);
  const float dist_sq = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
  const float inv_dist = rsqrtf(fmaxf(dist_sq, 1e-24f));
  const float norm_dist = __fmul_rn(__fmul_rn(dist_sq, inv_dist), s.inv_reach);
  const float t = __fsub_rn(1.0f, norm_dist);
  const float within = __fmul_rn(dist_sq < s.reach_sq ? 1.0f : 0.0f, dragging);
  const float scale = __fmul_rn(
      __fmul_rn(__fmul_rn(__fmul_rn(within, s.kick), t), t), inv_dist);
  vx = __fadd_rn(vx, __fmul_rn(dx, scale));
  vy = __fadd_rn(vy, __fmul_rn(dy, scale));
  vz = __fadd_rn(vz, __fmul_rn(dz, scale));
  // 3. integrate position BEFORE damping
  px = __fadd_rn(px, __fmul_rn(vx, s.dt));
  py = __fadd_rn(py, __fmul_rn(vy, s.dt));
  pz = __fadd_rn(pz, __fmul_rn(vz, s.dt));
  // 4. damping
  vx = __fmul_rn(vx, s.damping);
  vy = __fmul_rn(vy, s.damping);
  vz = __fmul_rn(vz, s.damping);
}

__global__ void __launch_bounds__(256) step_kernel(
    float* __restrict__ pos, float* __restrict__ vel,
    const float* __restrict__ params, int64_t n, int substeps) {
  const StepScalars s = load_scalars(params);
  const float dragging = __ldg(params + P_DRAGGING);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float px = pos[i], py = pos[n + i], pz = pos[2 * n + i];
    float vx = vel[i], vy = vel[n + i], vz = vel[2 * n + i];
    for (int k = 0; k < substeps; ++k) {
      attractor(px, py, pz, vx, vy, vz, s, dragging);
    }
    pos[i] = px; pos[n + i] = py; pos[2 * n + i] = pz;
    vel[i] = vx; vel[n + i] = vy; vel[2 * n + i] = vz;
  }
}

}  // namespace

// pos, vel: float32[3, n] contiguous, updated in place.
// params:   float32[16] on the device (core/params.py slots).
PSIM_EXPORT int psim_step(float* pos, float* vel, const float* params,
                          int64_t n, int substeps, cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  // grid-stride: enough resident blocks to fill 132 SMs, no more
  const int64_t max_blocks = 132 * 16;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  step_kernel<<<(unsigned)blocks, threads, 0, stream>>>(pos, vel, params, n,
                                                        substeps);
  return (int)cudaGetLastError();
}
