// The attractor step of one particle, shared by the step kernel
// (csrc/step.cu) and the PM gather's kicked instance (csrc/pm.cu), so the
// two translation units step with one source.
//
// Numerics: the arithmetic transcribes ops/physics.py:attractor_step in the
// same order. Each multiply/add is an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn) so nvcc cannot contract a*b+c into an
// FMA; the plain PyTorch version evaluates one rounded operation per op,
// and this keeps the kernels on the same rounding. The reciprocal square
// root is rsqrtf, the same function torch.rsqrt evaluates on a CUDA tensor.
#pragma once

#include "common.cuh"

struct StepScalars {
  float dt, g_dt, damping, mx, my, mz, reach_sq, inv_reach, kick;
};

// The step's scalars from the packed parameter vector (core/params.py
// slots) in device memory.
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
