// The isolated, exact-gradient Hockney solve around cuFFT: the zero pad,
// the spectral product and the crop-and-interleave as three hand-written
// kernels, and the four transforms as cuFFT plans in advanced layouts, so
// that each pass reads its input where the previous one left it.
//
// Replaces no TPU kernel: the JAX package leaves the solve to XLA's FFTs
// outside any kernel (particle_sim_tpu/ops/pm.py solve_accel). The port's
// plain version is ops/pm.py _solve_isolated on CPU tensors: rfftn of the
// (2G)^3 zero-padded density, the product with the three cached spectra
// K_c (c64[2G, 2G, G+1] each, [kz][ky][kx]), then _irfftn_octant_batch,
// which keeps the first octant of each inverse. This file computes the same
// transforms in full float32 precision, in the order (rho is f32[G, G, G],
// [z][y][x]; M = 2G (G + 1)):
//
//   pad       A[z][y][x] = rho[z][y][x] for y, x < G, in A f32[G][2G][2G]
//             whose zero part the wrapper wrote once;
//   F12       2D r2c over (y, x) of the G live z-planes of A -> the first G
//             slabs of B c64[2G][2G][G+1], whose upper G slabs stay zero;
//   F3        c2c along z over all M columns of B -> R c64[2G][2G][G+1], the
//             rfftn of the padded density;
//   product   P[kz][c][ky][kx] = R[kz][ky][kx] * K_c[kz][ky][kx]: R and the
//             spectra read once, the three products written where the next
//             pass reads them;
//   I1        c2c inverse along z over the 3M columns of P, in place;
//   I23       2D c2r over (y, x) of the 3G planes (z < G, c) of P -> Rr
//             f32[G][3][2G][2G];
//   crop      out[z][y][x] = (Rr[z][0][y][x], Rr[z][1][y][x], Rr[z][2][y][x],
//             0) / (2G)^3 for y, x < G: one 16-byte store a cell, the
//             interleaved f32[G, G, G, 4] layout the gather kernel reads
//             (ops/pm.py interleaved_view).
//
// The pass order prunes the forward transform: the x and y transforms run
// over the G live z-planes (2G^2 rows and G (G + 1) columns, where the full
// rfftn takes 4G^2 and 2G (G + 1)); only z runs over every column. A 2D
// plan also transforms the G zero rows of each plane: with one batch
// stride a plan, separate 1D x and y passes could not leave the spectrum
// in the [kz][ky][kx] order of the cached spectra without a copy.
// The plans' strides are built in ops/pm_fft.py (plan_specs), where a CPU
// test replays them.
//
// What bounds the solve on the H100: device-memory bandwidth. Counting each
// pass's input read once and its output written once (a 2D pass as one), a
// G = 128 solve moves 1.36 GB: 0.41 ms at 3.35 TB/s (ops/pm_fft.py
// solve_bytes). The product is a third of it: it reads 4 x 67.6 MB and
// writes 3 x 67.6 MB.
#include <cufft.h>

#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int FFT_THREADS = 256;
constexpr int ROW_THREADS = 128;

// rho f32[g][g][g] -> the live octant of a f32[g][2g][2g]; grid (g * g,
// ceil(g / 128)), a block a part of one (z, y) row.
__global__ void __launch_bounds__(ROW_THREADS) pm_solve_pad_kernel(
    const float* __restrict__ rho, float* __restrict__ a, int g) {
  const int x = blockIdx.y * ROW_THREADS + threadIdx.x;
  if (x >= g) return;
  const int64_t row = blockIdx.x;  // z * g + y
  const int64_t z = row / g, y = row - z * g;
  a[(z * 2 * g + y) * 2 * g + x] = __ldg(rho + row * g + x);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// p[kz][c][r] = rhat[kz][r] * k_c[kz][r] over r < m; two complex values a
// thread (m is even); grid (ceil(m / 512), 2g).
__global__ void __launch_bounds__(FFT_THREADS) pm_fft_product_kernel(
    const float4* __restrict__ rhat, const float4* __restrict__ k0,
    const float4* __restrict__ k1, const float4* __restrict__ k2,
    float4* __restrict__ p, int64_t m) {
  const int64_t pairs = m / 2;
  const int64_t r = (int64_t)blockIdx.x * FFT_THREADS + threadIdx.x;
  if (r >= pairs) return;
  const int64_t kz = blockIdx.y;
  const int64_t j = kz * pairs + r;
  const float4 a = __ldcs(rhat + j);
  const float4* ks[3] = {k0, k1, k2};
  float4* out = p + kz * 3 * pairs + r;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float4 k = __ldcs(ks[c] + j);
    const float2 lo = cmul(make_float2(a.x, a.y), make_float2(k.x, k.y));
    const float2 hi = cmul(make_float2(a.z, a.w), make_float2(k.z, k.w));
    out[c * pairs] = make_float4(lo.x, lo.y, hi.x, hi.y);
  }
}

// rr f32[g][3][2g][2g] -> out f32[g][g][g][4], scaled; grid (g * g,
// ceil(g / 128)), a block a part of one (z, y) row.
__global__ void __launch_bounds__(ROW_THREADS) pm_solve_interleave_kernel(
    const float* __restrict__ rr, float4* __restrict__ out, int g,
    float scale) {
  const int x = blockIdx.y * ROW_THREADS + threadIdx.x;
  if (x >= g) return;
  const int64_t row = blockIdx.x;  // z * g + y
  const int64_t z = row / g, y = row - z * g;
  const int64_t plane = 4 * (int64_t)g * g;
  const float* src = rr + z * 3 * plane + y * 2 * g + x;
  out[row * g + x] = make_float4(__ldcs(src) * scale,
                                 __ldcs(src + plane) * scale,
                                 __ldcs(src + 2 * plane) * scale, 0.0f);
}

// A cuFFT status as this file's return code: 0, or 1000 + the status.
inline int fft_status(cufftResult r) {
  return r == CUFFT_SUCCESS ? 0 : 1000 + (int)r;
}

}  // namespace

// A cuFFT plan of ``rank`` (1 or 2) dimensions ``n`` in the advanced layout
// (inembed, istride, idist; onembed, ostride, odist), of ``type`` 0 r2c, 1
// c2c, 2 c2r, over ``batch`` transforms, made on the current device, with
// no work area of its own: the caller allocates ``*work`` bytes and
// psim_pm_solve hands them to the plan. -> 0 and the handle in ``*plan``,
// or 1000 + the cuFFT status.
PSIM_EXPORT int psim_fft_plan(int rank, const long long* n,
                              const long long* inembed, long long istride,
                              long long idist, const long long* onembed,
                              long long ostride, long long odist, int type,
                              long long batch, int* plan,
                              unsigned long long* work) {
  static const cufftType types[3] = {CUFFT_R2C, CUFFT_C2C, CUFFT_C2R};
  if (type < 0 || type > 2 || rank < 1 || rank > 2)
    return fft_status(CUFFT_INVALID_VALUE);
  long long nn[2], in[2], on[2];
  for (int i = 0; i < rank; ++i) {
    nn[i] = n[i];
    in[i] = inembed[i];
    on[i] = onembed[i];
  }
  cufftHandle h;
  int err = fft_status(cufftCreate(&h));
  if (err) return err;
  size_t size = 0;
  err = fft_status(cufftSetAutoAllocation(h, 0));
  if (!err)
    err = fft_status(cufftMakePlanMany64(h, rank, nn, in, istride, idist, on,
                                         ostride, odist, types[type], batch,
                                         &size));
  if (err) {
    cufftDestroy(h);
    return err;
  }
  *plan = (int)h;
  *work = size;
  return 0;
}

// Destroys a plan of psim_fft_plan. -> 0, or 1000 + the cuFFT status.
PSIM_EXPORT int psim_fft_destroy(int plan) {
  return fft_status(cufftDestroy((cufftHandle)plan));
}

// The solve of rho (f32[g][g][g]) with the spectra k0, k1, k2
// (c64[2g][2g][g+1] each) into out (f32[g][g][g][4]), on ``stream``.
// Scratch from the wrapper: a f32[g][2g][2g] and b c64[2g][2g][g+1], zero
// outside what the passes write; rhat c64[2g][2g][g+1]; p c64[2g][3][2g][g+1];
// rr f32[g][3][2g][2g]; work, the plans' work area (the largest of their
// sizes: they run one after the other). plans: F12, F3, I1, I23 of
// psim_fft_plan, made for this g. scale: 1 / (2g)^3. -> 0, a CUDA error
// code, or 1000 + a cuFFT status.
PSIM_EXPORT int psim_pm_solve(const float* rho, int g, const void* k0,
                              const void* k1, const void* k2, float* a,
                              void* b, void* rhat, void* p, float* rr,
                              void* work, float* out, int plan_f12,
                              int plan_f3, int plan_i1, int plan_i23,
                              float scale, cudaStream_t stream) {
  for (const void* q : {k0, k1, k2, (const void*)rhat, (const void*)p,
                        (const void*)out}) {
    if (reinterpret_cast<uintptr_t>(q) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  }
  const int64_t m = 2 * (int64_t)g * (g + 1);
  const dim3 rows((unsigned)(g * g), (unsigned)((g + ROW_THREADS - 1) /
                                                ROW_THREADS));
  pm_solve_pad_kernel<<<rows, ROW_THREADS, 0, stream>>>(rho, a, g);
  int err = (int)cudaGetLastError();
  if (err) return err;
  for (int h : {plan_f12, plan_f3, plan_i1, plan_i23}) {
    err = fft_status(cufftSetStream((cufftHandle)h, stream));
    if (!err) err = fft_status(cufftSetWorkArea((cufftHandle)h, work));
    if (err) return err;
  }
  auto* bc = static_cast<cufftComplex*>(b);
  auto* rc = static_cast<cufftComplex*>(rhat);
  auto* pc = static_cast<cufftComplex*>(p);
  err = fft_status(cufftExecR2C((cufftHandle)plan_f12, a, bc));
  if (err) return err;
  err = fft_status(cufftExecC2C((cufftHandle)plan_f3, bc, rc, CUFFT_FORWARD));
  if (err) return err;
  const dim3 prod((unsigned)((m / 2 + FFT_THREADS - 1) / FFT_THREADS),
                  (unsigned)(2 * g));
  pm_fft_product_kernel<<<prod, FFT_THREADS, 0, stream>>>(
      static_cast<const float4*>(rhat), static_cast<const float4*>(k0),
      static_cast<const float4*>(k1), static_cast<const float4*>(k2),
      static_cast<float4*>(p), m);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = fft_status(cufftExecC2C((cufftHandle)plan_i1, pc, pc, CUFFT_INVERSE));
  if (err) return err;
  err = fft_status(cufftExecC2R((cufftHandle)plan_i23, pc, rr));
  if (err) return err;
  pm_solve_interleave_kernel<<<rows, ROW_THREADS, 0, stream>>>(
      rr, reinterpret_cast<float4*>(out), g, scale);
  return (int)cudaGetLastError();
}
