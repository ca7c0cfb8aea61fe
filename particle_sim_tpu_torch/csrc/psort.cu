// Merge sort of 1-D 32-bit keys with up to three 32-bit payloads: a block
// sort of SEG-element tiles, then merge rounds of sorted runs L -> 2L.
//
// Replaces particle_sim_tpu/ops/psort.py:_block_sort_kernel (a bitonic
// sort of each 32,768-element block, VMEM-resident) and
// particle_sim_tpu/ops/psort.py:_round_kernel (one merge-path round, its
// windows found by _partitions, ~34 dependent XLA launches a round).
//
// Keys. The kernels compare keys as unsigned 32-bit words after an XOR
// with `flip` (0 for uint32 keys, 0x80000000 for int32 keys, whose signed
// order is then the unsigned one), applied at every load and undone at
// every store, so each launch takes and returns keys of the caller's type.
//
// What bounds it on the H100: bytes. Each launch reads every word once and
// writes it once (3.35 TB/s: 2 x 4 bytes x words x n a launch); the sort
// makes 1 + ceil(log2(n / SEG)) launches. The block sort also does
// log2(SEG) (log2(SEG) + 1) / 2 = 66 shared-memory compare-exchange stages
// a tile, and each merge block two binary searches in device memory
// (~log2(L) dependent loads).
//
// Design.
//   * Block sort: one block sorts one SEG = 2,048-element tile in shared
//     memory. It sorts 64-bit words (key << 32 | position in the tile), so
//     every word is unique: the bitonic network gives one order whatever
//     its schedule, ties keep their input order, and the payloads move
//     once, at the end, gathered by the position. A ragged last tile is
//     padded with (0xFFFFFFFF << 32 | position >= count): after every real
//     key, the key maximum included, so real payloads are never swapped
//     with padding (psort.py's "invalid" flag, _merge_stage).
//   * Merge round: the runs [2pL, 2pL + L) and [2pL + L, 2pL + 2L) (the
//     last ones may be short or missing) merge into [2pL, 2pL + 2L). Block
//     b writes the output tile [b SEG, (b + 1) SEG), which lies in one pair
//     because 2L is a multiple of SEG. Two threads (of two warps) find the
//     tile's merge-path splits by binary search in device memory: this
//     replaces _partitions' launches. The block loads its two windows (at
//     most SEG words together, every word once, coalesced) into shared
//     memory; each thread finds its own 8-output split there and merges 8
//     outputs sequentially, recording where each came from; the block then
//     writes keys and payloads coalesced. Ties take A (the earlier run)
//     first.
//   * Both kernels preserve the input order of equal keys, so the whole
//     sort is stable (the JAX function's contract does not promise it).
//   * Any length n >= 1: the TPU tiling's limits (a multiple of SEG, a
//     power of two of blocks) do not apply.
#include "common.cuh"

#define PS_SEG 2048
#define PS_SORT_THREADS 512
#define PS_MERGE_THREADS 256
#define PS_ITEMS (PS_SEG / PS_MERGE_THREADS)

namespace {

struct Payloads {
  const uint32_t* in[3];
  uint32_t* out[3];
};

template <int NP>
__global__ void __launch_bounds__(PS_SORT_THREADS) block_sort_kernel(
    const uint32_t* __restrict__ kin, uint32_t* __restrict__ kout,
    Payloads pw, int n, uint32_t flip) {
  __shared__ unsigned long long s_key[PS_SEG];
  __shared__ uint32_t s_pay[NP > 0 ? NP : 1][PS_SEG];
  const int base = blockIdx.x * PS_SEG;
  const int cnt = min(PS_SEG, n - base);
  for (int i = threadIdx.x; i < PS_SEG; i += PS_SORT_THREADS) {
    unsigned long long k = (0xFFFFFFFFull << 32) | (unsigned)i;
    if (i < cnt) {
      k = ((unsigned long long)(kin[base + i] ^ flip) << 32) | (unsigned)i;
#pragma unroll
      for (int p = 0; p < NP; ++p) s_pay[p][i] = pw.in[p][base + i];
    }
    s_key[i] = k;
  }
  __syncthreads();
  for (int size = 2; size <= PS_SEG; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int c = threadIdx.x; c < PS_SEG / 2; c += PS_SORT_THREADS) {
        const int lo = ((c & ~(stride - 1)) << 1) | (c & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const unsigned long long a = s_key[lo], b = s_key[hi];
        if ((a > b) == up) {
          s_key[lo] = b;
          s_key[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < cnt; i += PS_SORT_THREADS) {
    const unsigned long long k = s_key[i];
    kout[base + i] = (uint32_t)(k >> 32) ^ flip;
    const int src = (int)(k & 0xFFFFu);
#pragma unroll
    for (int p = 0; p < NP; ++p) pw.out[p][base + i] = s_pay[p][src];
  }
}

// Number of A's elements among the first `diag` outputs of the merge of
// the sorted a[0, na) and b[0, nb), ties taking A first.
__device__ __forceinline__ int merge_path(const uint32_t* a, int na,
                                          const uint32_t* b, int nb,
                                          int diag, uint32_t flip) {
  int lo = max(0, diag - nb), hi = min(diag, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((a[mid] ^ flip) <= (b[diag - 1 - mid] ^ flip)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <int NP>
__global__ void __launch_bounds__(PS_MERGE_THREADS) merge_kernel(
    const uint32_t* __restrict__ kin, uint32_t* __restrict__ kout,
    Payloads pw, int n, int run, uint32_t flip) {
  __shared__ uint32_t s_key[PS_SEG];
  __shared__ uint32_t s_pay[NP > 0 ? NP : 1][PS_SEG];
  __shared__ uint16_t s_src[PS_SEG];
  __shared__ int s_split[2];
  const long long g0 = (long long)blockIdx.x * PS_SEG;
  const long long base = g0 / (2LL * run) * (2LL * run);
  const int na = (int)min((long long)run, n - base);
  const int nb = (int)max(0LL, min((long long)run, n - base - run));
  const uint32_t* a = kin + base;
  const uint32_t* b = a + run;
  const int d0 = (int)(g0 - base);
  const int d1 = min(d0 + PS_SEG, na + nb);
  if (threadIdx.x == 0) s_split[0] = merge_path(a, na, b, nb, d0, flip);
  if (threadIdx.x == 32) s_split[1] = merge_path(a, na, b, nb, d1, flip);
  __syncthreads();
  const int a0 = s_split[0], b0 = d0 - a0;
  const int ma = s_split[1] - a0, m = d1 - d0, mb = m - ma;
  for (int i = threadIdx.x; i < m; i += PS_MERGE_THREADS) {
    const long long src = i < ma ? base + a0 + i : base + run + b0 + (i - ma);
    s_key[i] = kin[src] ^ flip;
#pragma unroll
    for (int p = 0; p < NP; ++p) s_pay[p][i] = pw.in[p][src];
  }
  __syncthreads();
  const int diag = threadIdx.x * PS_ITEMS;
  if (diag < m) {
    int ia = merge_path(s_key, ma, s_key + ma, mb, diag, 0u);
    int ib = diag - ia;
    for (int k = 0; k < PS_ITEMS && diag + k < m; ++k) {
      const bool take_a =
          ib >= mb || (ia < ma && s_key[ia] <= s_key[ma + ib]);
      s_src[diag + k] = (uint16_t)(take_a ? ia++ : ma + ib++);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += PS_MERGE_THREADS) {
    const int s = s_src[i];
    kout[g0 + i] = s_key[s] ^ flip;
#pragma unroll
    for (int p = 0; p < NP; ++p) pw.out[p][g0 + i] = s_pay[p][s];
  }
}

}  // namespace

// keys: uint32/int32[n] in and out (flip: 0 for uint32, INT_MIN for
// int32); p*: up to three 32-bit payload words [n] in and out (NULL past
// n_pay). Sorts each SEG-element tile; the outputs must not alias the
// inputs.
PSIM_EXPORT int psim_block_sort(const uint32_t* kin, const uint32_t* p0,
                                const uint32_t* p1, const uint32_t* p2,
                                uint32_t* kout, uint32_t* q0, uint32_t* q1,
                                uint32_t* q2, int n, int n_pay, int flip,
                                cudaStream_t stream) {
  const Payloads pw = {{p0, p1, p2}, {q0, q1, q2}};
  const int blocks = (n + PS_SEG - 1) / PS_SEG;
  const uint32_t f = (uint32_t)flip;
  if (blocks <= 0) return (int)cudaGetLastError();
  switch (n_pay) {
    case 0:
      block_sort_kernel<0><<<blocks, PS_SORT_THREADS, 0, stream>>>(
          kin, kout, pw, n, f);
      break;
    case 1:
      block_sort_kernel<1><<<blocks, PS_SORT_THREADS, 0, stream>>>(
          kin, kout, pw, n, f);
      break;
    case 2:
      block_sort_kernel<2><<<blocks, PS_SORT_THREADS, 0, stream>>>(
          kin, kout, pw, n, f);
      break;
    case 3:
      block_sort_kernel<3><<<blocks, PS_SORT_THREADS, 0, stream>>>(
          kin, kout, pw, n, f);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The same words; merges the sorted runs of length `run` (a multiple of
// SEG) pairwise into runs of 2 run.
PSIM_EXPORT int psim_merge_round(const uint32_t* kin, const uint32_t* p0,
                                 const uint32_t* p1, const uint32_t* p2,
                                 uint32_t* kout, uint32_t* q0, uint32_t* q1,
                                 uint32_t* q2, int n, int run, int n_pay,
                                 int flip, cudaStream_t stream) {
  const Payloads pw = {{p0, p1, p2}, {q0, q1, q2}};
  const int blocks = (n + PS_SEG - 1) / PS_SEG;
  const uint32_t f = (uint32_t)flip;
  if (run <= 0 || run % PS_SEG) return (int)cudaErrorInvalidValue;
  if (blocks <= 0) return (int)cudaGetLastError();
  switch (n_pay) {
    case 0:
      merge_kernel<0><<<blocks, PS_MERGE_THREADS, 0, stream>>>(
          kin, kout, pw, n, run, f);
      break;
    case 1:
      merge_kernel<1><<<blocks, PS_MERGE_THREADS, 0, stream>>>(
          kin, kout, pw, n, run, f);
      break;
    case 2:
      merge_kernel<2><<<blocks, PS_MERGE_THREADS, 0, stream>>>(
          kin, kout, pw, n, run, f);
      break;
    case 3:
      merge_kernel<3><<<blocks, PS_MERGE_THREADS, 0, stream>>>(
          kin, kout, pw, n, run, f);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
