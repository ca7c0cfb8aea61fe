// Design probe of the radix sort (csrc/radix_sort.cu), built by
// tools/radix_variants.py into its own library: the package's kernels at
// 8-bit and 11-bit digits (and at the tile size, occupancy and look-back
// window the build's -D flags set), a pass kernel that prefetches the
// payloads (v1), and a gather of payload words by a sorted index, for the
// (key, index) variant.
#include "../csrc/radix_sort.cu"

namespace {

__device__ __forceinline__ void cp_async4(uint32_t* smem, const uint32_t* g) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t* smem,
                                           const uint32_t* g) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(g)
               : "memory");
}

// The tile's payload words, copied asynchronously into s_in[p - 1][pos]
// (16-byte copies where the word array is 16-byte aligned).
template <int NP>
__device__ __forceinline__ void prefetch_payloads(const Words& src,
                                                  long long base, int cnt,
                                                  uint32_t* s_in) {
#pragma unroll
  for (int p = 1; p <= NP; ++p) {
    const uint32_t* g = src.w[p] + base;
    uint32_t* s = s_in + (p - 1) * RS_TILE;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
      done = cnt & ~3;
      for (int c = threadIdx.x * 4; c < done; c += RS_THREADS * 4) {
        cp_async16(s + c, g + c);
      }
    }
    for (int i = done + threadIdx.x; i < cnt; i += RS_THREADS) {
      cp_async4(s + i, g + i);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int BITS, int NP>
constexpr size_t prefetch_smem() {
  return (1 + NP) * RS_TILE * sizeof(uint32_t) + rank_smem<BITS>() +
         RS_TILE * sizeof(uint16_t);
}

// v1: the payload words of a tile copied into shared memory by cp.async as
// the tile starts (overlapping the ranking and the look-back), then written
// from there at each key's staged position (one barrier for all words).
template <int BITS, int NP>
__global__ void __launch_bounds__(RS_THREADS)
    pass_kernel_prefetch(const PassArgs a) {
  using G = Digits<BITS>;
  constexpr int R = G::R;
  extern __shared__ uint4 smem_raw[];
  uint32_t* s_key = reinterpret_cast<uint32_t*>(smem_raw);  // [TILE]
  uint32_t* s_in = s_key + RS_TILE;  // [NP][TILE] payloads by position
  __shared__ uint32_t s_scan[RS_WARPS];
  __shared__ int s_tile;
  RankShared sh;
  sh.tx = s_in + NP * RS_TILE;
  sh.gb = sh.tx + R;
  sh.wh = reinterpret_cast<uint16_t*>(sh.gb + R);
  sh.scan = s_scan;
  uint16_t* s_src = sh.wh + RS_WARPS * R;  // [TILE] position of place r

  int k, j;
  pass_plan<BITS>(a.hist, a.n, a.digit, k, j);
  if (j < 0) {
    if (a.digit == G::D - 1 && k == 0) copy_words<NP>(a.in, a.out, a.n);
    return;
  }
  if (a.taken != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(a.taken, 1);
  }
  Words src, dst;
  pass_buffers(a, k, j, src, dst);
  const int tiles = (a.n + RS_TILE - 1) / RS_TILE;
  const int shift = a.digit * BITS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wbase = warp * 32 * RS_ITEMS;
  uint32_t hx[G::PER];
  global_base<BITS>(a, sh, hx);

  for (;;) {
    if (threadIdx.x == 0) s_tile = (int)atomicAdd(a.counter, 1u);
    for (int i = threadIdx.x; i < RS_WARPS * R / 2; i += RS_THREADS) {
      reinterpret_cast<uint32_t*>(sh.wh)[i] = 0u;
    }
    __syncthreads();
    const int tile = s_tile;
    if (tile >= tiles) break;
    const long long base = (long long)tile * RS_TILE;
    const int cnt = (int)min((long long)RS_TILE, a.n - base);
    // the payloads travel to shared memory while the keys are ranked
    prefetch_payloads<NP>(src, base, cnt, s_in);
    uint32_t key[RS_ITEMS];
    int rank[RS_ITEMS];
#pragma unroll
    for (int i = 0; i < RS_ITEMS; ++i) {
      const int pos = wbase + i * 32 + lane;
      key[i] = pos < cnt ? src.w[0][base + pos] ^ a.flip : 0u;
    }
    rank_tile<BITS>(key, rank, cnt, tile, hx, a, sh);
    // 4. stage the keys in digit order, each with its tile position
#pragma unroll
    for (int i = 0; i < RS_ITEMS; ++i) {
      const int pos = wbase + i * 32 + lane;
      if (pos < cnt) {
        s_key[rank[i]] = key[i];
        s_src[rank[i]] = (uint16_t)pos;
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    // 5. every word written in digit order: runs of consecutive indices
    int gidx[RS_ITEMS];
#pragma unroll
    for (int s = 0; s < RS_ITEMS; ++s) {
      const int r = s * RS_THREADS + threadIdx.x;
      gidx[s] = -1;
      if (r < cnt) {
        const uint32_t kk = s_key[r];
        gidx[s] = (int)sh.gb[(kk >> shift) & G::MASK] + r;
        dst.w[0][gidx[s]] = kk ^ a.flip;
      }
    }
#pragma unroll
    for (int p = 1; p <= NP; ++p) {
#pragma unroll
      for (int s = 0; s < RS_ITEMS; ++s) {
        if (gidx[s] >= 0) {
          dst.w[p][gidx[s]] =
              s_in[(p - 1) * RS_TILE + s_src[s * RS_THREADS + threadIdx.x]];
        }
      }
    }
    __syncthreads();
  }
}

template <int BITS, int NP>
struct PassKernelPrefetch {
  static constexpr size_t kSmem = prefetch_smem<BITS, NP>();
  static const void* fn() {
    return reinterpret_cast<const void*>(&pass_kernel_prefetch<BITS, NP>);
  }
  static void launch(int grid, cudaStream_t stream, const PassArgs& a) {
    pass_kernel_prefetch<BITS, NP><<<grid, RS_THREADS, kSmem, stream>>>(a);
  }
};

__global__ void gather_kernel(const uint32_t* __restrict__ idx, Words in,
                              Words out, int n, int n_pay) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const uint32_t j = idx[i];
    for (int p = 0; p < n_pay; ++p) out.w[p][i] = in.w[p][j];
  }
}

}  // namespace

PSIM_EXPORT int probe_hist(int bits, const uint32_t* kin, int n, int flip,
                           void* ws, long long ws_bytes,
                           cudaStream_t stream) {
  if (bits == 11) {
    return radix_hist_launch<11>(kin, n, (uint32_t)flip, ws, ws_bytes,
                                 stream);
  }
  return radix_hist_launch<8>(kin, n, (uint32_t)flip, ws, ws_bytes, stream);
}

// variant 1: the prefetching pass kernel; otherwise the package's
PSIM_EXPORT int probe_pass(int bits, int variant, const uint32_t* kin,
                           const uint32_t* p0, const uint32_t* p1,
                           const uint32_t* p2, uint32_t* kout, uint32_t* q0,
                           uint32_t* q1, uint32_t* q2, uint32_t* kscr,
                           uint32_t* s0, uint32_t* s1, uint32_t* s2, int n,
                           int digit, int n_pay, int flip, void* ws,
                           long long ws_bytes, cudaStream_t stream) {
#define PROBE_ARGS                                                        \
  kin, p0, p1, p2, kout, q0, q1, q2, kscr, s0, s1, s2, n, digit, n_pay, \
      flip, ws, ws_bytes, nullptr, stream
  if (variant == 1) {
    return bits == 11 ? radix_pass_launch<11, PassKernelPrefetch>(PROBE_ARGS)
                      : radix_pass_launch<8, PassKernelPrefetch>(PROBE_ARGS);
  }
  return bits == 11 ? radix_pass_launch<11>(PROBE_ARGS)
                    : radix_pass_launch<8>(PROBE_ARGS);
#undef PROBE_ARGS
}

// out_p[i] = in_p[idx[i]] for up to three words
PSIM_EXPORT int probe_gather(const uint32_t* idx, const uint32_t* p0,
                             const uint32_t* p1, const uint32_t* p2,
                             uint32_t* q0, uint32_t* q1, uint32_t* q2, int n,
                             int n_pay, cudaStream_t stream) {
  const Words in = {{const_cast<uint32_t*>(p0), const_cast<uint32_t*>(p1),
                     const_cast<uint32_t*>(p2), nullptr}};
  const Words out = {{q0, q1, q2, nullptr}};
  const int blocks = (int)std::min((n + 255LL) / 256, 132LL * 8);
  gather_kernel<<<blocks, 256, 0, stream>>>(idx, in, out, n, n_pay);
  return (int)cudaGetLastError();
}
