// Stable LSD radix sort of 1-D 32-bit keys with up to three 32-bit payloads:
// one histogram kernel for every digit at once, then one scatter kernel a
// digit in the Onesweep form (Adinets & Merrill, 2022).
//
// Replaces, as one function, particle_sim_tpu/ops/psort.py:
// _block_sort_kernel (a bitonic sort of each 32,768-element block) and
// _round_kernel (one merge-path round), which psort.sort chains; the merge
// sort's own port (csrc/psort.cu) stays beside it as the earlier design.
//
// Keys. The kernels see keys as unsigned 32-bit words after an XOR with
// `flip` (0 for uint32 keys, 0x80000000 for int32 keys, whose signed order
// is then the unsigned one), applied at every load and undone at every
// store. Digits are RS_BITS wide, from the least significant up.
//
// What bounds it on the H100: bytes. The histogram reads the keys once
// (4 n bytes); each pass taken reads and writes every word once
// (2 x 4 x words x n bytes). The PM cell keys and raster tile keys have 22
// significant bits: 3 passes of 8 bits, so at 16M x 3 words 1.27 GB,
// 0.38 ms at 3.35 TB/s, against the merge sort's 14 launches (1.68 ms).
//
// Design.
//   * Plan on the device. The histogram kernel builds the global count of
//     every digit value at once (per-warp copies in shared memory, shared
//     atomics). A digit whose count puts
//     all n keys in one bin is skipped: every pass kernel reads the counts,
//     so a skipped pass returns at once and no host read is needed. Each
//     pass taken picks its source and destination on the device: the
//     input, the caller's output, or one scratch set, alternating so that
//     the last pass taken lands in the output. When no pass is taken (all
//     keys equal) the last pass kernel copies the input to the output.
//   * One scatter kernel a pass. Persistent blocks take tiles of 4,096
//     keys from an atomic counter, so tiles are handed out in order and a
//     block only ever waits on tiles that running blocks hold. As a tile
//     starts, its payload words are copied into shared memory by cp.async,
//     so their loads overlap steps 1-3.
//     1. Stable ranking within the warp: warp w ranks its 512 keys item by
//        item; lanes of one digit value find each other with
//        __match_any_sync and take consecutive ranks after the warp's
//        running count of that value (a 16-bit counter a value and warp in
//        shared memory).
//     2. The counts are scanned across warps; the tile publishes its count
//        of every digit value and scans them across values.
//     3. Decoupled look-back: for each value the tile walks back over
//        earlier tiles until one has published its inclusive prefix, then
//        publishes its own. A status word is 64 bits: a 2-bit flag and a
//        62-bit count (a 30-bit count, as in Onesweep's 32-bit word, would
//        cap n at 2^30; the contract goes to 2^31 - 2,048). The base is the
//        exclusive scan of the global count.
//     4. The keys are staged in shared memory in digit order, each with its
//        tile position.
//     5. The keys, then each payload (read from shared memory at the staged
//        position), are written in digit order, so the stores to device
//        memory come out as runs of consecutive indices.
//   * Workspace (the caller allocates it, one memset at the histogram
//     launch zeroes it): the status words of every pass, the global
//     counts, one tile counter a pass.
//   * Build-time settings (-D): RS_ITEMS (keys a thread, 16), RS_MIN_BLOCKS
//     (the pass's __launch_bounds__ blocks, 1), RS_LOOKBACK (earlier tiles
//     a look-back step reads at once, 1), RS_HIST_BLOCKS (histogram blocks
//     an SM, 4), RS_HIST_UNIFORM (a one-value warp adds 32 in one atomic,
//     off). The defaults are the fastest that
//     particle_sim_tpu_torch/tools/radix_variants.py measured.
#include <algorithm>

#include "common.cuh"

#ifndef RS_BITS
#define RS_BITS 8
#endif
#define RS_THREADS 256
#define RS_WARPS (RS_THREADS / 32)
#ifndef RS_ITEMS
#define RS_ITEMS 16  // keys a thread: tiles of 4,096
#endif
#define RS_TILE (RS_THREADS * RS_ITEMS)
#ifndef RS_MIN_BLOCKS
#define RS_MIN_BLOCKS 1  // __launch_bounds__ blocks an SM of the pass
#endif
#ifndef RS_LOOKBACK
#define RS_LOOKBACK 1  // earlier tiles a look-back step reads at once
#endif
#define RS_HIST_ITEMS 16
#ifndef RS_HIST_BLOCKS
#define RS_HIST_BLOCKS 4  // histogram blocks an SM at most
#endif
#ifndef RS_HIST_UNIFORM
#define RS_HIST_UNIFORM 0  // 1: a warp whose lanes hold one value adds 32
#endif
#define RS_FULL 0xFFFFFFFFu
// look-back status word: flag in the top 2 bits, count below
#define RS_FLAG_AGG (1ull << 62)  // the tile's own count
#define RS_FLAG_INC (2ull << 62)  // the inclusive prefix through the tile
#define RS_COUNT_MASK ((1ull << 62) - 1)

namespace {

template <int BITS>
struct Digits {
  static constexpr int D = (32 + BITS - 1) / BITS;  // digits a key
  static constexpr int R = 1 << BITS;               // values a digit
  static constexpr uint32_t MASK = R - 1;
  static constexpr int PER = R / RS_THREADS;        // values a thread owns
  static_assert(R % RS_THREADS == 0, "digit values a multiple of threads");
};

template <int BITS>
long long status_bytes(int n) {
  const long long tiles = (n + RS_TILE - 1) / RS_TILE;
  return (long long)Digits<BITS>::D * tiles * Digits<BITS>::R * 8;
}

// status words, then the global counts [D][R], then one tile counter a pass
template <int BITS>
long long workspace_bytes(int n) {
  return status_bytes<BITS>(n) + 4LL * Digits<BITS>::D * Digits<BITS>::R +
         4LL * Digits<BITS>::D;
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

struct Words {
  uint32_t* w[4];  // key, then up to three payloads
};

template <int BITS>
__global__ void __launch_bounds__(RS_THREADS) radix_hist_kernel(
    const uint32_t* __restrict__ kin, int n, uint32_t flip,
    uint32_t* __restrict__ hist) {
  using G = Digits<BITS>;
  constexpr int COPIES = BITS <= 8 ? RS_WARPS : 1;  // 32 KB / 24 KB
  __shared__ uint32_t s_h[COPIES * G::D * G::R];
  for (int j = threadIdx.x; j < COPIES * G::D * G::R; j += RS_THREADS) {
    s_h[j] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  uint32_t* mine = s_h + ((threadIdx.x >> 5) % COPIES) * (G::D * G::R);
  const long long step = (long long)gridDim.x * RS_THREADS * RS_HIST_ITEMS;
  for (long long b0 = (long long)blockIdx.x * RS_THREADS * RS_HIST_ITEMS;
       b0 < n; b0 += step) {
    uint32_t k[RS_HIST_ITEMS];
    bool v[RS_HIST_ITEMS];
#pragma unroll
    for (int q = 0; q < RS_HIST_ITEMS; ++q) {
      const long long i = b0 + q * RS_THREADS + threadIdx.x;
      v[q] = i < n;
      k[q] = v[q] ? kin[i] ^ flip : 0u;
    }
#pragma unroll
    for (int q = 0; q < RS_HIST_ITEMS; ++q) {
#pragma unroll
      for (int d = 0; d < G::D; ++d) {
        const uint32_t bin = (k[q] >> (d * BITS)) & G::MASK;
        if (RS_HIST_UNIFORM) {
          const uint32_t bin0 = __shfl_sync(RS_FULL, bin, 0);
          if (__all_sync(RS_FULL, v[q] && bin == bin0)) {
            if (lane == 0) atomicAdd(mine + d * G::R + bin0, 32u);
            continue;
          }
        }
        if (v[q]) atomicAdd(mine + d * G::R + bin, 1u);
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < G::D * G::R; j += RS_THREADS) {
    uint32_t s = 0;
#pragma unroll
    for (int c = 0; c < COPIES; ++c) s += s_h[c * G::D * G::R + j];
    if (s) atomicAdd(hist + j, s);
  }
}

// Exclusive scan, in place, of a[RS_THREADS * PER] in shared memory; thread
// t owns a[t * PER, (t + 1) * PER). Every thread of the block calls it.
template <int PER>
__device__ void block_excl_scan(uint32_t* a, uint32_t* s_warp) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint32_t v[PER], sum = 0;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    v[q] = a[t * PER + q];
    sum += v[q];
  }
  uint32_t x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(RS_FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = lane < RS_WARPS ? s_warp[lane] : 0u;
    uint32_t wx = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(RS_FULL, wx, o);
      if (lane >= o) wx += y;
    }
    if (lane < RS_WARPS) s_warp[lane] = wx - w;
  }
  __syncthreads();
  uint32_t run = s_warp[warp] + x - sum;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    a[t * PER + q] = run;
    run += v[q];
  }
  __syncthreads();
}

// The plan, read by every pass block from the global counts: passes taken
// k, and this digit's place j among them (-1: skipped, every key has the
// same value of this digit). Every thread of the block calls it.
template <int BITS>
__device__ __forceinline__ void pass_plan(const uint32_t* hist, int n,
                                          int digit, int& k, int& j) {
  using G = Digits<BITS>;
  k = 0;
  j = -1;
  for (int dd = 0; dd < G::D; ++dd) {
    bool one_bin = false;
    for (int b = threadIdx.x; b < G::R; b += RS_THREADS) {
      one_bin |= hist[dd * G::R + b] == (uint32_t)n;
    }
    if (!__syncthreads_or(one_bin)) {
      if (dd == digit) j = k;
      ++k;
    }
  }
}

// The input words copied to the output (no pass taken: all keys equal).
template <int NP>
__device__ void copy_words(const Words& in, const Words& out, int n) {
  for (long long i = (long long)blockIdx.x * RS_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * RS_THREADS) {
#pragma unroll
    for (int p = 0; p <= NP; ++p) out.w[p][i] = in.w[p][i];
  }
}

// Arguments of one pass kernel.
struct PassArgs {
  Words in, out, scr;  // pass j reads in (j = 0) or the previous buffer
  int n, digit;
  uint32_t flip;
  const uint32_t* hist;        // [D][R] global counts
  unsigned long long* status;  // [tiles][R] this digit's look-back words
  uint32_t* counter;           // this digit's tile counter
  int* taken;                  // passes that ran (may be NULL)
};

// Shared memory of the ranking.
struct RankShared {
  uint32_t* tx;    // [R] the tile's count of each digit value, then its scan
  uint32_t* gb;    // [R] the global scan, then output index bases
  uint16_t* wh;    // [WARPS][R] each warp's counts, then its offsets
  uint32_t* scan;  // [WARPS] block-scan scratch
};

template <int BITS>
constexpr size_t rank_smem() {
  return 2 * Digits<BITS>::R * sizeof(uint32_t) +
         RS_WARPS * Digits<BITS>::R * sizeof(uint16_t);
}

// The pass's source and destination for its place j of k passes: pass j
// writes the output when k - 1 - j is even, else the scratch, so the last
// pass taken lands in the output.
__device__ __forceinline__ void pass_buffers(const PassArgs& a, int k, int j,
                                             Words& src, Words& dst) {
  dst = ((k - 1 - j) & 1) ? a.scr : a.out;
  src = j == 0 ? a.in : (((k - j) & 1) ? a.scr : a.out);
}

// The exclusive scan of this digit's global counts, every tile's base:
// thread t keeps values [t PER, (t + 1) PER) in hx.
template <int BITS>
__device__ __forceinline__ void global_base(const PassArgs& a,
                                            const RankShared& sh,
                                            uint32_t* hx) {
  constexpr int PER = Digits<BITS>::PER, R = Digits<BITS>::R;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    sh.gb[threadIdx.x * PER + q] = a.hist[a.digit * R + threadIdx.x * PER + q];
  }
  block_excl_scan<PER>(sh.gb, sh.scan);
#pragma unroll
  for (int q = 0; q < PER; ++q) hx[q] = sh.gb[threadIdx.x * PER + q];
}

// Ranks one tile's keys (item i of lane l of warp w at tile position
// w * 32 * ITEMS + 32 i + l; positions >= cnt are padding): on return
// rank[i] is the key's place in the tile's stable digit order, and the
// key staged there goes to device index gb[digit] + place. sh.wh must be
// zero on entry. Steps 1-3 of the module note.
template <int BITS>
__device__ __forceinline__ void rank_tile(const uint32_t* key, int* rank,
                                          int cnt, int tile,
                                          const uint32_t* hx,
                                          const PassArgs& a,
                                          const RankShared& sh) {
  using G = Digits<BITS>;
  constexpr int R = G::R, PER = G::PER;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lane_lt = (1u << lane) - 1u;
  const int wbase = warp * 32 * RS_ITEMS;
  const int shift = a.digit * BITS;
  // 1. within the warp: lanes of one value take consecutive ranks after
  // the warp's running count of that value
#pragma unroll
  for (int i = 0; i < RS_ITEMS; ++i) {
    const bool valid = wbase + i * 32 + lane < cnt;
    const uint32_t d = valid ? (key[i] >> shift) & G::MASK : (uint32_t)R;
    const unsigned peers = __match_any_sync(RS_FULL, d);
    const int leader = __ffs(peers) - 1;
    uint32_t before = 0;
    if (valid && lane == leader) before = sh.wh[warp * R + d];
    before = __shfl_sync(RS_FULL, before, leader);
    rank[i] = (int)before + __popc(peers & lane_lt);
    __syncwarp();
    if (valid && lane == leader) {
      sh.wh[warp * R + d] = (uint16_t)(before + __popc(peers));
    }
    __syncwarp();
  }
  __syncthreads();
  // 2. across warps; the tile's count of each value, published
  uint32_t cnt_d[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int b = threadIdx.x * PER + q;
    uint32_t run = 0;
#pragma unroll
    for (int w = 0; w < RS_WARPS; ++w) {
      const uint32_t c = sh.wh[w * R + b];
      sh.wh[w * R + b] = (uint16_t)run;
      run += c;
    }
    cnt_d[q] = run;
    sh.tx[b] = run;
    volatile unsigned long long* st = a.status + (size_t)tile * R + b;
    *st = (tile == 0 ? RS_FLAG_INC : RS_FLAG_AGG) | run;
  }
  block_excl_scan<PER>(sh.tx, sh.scan);
  // 3. decoupled look-back over the earlier tiles, value by value
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int b = threadIdx.x * PER + q;
    unsigned long long excl = 0;
    if (tile > 0) {
      // read RS_LOOKBACK earlier tiles at once, then add them nearest
      // first up to an inclusive prefix; stop at a tile not published yet
      // and read again from it
      int tt = tile - 1;
      for (bool done = false; !done;) {
        unsigned long long v[RS_LOOKBACK];
#pragma unroll
        for (int w = 0; w < RS_LOOKBACK; ++w) {
          v[w] = tt - w >= 0 ? *(volatile unsigned long long*)(
                                   a.status + (size_t)(tt - w) * R + b)
                             : RS_FLAG_INC;
        }
        int used = 0;
#pragma unroll
        for (int w = 0; w < RS_LOOKBACK; ++w) {
          if (done || used < w || (v[w] >> 62) == 0) continue;
          excl += v[w] & RS_COUNT_MASK;
          done = (v[w] & ~RS_COUNT_MASK) == RS_FLAG_INC;
          used = w + 1;
        }
        tt -= used;
      }
      volatile unsigned long long* st = a.status + (size_t)tile * R + b;
      *st = RS_FLAG_INC | (excl + cnt_d[q]);
    }
    sh.gb[b] = (uint32_t)((long long)hx[q] + (long long)excl -
                          (long long)sh.tx[b]);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RS_ITEMS; ++i) {
    if (wbase + i * 32 + lane < cnt) {
      const uint32_t d = (key[i] >> shift) & G::MASK;
      rank[i] += (int)sh.tx[d] + (int)sh.wh[warp * R + d];
    }
  }
}

template <int BITS>
constexpr size_t pass_smem() {
  return 2 * RS_TILE * sizeof(uint32_t) + rank_smem<BITS>();
}

template <int BITS, int NP>
__global__ void __launch_bounds__(RS_THREADS, RS_MIN_BLOCKS)
    radix_pass_kernel(const PassArgs a) {
  using G = Digits<BITS>;
  constexpr int R = G::R;
  extern __shared__ uint4 smem_raw[];
  uint32_t* s_key = reinterpret_cast<uint32_t*>(smem_raw);  // [TILE]
  uint32_t* s_pay = s_key + RS_TILE;                          // [TILE]
  __shared__ uint32_t s_scan[RS_WARPS];
  __shared__ int s_tile;
  RankShared sh;
  sh.tx = s_pay + RS_TILE;
  sh.gb = sh.tx + R;
  sh.wh = reinterpret_cast<uint16_t*>(sh.gb + R);
  sh.scan = s_scan;
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
    uint32_t key[RS_ITEMS];
    int rank[RS_ITEMS];
#pragma unroll
    for (int i = 0; i < RS_ITEMS; ++i) {
      const int pos = wbase + i * 32 + lane;
      key[i] = pos < cnt ? src.w[0][base + pos] ^ a.flip : 0u;
    }
    rank_tile<BITS>(key, rank, cnt, tile, hx, a, sh);
#pragma unroll
    for (int i = 0; i < RS_ITEMS; ++i) {
      if (wbase + i * 32 + lane < cnt) s_key[rank[i]] = key[i];
    }
    __syncthreads();
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
      uint32_t v[RS_ITEMS];
#pragma unroll
      for (int i = 0; i < RS_ITEMS; ++i) {
        const int pos = wbase + i * 32 + lane;
        v[i] = pos < cnt ? src.w[p][base + pos] : 0u;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RS_ITEMS; ++i) {
        if (wbase + i * 32 + lane < cnt) s_pay[rank[i]] = v[i];
      }
      __syncthreads();
#pragma unroll
      for (int s = 0; s < RS_ITEMS; ++s) {
        if (gidx[s] >= 0) {
          dst.w[p][gidx[s]] = s_pay[s * RS_THREADS + threadIdx.x];
        }
      }
    }
    __syncthreads();
  }
}

// The package's pass kernel as a launchable family (the design probe in
// tools/ brings others).
template <int BITS, int NP>
struct PassKernel {
  static constexpr size_t kSmem = pass_smem<BITS>();
  static const void* fn() {
    return reinterpret_cast<const void*>(&radix_pass_kernel<BITS, NP>);
  }
  static void launch(int grid, cudaStream_t stream, const PassArgs& a) {
    radix_pass_kernel<BITS, NP><<<grid, RS_THREADS, kSmem, stream>>>(a);
  }
};

template <int BITS>
int radix_hist_launch(const uint32_t* kin, int n, uint32_t flip, void* ws,
                      long long ws_bytes, cudaStream_t stream) {
  const long long need = workspace_bytes<BITS>(n);
  if (n < 1 || ws == nullptr || ws_bytes < need) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaMemsetAsync(ws, 0, (size_t)need, stream);
  if (err != cudaSuccess) return (int)err;
  uint32_t* hist = reinterpret_cast<uint32_t*>(static_cast<char*>(ws) +
                                               status_bytes<BITS>(n));
  const long long per_block = (long long)RS_THREADS * RS_HIST_ITEMS;
  const int blocks = (int)std::min((n + per_block - 1) / per_block,
                                   (long long)sm_count() * RS_HIST_BLOCKS);
  radix_hist_kernel<BITS><<<blocks, RS_THREADS, 0, stream>>>(kin, n, flip,
                                                             hist);
  return (int)cudaGetLastError();
}

template <int BITS, template <int, int> class K, int NP>
int radix_pass_np(const PassArgs& a, cudaStream_t stream) {
  using Kern = K<BITS, NP>;
  static int occupancy = -1;
  if (occupancy < 0) {
    if (Kern::kSmem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          Kern::fn(), cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)Kern::kSmem);
      if (err != cudaSuccess) return (int)err;
    }
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occupancy, Kern::fn(), RS_THREADS, Kern::kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long tiles = (a.n + RS_TILE - 1) / RS_TILE;
  const int grid = (int)std::min(tiles, (long long)std::max(occupancy, 1) *
                                            sm_count());
  Kern::launch(grid, stream, a);
  return (int)cudaGetLastError();
}

template <int BITS, template <int, int> class K = PassKernel>
int radix_pass_launch(const uint32_t* kin, const uint32_t* p0,
                      const uint32_t* p1, const uint32_t* p2, uint32_t* kout,
                      uint32_t* q0, uint32_t* q1, uint32_t* q2,
                      uint32_t* kscr, uint32_t* s0, uint32_t* s1,
                      uint32_t* s2, int n, int digit, int n_pay, int flip,
                      void* ws, long long ws_bytes, int* taken,
                      cudaStream_t stream) {
  using G = Digits<BITS>;
  if (n < 1 || digit < 0 || digit >= G::D || ws == nullptr ||
      ws_bytes < workspace_bytes<BITS>(n)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles = (n + RS_TILE - 1) / RS_TILE;
  char* w = static_cast<char*>(ws);
  uint32_t* hist = reinterpret_cast<uint32_t*>(w + status_bytes<BITS>(n));
  PassArgs a;
  a.in = {{const_cast<uint32_t*>(kin), const_cast<uint32_t*>(p0),
           const_cast<uint32_t*>(p1), const_cast<uint32_t*>(p2)}};
  a.out = {{kout, q0, q1, q2}};
  a.scr = {{kscr, s0, s1, s2}};
  a.n = n;
  a.digit = digit;
  a.flip = (uint32_t)flip;
  a.hist = hist;
  a.status = reinterpret_cast<unsigned long long*>(w) +
             (size_t)digit * tiles * G::R;
  a.counter = hist + G::D * G::R + digit;
  a.taken = taken;
  switch (n_pay) {
    case 0:
      return radix_pass_np<BITS, K, 0>(a, stream);
    case 1:
      return radix_pass_np<BITS, K, 1>(a, stream);
    case 2:
      return radix_pass_np<BITS, K, 2>(a, stream);
    case 3:
      return radix_pass_np<BITS, K, 3>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// keys: uint32/int32[n] (flip: 0 for uint32, INT_MIN for int32); ws: the
// workspace, at least workspace_bytes(n) (ops/psort.py:radix_workspace_bytes).
// Zeroes the workspace and counts every digit value of every digit.
PSIM_EXPORT int psim_radix_hist(const uint32_t* kin, int n, int flip,
                                void* ws, long long ws_bytes,
                                cudaStream_t stream) {
  return radix_hist_launch<RS_BITS>(kin, n, (uint32_t)flip, ws, ws_bytes,
                                    stream);
}

// One pass, by digit `digit` (0 = least significant), of the sort whose
// histogram psim_radix_hist built in `ws`: in (k, p*) -> out (k, q*) through
// the scratch words (k, s*) (NULL past n_pay; no buffer may alias another).
// A skipped digit returns at once; `taken` (may be NULL) counts the passes
// that ran.
PSIM_EXPORT int psim_radix_pass(const uint32_t* kin, const uint32_t* p0,
                                const uint32_t* p1, const uint32_t* p2,
                                uint32_t* kout, uint32_t* q0, uint32_t* q1,
                                uint32_t* q2, uint32_t* kscr, uint32_t* s0,
                                uint32_t* s1, uint32_t* s2, int n, int digit,
                                int n_pay, int flip, void* ws,
                                long long ws_bytes, int* taken,
                                cudaStream_t stream) {
  return radix_pass_launch<RS_BITS>(kin, p0, p1, p2, kout, q0, q1, q2, kscr,
                                    s0, s1, s2, n, digit, n_pay, flip, ws,
                                    ws_bytes, taken, stream);
}
