// Native frame packer for the streaming thin client (host code, no GPU).
//
// The port's own copy of particle_sim_tpu/native/packer.cpp, unchanged in
// what it computes: both wire formats of app/server.py come out byte for
// byte as the JAX package's do.
//
// Job: convert the engine's SoA planes (x/y/z float32 planes + RGBA8 colors)
// into the compact interleaved wire record
//     struct Record { uint16 x, y, z;  // IEEE binary16
//                     uint8  r, g, b, a; }       // 10 bytes/particle
// with optional stride subsampling, fanned out over std::thread workers;
// and the planar f32 gather of the zero-quantization mode. io/packer.py
// holds the numpy version, bit-identical to this one (tested).
//
// Build: particle_sim_tpu_torch/native/build.py (g++ -O3 -march=native
// -shared, into the git-ignored build/ directory).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// f32 -> f16 (IEEE 754 binary16, round-to-nearest-even). Uses the
// compiler/hardware conversion (vcvtps2ph with -march=native on x86) when
// _Float16 is available; portable bit-twiddling fallback otherwise.
#if defined(__FLT16_MANT_DIG__)
static inline uint16_t f32_to_f16(float f) {
    _Float16 h = (_Float16)f;
    uint16_t out;
    std::memcpy(&out, &h, 2);
    return out;
}
#else
static inline uint16_t f32_to_f16(float f) {
    uint32_t x;
    std::memcpy(&x, &f, 4);
    uint32_t sign = (x >> 16) & 0x8000u;
    int32_t exp = (int32_t)((x >> 23) & 0xFF) - 127 + 15;
    uint32_t mant = x & 0x7FFFFFu;
    if (exp <= 0) {                        // subnormal / zero
        if (exp < -10) return (uint16_t)sign;
        mant |= 0x800000u;
        uint32_t shift = (uint32_t)(14 - exp);
        uint32_t half = (mant >> shift);
        uint32_t rem = mant & ((1u << shift) - 1u);
        uint32_t halfway = 1u << (shift - 1);
        if (rem > halfway || (rem == halfway && (half & 1u))) half++;
        return (uint16_t)(sign | half);
    }
    if (exp >= 31) {                       // inf/NaN/overflow
        // preserve NaN (quiet) — matches the _Float16 and numpy paths
        if (((x >> 23) & 0xFF) == 0xFF && mant != 0)
            return (uint16_t)(sign | 0x7E00u);
        return (uint16_t)(sign | 0x7C00u);
    }
    uint32_t half = (uint32_t)(exp << 10) | (mant >> 13);
    uint32_t rem = mant & 0x1FFFu;
    if (rem > 0x1000u || (rem == 0x1000u && (half & 1u))) half++;
    return (uint16_t)(sign | half);
}
#endif

struct Job {
    const float *px, *py, *pz;   // component planes, length n (strided view)
    const uint8_t *rgba;         // n*4
    uint8_t *out;                // n_out*10
    int64_t begin, end;          // output record range
    int64_t stride;              // subsample stride over the input
};

static void pack_range(const Job &j) {
    for (int64_t i = j.begin; i < j.end; ++i) {
        const int64_t src = i * j.stride;
        uint8_t *rec = j.out + i * 10;
        uint16_t h[3] = {
            f32_to_f16(j.px[src]), f32_to_f16(j.py[src]), f32_to_f16(j.pz[src]),
        };
        std::memcpy(rec, h, 6);
        std::memcpy(rec + 6, j.rgba + src * 4, 4);
    }
}

}  // namespace

extern "C" {

// pos_planes: float32[3 * n_src] laid out as 3 contiguous planes of n_src.
// rgba: uint8[n_src * 4]. out: uint8[n_out * 10] where
// n_out = ceil(n_src / stride) computed by the caller.
void psim_pack_f16(const float *pos_planes, const uint8_t *rgba,
                   int64_t n_src, int64_t stride, uint8_t *out,
                   int64_t n_out, int32_t n_threads) {
    if (n_out <= 0) return;
    if (stride < 1) stride = 1;
    const float *px = pos_planes;
    const float *py = pos_planes + n_src;
    const float *pz = pos_planes + 2 * n_src;

    if (n_threads < 1) n_threads = 1;
    if (n_threads == 1 || n_out < 1 << 15) {
        pack_range({px, py, pz, rgba, out, 0, n_out, stride});
        return;
    }
    std::vector<std::thread> workers;
    workers.reserve((size_t)n_threads);
    const int64_t chunk = (n_out + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        int64_t b = (int64_t)t * chunk;
        int64_t e = b + chunk < n_out ? b + chunk : n_out;
        if (b >= e) break;
        workers.emplace_back(
            [=] { pack_range({px, py, pz, rgba, out, b, e, stride}); });
    }
    for (auto &w : workers) w.join();
}

// Planar passthrough with subsampling: gathers every stride-th element of
// the three position planes (f32) and rgba into packed planar output
// buffers — the zero-quantization local-viewer mode.
void psim_gather_f32(const float *pos_planes, const uint8_t *rgba,
                     int64_t n_src, int64_t stride, float *pos_out,
                     uint8_t *rgba_out, int64_t n_out, int32_t n_threads) {
    if (n_out <= 0) return;
    if (stride < 1) stride = 1;
    if (stride == 1) {
        for (int c = 0; c < 3; ++c)
            std::memcpy(pos_out + c * n_out, pos_planes + c * n_src,
                        (size_t)n_out * 4);
        std::memcpy(rgba_out, rgba, (size_t)n_out * 4);
        return;
    }
    auto run = [=](int64_t b, int64_t e) {
        for (int c = 0; c < 3; ++c) {
            const float *src = pos_planes + c * n_src;
            float *dst = pos_out + c * n_out;
            for (int64_t i = b; i < e; ++i) dst[i] = src[i * stride];
        }
        // memcpy per 4-byte record: uint32_t punning of the uint8 buffers
        // is strict-aliasing UB under -O3 and assumes alignment
        for (int64_t i = b; i < e; ++i)
            std::memcpy(rgba_out + i * 4, rgba + (i * stride) * 4, 4);
    };
    if (n_threads <= 1 || n_out < 1 << 15) {
        run(0, n_out);
        return;
    }
    std::vector<std::thread> workers;
    const int64_t chunk = (n_out + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        int64_t b = (int64_t)t * chunk;
        int64_t e = b + chunk < n_out ? b + chunk : n_out;
        if (b >= e) break;
        workers.emplace_back([=] { run(b, e); });
    }
    for (auto &w : workers) w.join();
}

}  // extern "C"
