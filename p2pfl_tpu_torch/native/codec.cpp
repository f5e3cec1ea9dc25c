// Native wire-codec kernels for network transports.
//
// The reference's wire path is pickle over gRPC (no integrity checking, no
// compression — p2pfl/learning/pytorch/lightning_learner.py:113-138). This
// library provides the byte-level hot loops for the rebuild's codec:
//
//   - symmetric per-tensor int8 quantization (4x smaller gossip payloads,
//     fp32 scale chosen from the absmax),
//   - dequantization back to fp32,
//   - CRC32C (Castagnoli, software slice-by-1) integrity checksums for
//     every framed payload.
//
// Exposed with C linkage for ctypes; a numpy fallback in
// p2pfl_tpu_torch/native/__init__.py keeps hosts without a compiler
// working. Built with g++ -O3 -shared -fPIC at first use (native/__init__.py).

#include <cstdint>
#include <cstddef>
#include <cmath>

extern "C" {

// ---- quantization ----

// Quantize n fp32 values to int8 with a single symmetric scale.
// Returns the scale used (absmax / 127); dst must hold n bytes.
float p2tw_quantize_f32_i8(const float* src, int64_t n, int8_t* dst) {
    float absmax = 0.0f;
    for (int64_t i = 0; i < n; ++i) {
        float a = std::fabs(src[i]);
        if (a > absmax) absmax = a;
    }
    float scale = absmax > 0.0f ? absmax / 127.0f : 1.0f;
    float inv = 1.0f / scale;
    for (int64_t i = 0; i < n; ++i) {
        float q = src[i] * inv;
        q = q > 127.0f ? 127.0f : (q < -127.0f ? -127.0f : q);
        dst[i] = (int8_t)std::lrintf(q);
    }
    return scale;
}

void p2tw_dequantize_i8_f32(const int8_t* src, int64_t n, float scale, float* dst) {
    for (int64_t i = 0; i < n; ++i) {
        dst[i] = (float)src[i] * scale;
    }
}

// ---- CRC32C (Castagnoli), reflected, poly 0x82F63B78 ----
//
// Two engines behind one entry point: the SSE4.2 crc32 instruction
// (8 bytes/cycle — the streaming byte plane checksums every chunk on both
// ends, so this path is what keeps integrity checking out of the wire
// profile) with a table-based software loop as the portable fallback.
// Dispatch is one __builtin_cpu_supports probe, cached after first call.

static uint32_t crc32c_table[256];
static bool crc32c_ready = false;

static void crc32c_init() {
    for (uint32_t i = 0; i < 256; ++i) {
        uint32_t c = i;
        for (int k = 0; k < 8; ++k)
            c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
        crc32c_table[i] = c;
    }
    crc32c_ready = true;
}

static uint32_t crc32c_sw(const uint8_t* buf, int64_t n, uint32_t c) {
    if (!crc32c_ready) crc32c_init();
    for (int64_t i = 0; i < n; ++i)
        c = crc32c_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
    return c;
}

#if defined(__x86_64__)
#include <cstring>

__attribute__((target("sse4.2")))
static uint32_t crc32c_hw(const uint8_t* buf, int64_t n, uint32_t c) {
    uint64_t c64 = c;
    while (n >= 8) {
        uint64_t w;
        std::memcpy(&w, buf, 8);  // unaligned-safe load
        c64 = __builtin_ia32_crc32di(c64, w);
        buf += 8;
        n -= 8;
    }
    uint32_t cc = (uint32_t)c64;
    while (n-- > 0)
        cc = __builtin_ia32_crc32qi(cc, *buf++);
    return cc;
}

static int crc32c_have_hw = -1;
#endif

uint32_t p2tw_crc32c(const uint8_t* buf, int64_t n, uint32_t seed) {
    uint32_t c = seed ^ 0xFFFFFFFFu;
#if defined(__x86_64__)
    if (crc32c_have_hw < 0)
        crc32c_have_hw = __builtin_cpu_supports("sse4.2") ? 1 : 0;
    if (crc32c_have_hw)
        return crc32c_hw(buf, n, c) ^ 0xFFFFFFFFu;
#endif
    return crc32c_sw(buf, n, c) ^ 0xFFFFFFFFu;
}

}  // extern "C"
