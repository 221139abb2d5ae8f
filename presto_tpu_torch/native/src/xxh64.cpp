// XXH64 (public algorithm, https://xxhash.com) implemented from scratch.
//
// Role: the 64-bit hash of every value a HyperLogLog sketch takes
// (approx_distinct, presto_tpu_torch/sketch.py).  The reference's analogue
// is the XxHash64-based raw hashes used across its runtime (airlift slice
// XxHash64).  Built with g++ by presto_tpu_torch/native/__init__.py.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t P1 = 11400714785074694791ull;
constexpr uint64_t P2 = 14029467366897019727ull;
constexpr uint64_t P3 = 1609587929392839161ull;
constexpr uint64_t P4 = 9650029242287828579ull;
constexpr uint64_t P5 = 2870177450012600261ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t read64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;
}

inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

inline uint64_t round1(uint64_t acc, uint64_t input) {
    acc += input * P2;
    acc = rotl(acc, 31);
    return acc * P1;
}

inline uint64_t merge_round(uint64_t acc, uint64_t val) {
    acc ^= round1(0, val);
    return acc * P1 + P4;
}

}  // namespace

extern "C" {

uint64_t pt_xxh64(const uint8_t* data, int64_t len, uint64_t seed) {
    const uint8_t* p = data;
    const uint8_t* const end = data + len;
    uint64_t h;

    if (len >= 32) {
        uint64_t v1 = seed + P1 + P2;
        uint64_t v2 = seed + P2;
        uint64_t v3 = seed;
        uint64_t v4 = seed - P1;
        const uint8_t* const limit = end - 32;
        do {
            v1 = round1(v1, read64(p));
            v2 = round1(v2, read64(p + 8));
            v3 = round1(v3, read64(p + 16));
            v4 = round1(v4, read64(p + 24));
            p += 32;
        } while (p <= limit);
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = merge_round(h, v1);
        h = merge_round(h, v2);
        h = merge_round(h, v3);
        h = merge_round(h, v4);
    } else {
        h = seed + P5;
    }

    h += static_cast<uint64_t>(len);
    while (p + 8 <= end) {
        h ^= round1(0, read64(p));
        h = rotl(h, 27) * P1 + P4;
        p += 8;
    }
    if (p + 4 <= end) {
        h ^= static_cast<uint64_t>(read32(p)) * P1;
        h = rotl(h, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h ^= (*p++) * P5;
        h = rotl(h, 11) * P1;
    }

    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

}  // extern "C"
