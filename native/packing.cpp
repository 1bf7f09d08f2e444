// Native wire bit-packing for the FLASHE wire format.
//
// The role the reference fills with native code on its hot host paths
// (eggroll's C++ storage service; multiprocessing big-int packing in
// jzf_weights.py:45-137): streaming conversion between uint32 lane/limb
// arrays and the big-endian packed byte layout (element 0 most
// significant, int_bits per element) without materializing a bit matrix.
//
// Layout contract == flashe_tpu/ops/pack.py (tested for equality): the
// packed string is the big-endian byte serialization of
// sum_i lane_i << ((n-1-i)*int_bits), ceil(n*int_bits/8) bytes.
//
// Build: g++ -O3 -shared -fPIC -o libflashepack.so packing.cpp

#include <cstdint>
#include <cstring>

extern "C" {

// lanes: n * nlimbs uint32 little-endian limbs per element.
// out: preset to zero, size (n*int_bits + 7) / 8.
void pack_lanes_u32(const uint32_t* lanes, int64_t n, int32_t nlimbs,
                    int32_t int_bits, uint8_t* out) {
    const int64_t total_bits = n * (int64_t)int_bits;
    const int64_t pad = (8 - (total_bits & 7)) & 7;

    if (nlimbs == 1 && int_bits <= 32) {
        // fast path: 64-bit accumulator, flush full bytes
        uint64_t acc = 0;
        int32_t acc_bits = (int32_t)pad;  // leading zero pad bits
        int64_t out_pos = 0;
        for (int64_t i = 0; i < n; ++i) {
            acc = (acc << int_bits) | (uint64_t)lanes[i];
            acc_bits += int_bits;
            while (acc_bits >= 8) {
                out[out_pos++] = (uint8_t)(acc >> (acc_bits - 8));
                acc_bits -= 8;
            }
        }
        if (acc_bits > 0) {
            out[out_pos++] = (uint8_t)(acc << (8 - acc_bits));
        }
        return;
    }

    // generic path: per-bit, MSB-first cursor
    int64_t cursor = pad;
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t* limb = lanes + i * nlimbs;
        for (int32_t b = int_bits - 1; b >= 0; --b) {
            uint32_t bit = (limb[b >> 5] >> (b & 31)) & 1u;
            out[cursor >> 3] |= (uint8_t)(bit << (7 - (cursor & 7)));
            ++cursor;
        }
    }
}

// Inverse: data -> n * nlimbs uint32 limbs (out preset to zero).
void unpack_lanes_u32(const uint8_t* data, int64_t n, int32_t nlimbs,
                      int32_t int_bits, uint32_t* lanes) {
    const int64_t total_bits = n * (int64_t)int_bits;
    const int64_t pad = (8 - (total_bits & 7)) & 7;

    if (nlimbs == 1 && int_bits <= 32) {
        const uint64_t mask =
            int_bits == 32 ? 0xFFFFFFFFull : ((1ull << int_bits) - 1);
        int64_t bitpos = pad;  // absolute position of the element's MSB
        for (int64_t i = 0; i < n; ++i) {
            int64_t byte = bitpos >> 3;
            int32_t off = (int32_t)(bitpos & 7);
            uint64_t window = 0;
            int32_t have = 0;
            while (have < off + int_bits) {
                window = (window << 8) | data[byte++];
                have += 8;
            }
            lanes[i] = (uint32_t)((window >> (have - off - int_bits)) & mask);
            bitpos += int_bits;
        }
        return;
    }

    int64_t cursor = pad;
    for (int64_t i = 0; i < n; ++i) {
        uint32_t* limb = lanes + i * nlimbs;
        for (int32_t b = int_bits - 1; b >= 0; --b) {
            uint32_t bit = (data[cursor >> 3] >> (7 - (cursor & 7))) & 1u;
            limb[b >> 5] |= bit << (b & 31);
            ++cursor;
        }
    }
}

}  // extern "C"
