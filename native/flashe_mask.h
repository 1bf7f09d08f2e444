// Bitsliced AES-256 counter blocks for FLASHE mask streams.
//
// One call evaluates 32 consecutive counter blocks: each of the 128 state
// planes is one uint32 whose bit j belongs to block first_block + j.  The
// same circuit as flashe_tpu/ops/aes_bitsliced.py (Boyar-Peralta S-box,
// MixColumns as plane XORs, ShiftRows as renaming), written so that it
// compiles both as CUDA device code (native/flashe_mask.cu) and as host
// C++ (native/flashe_mask_host.cpp, the CPU check of this arithmetic).
// Constant time: no table lookups, no data-dependent branches.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define FM_INLINE __device__ __forceinline__
#else
#define FM_INLINE inline
#endif

namespace flashe_mask {

// Plane index convention: p[8 * k + i] = bit i (LSB first) of state byte k.
// The S-box below takes and returns one byte's 8 planes, LSB first.
FM_INLINE void sbox(uint32_t* b) {
  const uint32_t U0 = b[7], U1 = b[6], U2 = b[5], U3 = b[4],
                 U4 = b[3], U5 = b[2], U6 = b[1], U7 = b[0];
  uint32_t T1 = U0 ^ U3; uint32_t T2 = U0 ^ U5; uint32_t T3 = U0 ^ U6;
  uint32_t T4 = U3 ^ U5; uint32_t T5 = U4 ^ U6; uint32_t T6 = T1 ^ T5;
  uint32_t T7 = U1 ^ U2; uint32_t T8 = U7 ^ T6; uint32_t T9 = U7 ^ T7;
  uint32_t T10 = T6 ^ T7; uint32_t T11 = U1 ^ U5; uint32_t T12 = U2 ^ U5;
  uint32_t T13 = T3 ^ T4; uint32_t T14 = T6 ^ T11; uint32_t T15 = T5 ^ T11;
  uint32_t T16 = T5 ^ T12; uint32_t T17 = T9 ^ T16; uint32_t T18 = U3 ^ U7;
  uint32_t T19 = T7 ^ T18; uint32_t T20 = T1 ^ T19; uint32_t T21 = U6 ^ U7;
  uint32_t T22 = T7 ^ T21; uint32_t T23 = T2 ^ T22; uint32_t T24 = T2 ^ T10;
  uint32_t T25 = T20 ^ T17; uint32_t T26 = T3 ^ T16; uint32_t T27 = T1 ^ T12;
  uint32_t M1 = T13 & T6; uint32_t M2 = T23 & T8; uint32_t M3 = T14 ^ M1;
  uint32_t M4 = T19 & U7; uint32_t M5 = M4 ^ M1; uint32_t M6 = T3 & T16;
  uint32_t M7 = T22 & T9; uint32_t M8 = T26 ^ M6; uint32_t M9 = T20 & T17;
  uint32_t M10 = M9 ^ M6; uint32_t M11 = T1 & T15; uint32_t M12 = T4 & T27;
  uint32_t M13 = M12 ^ M11; uint32_t M14 = T2 & T10; uint32_t M15 = M14 ^ M11;
  uint32_t M16 = M3 ^ M2; uint32_t M17 = M5 ^ T24; uint32_t M18 = M8 ^ M7;
  uint32_t M19 = M10 ^ M15; uint32_t M20 = M16 ^ M13;
  uint32_t M21 = M17 ^ M15; uint32_t M22 = M18 ^ M13;
  uint32_t M23 = M19 ^ T25; uint32_t M24 = M22 ^ M23;
  uint32_t M25 = M22 & M20; uint32_t M26 = M21 ^ M25;
  uint32_t M27 = M20 ^ M21; uint32_t M28 = M23 ^ M25;
  uint32_t M29 = M28 & M27; uint32_t M30 = M26 & M24;
  uint32_t M31 = M20 & M23; uint32_t M32 = M27 & M31;
  uint32_t M33 = M27 ^ M25; uint32_t M34 = M21 & M22;
  uint32_t M35 = M24 & M34; uint32_t M36 = M24 ^ M25;
  uint32_t M37 = M21 ^ M29; uint32_t M38 = M32 ^ M33;
  uint32_t M39 = M23 ^ M30; uint32_t M40 = M35 ^ M36;
  uint32_t M41 = M38 ^ M40; uint32_t M42 = M37 ^ M39;
  uint32_t M43 = M37 ^ M38; uint32_t M44 = M39 ^ M40;
  uint32_t M45 = M42 ^ M41; uint32_t M46 = M44 & T6; uint32_t M47 = M40 & T8;
  uint32_t M48 = M39 & U7; uint32_t M49 = M43 & T16; uint32_t M50 = M38 & T9;
  uint32_t M51 = M37 & T17; uint32_t M52 = M42 & T15;
  uint32_t M53 = M45 & T27; uint32_t M54 = M41 & T10;
  uint32_t M55 = M44 & T13; uint32_t M56 = M40 & T23;
  uint32_t M57 = M39 & T19; uint32_t M58 = M43 & T3; uint32_t M59 = M38 & T22;
  uint32_t M60 = M37 & T20; uint32_t M61 = M42 & T1; uint32_t M62 = M45 & T4;
  uint32_t M63 = M41 & T2; uint32_t L0 = M61 ^ M62; uint32_t L1 = M50 ^ M56;
  uint32_t L2 = M46 ^ M48; uint32_t L3 = M47 ^ M55; uint32_t L4 = M54 ^ M58;
  uint32_t L5 = M49 ^ M61; uint32_t L6 = M62 ^ L5; uint32_t L7 = M46 ^ L3;
  uint32_t L8 = M51 ^ M59; uint32_t L9 = M52 ^ M53; uint32_t L10 = M53 ^ L4;
  uint32_t L11 = M60 ^ L2; uint32_t L12 = M48 ^ M51; uint32_t L13 = M50 ^ L0;
  uint32_t L14 = M52 ^ M61; uint32_t L15 = M55 ^ L1; uint32_t L16 = M56 ^ L0;
  uint32_t L17 = M57 ^ L1; uint32_t L18 = M58 ^ L8; uint32_t L19 = M63 ^ L4;
  uint32_t L20 = L0 ^ L1; uint32_t L21 = L1 ^ L7; uint32_t L22 = L3 ^ L12;
  uint32_t L23 = L18 ^ L2; uint32_t L24 = L15 ^ L9; uint32_t L25 = L6 ^ L10;
  uint32_t L26 = L7 ^ L9; uint32_t L27 = L8 ^ L10; uint32_t L28 = L11 ^ L14;
  uint32_t L29 = L11 ^ L17; uint32_t S0 = L6 ^ L24;
  uint32_t S1 = ~(L16 ^ L26); uint32_t S2 = ~(L19 ^ L28);
  uint32_t S3 = L6 ^ L21; uint32_t S4 = L20 ^ L22; uint32_t S5 = L25 ^ L29;
  uint32_t S6 = ~(L13 ^ L27); uint32_t S7 = ~(L6 ^ L23);
  b[7] = S0; b[6] = S1; b[5] = S2; b[4] = S3;
  b[3] = S4; b[2] = S5; b[1] = S6; b[0] = S7;
}

FM_INLINE void sub_shift(uint32_t* p) {
  // SubBytes on every byte, then ShiftRows: byte r + 4c <- r + 4((c + r) % 4)
#pragma unroll
  for (int k = 0; k < 16; ++k) sbox(p + 8 * k);
  uint32_t t[8];
  // row 1: rotate columns left by 1
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    t[i] = p[8 * 1 + i];
    p[8 * 1 + i] = p[8 * 5 + i];
    p[8 * 5 + i] = p[8 * 9 + i];
    p[8 * 9 + i] = p[8 * 13 + i];
    p[8 * 13 + i] = t[i];
  }
  // row 2: rotate by 2 (two swaps)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    t[i] = p[8 * 2 + i];
    p[8 * 2 + i] = p[8 * 10 + i];
    p[8 * 10 + i] = t[i];
    t[i] = p[8 * 6 + i];
    p[8 * 6 + i] = p[8 * 14 + i];
    p[8 * 14 + i] = t[i];
  }
  // row 3: rotate by 3 = right by 1
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    t[i] = p[8 * 15 + i];
    p[8 * 15 + i] = p[8 * 11 + i];
    p[8 * 11 + i] = p[8 * 7 + i];
    p[8 * 7 + i] = p[8 * 3 + i];
    p[8 * 3 + i] = t[i];
  }
}

FM_INLINE void mix_columns(uint32_t* p) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t* s0 = p + 8 * (4 * c + 0);
    uint32_t* s1 = p + 8 * (4 * c + 1);
    uint32_t* s2 = p + 8 * (4 * c + 2);
    uint32_t* s3 = p + 8 * (4 * c + 3);
  uint32_t o0[8], o1[8], o2[8], o3[8];
    // xtime on planes: out bit i = in bit i-1, with 0x1B taps from bit 7
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int tap = (i == 1 || i == 3 || i == 4);
      uint32_t x0 = (i ? s0[i - 1] : 0) ^ ((i == 0 || tap) ? s0[7] : 0);
      uint32_t x1 = (i ? s1[i - 1] : 0) ^ ((i == 0 || tap) ? s1[7] : 0);
      uint32_t x2 = (i ? s2[i - 1] : 0) ^ ((i == 0 || tap) ? s2[7] : 0);
      uint32_t x3 = (i ? s3[i - 1] : 0) ^ ((i == 0 || tap) ? s3[7] : 0);
      o0[i] = x0 ^ x1 ^ s1[i] ^ s2[i] ^ s3[i];
      o1[i] = s0[i] ^ x1 ^ x2 ^ s2[i] ^ s3[i];
      o2[i] = s0[i] ^ s1[i] ^ x2 ^ x3 ^ s3[i];
      o3[i] = x0 ^ s0[i] ^ s1[i] ^ s2[i] ^ x3;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s0[i] = o0[i]; s1[i] = o1[i]; s2[i] = o2[i]; s3[i] = o3[i];
    }
  }
}

FM_INLINE void add_round_key(uint32_t* p, const uint32_t* key_planes,
                             int r) {
#pragma unroll
  for (int j = 0; j < 128; ++j) p[j] ^= key_planes[128 * r + j];
}

// 32x32 bit transpose (Hacker's Delight), exact: out[j] bit t == in[t]
// bit j.  The raw network computes the double-reversed transpose, so it
// runs on the reversed order.
FM_INLINE void transpose32(uint32_t* x) {
  uint32_t y[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) y[k] = x[31 - k];
  uint32_t m = 0x0000FFFFu;
#pragma unroll
  for (int j = 16; j != 0; j >>= 1, m ^= (m << j)) {
#pragma unroll
    for (int k = 0; k < 32; k = (k + j + 1) & ~j) {
      const uint32_t t = (y[k] ^ (y[k + j] >> j)) & m;
      y[k] ^= t;
      y[k + j] ^= (t << j);
    }
  }
#pragma unroll
  for (int k = 0; k < 32; ++k) x[k] = y[31 - k];
}

// Blocks first_block .. first_block + 31 of stream (iter, stream_idx);
// first_block is a multiple of 32 and below 2^31.  key_planes: (15, 128)
// all-ones/zero masks of the round-key bits (round_key_planes in
// ops/aes_bitsliced.py).  On return w[32 * wi + j] is 32-bit word wi (w0
// least significant) of block first_block + j.
FM_INLINE void counter_words(const uint32_t* key_planes, int32_t iter,
                             int32_t stream_idx, int32_t first_block,
                             uint32_t* w) {
  const uint32_t low[5] = {0xAAAAAAAAu, 0xCCCCCCCCu, 0xF0F0F0F0u,
                           0xFF00FF00u, 0xFFFF0000u};
  uint32_t p[128];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      p[8 * k + i] = 0u - ((uint32_t(iter) >> (8 * (3 - k) + i)) & 1u);
      p[8 * (4 + k) + i] =
          0u - ((uint32_t(stream_idx) >> (8 * (3 - k) + i)) & 1u);
    }
  }
#pragma unroll
  for (int k = 8; k < 16; ++k) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int bit = (15 - k) * 8 + i;
      p[8 * k + i] = bit < 5 ? low[bit < 5 ? bit : 0]
                   : bit < 31 ? 0u - ((uint32_t(first_block) >> bit) & 1u)
                   : 0u;
    }
  }
  add_round_key(p, key_planes, 0);
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int r = 1; r < 14; ++r) {
    sub_shift(p);
    mix_columns(p);
    add_round_key(p, key_planes, r);
  }
  sub_shift(p);
  add_round_key(p, key_planes, 14);
  // un-bitslice: word wi of the block = bits 32 wi .. 32 wi + 31 of the
  // big-endian 128-bit block, i.e. byte 15 - (bit >> 3), bit (bit & 7)
#pragma unroll
  for (int wi = 0; wi < 4; ++wi) {
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const int bit = 32 * wi + t;
      w[32 * wi + t] = p[8 * (15 - (bit >> 3)) + (bit & 7)];
    }
    transpose32(w + 32 * wi);
  }
}

// Lane j0 of a block given as four little-endian words (unmasked: the
// caller reduces mod 2^int_bits once at the end).
FM_INLINE uint32_t block_lane(uint32_t w0, uint32_t w1, uint32_t w2,
                              uint32_t w3, int j0, int int_bits) {
  const int bit = j0 * int_bits, wi = bit >> 5, off = bit & 31;
  const uint32_t lo = wi == 0 ? w0 : wi == 1 ? w1 : wi == 2 ? w2 : w3;
  const uint32_t hi = wi == 0 ? w1 : wi == 1 ? w2 : wi == 2 ? w3 : 0u;
  return off ? (lo >> off) | (hi << (32 - off)) : lo;
}

}  // namespace flashe_mask
