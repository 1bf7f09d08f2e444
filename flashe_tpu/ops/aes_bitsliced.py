"""Bitsliced AES-256 counter-mode mask streams — the fast path.

The byte-plane implementation (flashe_tpu/ops/aes.py) spends one int32
lane per byte, wasting 24 of 32 bits.  Here 32 counter blocks share each
uint32: the state is 128 bit-planes, each a (ngroups,) uint32 vector whose
bit j belongs to block 32*g + j.  Every AES gate then processes 32 blocks
at once, cutting per-block arithmetic ~30x:

- counters are generated *directly in bitsliced form*: for 32-aligned
  groups the low 5 counter bits are compile-time constants
  (0xAAAAAAAA, ...) and higher bits are per-group broadcasts — no
  transpose on the way in,
- SubBytes is the same Boyar-Peralta circuit, evaluated once over the
  (16 bytes, ngroups) plane stack per bit-position,
- ShiftRows/MixColumns are static plane rewiring + XORs (xtime is a plane
  rotation with 0x1B taps),
- only the way *out* needs a 32x32 bit transpose (Hacker's Delight
  swap network, 5 stages of masked shifts) to recover per-block words,
  then lanes are extracted exactly as in flashe_tpu/ops/masks.py.

Bit-exact with the reference PRP stream (same contract as
flashe_tpu/ops/masks.py); pinned against it in tests/test_bitsliced.py.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from flashe_tpu.ops import aes as aes_mod
from flashe_tpu.ops.lanes import nlimbs_for
from flashe_tpu.ops.masks import merge_size, num_blocks

__all__ = ["bitsliced_prp_lane_stream", "bitsliced_counter_words",
           "round_key_planes"]

_FULL = np.uint32(0xFFFFFFFF)

# constant planes of the within-group counter bits (j = 0..31)
_LOW_BIT_PLANES = [
    np.uint32(0xAAAAAAAA),  # bit 0 of j
    np.uint32(0xCCCCCCCC),  # bit 1
    np.uint32(0xF0F0F0F0),  # bit 2
    np.uint32(0xFF00FF00),  # bit 3
    np.uint32(0xFFFF0000),  # bit 4
]


def _sbox_planes(bits):
    """Boyar-Peralta circuit over plane stacks.

    bits: list of 8 arrays (i = bit significance 0..7, LSB first), each
    (16, ngroups) uint32.  Returns the substituted 8 planes, same order.
    """
    # circuit convention: U0 is the MSB
    U = [bits[7 - i] for i in range(8)]
    x_, a_ = jnp.bitwise_xor, jnp.bitwise_and
    U0, U1, U2, U3, U4, U5, U6, U7 = U

    T1 = x_(U0, U3); T2 = x_(U0, U5); T3 = x_(U0, U6); T4 = x_(U3, U5)
    T5 = x_(U4, U6); T6 = x_(T1, T5); T7 = x_(U1, U2); T8 = x_(U7, T6)
    T9 = x_(U7, T7); T10 = x_(T6, T7); T11 = x_(U1, U5); T12 = x_(U2, U5)
    T13 = x_(T3, T4); T14 = x_(T6, T11); T15 = x_(T5, T11)
    T16 = x_(T5, T12); T17 = x_(T9, T16); T18 = x_(U3, U7)
    T19 = x_(T7, T18); T20 = x_(T1, T19); T21 = x_(U6, U7)
    T22 = x_(T7, T21); T23 = x_(T2, T22); T24 = x_(T2, T10)
    T25 = x_(T20, T17); T26 = x_(T3, T16); T27 = x_(T1, T12)

    M1 = a_(T13, T6); M2 = a_(T23, T8); M3 = x_(T14, M1)
    M4 = a_(T19, U7); M5 = x_(M4, M1); M6 = a_(T3, T16)
    M7 = a_(T22, T9); M8 = x_(T26, M6); M9 = a_(T20, T17)
    M10 = x_(M9, M6); M11 = a_(T1, T15); M12 = a_(T4, T27)
    M13 = x_(M12, M11); M14 = a_(T2, T10); M15 = x_(M14, M11)
    M16 = x_(M3, M2); M17 = x_(M5, T24); M18 = x_(M8, M7)
    M19 = x_(M10, M15); M20 = x_(M16, M13); M21 = x_(M17, M15)
    M22 = x_(M18, M13); M23 = x_(M19, T25); M24 = x_(M22, M23)
    M25 = a_(M22, M20); M26 = x_(M21, M25); M27 = x_(M20, M21)
    M28 = x_(M23, M25); M29 = a_(M28, M27); M30 = a_(M26, M24)
    M31 = a_(M20, M23); M32 = a_(M27, M31); M33 = x_(M27, M25)
    M34 = a_(M21, M22); M35 = a_(M24, M34); M36 = x_(M24, M25)
    M37 = x_(M21, M29); M38 = x_(M32, M33); M39 = x_(M23, M30)
    M40 = x_(M35, M36); M41 = x_(M38, M40); M42 = x_(M37, M39)
    M43 = x_(M37, M38); M44 = x_(M39, M40); M45 = x_(M42, M41)
    M46 = a_(M44, T6); M47 = a_(M40, T8); M48 = a_(M39, U7)
    M49 = a_(M43, T16); M50 = a_(M38, T9); M51 = a_(M37, T17)
    M52 = a_(M42, T15); M53 = a_(M45, T27); M54 = a_(M41, T10)
    M55 = a_(M44, T13); M56 = a_(M40, T23); M57 = a_(M39, T19)
    M58 = a_(M43, T3); M59 = a_(M38, T22); M60 = a_(M37, T20)
    M61 = a_(M42, T1); M62 = a_(M45, T4); M63 = a_(M41, T2)

    L0 = x_(M61, M62); L1 = x_(M50, M56); L2 = x_(M46, M48)
    L3 = x_(M47, M55); L4 = x_(M54, M58); L5 = x_(M49, M61)
    L6 = x_(M62, L5); L7 = x_(M46, L3); L8 = x_(M51, M59)
    L9 = x_(M52, M53); L10 = x_(M53, L4); L11 = x_(M60, L2)
    L12 = x_(M48, M51); L13 = x_(M50, L0); L14 = x_(M52, M61)
    L15 = x_(M55, L1); L16 = x_(M56, L0); L17 = x_(M57, L1)
    L18 = x_(M58, L8); L19 = x_(M63, L4); L20 = x_(L0, L1)
    L21 = x_(L1, L7); L22 = x_(L3, L12); L23 = x_(L18, L2)
    L24 = x_(L15, L9); L25 = x_(L6, L10); L26 = x_(L7, L9)
    L27 = x_(L8, L10); L28 = x_(L11, L14); L29 = x_(L11, L17)

    S0 = x_(L6, L24)
    S1 = x_(x_(L16, L26), _FULL)  # XNOR on planes
    S2 = x_(x_(L19, L28), _FULL)
    S3 = x_(L6, L21)
    S4 = x_(L20, L22)
    S5 = x_(L25, L29)
    S6 = x_(x_(L13, L27), _FULL)
    S7 = x_(x_(L6, L23), _FULL)
    S = [S0, S1, S2, S3, S4, S5, S6, S7]  # S0 = MSB
    return [S[7 - i] for i in range(8)]  # back to LSB-first


def _xtime_stack(b):
    """xtime over a (..., 8, G) byte-plane stack (LSB-first bit axis)."""
    b7 = b[..., 7:8, :]
    return jnp.concatenate([
        b7,
        b[..., 0:1, :] ^ b7,
        b[..., 1:2, :],
        b[..., 2:3, :] ^ b7,
        b[..., 3:4, :] ^ b7,
        b[..., 4:7, :],
    ], axis=-2)


def _mix_columns_stack(S):
    """S: (16, 8, G) plane state, flat byte index r + 4c."""
    s = S.reshape(4, 4, 8, S.shape[-1])  # (col, row, bit, G)
    xt = _xtime_stack(s)
    s0, s1, s2, s3 = s[:, 0], s[:, 1], s[:, 2], s[:, 3]
    x0, x1, x2, x3 = xt[:, 0], xt[:, 1], xt[:, 2], xt[:, 3]
    o0 = x0 ^ x1 ^ s1 ^ s2 ^ s3
    o1 = s0 ^ x1 ^ x2 ^ s2 ^ s3
    o2 = s0 ^ s1 ^ x2 ^ x3 ^ s3
    o3 = x0 ^ s0 ^ s1 ^ s2 ^ x3
    return jnp.stack([o0, o1, o2, o3], axis=1).reshape(S.shape)


def _transpose32(words):
    """Hacker's Delight 32x32 bit transpose.

    words: list of 32 arrays (ngroups,) uint32.  Returns out with
    out[j] bit t == words[t] bit j (the exact transpose).  The raw HD
    network computes the double-reversed transpose, so input and output
    orders are flipped around it.
    """
    x = list(reversed(words))
    j = 16
    m = np.uint32(0x0000FFFF)
    while j != 0:
        k = 0
        while k < 32:
            t = (x[k] ^ (x[k + j] >> j)) & m
            x[k] = x[k] ^ t
            x[k + j] = x[k + j] ^ (t << j)
            k = (k + j + 1) & ~j
        j >>= 1
        m = m ^ (m << j) if j else m
    return list(reversed(x))


def bitsliced_counter_words(round_keys, iter_index, stream_idx,
                            ngroups: int, begin_block=0):
    """AES-256 counter blocks as bit-transposed 32-bit words.

    Generates blocks [begin_block, begin_block + 32*ngroups) (begin_block
    must be 32-aligned) and returns a list of four (32, ngroups) uint32
    arrays: words[w][j, g] is 32-bit word w (w0 = least significant) of
    block begin_block + 32*g + j.  Callers turn the (32, G) words into
    linear block order themselves (bitsliced_prp_lane_stream).
    """
    iter_index = jnp.asarray(iter_index, jnp.int32)
    stream_idx = jnp.asarray(stream_idx, jnp.int32)
    base = jnp.asarray(begin_block, jnp.int32)
    group_base = base + 32 * jnp.arange(ngroups, dtype=jnp.int32)

    # --- build bitsliced counter blocks as one (16, 8, G) plane tensor;
    # S[k, i] = plane of bit i (LSB-first) of byte k ---
    zeros = jnp.zeros((ngroups,), jnp.uint32)
    bit_idx = jnp.arange(8, dtype=jnp.int32)

    def scalar_byte_planes(byte):  # (8, G) planes of a traced byte
        bits = ((byte >> bit_idx) & 1).astype(jnp.uint32) * _FULL
        return jnp.broadcast_to(bits[:, None], (8, ngroups))

    rows = []
    for k in range(4):  # bytes 0-3: iter_index BE
        rows.append(scalar_byte_planes((iter_index >> (8 * (3 - k))) & 0xFF))
    for k in range(4):  # bytes 4-7: stream_idx BE
        rows.append(scalar_byte_planes((stream_idx >> (8 * (3 - k))) & 0xFF))
    for k in range(8):  # bytes 8-15: 64-bit counter BE, ctr = group_base + j
        byte_rows = []
        for i in range(8):
            bitpos = (7 - k) * 8 + i
            if bitpos < 5:
                byte_rows.append(jnp.full(
                    (ngroups,), _LOW_BIT_PLANES[bitpos], jnp.uint32))
            elif bitpos < 31:
                byte_rows.append(
                    ((group_base >> bitpos) & 1).astype(jnp.uint32) * _FULL)
            else:
                byte_rows.append(zeros)  # counters < 2^31
        rows.append(jnp.stack(byte_rows))
    S = jnp.stack(rows)  # (16, 8, G)

    # --- round key planes: (15, 16, 8, 1), one XOR per AddRoundKey ---
    rk = jnp.asarray(round_keys, jnp.int32)
    rk_planes = (
        ((rk[:, :, None] >> bit_idx[None, None, :]) & 1).astype(jnp.uint32)
        * _FULL
    )[..., None]  # (15, 16, 8, 1)

    def sub_bytes(S):
        bits = [S[:, i, :] for i in range(8)]
        return jnp.stack(_sbox_planes(bits), axis=1)

    # ShiftRows as static restacking (no gather)
    perm = [int(p) for p in aes_mod._SHIFT_ROWS]

    def shift_rows(S):
        return jnp.stack([S[p] for p in perm])

    S = S ^ rk_planes[0]
    for r in range(1, 14):
        S = sub_bytes(S)
        S = shift_rows(S)
        S = _mix_columns_stack(S)
        S = S ^ rk_planes[r]
    S = sub_bytes(S)
    S = shift_rows(S)
    S = S ^ rk_planes[14]

    # --- un-bitslice into per-block 32-bit words (w0 = least significant)
    words = []
    for w in range(4):
        plane_list = []
        for t in range(32):
            bitpos = 32 * w + t
            k = 15 - (bitpos >> 3)
            i = bitpos & 7
            plane_list.append(S[k, i])
        tr = _transpose32(plane_list)  # tr[j] holds word w of blocks j mod 32
        words.append(jnp.stack(tr, axis=0))  # (32, ngroups)
    return words


def round_key_planes(round_keys):
    """(15, 16) AES round-key bytes -> (15, 128) uint32 bit masks.

    Entry [r, 8 * k + i] is all ones where bit i (LSB first) of byte k
    of round key r is set, else zero: AddRoundKey on bit-planes is then
    one XOR per plane with a ready-made scalar (the fused CUDA kernel's
    key input, native/flashe_mask.h).
    """
    rk = jnp.asarray(round_keys, jnp.int32)
    bits = (rk[:, :, None] >> jnp.arange(8, dtype=jnp.int32)) & 1
    return (bits.astype(jnp.uint32) * _FULL).reshape(15, 128)


def bitsliced_prp_lane_stream(round_keys, iter_index, stream_idx,
                              count: int, int_bits: int, begin_block=0):
    """Drop-in equivalent of prp_lane_stream via bitsliced AES.

    Lane semantics and bit-exactness contract identical to
    flashe_tpu/ops/masks.py.  The counter base is aligned to 32 blocks
    internally and the offset lanes are sliced off (0..31 blocks of
    overgeneration).
    """
    nb = num_blocks(count, int_bits)
    raw_base = jnp.asarray(begin_block, jnp.int32)
    base = raw_base & np.int32(~31)
    skip_blocks = raw_base - base
    nb_padded = nb + 31  # room for the worst-case misalignment
    ngroups = -(-nb_padded // 32)

    words = bitsliced_counter_words(round_keys, iter_index, stream_idx,
                                    ngroups, base)
    # linear block order: (32, G) -> (G, 32) -> flat
    words_per_block = [w.transpose(1, 0).reshape(ngroups * 32)
                       for w in words]
    words_per_block.append(jnp.zeros_like(words_per_block[0]))

    # --- lane extraction (same as masks.lanes_from_blocks) ---
    merge = merge_size(int_bits)
    nl = nlimbs_for(int_bits)
    top_bits = int_bits - 32 * (nl - 1)
    top_mask = np.uint32((1 << top_bits) - 1) if top_bits < 32 else _FULL

    def extract32(bitpos):
        wi, off = bitpos >> 5, bitpos & 31
        if off == 0:
            return words_per_block[wi]
        return (words_per_block[wi] >> off) | (
            words_per_block[wi + 1] << (32 - off))

    lanes = []
    for j in range(merge):
        limbs = []
        for l in range(nl):
            v = extract32(j * int_bits + 32 * l)
            limbs.append(v & top_mask if l == nl - 1 else v)
        lanes.append(jnp.stack(limbs, axis=-1))
    all_lanes = jnp.stack(lanes, axis=1).reshape(ngroups * 32 * merge, nl)
    out = jax.lax.dynamic_slice(
        all_lanes, (skip_blocks * merge, 0 * skip_blocks), (count, nl))
    if nl == 1:
        return out[:, 0]
    return out
