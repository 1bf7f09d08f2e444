"""Bit-exact AES-256 as a vectorized JAX op.

FLASHE derives its one-time masks from AES-256-ECB evaluated over structured
16-byte indices (reference: federatedml/secureprotol/jzf_aes_prp.py:11-30,
jzf_flashe.py:48-82).  To make the whole cipher a device program, AES itself is
implemented here as an elementwise int32 program over byte planes:

- the key schedule runs on the host (tiny, once per session),
- block encryption is pure `jnp` bit arithmetic over an (N, 16) int32 batch
  of byte values, so XLA can fuse it with lane extraction and the mask
  add/sub that follows (see flashe_tpu/ops/masks.py),
- SubBytes has two interchangeable implementations:
  * `sbox_lookup` — a 256-entry table gather (always correct, used on CPU),
  * `sbox_circuit` — the Boyar–Peralta boolean circuit evaluated on the 8
    bit planes of each byte.  No gathers: pure XOR/AND ops, which is
    what the bitsliced stream (ops/aes_bitsliced.py) is built from.

Both are validated against each other and against the host AES oracles
in tests/test_aes.py.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

__all__ = [
    "SBOX",
    "key_schedule",
    "aes_encrypt_blocks",
    "sbox_lookup",
    "sbox_circuit",
]


# ---------------------------------------------------------------------------
# S-box derivation (host-side, once).  sbox[x] = affine(x^-1 in GF(2^8)).
# ---------------------------------------------------------------------------

def _gf_mul(a: int, b: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        if a & 0x100:
            a ^= 0x11B
        b >>= 1
    return r


def _derive_sbox() -> np.ndarray:
    # multiplicative inverse via x^254 (Fermat in GF(2^8)); 0 -> 0
    inv = [0] * 256
    for x in range(1, 256):
        v = x
        r = 1
        e = 254
        while e:
            if e & 1:
                r = _gf_mul(r, v)
            v = _gf_mul(v, v)
            e >>= 1
        inv[x] = r
    sbox = np.zeros(256, dtype=np.uint8)
    for x in range(256):
        b = inv[x]
        s = 0
        for i in range(8):
            bit = (
                (b >> i)
                ^ (b >> ((i + 4) % 8))
                ^ (b >> ((i + 5) % 8))
                ^ (b >> ((i + 6) % 8))
                ^ (b >> ((i + 7) % 8))
                ^ (0x63 >> i)
            ) & 1
            s |= bit << i
        sbox[x] = s
    return sbox


SBOX = _derive_sbox()
@functools.lru_cache(maxsize=1)
def _sbox_j():
    # lazy: a module-level jnp.asarray would initialise the XLA backend at
    # import time, which breaks jax.distributed.initialize in multi-host
    # children (parallel/multihost.py)
    return jnp.asarray(SBOX.astype(np.int32))

# ShiftRows permutation on flat byte index i = row + 4*col (FIPS-197
# column-major state): out[r + 4c] = in[r + 4*((c + r) % 4)].
_SHIFT_ROWS = np.array(
    [(i % 4) + 4 * (((i // 4) + (i % 4)) % 4) for i in range(16)], dtype=np.int32
)


# ---------------------------------------------------------------------------
# Key schedule (host side, plain python ints — runs once per session)
# ---------------------------------------------------------------------------

_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36, 0x6C]


def key_schedule(key: bytes) -> np.ndarray:
    """AES-256 key expansion -> (15, 16) uint8 round keys.

    Matches FIPS-197; the PRP seed in FLASHE is exactly this 32-byte key
    (reference jzf_flashe.py:280-295 masks an assigned seed to 256 bits).
    """
    if len(key) != 32:
        raise ValueError(f"AES-256 key must be 32 bytes, got {len(key)}")
    nk = 8
    words = [list(key[4 * i : 4 * i + 4]) for i in range(nk)]
    for i in range(nk, 60):
        temp = list(words[i - 1])
        if i % nk == 0:
            temp = temp[1:] + temp[:1]  # RotWord
            temp = [int(SBOX[b]) for b in temp]  # SubWord
            temp[0] ^= _RCON[i // nk - 1]
        elif i % nk == 4:
            temp = [int(SBOX[b]) for b in temp]
        words.append([a ^ b for a, b in zip(words[i - nk], temp)])
    rk = np.array(words, dtype=np.uint8).reshape(15, 16)
    return rk


# ---------------------------------------------------------------------------
# SubBytes
# ---------------------------------------------------------------------------

def sbox_lookup(x: jnp.ndarray) -> jnp.ndarray:
    """SubBytes via table gather.  x: int32 byte values in [0, 256)."""
    return jnp.take(_sbox_j(), x, axis=0)


def sbox_circuit(x: jnp.ndarray) -> jnp.ndarray:
    """SubBytes via the Boyar–Peralta 113-gate circuit on bit planes.

    Gather-free: only shifts/AND/XOR on int32, so the VPU executes it as
    straight-line elementwise code.  x: int32 byte values in [0, 256).
    """
    # bit planes; U0 is the MOST significant bit in the B-P convention
    u = [(x >> (7 - i)) & 1 for i in range(8)]
    U0, U1, U2, U3, U4, U5, U6, U7 = u
    x_ = jnp.bitwise_xor
    a_ = jnp.bitwise_and

    T1 = x_(U0, U3)
    T2 = x_(U0, U5)
    T3 = x_(U0, U6)
    T4 = x_(U3, U5)
    T5 = x_(U4, U6)
    T6 = x_(T1, T5)
    T7 = x_(U1, U2)
    T8 = x_(U7, T6)
    T9 = x_(U7, T7)
    T10 = x_(T6, T7)
    T11 = x_(U1, U5)
    T12 = x_(U2, U5)
    T13 = x_(T3, T4)
    T14 = x_(T6, T11)
    T15 = x_(T5, T11)
    T16 = x_(T5, T12)
    T17 = x_(T9, T16)
    T18 = x_(U3, U7)
    T19 = x_(T7, T18)
    T20 = x_(T1, T19)
    T21 = x_(U6, U7)
    T22 = x_(T7, T21)
    T23 = x_(T2, T22)
    T24 = x_(T2, T10)
    T25 = x_(T20, T17)
    T26 = x_(T3, T16)
    T27 = x_(T1, T12)

    M1 = a_(T13, T6)
    M2 = a_(T23, T8)
    M3 = x_(T14, M1)
    M4 = a_(T19, U7)
    M5 = x_(M4, M1)
    M6 = a_(T3, T16)
    M7 = a_(T22, T9)
    M8 = x_(T26, M6)
    M9 = a_(T20, T17)
    M10 = x_(M9, M6)
    M11 = a_(T1, T15)
    M12 = a_(T4, T27)
    M13 = x_(M12, M11)
    M14 = a_(T2, T10)
    M15 = x_(M14, M11)
    M16 = x_(M3, M2)
    M17 = x_(M5, T24)
    M18 = x_(M8, M7)
    M19 = x_(M10, M15)
    M20 = x_(M16, M13)
    M21 = x_(M17, M15)
    M22 = x_(M18, M13)
    M23 = x_(M19, T25)
    M24 = x_(M22, M23)
    M25 = a_(M22, M20)
    M26 = x_(M21, M25)
    M27 = x_(M20, M21)
    M28 = x_(M23, M25)
    M29 = a_(M28, M27)
    M30 = a_(M26, M24)
    M31 = a_(M20, M23)
    M32 = a_(M27, M31)
    M33 = x_(M27, M25)
    M34 = a_(M21, M22)
    M35 = a_(M24, M34)
    M36 = x_(M24, M25)
    M37 = x_(M21, M29)
    M38 = x_(M32, M33)
    M39 = x_(M23, M30)
    M40 = x_(M35, M36)
    M41 = x_(M38, M40)
    M42 = x_(M37, M39)
    M43 = x_(M37, M38)
    M44 = x_(M39, M40)
    M45 = x_(M42, M41)
    M46 = a_(M44, T6)
    M47 = a_(M40, T8)
    M48 = a_(M39, U7)
    M49 = a_(M43, T16)
    M50 = a_(M38, T9)
    M51 = a_(M37, T17)
    M52 = a_(M42, T15)
    M53 = a_(M45, T27)
    M54 = a_(M41, T10)
    M55 = a_(M44, T13)
    M56 = a_(M40, T23)
    M57 = a_(M39, T19)
    M58 = a_(M43, T3)
    M59 = a_(M38, T22)
    M60 = a_(M37, T20)
    M61 = a_(M42, T1)
    M62 = a_(M45, T4)
    M63 = a_(M41, T2)

    L0 = x_(M61, M62)
    L1 = x_(M50, M56)
    L2 = x_(M46, M48)
    L3 = x_(M47, M55)
    L4 = x_(M54, M58)
    L5 = x_(M49, M61)
    L6 = x_(M62, L5)
    L7 = x_(M46, L3)
    L8 = x_(M51, M59)
    L9 = x_(M52, M53)
    L10 = x_(M53, L4)
    L11 = x_(M60, L2)
    L12 = x_(M48, M51)
    L13 = x_(M50, L0)
    L14 = x_(M52, M61)
    L15 = x_(M55, L1)
    L16 = x_(M56, L0)
    L17 = x_(M57, L1)
    L18 = x_(M58, L8)
    L19 = x_(M63, L4)
    L20 = x_(L0, L1)
    L21 = x_(L1, L7)
    L22 = x_(L3, L12)
    L23 = x_(L18, L2)
    L24 = x_(L15, L9)
    L25 = x_(L6, L10)
    L26 = x_(L7, L9)
    L27 = x_(L8, L10)
    L28 = x_(L11, L14)
    L29 = x_(L11, L17)

    one = jnp.int32(1)
    S0 = x_(L6, L24)
    S1 = x_(x_(L16, L26), one)  # XNOR
    S2 = x_(x_(L19, L28), one)
    S3 = x_(L6, L21)
    S4 = x_(L20, L22)
    S5 = x_(L25, L29)
    S6 = x_(x_(L13, L27), one)
    S7 = x_(x_(L6, L23), one)

    # S0 is the most significant output bit
    out = (
        (S0 << 7) | (S1 << 6) | (S2 << 5) | (S3 << 4)
        | (S4 << 3) | (S5 << 2) | (S6 << 1) | S7
    )
    return out


# ---------------------------------------------------------------------------
# Round functions
# ---------------------------------------------------------------------------

def _shift_rows(state: jnp.ndarray) -> jnp.ndarray:
    return state[..., _SHIFT_ROWS]


def _xtime(a: jnp.ndarray) -> jnp.ndarray:
    return ((a << 1) & 0xFF) ^ (0x1B * ((a >> 7) & 1))


def _mix_columns(state: jnp.ndarray) -> jnp.ndarray:
    # state (..., 16) with byte i = row i%4 of column i//4
    s = state.reshape(state.shape[:-1] + (4, 4))  # (..., col, row)
    s0, s1, s2, s3 = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    x0, x1, x2, x3 = _xtime(s0), _xtime(s1), _xtime(s2), _xtime(s3)
    o0 = x0 ^ x1 ^ s1 ^ s2 ^ s3
    o1 = s0 ^ x1 ^ x2 ^ s2 ^ s3
    o2 = s0 ^ s1 ^ x2 ^ x3 ^ s3
    o3 = x0 ^ s0 ^ s1 ^ s2 ^ x3
    out = jnp.stack([o0, o1, o2, o3], axis=-1)
    return out.reshape(state.shape)


def aes_encrypt_blocks(
    blocks: jnp.ndarray, round_keys: jnp.ndarray, use_circuit: bool = True
) -> jnp.ndarray:
    """AES-256-ECB encrypt a batch of blocks.

    blocks: (..., 16) int32 byte values; round_keys: (15, 16) int32 (device
    array or numpy).  Returns (..., 16) int32 byte values.
    """
    sub = sbox_circuit if use_circuit else sbox_lookup
    rk = jnp.asarray(round_keys, dtype=jnp.int32)
    state = blocks ^ rk[0]
    for r in range(1, 14):
        state = sub(state)
        state = _shift_rows(state)
        state = _mix_columns(state)
        state = state ^ rk[r]
    state = sub(state)
    state = _shift_rows(state)
    state = state ^ rk[14]
    return state
