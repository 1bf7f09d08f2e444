"""Host-side AES for key wrapping and PRP oracles.

Mirrors the reference AESCipher (federatedml/secureprotol/jzf_aes.py):
AES-256 in ECB (PRP evaluation) or CTR with a zero initial counter (seed
wrapping in transit), with the same key-derivation rule for int/bytes
secrets.  The block cipher is a numpy AES vectorized over blocks, built on
ops/aes.py's S-box and key schedule (the reference uses PyCryptodome;
both are NIST AES, pinned against FIPS-197 and SP 800-38A vectors in
tests/test_aes_host.py).
"""

from __future__ import annotations

import os

import numpy as np

from flashe_tpu.ops.aes import SBOX, _SHIFT_ROWS, key_schedule

__all__ = ["AESCipher", "derive_key_bytes", "ecb_encrypt"]


def _xtime(a: np.ndarray) -> np.ndarray:
    return ((a << 1) & 0xFF) ^ (0x1B * (a >> 7))


def _mix_columns(s: np.ndarray) -> np.ndarray:
    c = s.reshape(-1, 4, 4)  # (blocks, column, row)
    s0, s1, s2, s3 = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    x0, x1, x2, x3 = _xtime(s0), _xtime(s1), _xtime(s2), _xtime(s3)
    out = np.stack([x0 ^ x1 ^ s1 ^ s2 ^ s3,
                    s0 ^ x1 ^ x2 ^ s2 ^ s3,
                    s0 ^ s1 ^ x2 ^ x3 ^ s3,
                    x0 ^ s0 ^ s1 ^ s2 ^ x3], axis=-1)
    return out.reshape(s.shape)


def ecb_encrypt(key: bytes, blocks: np.ndarray) -> np.ndarray:
    """AES-256-ECB of (N, 16) uint8 blocks -> (N, 16) uint8."""
    rk = key_schedule(key).astype(np.uint16)
    s = np.asarray(blocks, np.uint16) ^ rk[0]
    for r in range(1, 14):
        s = _mix_columns(SBOX[s][:, _SHIFT_ROWS].astype(np.uint16)) ^ rk[r]
    s = SBOX[s][:, _SHIFT_ROWS].astype(np.uint16) ^ rk[14]
    return s.astype(np.uint8)


def derive_key_bytes(secret, key_len_bytes: int) -> bytes:
    """Mask an int or bytes secret to the key length (jzf_aes.py:21-28)."""
    if isinstance(secret, bytes):
        secret = int.from_bytes(secret, "big")
    return (int(secret) & (256 ** key_len_bytes - 1)).to_bytes(
        key_len_bytes, "big"
    )


class _Ctr:
    """CTR keystream from a 128-bit big-endian counter (zero unless told
    otherwise); successive calls continue the stream, like a streaming
    cipher context."""

    def __init__(self, key: bytes, initial: int = 0):
        self.key = key
        self.initial = initial
        self.pos = 0  # bytes of keystream consumed

    def update(self, data: bytes) -> bytes:
        first = self.pos // 16
        last = max((self.pos + len(data) + 15) // 16, first + 1)
        blocks = np.frombuffer(b"".join(
            ((self.initial + i) % (1 << 128)).to_bytes(16, "big")
            for i in range(first, last)), np.uint8).reshape(-1, 16)
        stream = ecb_encrypt(self.key, blocks).reshape(-1)
        off = self.pos - 16 * first
        ks = stream[off: off + len(data)]
        self.pos += len(data)
        return (np.frombuffer(data, np.uint8) ^ ks).tobytes()


class _Ecb:
    def __init__(self, key: bytes):
        self.key = key

    def update(self, data: bytes) -> bytes:
        if len(data) % 16:
            raise ValueError("ECB input must be a multiple of 16 bytes")
        blocks = np.frombuffer(data, np.uint8).reshape(-1, 16)
        return ecb_encrypt(self.key, blocks).tobytes()


class AESCipher:
    """AES with ECB or CTR(initial_value=0) modes (jzf_aes.py:14-48)."""

    def __init__(self):
        self.key = None
        self._mode = None
        self._enc = None
        self._dec = None

    def generate_key(self, key_length: int = 256, assigned_key=None,
                     mode: str = "CTR"):
        if key_length != 256:
            raise ValueError("only AES-256 is supported")
        nbytes = key_length // 8
        if assigned_key is None:
            key = os.urandom(nbytes)
        else:
            key = derive_key_bytes(assigned_key, nbytes)
        self.key = key
        self._mode = mode
        if mode == "CTR":
            self._enc, self._dec = _Ctr(key), _Ctr(key)
        elif mode == "ECB":
            self._enc, self._dec = _Ecb(key), None  # PRP use: encrypt only
        else:
            raise ValueError(f"unsupported AES mode {mode}")

    def encrypt(self, plaintext: bytes) -> bytes:
        return self._enc.update(plaintext)

    def decrypt(self, ciphertext: bytes) -> bytes:
        if self._dec is None:
            raise NotImplementedError("ECB mode evaluates the PRP only")
        return self._dec.update(ciphertext)

    def get_key(self) -> bytes:
        return self.key
