"""The numpy AES-256 (crypto/aes_host.py) against the NIST vectors, and the
host PRP oracle built on it."""

import numpy as np
import pytest

from flashe_tpu.crypto.aes_host import AESCipher, _Ctr, ecb_encrypt
from flashe_tpu.ops import aes, masks

FIPS_KEY = bytes.fromhex(
    "000102030405060708090a0b0c0d0e0f101112131415161718191a1b1c1d1e1f")
SP_KEY = bytes.fromhex(
    "603deb1015ca71be2b73aef0857d77811f352c073b6108d72d9810a30914dff4")
SP_PLAIN = bytes.fromhex(
    "6bc1bee22e409f96e93d7e117393172a" "ae2d8a571e03ac9c9eb76fac45af8e51"
    "30c81c46a35ce411e5fbc1191a0a52ef" "f69f2445df4f9b17ad2b417be66c3710")


def test_fips197_c3_aes256():
    block = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"),
                          np.uint8).reshape(1, 16)
    assert ecb_encrypt(FIPS_KEY, block).tobytes().hex() == \
        "8ea2b7ca516745bfeafc49904b496089"


def test_sp800_38a_f55_ctr_aes256():
    ctr = _Ctr(SP_KEY, initial=int("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff", 16))
    ct = ctr.update(SP_PLAIN[:5]) + ctr.update(SP_PLAIN[5:])  # streaming
    assert ct.hex() == (
        "601ec313775789a5b7a7f504bbf3d228" "f443e3ca4d62b59aca84e990cacaf5c5"
        "2b0930daa23de94ce87017ba2d84988d" "dfc9c58db67aada613c2dd08457941a6")


def test_sp800_38a_f55_ecb_blocks():
    """F.5.5's keystream blocks are ECB encryptions of its counters."""
    counters = [int("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff", 16) + i
                for i in range(4)]
    blocks = np.frombuffer(b"".join(c.to_bytes(16, "big") for c in counters),
                           np.uint8).reshape(4, 16)
    ks = ecb_encrypt(SP_KEY, blocks).tobytes()
    assert ks[:16].hex() == "0bdf7df1591716335e9a8b15c860c502"


def test_ctr_key_wrap_roundtrip():
    """The seed wrap of the protocol blocks: CTR from a zero counter with
    an int-derived key, decrypted by a fresh cipher."""
    secret = 0x1234_5678_9ABC_DEF0 << 100
    blob = bytes(range(40))
    a = AESCipher()
    a.generate_key(256, assigned_key=secret, mode="CTR")
    b = AESCipher()
    b.generate_key(256, assigned_key=secret, mode="CTR")
    wrapped = a.encrypt(blob)
    assert wrapped != blob
    assert b.decrypt(wrapped) == blob


def test_ecb_mode_is_encrypt_only():
    c = AESCipher()
    c.generate_key(256, assigned_key=5, mode="ECB")
    assert len(c.encrypt(bytes(32))) == 32
    with pytest.raises(NotImplementedError):
        c.decrypt(bytes(16))
    with pytest.raises(ValueError):
        c.encrypt(bytes(5))


@pytest.mark.parametrize("int_bits", [16, 20, 120])
def test_host_oracle_matches_byteplane_aes(int_bits):
    """reference_mask_stream_host == the device byte-plane AES stream, and
    its begin_block offset slices the global stream."""
    seed = bytes(range(3, 35))
    rk = aes.key_schedule(seed)
    want = masks.reference_mask_stream_host(seed, 2, 5, 300, int_bits)
    got = np.asarray(masks.prp_lane_stream(rk, 2, 5, 300, int_bits,
                                           impl="byteplane"))
    if got.ndim == 2:
        from flashe_tpu.ops.lanes import lanes_to_ints

        got = lanes_to_ints(got, int_bits)
    np.testing.assert_array_equal(np.asarray(got, dtype=object), want)
    merge = masks.merge_size(int_bits)
    tail = masks.reference_mask_stream_host(seed, 2, 5, 300 - 10 * merge,
                                            int_bits, begin_block=10)
    np.testing.assert_array_equal(tail, want[10 * merge:])
