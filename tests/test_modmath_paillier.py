"""Montgomery limb kernels and the Paillier baseline vs python-int oracles."""

import numpy as np
import jax.numpy as jnp
import pytest

from flashe_tpu.crypto import paillier
from flashe_tpu.ops import modmath

pytestmark = pytest.mark.slow  # HE kernels: minutes on CPU; run in the full suite


def test_limb_roundtrip():
    vals = [0, 1, (1 << 500) - 3, 123456789 ** 5]
    limbs = modmath.to_limbs(vals, 40)
    assert modmath.from_limbs(limbs) == vals


def test_add_sub_limbs():
    rng = np.random.RandomState(0)
    L = 20
    a = [int.from_bytes(rng.bytes(L * 2 - 1), "big") for _ in range(8)]
    b = [int.from_bytes(rng.bytes(L * 2 - 1), "big") for _ in range(8)]
    A = jnp.asarray(modmath.to_limbs(a, L))
    B = jnp.asarray(modmath.to_limbs(b, L))
    R = 1 << (16 * L)
    got_add = modmath.from_limbs(np.asarray(modmath.add_limbs(A, B)))
    assert got_add == [(x + y) % R for x, y in zip(a, b)]
    got_sub = modmath.from_limbs(np.asarray(modmath.sub_limbs(A, B)))
    assert got_sub == [(x - y) % R for x, y in zip(a, b)]


@pytest.mark.parametrize("nbits", [256, 1024])
def test_mont_mul_and_exp(nbits):
    rng = np.random.RandomState(1)
    # deterministic odd modulus
    n = (int.from_bytes(rng.bytes(nbits // 8), "big") | (1 << (nbits - 1))) | 1
    ctx = modmath.MontCtx(n)
    a = [int.from_bytes(rng.bytes(nbits // 8 - 1), "big") % n for _ in range(5)]
    b = [int.from_bytes(rng.bytes(nbits // 8 - 1), "big") % n for _ in range(5)]
    A = modmath.mont_from(ctx, jnp.asarray(modmath.to_limbs(a, ctx.L)))
    B = modmath.mont_from(ctx, jnp.asarray(modmath.to_limbs(b, ctx.L)))
    prod = modmath.mont_to(ctx, modmath.mont_mul(ctx, A, B))
    got = modmath.from_limbs(np.asarray(prod))
    assert got == [(x * y) % n for x, y in zip(a, b)]

    e = 0x10001
    ebits = jnp.asarray(modmath.exponent_bits(e, 17))
    powed = modmath.mont_to(ctx, modmath.mont_exp(ctx, A, ebits))
    got = modmath.from_limbs(np.asarray(powed))
    assert got == [pow(x, e, n) for x in a]


def test_paillier_roundtrip_small_key():
    c = paillier.PaillierCipher()
    c.generate_key(n_length=512)  # small key: fast tests, same kernels
    rng = np.random.RandomState(2)
    msgs = np.array([int(v) for v in rng.randint(0, 1 << 40, 6)], dtype=object)
    cts = c.encrypt(msgs)
    dec = c.decrypt(cts)
    assert list(dec) == list(msgs)


def test_paillier_homomorphic_sum():
    c = paillier.PaillierCipher()
    c.generate_key(n_length=512)
    rng = np.random.RandomState(3)
    batches = [
        np.array([int(v) for v in rng.randint(0, 1 << 30, 4)], dtype=object)
        for _ in range(3)
    ]
    cts = [c.encrypt(b) for b in batches]
    agg = c.add_ciphertexts(cts)
    dec = c.decrypt(agg)
    want = [int(sum(b[i] for b in batches)) for i in range(4)]
    assert list(dec) == want


def test_device_encrypt_matches_host_oracle():
    """The device modexp path must agree with host pow() for fixed r."""
    pub, prv = paillier.PaillierKeypair.generate_keypair(512)
    c = paillier.PaillierCipher()
    c.set_public_key(pub)
    c.set_privacy_key(prv)
    # deterministic obfuscators for reproducibility
    rs = [12345, 67890, 13579]
    c._obfuscators = lambda count: rs[:count]
    msgs = np.array([1, 2, 3], dtype=object)
    cts = c.encrypt(msgs)
    want = [pub.encrypt_scalar(int(m), r) for m, r in zip(msgs, rs)]
    assert list(cts) == want


def test_mont_exp_window_matches_pow():
    rng = np.random.RandomState(5)
    nbits = 512
    n = (int.from_bytes(rng.bytes(nbits // 8), "big") | (1 << (nbits - 1))) | 1
    ctx = modmath.MontCtx(n)
    a = [int.from_bytes(rng.bytes(nbits // 8 - 1), "big") % n
         for _ in range(4)]
    e = int.from_bytes(rng.bytes(64), "big")  # 512-bit exponent
    A = modmath.mont_from(ctx, jnp.asarray(modmath.to_limbs(a, ctx.L)))
    digs = jnp.asarray(modmath.exponent_digits(e, e.bit_length()))
    got = modmath.from_limbs(
        np.asarray(modmath.mont_to(ctx, modmath.mont_exp_window(ctx, A, digs))))
    assert got == [pow(x, e, n) for x in a]


def test_mont_mul_v_per_row_modulus():
    """Per-row-modulus Montgomery product (the merged CRT chain core)
    matches the per-context mont_mul row by row."""
    rng = np.random.RandomState(11)
    nbits = 256
    mods = []
    while len(mods) < 2:
        n = (int.from_bytes(rng.bytes(nbits // 8), "big")
             | (1 << (nbits - 1))) | 1
        mods.append(n)
    n1, n2 = mods
    L = modmath.MontCtx(n1).L
    B = 5
    a1 = [int.from_bytes(rng.bytes(nbits // 8 - 1), "big") % n1
          for _ in range(B)]
    b1 = [int.from_bytes(rng.bytes(nbits // 8 - 1), "big") % n1
          for _ in range(B)]
    a2 = [int.from_bytes(rng.bytes(nbits // 8 - 1), "big") % n2
          for _ in range(B)]
    b2 = [int.from_bytes(rng.bytes(nbits // 8 - 1), "big") % n2
          for _ in range(B)]
    a = jnp.asarray(modmath.to_limbs(a1 + a2, L))
    b = jnp.asarray(modmath.to_limbs(b1 + b2, L))
    nl = jnp.asarray(modmath.to_limbs([n1] * B + [n2] * B, L))
    npr = jnp.asarray(np.array(
        [(-pow(n1, -1, 1 << 16)) % (1 << 16)] * B
        + [(-pow(n2, -1, 1 << 16)) % (1 << 16)] * B, np.uint32))
    got = modmath.mont_mul_v(a, b, nl, npr)
    ctx1, ctx2 = modmath.MontCtx(n1, L), modmath.MontCtx(n2, L)
    want1 = modmath.mont_mul(ctx1, a[:B], b[:B])
    want2 = modmath.mont_mul(ctx2, a[B:], b[B:])
    np.testing.assert_array_equal(np.asarray(got[:B]), np.asarray(want1))
    np.testing.assert_array_equal(np.asarray(got[B:]), np.asarray(want2))


def test_pair_ctx_exp_matches_pow():
    """PairMontCtx runs both CRT exponent chains as one batch and
    matches python pow() on each side."""
    rng = np.random.RandomState(12)
    nbits = 256
    n1 = (int.from_bytes(rng.bytes(nbits // 8), "big")
          | (1 << (nbits - 1))) | 1
    n2 = (int.from_bytes(rng.bytes(nbits // 8), "big")
          | (1 << (nbits - 1))) | 1
    pair = modmath.PairMontCtx(n1, n2)
    B = 3
    c1 = [int.from_bytes(rng.bytes(nbits // 8 - 1), "big") % n1
          for _ in range(B)]
    c2 = [int.from_bytes(rng.bytes(nbits // 8 - 1), "big") % n2
          for _ in range(B)]
    e1 = int.from_bytes(rng.bytes(16), "big")
    e2 = int.from_bytes(rng.bytes(16), "big")
    nb = max(e1.bit_length(), e2.bit_length())
    x1, x2 = pair.exp_pair(
        jnp.asarray(modmath.to_limbs(c1, pair.L)),
        jnp.asarray(modmath.to_limbs(c2, pair.L)),
        modmath.exponent_digits(e1, nb), modmath.exponent_digits(e2, nb))
    assert modmath.from_limbs(np.asarray(x1)) == [
        pow(c, e1, n1) for c in c1]
    assert modmath.from_limbs(np.asarray(x2)) == [
        pow(c, e2, n2) for c in c2]
