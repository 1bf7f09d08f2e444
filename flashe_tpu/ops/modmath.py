"""Fixed-limb modular bignum arithmetic for the general-HE baselines.

The reference's Paillier baseline runs per-element 2048-bit modexp through
gmpy2 on CPU pools (jzf_paillier.py:190-237).  Here big numbers are
(batch, L) uint32 arrays of 16-bit little-endian limbs and modular
multiplication is CIOS Montgomery reduction vectorized over the batch:
every step is an elementwise/broadcast op over the batch x limb grid and
16-bit limb products fit uint32 exactly
((2^16-1)^2 < 2^32).

Carry discipline: limb products are split into lo/hi halves and
accumulated into uint32 "lazy" accumulators; they grow by < 2^18 per CIOS
step, so for L <= 512 they stay < 2^27 and one exact normalization at the
end suffices.  Normalization and subtraction use a Kogge-Stone style
generate/propagate carry resolution via jax.lax.associative_scan (log-depth
instead of a ripple chain).  Montgomery's per-step m = t0 * n' mod 2^16
needs only t0's low 16 bits, which are exact in the lazy representation
(all other limbs carry weight 2^16k).

Exponents are passed as bit arrays and processed with a constant-time
square-and-always-multiply lax.scan — branchless, which is both
XLA-friendly and the right thing for secret exponents (Paillier CRT
decryption).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "MontCtx", "to_limbs", "from_limbs", "add_limbs", "sub_limbs", "geq",
    "normalize", "mont_mul", "mont_exp", "mont_from", "mont_to",
    "exponent_bits",
]

_BASE_BITS = 16
_BASE = 1 << _BASE_BITS
_BMASK = _BASE - 1


# ---------------------------------------------------------------------------
# host conversions
# ---------------------------------------------------------------------------

def to_limbs(values, L: int) -> np.ndarray:
    """python ints -> (B, L) uint32 array of 16-bit limbs.

    C-speed conversion via int.to_bytes: the per-limb python loop cost
    dominated Paillier's end-to-end add/dec times at realistic batch
    sizes (2,572 cts x 256 limbs ~ 2 s of pure interpreter time)."""
    nbytes = 2 * L
    if len(values) == 0:
        return np.zeros((0, L), np.uint32)
    try:
        buf = b"".join(int(v).to_bytes(nbytes, "little") for v in values)
    except OverflowError as e:
        raise ValueError("value does not fit in L limbs") from e
    return (np.frombuffer(buf, dtype="<u2").reshape(len(values), L)
            .astype(np.uint32))


def from_limbs(limbs: np.ndarray) -> list:
    """(B, L) uint32 limb array -> python ints (C-speed via from_bytes)."""
    a = np.ascontiguousarray(np.asarray(limbs).astype("<u2"))
    if a.ndim == 1:
        a = a[None, :]
    nbytes = 2 * a.shape[1]
    buf = a.tobytes()
    return [int.from_bytes(buf[i * nbytes : (i + 1) * nbytes], "little")
            for i in range(a.shape[0])]


def exponent_bits(e: int, nbits: int) -> np.ndarray:
    """LSB-first bit array of an exponent, padded to nbits."""
    return np.array([(e >> i) & 1 for i in range(nbits)], np.uint32)


# ---------------------------------------------------------------------------
# exact carry resolution (Kogge-Stone over limbs)
# ---------------------------------------------------------------------------

def _resolve_carries(s: jnp.ndarray) -> jnp.ndarray:
    """Digits s < 2*BASE -> normalized digits < BASE (exact addition tail).

    Carry recurrence c_{j+1} = g_j | (p_j & c_j) with g = s>=BASE,
    p = s==BASE-1 is associative; resolved in log L steps.
    """
    g = (s >= _BASE).astype(jnp.uint32)
    p = (s == _BMASK).astype(jnp.uint32)

    def combine(lo, hi):
        g1, p1 = lo
        g2, p2 = hi
        return (g2 | (p2 & g1), p1 & p2)

    G, _ = jax.lax.associative_scan(combine, (g, p), axis=-1)
    carry_in = jnp.concatenate(
        [jnp.zeros_like(G[..., :1]), G[..., :-1]], axis=-1)
    return (s + carry_in) & _BMASK


def add_limbs(a: jnp.ndarray, b: jnp.ndarray,
              carry_in0: int = 0) -> jnp.ndarray:
    """Exact addition of normalized limb vectors (result truncated mod R)."""
    s = a + b
    if carry_in0:
        s = s.at[..., 0].add(carry_in0)
    return _resolve_carries(s)


def sub_limbs(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a - b mod R over normalized limbs (two's complement addition)."""
    comp = _BMASK - b
    return add_limbs(a, comp, carry_in0=1)


def geq(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Lexicographic a >= b over normalized limb vectors -> bool (B,)."""
    L = a.shape[-1]
    gt = jnp.zeros(a.shape[:-1], jnp.bool_)
    eq = jnp.ones(a.shape[:-1], jnp.bool_)
    for j in reversed(range(L)):
        gt = gt | (eq & (a[..., j] > b[..., j]))
        eq = eq & (a[..., j] == b[..., j])
    return gt | eq


def normalize(t: jnp.ndarray) -> jnp.ndarray:
    """Lazy accumulators (< 2^27 per digit) -> normalized digits < BASE."""
    lo = t & _BMASK
    hi = t >> _BASE_BITS  # < 2^11
    hi_shifted = jnp.concatenate(
        [jnp.zeros_like(hi[..., :1]), hi[..., :-1]], axis=-1)
    s = lo + hi_shifted  # < BASE + 2^11: one more split may be needed
    lo2 = s & _BMASK
    hi2 = s >> _BASE_BITS  # 0 or 1
    hi2_shifted = jnp.concatenate(
        [jnp.zeros_like(hi2[..., :1]), hi2[..., :-1]], axis=-1)
    return _resolve_carries(lo2 + hi2_shifted)


# ---------------------------------------------------------------------------
# Montgomery context and kernels
# ---------------------------------------------------------------------------

class MontCtx:
    """Montgomery context for an odd modulus n over L 16-bit limbs."""

    def __init__(self, n: int, L: int | None = None):
        if n % 2 == 0:
            raise ValueError("modulus must be odd")
        self.n = n
        self.L = L if L is not None else -(-n.bit_length() // _BASE_BITS)
        if self.L > 512:
            raise ValueError("modulus too large (L > 512)")
        self.R = 1 << (_BASE_BITS * self.L)
        if self.R <= n:
            raise ValueError("L too small for modulus")
        self.n_prime = (-pow(n, -1, _BASE)) % _BASE
        self.r2 = (self.R * self.R) % n
        self.n_limbs = jnp.asarray(to_limbs([n], self.L)[0])
        self.r2_limbs = jnp.asarray(to_limbs([self.r2], self.L)[0])
        self.one_mont = jnp.asarray(to_limbs([self.R % n], self.L)[0])
        # per-context jitted exponent scans (see mont_exp/mont_exp_window:
        # eager dispatch of thousands of mont_muls pays a kernel launch
        # for each)
        self._jit_cache: dict = {}


def _cond_sub_n(t: jnp.ndarray, n_limbs: jnp.ndarray) -> jnp.ndarray:
    need = geq(t, n_limbs)
    sub = sub_limbs(t, jnp.broadcast_to(n_limbs, t.shape))
    return jnp.where(need[..., None], sub, t)


def mont_mul(ctx: MontCtx, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Montgomery product a*b*R^-1 mod n.

    a, b: (B, L) normalized uint32 limbs, values < n.  Returns (B, L)
    normalized, value < n.
    """
    L = ctx.L
    n_limbs = ctx.n_limbs
    n_prime = jnp.uint32(ctx.n_prime)
    B = a.shape[0]
    t = jnp.zeros((B, L + 2), jnp.uint32)

    def step(i, t):
        ai = jax.lax.dynamic_slice_in_dim(a, i, 1, axis=1)  # (B,1)
        p = ai * b  # (B,L) uint32, exact
        t = t.at[:, :L].add(p & _BMASK)
        t = t.at[:, 1 : L + 1].add(p >> _BASE_BITS)
        m = ((t[:, 0] & _BMASK) * n_prime) & _BMASK  # (B,)
        q = m[:, None] * n_limbs[None, :]
        t = t.at[:, :L].add(q & _BMASK)
        t = t.at[:, 1 : L + 1].add(q >> _BASE_BITS)
        # shift one limb right; t[:,0] low 16 bits are exactly zero now
        carry0 = t[:, 0] >> _BASE_BITS
        t = jnp.concatenate([t[:, 1:], jnp.zeros((B, 1), jnp.uint32)], axis=1)
        t = t.at[:, 0].add(carry0)
        return t

    t = jax.lax.fori_loop(0, L, step, t)
    t = normalize(t)
    # T < 2n may exceed R (limb L set); subtract n whenever the overflow
    # limb is set or the low L limbs are >= n — mod-R subtraction yields
    # the exact low limbs either way since T - n < n < R.
    low = t[:, :L]
    need = (t[:, L] > 0) | geq(low, n_limbs)
    sub = sub_limbs(low, jnp.broadcast_to(n_limbs, low.shape))
    return jnp.where(need[:, None], sub, low)


def mont_from(ctx: MontCtx, x: jnp.ndarray) -> jnp.ndarray:
    """Enter Montgomery domain: x*R mod n."""
    return mont_mul(ctx, x, jnp.broadcast_to(ctx.r2_limbs, x.shape))


def mont_to(ctx: MontCtx, x: jnp.ndarray) -> jnp.ndarray:
    """Leave Montgomery domain: x*R^-1 mod n."""
    one = jnp.zeros_like(x).at[..., 0].set(1)
    return mont_mul(ctx, x, one)


def mont_exp(ctx: MontCtx, base_mont: jnp.ndarray,
             ebits: jnp.ndarray) -> jnp.ndarray:
    """base^e mod n in the Montgomery domain (square-and-always-multiply).

    base_mont: (B, L) in Montgomery form.  ebits: (nbits,) uint32 LSB-first
    (may be a traced array — secret exponents run constant-time).
    Returns (B, L) in Montgomery form.

    The whole scan runs under one jit (cached per context + shapes):
    dispatched eagerly, its thousands of mont_muls each pay kernel
    launch latency.
    """
    key = ("exp", base_mont.shape, ebits.shape)
    fn = ctx._jit_cache.get(key)
    if fn is None:
        def _run(base, eb):
            acc0 = jnp.broadcast_to(ctx.one_mont, base.shape)

            def step(carry, bit):
                acc, b = carry
                mul = mont_mul(ctx, acc, b)
                acc = jnp.where(bit > 0, mul, acc)
                b = mont_mul(ctx, b, b)
                return (acc, b), None

            (acc, _), _ = jax.lax.scan(step, (acc0, base), eb)
            return acc

        fn = jax.jit(_run)
        ctx._jit_cache[key] = fn
    return fn(base_mont, ebits)


def exponent_digits(e: int, nbits: int, w: int = 4) -> np.ndarray:
    """MSB-first base-2^w digit array of an exponent (nbits padded)."""
    ndig = -(-nbits // w)
    return np.array(
        [(e >> (w * (ndig - 1 - i))) & ((1 << w) - 1) for i in range(ndig)],
        np.int32)


def mont_mul_v(a: jnp.ndarray, b: jnp.ndarray, n_limbs: jnp.ndarray,
               n_prime: jnp.ndarray) -> jnp.ndarray:
    """Montgomery product with a per-row modulus.

    a, b, n_limbs: (B, L) normalized uint32 limbs (row r reduces mod its
    own n_r); n_prime: (B,) uint32.  Same math as mont_mul with the
    modulus broadcast replaced by per-row arrays — used to run the CRT
    p^2/q^2 exponent chains as ONE batch (see PairMontCtx)."""
    L = a.shape[1]
    B = a.shape[0]
    t = jnp.zeros((B, L + 2), jnp.uint32)

    def step(i, t):
        ai = jax.lax.dynamic_slice_in_dim(a, i, 1, axis=1)  # (B,1)
        p = ai * b
        t = t.at[:, :L].add(p & _BMASK)
        t = t.at[:, 1 : L + 1].add(p >> _BASE_BITS)
        m = ((t[:, 0] & _BMASK) * n_prime) & _BMASK  # (B,)
        q = m[:, None] * n_limbs
        t = t.at[:, :L].add(q & _BMASK)
        t = t.at[:, 1 : L + 1].add(q >> _BASE_BITS)
        carry0 = t[:, 0] >> _BASE_BITS
        t = jnp.concatenate([t[:, 1:], jnp.zeros((B, 1), jnp.uint32)],
                            axis=1)
        t = t.at[:, 0].add(carry0)
        return t

    t = jax.lax.fori_loop(0, L, step, t)
    t = normalize(t)
    low = t[:, :L]
    need = (t[:, L] > 0) | geq(low, n_limbs)
    sub = sub_limbs(low, n_limbs)
    return jnp.where(need[:, None], sub, low)


class PairMontCtx:
    """Two same-width moduli run as one per-row-modulus batch.

    Paillier CRT decryption runs c^(p-1) mod p^2 and c^(q-1) mod q^2 —
    two windowed exponent scans of identical depth.  Stacking them as
    rows [0:B) = mod p^2, [B:2B) = mod q^2 halves the sequential chain
    (the dominant decrypt cost at small batches); the digit selection
    needs only TWO dynamic table indexes per step (one per modulus), not
    a per-row gather.
    """

    def __init__(self, n1: int, n2: int):
        L = max(-(-n1.bit_length() // _BASE_BITS),
                -(-n2.bit_length() // _BASE_BITS))
        self.L = L
        R = 1 << (_BASE_BITS * L)
        self.n_pat = jnp.asarray(to_limbs([n1, n2], L))         # (2, L)
        self.npr_pat = jnp.asarray(np.array(
            [(-pow(n1, -1, _BASE)) % _BASE,
             (-pow(n2, -1, _BASE)) % _BASE], np.uint32))        # (2,)
        self.r2_pat = jnp.asarray(to_limbs(
            [(R * R) % n1, (R * R) % n2], L))                   # (2, L)
        self.one_pat = jnp.asarray(to_limbs([R % n1, R % n2], L))
        self._jit_cache: dict = {}

    def exp_pair(self, c1: jnp.ndarray, c2: jnp.ndarray,
                 ed1: jnp.ndarray, ed2: jnp.ndarray, w: int = 4):
        """(c1^e1 mod n1, c2^e2 mod n2) — plain domain in and out.

        c1, c2: (B, L) normalized limbs; ed1, ed2: (ndig,) int32 MSB-first
        base-2^w digits (equal length; pad the shorter exponent).
        """
        B = c1.shape[0]
        key = ("pair", w, c1.shape, ed1.shape)
        fn = self._jit_cache.get(key)
        if fn is None:
            n_pat, npr_pat = self.n_pat, self.npr_pat
            r2_pat, one_pat = self.r2_pat, self.one_pat

            def _run(c1, c2, ed):
                nl = jnp.concatenate([
                    jnp.broadcast_to(n_pat[0], (B, self.L)),
                    jnp.broadcast_to(n_pat[1], (B, self.L))])
                npr = jnp.concatenate([
                    jnp.broadcast_to(npr_pat[0], (B,)),
                    jnp.broadcast_to(npr_pat[1], (B,))])
                r2 = jnp.concatenate([
                    jnp.broadcast_to(r2_pat[0], (B, self.L)),
                    jnp.broadcast_to(r2_pat[1], (B, self.L))])
                one = jnp.concatenate([
                    jnp.broadcast_to(one_pat[0], (B, self.L)),
                    jnp.broadcast_to(one_pat[1], (B, self.L))])
                a = jnp.concatenate([c1, c2])
                base = mont_mul_v(a, r2, nl, npr)  # to Montgomery

                table = [one]
                for _ in range((1 << w) - 1):
                    table.append(mont_mul_v(table[-1], base, nl, npr))
                tbl = jnp.stack(table)  # (2^w, 2B, L)

                def step(acc, digits):
                    for _ in range(w):
                        acc = mont_mul_v(acc, acc, nl, npr)
                    s1 = jax.lax.dynamic_index_in_dim(
                        tbl, digits[0], axis=0, keepdims=False)[:B]
                    s2 = jax.lax.dynamic_index_in_dim(
                        tbl, digits[1], axis=0, keepdims=False)[B:]
                    sel = jnp.concatenate([s1, s2])
                    return mont_mul_v(acc, sel, nl, npr), None

                acc, _ = jax.lax.scan(step, one, ed)
                # leave Montgomery: multiply by limb-one
                lone = jnp.zeros_like(acc).at[..., 0].set(1)
                out = mont_mul_v(acc, lone, nl, npr)
                return out[:B], out[B:]

            fn = jax.jit(_run)
            self._jit_cache[key] = fn
        ed = jnp.stack([jnp.asarray(ed1, jnp.int32),
                        jnp.asarray(ed2, jnp.int32)], axis=1)  # (ndig, 2)
        return fn(c1, c2, ed)


def mont_exp_window(ctx: MontCtx, base_mont: jnp.ndarray,
                    edigits: jnp.ndarray, w: int = 4) -> jnp.ndarray:
    """Fixed-window modexp: ~1.6x fewer Montgomery products than binary
    square-and-always-multiply (w squarings + 1 table multiply per digit;
    2^w - 1 table build products).  Still constant-time in the exponent
    value (every digit does the same work), so safe for secret exponents.

    Runs under one jit per (context, shapes) — see mont_exp.
    """
    key = ("expw", w, base_mont.shape, edigits.shape)
    fn = ctx._jit_cache.get(key)
    if fn is None:
        def _run(base, ed):
            table = [jnp.broadcast_to(ctx.one_mont, base.shape)]
            for _ in range((1 << w) - 1):
                table.append(mont_mul(ctx, table[-1], base))
            tbl = jnp.stack(table)  # (2^w, B, L)

            def step(acc, digit):
                for _ in range(w):
                    acc = mont_mul(ctx, acc, acc)
                sel = jax.lax.dynamic_index_in_dim(tbl, digit, axis=0,
                                                   keepdims=False)
                return mont_mul(ctx, acc, sel), None

            acc0 = jnp.broadcast_to(ctx.one_mont, base.shape)
            acc, _ = jax.lax.scan(step, acc0, ed)
            return acc

        fn = jax.jit(_run)
        ctx._jit_cache[key] = fn
    return fn(base_mont, edigits)
