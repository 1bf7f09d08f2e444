"""FLASHE headline benchmark: encrypted-gradient round throughput.

Measures one full 10-client FLASHE round on a single device — quantized
uint32 lanes through encrypt, 10-ciphertext modular aggregation, and
boundary-mask decrypt — and reports elements/s on the device that every
result names under "device" (platform, device_kind, device count).

Baseline (BASELINE.md section 1, reference notebook cell 30 on c5.4xlarge,
16 vCPU, int_bits=20): at 262,144 elements FLASHE takes 2.42 s encrypt +
7.33 s add(10 cts) + 2.42 s decrypt = 12.17 s -> 21,540 elements/s for the
enc+agg+dec critical path.  vs_baseline = ours / 21,540.

Timing: one warm-up call compiles, then the median of a few timed runs,
each ended by block_until_ready.  Prints ONE JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

BASELINE_ELEMENTS_PER_SEC = 262_144 / (2.42 + 7.33 + 2.42)  # 21,540/s


def _median(ts):
    return sorted(ts)[len(ts) // 2]


def loop_time(step, x0, reps=10, samples=3):
    """Seconds per step of `step(i, carry)`, chained `reps` times inside
    one jitted fori_loop (data dependence defeats overlap and dead-code
    elimination)."""
    import jax

    loop = jax.jit(lambda x: jax.lax.fori_loop(0, reps, step, x))
    jax.block_until_ready(loop(x0))  # compile + warm
    ts = []
    for _ in range(samples):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(x0))
        ts.append(time.perf_counter() - t0)
    return _median(ts) / reps


def call_time(fn, x0, reps=5, samples=3):
    """Seconds per call of a host-driven chain (cipher methods whose
    python glue cannot trace into a fori_loop): x threads through fn so
    calls cannot overlap; per-call dispatch is included, as it is part of
    the op's real cost when driven this way."""
    import jax

    def run():
        x = x0
        for i in range(reps):
            x = fn(i, x)
        jax.block_until_ready(x)

    run()  # compile + warm
    ts = []
    for _ in range(samples):
        t0 = time.perf_counter()
        run()
        ts.append(time.perf_counter() - t0)
    return _median(ts) / reps


def device_info() -> dict:
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "device_kind": d[0].device_kind,
            "count": len(d)}


def setup_jax(force_cpu: bool = False) -> None:
    from flashe_tpu import jaxenv

    jaxenv.setup(force_cpu=force_cpu)


def mask_pair_fns(rk, n, m, c):
    """(enc_one(q, it, idx), dec_one(agg, it)) for n lanes, m-bit lanes and
    c clients, through the kernel jaxenv.mask_kernel picks here."""
    import jax

    from flashe_tpu.jaxenv import mask_kernel

    mask = np.uint32((1 << m) - 1)
    if mask_kernel(jax.devices()[0]) == "cuda":
        from flashe_tpu.ops.fused_mask import fused_mask_apply

        def enc_one(q, it, idx):
            return fused_mask_apply(q, rk, it, idx, idx + 1, m)

        def dec_one(agg, it):
            return fused_mask_apply(agg, rk, it, c, 0, m)
    else:
        from flashe_tpu.ops.masks import prp_lane_stream

        def enc_one(q, it, idx):
            add = prp_lane_stream(rk, it, idx, n, m)
            minus = prp_lane_stream(rk, it, idx + 1, n, m)
            return (q + add - minus) & mask

        def dec_one(agg, it):
            add = prp_lane_stream(rk, it, c, n, m)
            minus = prp_lane_stream(rk, it, 0, n, m)
            return (agg + add - minus) & mask
    return enc_one, dec_one


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--elements", type=int, default=4_194_304,
                    help="gradient vector length (default 4M)")
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--int-bits", type=int, default=20)
    ap.add_argument("--reps", type=int, default=10,
                    help="chained steps per timed run")
    ap.add_argument("--stats", type=int, default=5,
                    help="number of independent samples of the headline "
                         "round; the reported value is the median and the "
                         "min/max spread is included")
    ap.add_argument("--mode", default="flashe",
                    choices=["flashe", "roundtrip1m", "precompute",
                             "paillier", "model100m", "table2",
                             "roofline", "party"],
                    help="benchmark config (BASELINE.json configs; "
                         "table2 = the reference's full crypto comparison "
                         "table)")
    ap.add_argument("--full", action="store_true",
                    help="table2: include the no-batch BFV/CKKS rows "
                         "(minutes of runtime / GBs of ciphertext, like "
                         "the reference's)")
    ap.add_argument("--table-sizes",
                    help="table2: comma-separated element counts "
                         "(default 16384,65536,262144 = the reference's)")
    ap.add_argument("--table-schemes",
                    help="table2: comma-separated scheme filter "
                         "(flashe,paillier,bfv,ckks; default all) — for "
                         "re-measuring a subset without a full run")
    ap.add_argument("--party-batch", type=int, default=256,
                    help="party mode: HE rows per device-count "
                         "(paillier cts; x64 = bfv/ckks elements)")
    ap.add_argument("--party-key", type=int, default=2048,
                    help="party mode: paillier key bits")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (a smoke run of the code "
                         "path; its times are not device numbers)")
    args = ap.parse_args()

    setup_jax(force_cpu=args.cpu)

    if args.mode == "table2":
        run_table2(args)
        return
    if args.mode == "roofline":
        run_roofline(args)
        return
    if args.mode == "party":
        run_party(args)
        return
    if args.mode != "flashe":
        run_extra_mode(args)
        return

    import jax
    import jax.numpy as jnp

    from flashe_tpu.ops import aes

    n, c, m = args.elements, args.clients, args.int_bits
    rk = jnp.asarray(aes.key_schedule(bytes(range(32))).astype(np.int32))
    mask = np.uint32((1 << m) - 1)
    enc_one, dec_one = mask_pair_fns(rk, n, m, c)

    @jax.jit
    def encrypt_all(q, it):
        return jnp.stack([enc_one(q[i], it, i) for i in range(c)])

    @jax.jit
    def aggregate(cts):
        # exact for clients * 2^int_bits <= 2^32 (here 10 * 2^20)
        return jnp.sum(cts, axis=0, dtype=jnp.uint32) & mask

    decrypt = jax.jit(dec_one)

    @jax.jit
    def make_q(key):
        return jax.random.randint(key, (c, n), 0, 1 << 16,
                                  dtype=jnp.uint32)

    q = make_q(jax.random.PRNGKey(0))
    it0 = jnp.asarray(0, jnp.int32)
    out = decrypt(aggregate(encrypt_all(q, it0)), it0)  # compile + warm

    @jax.jit
    def check(out, q):
        want = jnp.sum(q, axis=0, dtype=jnp.uint32) & mask
        return jnp.all(out == want)

    assert bool(check(out, q)), "round mismatch"

    # each phase loops inside ONE jit with a data-chained carry
    def enc_step(i, acc):
        # chain: next input depends on the previous ciphertext (1 extra
        # xor per element vs the 441-op mask stream — negligible)
        return enc_one(acc ^ (q[0] & jnp.uint32(1)), i, 0)

    cts0 = encrypt_all(q, it0)

    def agg_step(i, acc):
        # perturb the inputs with the carry so the reduction cannot be
        # hoisted; the add fuses into the reduce (same HBM traffic)
        return jnp.sum(cts0 + (acc & jnp.uint32(1))[None, :], axis=0,
                       dtype=jnp.uint32) & mask

    def dec_step(i, acc):
        return dec_one(acc, i)

    samples = []
    for _ in range(max(args.stats, 1)):
        t_enc1 = loop_time(enc_step, q[0], reps=args.reps)
        t_agg = loop_time(agg_step, cts0[0], reps=args.reps)
        t_dec = loop_time(dec_step, out, reps=args.reps)
        samples.append((t_enc1, t_agg, t_dec))
    samples.sort(key=lambda s: s[0] + s[1] + s[2])
    eps_samples = sorted(n / (a + b + d) for a, b, d in samples)
    t_enc1, t_agg, t_dec = samples[len(samples) // 2]  # median round
    eps = n / (t_enc1 + t_agg + t_dec)
    result = {
        "metric": "flashe_enc_agg_dec_elements_per_sec",
        "value": eps,
        "unit": "elements/s",
        "vs_baseline": round(eps / BASELINE_ELEMENTS_PER_SEC, 2),
        "device": device_info(),
        "spread": {
            "n_samples": len(eps_samples),
            "min": eps_samples[0],
            "max": eps_samples[-1],
        },
    }
    if args.verbose:
        result["detail"] = {
            "elements": n,
            "clients": c,
            "int_bits": m,
            "t_encrypt_all_clients_s": t_enc1 * c,
            "t_aggregate_s": t_agg,
            "t_decrypt_s": t_dec,
        }
    print(json.dumps(result))


def run_extra_mode(args):
    """Secondary benchmark configs from BASELINE.json."""
    import jax
    import jax.numpy as jnp

    from flashe_tpu.crypto.flashe import FlasheCipher

    rng = np.random.RandomState(0)
    seed = bytes(range(32))

    if args.mode == "roundtrip1m":
        # config 1: 1M-element roundtrip at a 64-bit modulus (2-limb lanes)
        n, m = 1_048_576, 64
        c = FlasheCipher(m)
        c.idx = 0
        c.set_num_clients(1)
        c.generate_prp_seed(assigned_seed=seed)
        c.set_iter_index(0)
        q = jnp.asarray(
            rng.randint(0, 1 << 31, (n, 2), dtype=np.int64).astype(np.uint32))
        # chain each call's input on the previous output
        t_enc = call_time(lambda i, x: c.encrypt(x), q)
        ct = c.encrypt(q)
        t_dec = call_time(lambda i, x: c.decrypt(x, idx_list=[0]), ct)
        eps = n / (t_enc + t_dec)
        print(json.dumps({
            "metric": "flashe64_roundtrip_elements_per_sec",
            "value": eps, "unit": "elements/s",
            "vs_baseline": round(eps / BASELINE_ELEMENTS_PER_SEC, 2),
            "device": device_info()}))

    elif args.mode == "precompute":
        # config 2: 10-client 10M vectors with mask precomputation; the
        # reported figure is the ONLINE encrypt+agg+dec time (the paper's
        # "<0.1 s online crypto cost" claim)
        n, m, nc = 10_000_000, 20, 10
        q = jnp.asarray(
            rng.randint(0, 1 << 16, n, dtype=np.int64).astype(np.uint32))

        # offline phase (not timed): materialize every mask stream this
        # round needs, exactly what prepare_encrypt/prepare_decrypt stash
        # (jzf_flashe.py:599-666) — streams 0..nc (client idx i uses
        # i and i+1; aggregate-decrypt uses nc and 0)
        from flashe_tpu.ops import aes as aes_mod
        from flashe_tpu.ops.masks import prp_lane_stream

        rk = jnp.asarray(aes_mod.key_schedule(seed).astype(np.int32))
        lane_mask = np.uint32((1 << m) - 1)
        gen = jax.jit(lambda rk, i: prp_lane_stream(rk, 0, i, n, m))
        S = jnp.stack([gen(rk, jnp.int32(i)) for i in range(nc + 1)])

        # online phase: apply prepared masks + aggregate + decrypt
        def online_step(_, carry):
            qv, S = carry
            agg = None
            for i in range(nc):
                ct = (qv + S[i] - S[i + 1]) & lane_mask
                agg = ct if agg is None else (agg + ct) & lane_mask
            dec = (agg + S[nc] - S[0]) & lane_mask
            return (dec ^ (qv & jnp.uint32(1)), S)  # chain

        t_online = loop_time(online_step, (q, S), reps=4)
        # reference: <0.1 s online crypto for 1.2M params (README.md:23);
        # per-element ratio against that claim
        ref_per_elem = 0.1 / 1_206_590
        print(json.dumps({
            "metric": "flashe_online_round_seconds_10clients_10m",
            "value": t_online, "unit": "s",
            "vs_baseline": round(ref_per_elem / (t_online / n), 2),
            "device": device_info()}))

    elif args.mode == "paillier":
        # config 3: 2048-bit modexp limb kernel over a batch-encoded vector
        from flashe_tpu.ops import modmath
        from flashe_tpu.crypto.paillier import PaillierKeypair

        batch = 2048  # ciphertexts (= 204,800 packed elements at b100)
        pub, _ = PaillierKeypair.generate_keypair(2048)
        ctx = modmath.MontCtx(pub.nsquare)
        rs = [rng.randint(1, 1 << 62) for _ in range(batch)]
        r = jnp.asarray(modmath.to_limbs(rs, ctx.L))
        # 4-bit fixed-window scan — what PaillierCipher.encrypt runs
        # (crypto/paillier.py): ~1.6x fewer Montgomery products than the
        # binary square-and-always-multiply, still constant-time
        edig = jnp.asarray(
            modmath.exponent_digits(pub.n, pub.n.bit_length()))

        base = modmath.mont_from(ctx, r)
        t = call_time(lambda i, x: modmath.mont_exp_window(ctx, x, edig),
                      base, reps=2)
        cts_per_s = batch / t
        elems_per_s = cts_per_s * 100  # b100 batching
        # reference: batched Paillier encrypt 4.69 s @ 262,144 elements
        print(json.dumps({
            "metric": "paillier2048_modexp_ciphertexts_per_sec",
            "value": cts_per_s, "unit": "ct/s",
            "vs_baseline": round(elems_per_s / (262_144 / 4.69), 2),
            "device": device_info()}))

    elif args.mode == "model100m":
        # config 4: 100M-param gradient quantize->encrypt->agg->decrypt
        from flashe_tpu.ops import aes as aes_mod

        n, m, nc = 100_000_000, 20, 10
        rk = jnp.asarray(aes_mod.key_schedule(seed).astype(np.int32))
        mask = np.uint32((1 << m) - 1)
        enc_one, dec_one = mask_pair_fns(rk, n, m, nc)
        x = jnp.asarray(rng.randn(n).astype(np.float32) * 0.1)

        @jax.jit
        def quantize(x, key):
            a = np.float32(0.5)
            v = (jnp.clip(x, -a, a) + a) * (np.float32(65535.0) / (2 * a))
            u = jax.random.uniform(key, v.shape, dtype=jnp.float32)
            return jnp.floor(v + u).astype(jnp.uint32)

        it0 = jnp.asarray(0, jnp.int32)
        enc = jax.jit(lambda q, idx: enc_one(q, it0, idx))
        agg_step = jax.jit(lambda acc, idx, q: (acc + enc_one(q, it0, idx))
                           & mask)
        dec = jax.jit(lambda acc: dec_one(acc, it0))

        def full_round(i, _):
            q = quantize(x, jax.random.PRNGKey(0))
            acc = enc(q, jnp.int32(0))
            for k in range(1, nc):
                acc = agg_step(acc, jnp.int32(k), q)
            return dec(acc)

        t = call_time(full_round, None, reps=1)
        eps = n / t
        print(json.dumps({
            "metric": "flashe_100m_full_round_elements_per_sec",
            "value": eps, "unit": "elements/s",
            "vs_baseline": round(eps / BASELINE_ELEMENTS_PER_SEC, 2),
            "device": device_info(),
            "detail": {"round_seconds": t, "clients": nc}}))


def run_table2(args):
    """Reproduce the reference's crypto comparison table
    (encrypt_test/final_big_table.ipynb cell 30; BASELINE.md section 1):
    every scheme +/- batching x {16384, 65536, 262144} elements, with
    exact ciphertext bytes and encrypt / add(10 cts) / decrypt times.

    Parity notes vs the notebook:
    - same quantization geometry: 16-bit elements + 4 padding bits
      (10 clients) = 20-bit lanes;
    - Paillier n=2048 (batch packs 102 lanes/plaintext), BFV
      t=1964769281 m=8192 batch / m=2048 no-batch, CKKS N=8192 scale
      2^40 (floats in the clear slots, like the reference CKKS block);
    - the 10-ciphertext aggregate reuses one encrypted vector ten times
      (identical op count; avoids 10x the encrypt wall time on the
      multi-minute no-batch rows), and decryption is verified against
      the 10x plaintext sum;
    - no-batch BFV/CKKS rows stream in fixed chunks (their ciphertexts
      run to GBs, as in the reference table) and run only with --full;
      their ciphertext sizes are always reported (exact formula).
    Emits ONE JSON line: {"metric": "table2", "rows": [...]}.
    """
    import time

    import jax
    import jax.numpy as jnp

    from flashe_tpu.crypto.bfv import BFVCipher
    from flashe_tpu.crypto.ckks import CKKSCipher
    from flashe_tpu.crypto.flashe import FlasheCipher
    from flashe_tpu.crypto.paillier import PaillierCipher
    from flashe_tpu.ops import pack as packops
    from flashe_tpu.ops import quantize as qops
    from flashe_tpu.ops.lanes import lane_add, lanes_to_ints, ints_to_lanes

    NC, EB, FACTOR = 10, 16, 4
    M = EB + FACTOR  # 20-bit lanes
    sizes = ([int(s) for s in args.table_sizes.split(",")]
             if args.table_sizes else [16384, 65536, 262144])
    rng = np.random.RandomState(0)
    seed = bytes(range(32))
    rows = []

    def rec(alg, n, ct_bytes, t_enc, t_add, t_dec, ok=True):
        rows.append({
            "algorithm": alg, "elements": n,
            "plaintext_bytes": n * M // 8,
            "ciphertext_bytes": int(ct_bytes),
            "inflation_x": round(ct_bytes / (n * M / 8), 2),
            "encrypt_s": t_enc,
            "add10_s": t_add,
            "decrypt_s": t_dec,
            "correct": bool(ok),
        })
        if args.verbose:
            print(f"# {alg:16s} n={n:7d} ct={ct_bytes/1e6:10.2f}MB "
                  f"enc={t_enc} add={t_add} dec={t_dec} ok={ok}",
                  flush=True)

    def timeit(f, warm=True, reps=3):
        """Steady-state timing: one untimed warm call first (XLA compile
        is per-shape and amortizes over a training run; the reference's
        library crypto had no JIT to pay), then the MEDIAN of `reps`
        calls, each ended by block_until_ready (host results — object
        arrays — are synchronous already)."""
        if warm:
            jax.block_until_ready(f())
        ts = []
        out = None
        for _ in range(max(reps, 1)):
            t0 = time.perf_counter()
            out = jax.block_until_ready(f())
            ts.append(time.perf_counter() - t0)
        return _median(ts), out

    schemes = (set(args.table_schemes.split(","))
               if args.table_schemes
               else {"flashe", "paillier", "bfv", "ckks"})

    # ---------------- FLASHE (all sizes) ---------------------------------
    for n in sizes if "flashe" in schemes else []:
        q = rng.randint(0, 1 << EB, (NC, n)).astype(np.uint32)
        ciphers = []
        for i in range(NC):
            c = FlasheCipher(M)
            c.idx = i
            c.set_num_clients(NC)
            c.generate_prp_seed(assigned_seed=seed)
            c.set_iter_index(0)
            ciphers.append(c)
        t_enc, ct0 = timeit(
            lambda: ciphers[0].encrypt(jnp.asarray(q[0])))
        cts = [ct0] + [ciphers[i].encrypt(jnp.asarray(q[i]))
                       for i in range(1, NC)]

        def add_all():
            acc = cts[0]
            for ct in cts[1:]:
                acc = lane_add(acc, ct, M)
            return acc

        t_add, agg = timeit(add_all)
        t_dec, dec = timeit(lambda: ciphers[0].decrypt(agg))
        want = q.astype(np.int64).sum(0) % (1 << M)
        ok = np.array_equal(np.asarray(dec).astype(np.int64), want)
        ct_bytes = len(packops.pack_lanes(np.asarray(ct0), M))
        rec("flashe", n, ct_bytes, t_enc, t_add, t_dec, ok)

    # ---------------- Paillier ------------------------------------------
    if "paillier" in schemes:
        pail = PaillierCipher()
        pail.generate_key(2048)
        ctbytes_per = (2 * 2048) // 8  # 4096-bit ciphertext

        # batch: pack 2048//20 = 102 lanes per plaintext int
        for n in sizes:
            q0 = rng.randint(0, 1 << EB, n).astype(np.uint32)
            # host codec twins: the Paillier wire format is python
            # big-ints, so packing on device costs two transfers for zero
            # compute benefit
            packed = qops.batch_lanes_np(q0, 2048, EB, FACTOR)
            ints = lanes_to_ints(packed, 2048)
            t_enc, cts0 = timeit(lambda: pail.encrypt(ints))
            t_add, agg = timeit(lambda: pail.add_ciphertexts([cts0] * NC))

            def dec_batch():
                sums = pail.decrypt(agg)
                lanes2 = ints_to_lanes(sums, 2048)
                return qops.unbatch_lanes_np(lanes2, n, 2048, EB, FACTOR)

            t_dec, dec = timeit(dec_batch)
            want = (q0.astype(np.int64) * NC) % (1 << M)
            ok = np.array_equal(np.asarray(dec).astype(np.int64), want)
            rec("paillier+batch", n, len(ints) * ctbytes_per, t_enc, t_add,
                t_dec, ok)

        # no batch: one 20-bit value per ciphertext (16,384 only, like the
        # reference's table)
        n = sizes[0]
        q0 = rng.randint(0, 1 << EB, n).astype(np.uint32)
        ints = q0.astype(object)
        t_enc, cts0 = timeit(lambda: pail.encrypt(ints))
        t_add, agg = timeit(lambda: pail.add_ciphertexts([cts0] * NC))
        t_dec, dec = timeit(lambda: pail.decrypt(agg))
        ok = np.array_equal(
            np.asarray([int(v) for v in dec], dtype=np.int64),
            q0.astype(np.int64) * NC)
        rec("paillier", n, n * ctbytes_per, t_enc, t_add, t_dec, ok)
        for n2 in sizes[1:]:
            # linear extrapolation from the fully measured first size:
            # the per-ciphertext work is independent (embarrassingly
            # parallel over elements), matching the reference's own
            # linear scaling
            sc = n2 / n
            rec("paillier (extrapolated)", n2, n2 * ctbytes_per,
                t_enc * sc, t_add * sc, t_dec * sc, ok)

    # ---------------- BFV ------------------------------------------------
    if "bfv" in schemes:
        T_BFV = 1964769281  # = 1 mod 2*8192: the reference's batch prime
        bfv = BFVCipher(T_BFV, 8192, flagBatching=True, seed=0)
        bfv.generate_keys()
        bfv_ct_bytes = 2 * bfv.N * ((bfv.q.bit_length() + 7) // 8)
        for n in sizes:
            q0 = rng.randint(0, 1 << EB, n).astype(np.uint32)
            t_enc, cts0 = timeit(lambda: bfv.encrypt(q0))
            t_add, agg = timeit(lambda: bfv.add_ciphertexts([cts0] * NC))
            t_dec, dec = timeit(lambda: bfv.decrypt(agg, n))
            ok = np.array_equal(np.asarray(dec, np.int64),
                                q0.astype(np.int64) * NC)
            rec("bfv+batch", n, cts0.shape[0] * bfv_ct_bytes, t_enc, t_add,
                t_dec, ok)

        n = sizes[0]
        bfv_nb = BFVCipher(T_BFV, 2048, flagBatching=False, seed=0)
        bfv_nb.generate_keys()
        nb_ct_bytes = 2 * bfv_nb.N * ((bfv_nb.q.bit_length() + 7) // 8)
        if args.full:
            q0 = rng.randint(0, 1 << EB, n).astype(np.uint32)
            chunk = 2048
            t_enc = t_add = t_dec = 0.0
            ok = True
            for b in range(0, n, chunk):
                part = q0[b : b + chunk]
                te, cts0 = timeit(lambda: bfv_nb.encrypt(part))
                ta, agg = timeit(lambda: bfv_nb.add_ciphertexts([cts0] * NC))
                td, dec = timeit(lambda: bfv_nb.decrypt(agg, len(part)))
                t_enc, t_add, t_dec = t_enc + te, t_add + ta, t_dec + td
                ok = ok and np.array_equal(np.asarray(dec, np.int64),
                                           part.astype(np.int64) * NC)
            rec("bfv", n, n * nb_ct_bytes, t_enc, t_add, t_dec, ok)
        else:
            # measured sub-slice x linear extrapolation (see ckks note)
            sub = 2048
            part = rng.randint(0, 1 << EB, sub).astype(np.uint32)
            te, cts0 = timeit(lambda: bfv_nb.encrypt(part))
            ta, agg = timeit(lambda: bfv_nb.add_ciphertexts([cts0] * NC))
            td, dec = timeit(lambda: bfv_nb.decrypt(agg, sub))
            ok = np.array_equal(np.asarray(dec, np.int64),
                                part.astype(np.int64) * NC)
            scale = n / sub
            rec("bfv (extrapolated)", n, n * nb_ct_bytes, te * scale,
                ta * scale, td * scale, ok)


    # ---------------- CKKS -----------------------------------------------
    if "ckks" in schemes:
        ck = CKKSCipher(8192, global_scale=2.0 ** 40, seed=0)
        ck.generate_keys()
        ck_ct_bytes = 2 * ck.N * ((ck.q.bit_length() + 7) // 8)
        for n in sizes:
            x0 = rng.randn(n).astype(np.float64)
            t_enc, cts0 = timeit(lambda: ck.encrypt(x0))
            t_add, agg = timeit(lambda: ck.add_ciphertexts([cts0] * NC))
            t_dec, dec = timeit(lambda: ck.decrypt(agg, n))
            err = np.max(np.abs(np.asarray(dec) - x0 * NC))
            rec("ckks+batch", n, cts0.shape[0] * ck_ct_bytes, t_enc, t_add,
                t_dec, err < 1e-2)

        n = sizes[0]
        if args.full:
            x0 = rng.randn(n).astype(np.float64)
            chunk = 512
            t_enc = t_add = t_dec = 0.0
            worst = 0.0
            for b in range(0, n, chunk):
                part = x0[b : b + chunk]
                te, cts0 = timeit(lambda: ck.encrypt_no_batch(part))
                ta, agg = timeit(lambda: ck.add_ciphertexts([cts0] * NC))
                td, dec = timeit(
                    lambda: ck.decrypt_no_batch(agg, len(part)))
                t_enc, t_add, t_dec = t_enc + te, t_add + ta, t_dec + td
                worst = max(worst, float(np.max(np.abs(dec - part * NC))))
            rec("ckks", n, n * ck_ct_bytes, t_enc, t_add, t_dec, worst < 1e-2)
        else:
            # measured sub-slice x documented extrapolation (the work is
            # embarrassingly parallel over ciphertexts, so cost scales
            # linearly in n; the cell is labeled 'extrapolated' in the row)
            sub = 512
            part = rng.randn(sub).astype(np.float64)
            te, cts0 = timeit(lambda: ck.encrypt_no_batch(part))
            ta, agg = timeit(lambda: ck.add_ciphertexts([cts0] * NC))
            td, dec = timeit(lambda: ck.decrypt_no_batch(agg, sub))
            ok = float(np.max(np.abs(dec - part * NC))) < 1e-2
            scale = n / sub
            rec("ckks (extrapolated)", n, n * ck_ct_bytes, te * scale,
                ta * scale, td * scale, ok)


    print(json.dumps({"metric": "table2", "unit": "see rows",
                      "value": len(rows), "vs_baseline": 1.0,
                      "device": device_info(), "rows": rows}))


def run_roofline(args):
    """Speed-of-light accounting (docs/ROOFLINE.md; SURVEY section 7.2 M1).

    Measures on this device:
      1. the attainable integer ceiling for AES-class work — a dependent
         uint32 xor/add/shift chain, 320 ops/element fused into one
         kernel (arithmetic intensity 40 ops/byte, far past the
         compute/memory crossover, so the timing is compute-bound);
      2. device-memory stream bandwidth (y = x + 1 over 1 GiB, read+write);
      3. achieved throughput of the production kernels — encrypt,
         decrypt (through the kernel jaxenv.mask_kernel picks), the
         10-ciphertext lane aggregate, and the Paillier-2048 Montgomery
         modexp;
    and reports each kernel's fraction of the ceiling implied by its
    op-count model (441 bitwise ops per encrypted element for the
    bitsliced-AES double-mask stream; ~8.1e8 int ops per ciphertext for
    the 2048-bit CIOS exponent scan — derivations in docs/ROOFLINE.md).
    """
    import jax
    import jax.numpy as jnp

    from flashe_tpu.ops import aes as aes_mod

    # ---- 1. integer ceiling: 320 dependent uint32 ops/element ----------
    n_alu = 8_388_608
    CONSTS = np.random.RandomState(7).randint(
        1, 1 << 31, 64, dtype=np.uint32)

    def chain_step(i, x):
        for k in range(64):
            c = jnp.uint32(CONSTS[k])
            x = x ^ c                      # 1
            x = x + (x >> jnp.uint32(7))   # 2 (shift + add)
            x = x ^ (x << jnp.uint32(3))   # 2 (shift + xor): 5 ops/iter
        return x

    OPS_PER_ELEM_CHAIN = 64 * 5
    x0 = jnp.arange(n_alu, dtype=jnp.uint32)
    t_alu = loop_time(chain_step, x0)
    alu_ops = n_alu * OPS_PER_ELEM_CHAIN / t_alu

    # ---- 2. memory stream bandwidth --------------------------------------
    n_mem = 268_435_456  # 1 GiB of uint32
    y0 = jnp.arange(n_mem, dtype=jnp.uint32)
    t_mem = loop_time(lambda i, v: v + jnp.uint32(1), y0)
    mem_bw = 2 * 4 * n_mem / t_mem  # read + write

    # ---- 3. achieved kernels -------------------------------------------
    n, m, nc = 4_194_304, 20, 10
    rk = jnp.asarray(aes_mod.key_schedule(bytes(range(32))).astype(np.int32))
    lane_mask = np.uint32((1 << m) - 1)
    enc_one, dec_one = mask_pair_fns(rk, n, m, nc)

    q = jnp.asarray(np.random.RandomState(0).randint(
        0, 1 << 16, n).astype(np.uint32))
    t_enc = loop_time(lambda i, x: enc_one(x ^ (q & jnp.uint32(1)), i, 0), q)
    ct = jax.jit(enc_one)(q, jnp.int32(0), 0)
    t_dec = loop_time(lambda i, x: dec_one(x, i), ct)

    cts = jnp.stack([ct] * nc)
    t_agg = loop_time(
        lambda i, x: jnp.sum(cts + (x & jnp.uint32(1))[None, :], axis=0,
                             dtype=jnp.uint32) & lane_mask, ct)

    # Paillier modexp (smaller batch than --mode paillier to keep the
    # roofline run short; throughput is batch-insensitive once the
    # device is full).  --cpu shrinks it to a smoke run: the ops model
    # (section 4) is for 2048-bit keys.
    from flashe_tpu.ops import modmath
    from flashe_tpu.crypto.paillier import PaillierKeypair

    kbits, batch = (256, 8) if args.cpu else (2048, 512)
    pub, _ = PaillierKeypair.generate_keypair(kbits)
    ctx = modmath.MontCtx(pub.nsquare)
    rng = np.random.RandomState(1)
    r = jnp.asarray(modmath.to_limbs(
        [rng.randint(1, 1 << 62) for _ in range(batch)], ctx.L))
    ebits = jnp.asarray(modmath.exponent_bits(pub.n, pub.n.bit_length()))
    t_exp = call_time(lambda i, x: modmath.mont_exp(ctx, x, ebits),
                      modmath.mont_from(ctx, r), reps=1)
    OPS_PER_CT_MODEXP = 8.1e8 * (kbits / 2048) ** 3

    OPS_PER_ELEM_FLASHE = 441      # docs/ROOFLINE.md section 1
    enc_eps, dec_eps = n / t_enc, n / t_dec
    agg_bytes = (nc + 1) * 4 * n / t_agg
    ct_per_s = batch / t_exp
    out = {
        "metric": "roofline",
        "value": 100 * enc_eps * OPS_PER_ELEM_FLASHE / alu_ops,
        "unit": "% of measured integer ceiling (encrypt)",
        "vs_baseline": 1.0,
        "device": device_info(),
        "detail": {
            "int32_Gops": alu_ops / 1e9,
            "mem_GBps": mem_bw / 1e9,
            "encrypt_Melem_s": enc_eps / 1e6,
            "encrypt_pct_of_ceiling": (
                100 * enc_eps * OPS_PER_ELEM_FLASHE / alu_ops),
            "decrypt_Melem_s": dec_eps / 1e6,
            "decrypt_pct_of_ceiling": (
                100 * dec_eps * OPS_PER_ELEM_FLASHE / alu_ops),
            "aggregate10_GBps": agg_bytes / 1e9,
            "aggregate_pct_of_mem_bw": 100 * agg_bytes / mem_bw,
            "modexp_ct_s": ct_per_s,
            "modexp_key_bits": kbits,
            "modexp_pct_of_ceiling": (
                100 * ct_per_s * OPS_PER_CT_MODEXP / alu_ops),
        },
    }
    print(json.dumps(out))


def run_party(args):
    """Per-party multi-device scaling, per scheme: a single federated
    client's crypto sharded over 1..D local devices — FLASHE over the
    lane mesh (FlasheCipher.set_local_devices, parallel/party.py), the
    baseline HE schemes over the batch-axis fan-out
    (parallel/fanout.DeviceFanout) — the accelerator counterpart of the
    reference's per-silo Pool fan-out for EVERY scheme
    (jzf_flashe.py:436-447, jzf_paillier.py:190-237, jzf_bfv.py:116-173).
    With --cpu it runs over virtual devices (relative scaling only); on a
    multi-GPU host the same code measures absolute speedup."""
    import jax
    import jax.numpy as jnp

    from flashe_tpu.crypto.bfv import BFVCipher
    from flashe_tpu.crypto.ckks import CKKSCipher
    from flashe_tpu.crypto.flashe import FlasheCipher
    from flashe_tpu.crypto.paillier import PaillierCipher

    n, m = args.elements, args.int_bits
    n_dev = len(jax.devices())
    shard_counts = sorted({1, 2, n_dev} & set(range(1, n_dev + 1)))
    rng = np.random.RandomState(0)
    schemes = {}

    def median_time(f, reps=3):
        """Host-synchronous scheme methods (fan-out gathers to numpy):
        one warm call, then the median of `reps`."""
        f()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            f()
            ts.append(time.perf_counter() - t0)
        ts.sort()
        return ts[len(ts) // 2]

    # ---- FLASHE dense: lane-mesh shards, device-resident output -------
    q = jnp.asarray(rng.randint(0, 1 << 16, n).astype(np.uint32))
    rows = []
    for s in shard_counts:
        c = FlasheCipher(m)
        c.idx = 1
        c.set_num_clients(10)
        c.set_iter_index(0)
        c.generate_prp_seed(assigned_seed=bytes(range(32)))
        if s > 1:
            c.set_local_devices(s)
        t = call_time(lambda i, x: c.encrypt(
            (x ^ jnp.uint32(1)).astype(jnp.uint32)), q)
        rows.append({"shards": s, "encrypt_s": t, "elements_per_s": n / t})
    schemes["flashe"] = rows

    # ---- Paillier: batch-row fan-out of the CIOS modexp kernel --------
    pail = PaillierCipher()
    pail.generate_key(args.party_key)
    B = args.party_batch * max(n_dev, 1)
    vals = np.array([int(v) for v in rng.randint(0, 1 << 30, B)],
                    dtype=object)
    cts = pail.encrypt(vals)
    rows = []
    for s in shard_counts:
        pail.set_local_devices(s) if s > 1 else setattr(
            pail, "_fanout", None)
        te = median_time(lambda: pail.encrypt(vals))
        td = median_time(lambda: pail.decrypt(cts))
        rows.append({"shards": s, "encrypt_s": round(te, 5),
                     "decrypt_s": round(td, 5),
                     "cts_per_s": round(B / te, 1)})
    schemes["paillier"] = rows

    # ---- BFV / CKKS: per-ciphertext-row fan-out of the NTT chains -----
    nb = 64 * args.party_batch * max(n_dev, 1)
    bfv = BFVCipher(1964769281, 2048, flagBatching=True,
                    seed=0).generate_keys()
    qb = rng.randint(0, 1 << 16, nb).astype(np.uint32)
    ctb = np.asarray(bfv.encrypt(qb))
    ck = CKKSCipher(2048, global_scale=2.0 ** 40, seed=0).generate_keys()
    xc = rng.randn(nb).astype(np.float64)
    ctc = np.asarray(ck.encrypt(xc))
    for name, ciph, enc_arg, dec_args in (
            ("bfv", bfv, qb, (ctb, nb)), ("ckks", ck, xc, (ctc, nb))):
        rows = []
        for s in shard_counts:
            ciph.set_local_devices(s) if s > 1 else setattr(
                ciph, "_fanout", None)
            te = median_time(lambda: ciph.encrypt(enc_arg))
            td = median_time(lambda: ciph.decrypt(*dec_args))
            rows.append({"shards": s, "encrypt_s": round(te, 5),
                         "decrypt_s": round(td, 5),
                         "elements_per_s": round(nb / te, 1)})
        schemes[name] = rows

    def speedup(rows):
        key = ("elements_per_s" if "elements_per_s" in rows[0]
               else "cts_per_s")
        return round(max(r[key] for r in rows) / rows[0][key], 2)

    fl = schemes["flashe"]
    print(json.dumps({
        "metric": "party_shard_scaling",
        "value": speedup(fl), "unit": "x vs 1 device (flashe)",
        "vs_baseline": round(
            max(r["elements_per_s"] for r in fl)
            / BASELINE_ELEMENTS_PER_SEC, 2),
        "speedup_x": {k: speedup(v) for k, v in schemes.items()},
        "device": device_info(),
        "rows": schemes}))


if __name__ == "__main__":
    main()
