"""Smoke run of the FLASHE main path on NVIDIA GPUs.

    python chip_smoke.py             # phases a-g on one card
    python chip_smoke.py --chips 4   # the multi-card path only (4 cards)

One card (the default), in this order:
  e. `--processes` launcher: a FLASHE job with one OS process per role,
     started before this process touches the card; the role processes
     share the card by runtime/placement.py's rule;
  a. device: JAX must see a GPU; there is no CPU fallback;
  b. mask kernel: FlasheCipher double-mask encrypt and boundary decrypt at
     int_bits=20, 1,206,590 and 4,194,304 lanes, bit for bit against the
     XLA stream path and the host AES oracle; the fused kernel's round
     (10 encrypts + aggregate + decrypt) timed against XLA's;
  c. a 10-client round at FemnistCNN width checked against the host
     mod-2^20 sum, and again with a client dropped;
  d. the federated FemnistCNN job through `python -m flashe_tpu submit`
     (cmd_submit, in-process roles), FLASHE vs the plain scheme;
  f. Paillier-2048, BFV and CKKS encrypt -> add -> decrypt against host
     sums (`python bench.py --mode paillier` measures the modexp rate);
  g. the `gpu`-marked tests (tests/test_gpu_gate.py) through pytest.

Every time printed carries the card's name and power limit.  Any failed
phase makes the exit code non-zero; the last line of a passing run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

SEED = bytes(range(32))
INT_BITS = 20
FEMNIST_PARAMS = 1_206_590
WIDTHS = (FEMNIST_PARAMS, 4_194_304)
CARD = "card unknown"


def card_line() -> str:
    """`nvidia-smi` name and power limit, from a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(label: str, seconds: float) -> None:
    log(f"  {label}: {seconds:.6f} s  [{CARD}]")


def peak_bytes() -> int:
    import jax

    return max(d.memory_stats().get("peak_bytes_in_use", 0)
               for d in jax.local_devices())


def median_time(fn, n: int = 20, warm: bool = True) -> float:
    import jax

    if warm:
        jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def first_call(fn):
    """(seconds, result) of the first call: compilation plus one run."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return time.perf_counter() - t0, out


def cipher(idx: int, num_clients: int = 10, it: int = 3):
    from flashe_tpu.crypto.flashe import FlasheCipher

    c = FlasheCipher(INT_BITS)
    c.idx = idx
    c.set_num_clients(num_clients)
    c.set_iter_index(it)
    c.generate_prp_seed(assigned_seed=SEED)
    return c


def random_q(n: int, rows=None, seed: int = 0):
    import jax
    import jax.numpy as jnp

    shape = (n,) if rows is None else (rows, n)
    return jax.random.randint(jax.random.PRNGKey(seed), shape, 0, 1 << 16,
                              dtype=jnp.uint32)


def run_cli(argv) -> dict:
    """`python -m flashe_tpu submit ...` in this process; its JSON."""
    from flashe_tpu.__main__ import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"submit {argv} returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


# -- phases -------------------------------------------------------------------

def phase_e():
    """--processes: one OS process per role, sharing the card."""
    t0 = time.perf_counter()
    out = run_cli(["submit", "-c", "examples/configs/mlp_flashe.json",
                   "--processes", "--json"])
    timed("mlp_flashe.json --processes job wall time",
          time.perf_counter() - t0)
    losses = out["loss_per_round"]
    log(f"  loss_per_round: {losses}")
    import math

    assert losses and all(math.isfinite(v) for v in losses), losses


def phase_a(count: int):
    import jax

    devs = jax.devices()
    log(f"  platform={devs[0].platform} device_kind={devs[0].device_kind} "
        f"count={len(devs)}")
    assert devs[0].platform == "gpu", "JAX found no GPU"
    assert len(devs) >= count, f"need {count} cards, JAX sees {len(devs)}"


def _oracle_check(got, q, it, add_idx, minus_idx, n):
    """Host AES oracle on the first and last 4,096 lanes."""
    import numpy as np

    from flashe_tpu.ops.masks import merge_size, reference_mask_stream_host

    merge = merge_size(INT_BITS)
    got, q = np.asarray(got), np.asarray(q)
    for start in (0, n - 4096):
        block0 = start // merge
        lane0 = block0 * merge
        cnt = n - lane0 if start else 4096
        add = reference_mask_stream_host(SEED, it, add_idx, cnt, INT_BITS,
                                         block0)
        minus = reference_mask_stream_host(SEED, it, minus_idx, cnt,
                                           INT_BITS, block0)
        want = ((q[lane0:lane0 + cnt].astype(object) + add - minus)
                % (1 << INT_BITS))
        assert np.array_equal(got[lane0:lane0 + cnt].astype(object), want), \
            f"host oracle mismatch at lanes {lane0}.."


def _round(apply, q10, nc=10):
    """10 client encrypts, the lane aggregate and the boundary decrypt,
    driven from the host one call at a time, as the cipher runs them."""
    import jax.numpy as jnp
    import numpy as np

    mask = np.uint32((1 << INT_BITS) - 1)
    agg = jnp.zeros(q10.shape[1:], jnp.uint32)
    for i in range(nc):
        agg = agg + apply(q10[i], i, i + 1)
    return apply(agg & mask, nc, 0)


def phase_b():
    import numpy as np

    from flashe_tpu.crypto import flashe as fl
    from flashe_tpu.jaxenv import mask_kernel
    from flashe_tpu.ops.fused_mask import fused_mask_apply

    results = {}
    for n in WIDTHS:
        log(f" width {n}")
        c = cipher(idx=2)
        q = random_q(n, seed=n)
        assert mask_kernel(q) == "cuda", "backend rule did not pick the "\
            "fused kernel on the card"
        rk, it = c._round_keys, c.iter_index

        def fused(x, a, b):
            return fused_mask_apply(x, rk, it, a, b, INT_BITS)

        def xla(x, a, b):
            # the cipher's XLA path: each stream materialized, then applied
            return fl._mask_apply(x, fl._stream(rk, it, a, n, INT_BITS),
                                  fl._stream(rk, it, b, n, INT_BITS),
                                  INT_BITS)

        t_c, ct = first_call(lambda: c.encrypt(q))
        timed("fused encrypt first call (compile + run)", t_c)
        t_cx, want = first_call(lambda: xla(q, 2, 3))
        timed("XLA encrypt first call (compile + run)", t_cx)
        assert np.array_equal(np.asarray(ct), np.asarray(want)), \
            "fused encrypt != XLA stream path"
        _oracle_check(ct, q, 3, 2, 3, n)
        dec = c.decrypt(q)  # boundary streams: add idx 10, minus idx 0
        assert np.array_equal(np.asarray(dec), np.asarray(xla(q, 10, 0))), \
            "fused decrypt != XLA stream path"
        _oracle_check(dec, q, 3, 10, 0, n)
        log("  encrypt/decrypt bit-exact vs XLA over all lanes and vs the "
            "host oracle on the first and last 4,096 lanes")
        t_enc_f = median_time(lambda: c.encrypt(q))
        t_enc_x = median_time(lambda: xla(q, 2, 3))
        timed("encrypt median, fused kernel", t_enc_f)
        timed("encrypt median, XLA streams", t_enc_x)

        q10 = random_q(n, rows=10, seed=7)
        want = np.asarray(q10, np.int64).sum(0) % (1 << INT_BITS)
        for name, apply in (("fused", fused), ("XLA", xla)):
            out = _round(apply, q10)
            assert np.array_equal(np.asarray(out, np.int64), want), name
        t_rf = median_time(lambda: _round(fused, q10))
        t_rx = median_time(lambda: _round(xla, q10))
        timed("round median (10 enc + agg + dec), fused kernel", t_rf)
        timed("round median (10 enc + agg + dec), XLA streams", t_rx)
        results[n] = {"round_fused_s": t_rf, "round_xla_s": t_rx,
                      "encrypt_fused_s": t_enc_f, "encrypt_xla_s": t_enc_x}
    log(f"  summary: {json.dumps(results)}  [{CARD}]")


def phase_c():
    import numpy as np

    from flashe_tpu.ops.lanes import lane_add

    n, nc = FEMNIST_PARAMS, 10
    q = np.asarray(random_q(n, rows=nc, seed=11))
    ciphers = [cipher(i, nc, it=5) for i in range(nc)]
    t0 = time.perf_counter()
    cts = [c.encrypt(q[i]) for i, c in enumerate(ciphers)]

    def aggregate(idx):
        agg = cts[idx[0]]
        for i in idx[1:]:
            agg = lane_add(agg, cts[i], INT_BITS)
        return agg

    dec = np.asarray(ciphers[0].decrypt(aggregate(list(range(nc)))))
    timed("10 encrypts + aggregate + decrypt (host-driven)",
          time.perf_counter() - t0)
    want = q.astype(np.int64).sum(0) % (1 << INT_BITS)
    assert np.array_equal(dec.astype(np.int64), want), "round mismatch"
    survivors = [i for i in range(nc) if i != 4]
    dec = np.asarray(ciphers[0].decrypt(aggregate(survivors),
                                        idx_list=survivors))
    want = q[survivors].astype(np.int64).sum(0) % (1 << INT_BITS)
    assert np.array_equal(dec.astype(np.int64), want), "dropout mismatch"
    log("  full round and client-4-dropped round bit-exact vs the host "
        "mod-2^20 sum")


def phase_d():
    import math

    import jax

    runs = {}
    for name, cfg in (("flashe", "cnn_flashe_q16_b1_pad.json"),
                      ("plain", "cnn_plain_q16_pad.json")):
        t0 = time.perf_counter()
        if name == "plain":
            # the float32 reference: full-precision matmuls and convs
            with jax.default_matmul_precision("highest"):
                out = run_cli(["submit", "-c", f"examples/configs/{cfg}",
                               "--json"])
        else:
            out = run_cli(["submit", "-c", f"examples/configs/{cfg}",
                           "--json"])
        timed(f"{cfg} job wall time (compile included)",
              time.perf_counter() - t0)
        log(f"  {name} loss_per_round: {out['loss_per_round']}")
        log(f"  {name} guest phase profile: {json.dumps(out['phases'])}")
        runs[name] = out["loss_per_round"]
    fl, pl = runs["flashe"], runs["plain"]
    assert len(fl) == len(pl) == 2, (fl, pl)
    assert all(math.isfinite(v) for v in fl + pl), (fl, pl)
    # The FLASHE aggregate decrypts exactly to the plain scheme's, so the
    # two jobs differ only in arithmetic: the FLASHE job runs at default
    # precision (TF32 matmuls and convs on the card), the reference at
    # float32, and the card's reductions run in another order.  That
    # moves a 16-bit quantized value by a step now and then; 1% of the
    # loss bounds the drift over two rounds.
    for a, b in zip(fl, pl):
        assert abs(a - b) <= 1e-2 * abs(b), (fl, pl)
    log("  FLASHE and plain losses agree within rtol 1e-2")


def phase_f():
    import numpy as np

    from flashe_tpu.crypto.bfv import BFVCipher
    from flashe_tpu.crypto.ckks import CKKSCipher
    from flashe_tpu.crypto.paillier import PaillierCipher

    rng = np.random.RandomState(3)
    nc = 3
    pail = PaillierCipher()
    pail.generate_key(2048)
    vals = [np.array([int(v) for v in rng.randint(0, 1 << 30, 8)],
                     dtype=object) for _ in range(nc)]
    t0 = time.perf_counter()
    dec = pail.decrypt(pail.add_ciphertexts([pail.encrypt(v) for v in vals]))
    timed("Paillier-2048 encrypt x3 + add + decrypt (compile included)",
          time.perf_counter() - t0)
    assert [int(x) for x in dec] == [int(sum(v[i] for v in vals))
                                     for i in range(8)], "paillier sum"

    bfv = BFVCipher(1964769281, 8192, flagBatching=True, seed=0)
    bfv.generate_keys()
    q = [rng.randint(0, 1 << 16, 4096).astype(np.uint32) for _ in range(nc)]
    dec = bfv.decrypt(bfv.add_ciphertexts([bfv.encrypt(x) for x in q]), 4096)
    assert np.array_equal(np.asarray(dec, np.int64),
                          sum(x.astype(np.int64) for x in q)), "bfv sum"

    ck = CKKSCipher(8192, global_scale=2.0 ** 40, seed=0)
    ck.generate_keys()
    xs = [rng.randn(4096) for _ in range(nc)]
    dec = ck.decrypt(ck.add_ciphertexts([ck.encrypt(x) for x in xs]), 4096)
    err = float(np.max(np.abs(np.asarray(dec) - sum(xs))))
    assert err < 1e-2, f"ckks error {err}"
    log(f"  Paillier-2048, BFV and CKKS sums correct (CKKS max error {err:.2e})")


def phase_g():
    import pytest

    class Count:
        passed = failed = skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.failed:
                Count.failed += 1
            elif report.skipped:
                Count.skipped += 1
            elif report.when == "call":
                Count.passed += 1

    os.environ["FLASHE_TESTS_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_gpu_gate.py")],
                     plugins=[Count()])
    log(f"  gpu gate: rc={int(rc)} passed={Count.passed} "
        f"failed={Count.failed} skipped={Count.skipped}")
    assert int(rc) == 0 and Count.failed == 0 and Count.passed > 0


# -- four cards ----------------------------------------------------------------

def phase_mesh4():
    """2 clients x 2 lane shards over four cards at FemnistCNN width."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flashe_tpu.ops import aes
    from flashe_tpu.parallel.sharded import (
        encrypted_aggregate, make_mesh, padded_lane_count)

    mesh = make_mesh(2, 2)
    assert len(set(mesh.devices.flat)) == 4, "mesh reuses a card"
    n = padded_lane_count(FEMNIST_PARAMS, INT_BITS, 2)
    rk = jnp.asarray(aes.key_schedule(SEED).astype(np.int32))
    q = np.asarray(random_q(n, rows=2, seed=5))
    for survivors in (None, (1,)):
        t_c, out = first_call(lambda: encrypted_aggregate(
            mesh, rk, jnp.asarray(q), jnp.int32(2), INT_BITS, 2,
            survivors=survivors))
        rows = [0, 1] if survivors is None else list(survivors)
        want = q[rows].astype(np.int64).sum(0) % (1 << INT_BITS)
        assert np.array_equal(np.asarray(out, np.int64), want), \
            f"mesh aggregate mismatch (survivors={survivors})"
        assert len(out.sharding.device_set) == 4, out.sharding
        timed(f"mesh aggregate compile + run (survivors={survivors})", t_c)
        t = median_time(lambda: encrypted_aggregate(
            mesh, rk, jnp.asarray(q), jnp.int32(2), INT_BITS, 2,
            survivors=survivors), n=10)
        timed(f"mesh aggregate median (survivors={survivors})", t)
    log(f"  mesh {dict(mesh.shape)} on cards "
        f"{sorted(d.id for d in mesh.devices.flat)}: bit-exact vs the host "
        "mod-2^20 sum, with and without a dropped client")


def phase_party4():
    """set_local_devices(4) encrypt/decrypt == single-card encrypt."""
    import numpy as np

    n = FEMNIST_PARAMS
    q = np.asarray(random_q(n, seed=9))
    single = cipher(idx=1, num_clients=3)
    party = cipher(idx=1, num_clients=3)
    party.set_local_devices(4)
    assert len({d.id for d in party._party_mesh.devices}) == 4
    ct_s = np.asarray(single.encrypt(q))
    t_c, ct_p = first_call(lambda: party.encrypt(q))
    timed("party encrypt over 4 cards, compile + run", t_c)
    assert np.array_equal(np.asarray(ct_p), ct_s), "party encrypt mismatch"
    dec_s = np.asarray(single.decrypt(ct_s, idx_list=[1]))
    dec_p = np.asarray(party.decrypt(ct_p, idx_list=[1]))
    assert np.array_equal(dec_p, dec_s), "party decrypt mismatch"
    assert np.array_equal(dec_p, q), "party roundtrip mismatch"
    timed("party encrypt over 4 cards, median",
          median_time(lambda: party.encrypt(q), n=10))
    timed("single-card encrypt, median",
          median_time(lambda: single.encrypt(q), n=10))
    log("  4-card party encrypt/decrypt bit-exact vs single-card")


def phase_dryrun4():
    import __graft_entry__

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4)
    timed("dryrun_multichip(4) (compile included)", time.perf_counter() - t0)


# -- driver --------------------------------------------------------------------

def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the multi-card path (needs 4 cards)")
    args = ap.parse_args()
    os.chdir(REPO)

    try:
        CARD = card_line()
    except (OSError, subprocess.SubprocessError) as e:
        print(f"no NVIDIA GPU: nvidia-smi failed ({e})", file=sys.stderr)
        return 2

    from flashe_tpu import jaxenv
    from flashe_tpu.ops import fused_mask

    jaxenv.setup()
    # set-up: build the fused kernel once, before any role process starts
    t0 = time.perf_counter()
    log(f"fused kernel library: {fused_mask.build_library()}")
    timed("nvcc build (set-up; 0 when already built)",
          time.perf_counter() - t0)
    if args.chips == 1:
        phases = [("e", "--processes launcher", phase_e),
                  ("a", "device", lambda: phase_a(1)),
                  ("b", "mask kernel", phase_b),
                  ("c", "round at full width", phase_c),
                  ("d", "federated job", phase_d),
                  ("f", "baselines reachable", phase_f),
                  ("g", "gpu gate", phase_g)]
    else:
        phases = [("a", "device", lambda: phase_a(4)),
                  ("mesh", "mesh aggregate, 2 clients x 2 shards",
                   phase_mesh4),
                  ("party", "party over 4 local cards", phase_party4),
                  ("dryrun", "dryrun_multichip(4)", phase_dryrun4)]

    failed = []
    for key, name, fn in phases:
        log(f"phase {key} ({name}): start")
        t0 = time.perf_counter()
        try:
            fn()
            status = "PASS"
        except Exception:
            traceback.print_exc()
            status = "FAIL"
            failed.append(key)
        peak = peak_bytes() if key not in ("e",) else 0
        log(f"phase {key} ({name}): {status} in "
            f"{time.perf_counter() - t0:.1f} s, peak_bytes_in_use={peak}"
            f"  [{CARD}]")
        if key == "a" and status == "FAIL":
            break  # no GPU: never continue on the CPU

    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    import jax

    devs = jax.devices()
    log(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
