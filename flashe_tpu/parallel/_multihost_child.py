"""Child worker for multi-process mesh validation (launched by
parallel.multihost.launch_local from tests).

Each process emulates one party's host: it joins the coordinator, owns
one client row of the global (clients, lanes) mesh with its local
devices as lane shards, supplies ONLY its own quantized lanes, and runs
the encrypted aggregate.  Every process then checks its addressable
output shards bit-for-bit against the plaintext mod-2^m sum computed
from the shared seed — the same value the single-process mesh path
(tests/test_sharded.py) and the federated protocol cipher produce, so
equality here is bit-identity across all three paths.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

SEED = bytes(range(32))
INT_BITS = 20


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--elements", type=int, default=4000)
    args = ap.parse_args()

    from flashe_tpu.parallel import multihost
    from flashe_tpu.parallel.sharded import padded_lane_count

    multihost.init_multihost(args.coordinator, args.num_processes,
                             args.process_id)

    from flashe_tpu import jaxenv

    jaxenv.setup()  # persistent compile cache: repeat runs skip XLA compile

    import jax
    import jax.numpy as jnp

    from flashe_tpu.ops import aes

    mesh = multihost.make_multihost_mesh()
    n_clients = mesh.shape["clients"]
    n_shards = mesh.shape["lanes"]
    assert n_clients == args.num_processes

    n = padded_lane_count(args.elements, INT_BITS, n_shards)
    rng = np.random.RandomState(0)  # shared seed: every process knows all q
    q_full = rng.randint(0, 1 << 16, (n_clients, n)).astype(np.uint32)
    rows = multihost.local_client_rows(mesh, n_clients)
    q_local = q_full[rows]

    rk = jnp.asarray(aes.key_schedule(SEED).astype(np.int32))

    def check(out, want):
        # out: (N,) decrypted aggregate, sharded over the lane axis; every
        # process verifies each of its addressable lane shards bit-for-bit
        assert out.addressable_shards, "process owns no output shards"
        for s in out.addressable_shards:
            sl = s.index[-1] if s.index else slice(None)
            np.testing.assert_array_equal(
                np.asarray(s.data).reshape(-1).astype(np.int64), want[sl])

    # AOT-compile both round programs, then rendezvous: every process
    # must reach the FIRST collective within the Gloo exchange's ~30 s
    # window, and concurrent XLA compiles on few cores spread far wider
    # than that (see multihost.coordination_barrier)
    survivors0 = tuple(range(n_clients - 1)) if n_clients > 1 else (0,)
    multihost.multihost_encrypted_aggregate(
        mesh, rk, q_local, jnp.int32(0), INT_BITS, n_clients,
        compile_only=True)
    multihost.multihost_encrypted_aggregate(
        mesh, rk, q_local, jnp.int32(1), INT_BITS, n_clients,
        survivors=survivors0, compile_only=True)
    multihost.coordination_barrier("compiled")

    # round 0: full participation
    t0 = time.perf_counter()
    out = multihost.multihost_encrypted_aggregate(
        mesh, rk, q_local, jnp.int32(0), INT_BITS, n_clients)
    out.block_until_ready()
    dt0 = time.perf_counter() - t0
    want = q_full.astype(np.int64).sum(0) % (1 << INT_BITS)
    check(out, want)

    # round 1: dropout — last client's ciphertext excluded via survivors
    survivors = survivors0
    out = multihost.multihost_encrypted_aggregate(
        mesh, rk, q_local, jnp.int32(1), INT_BITS, n_clients,
        survivors=survivors)
    out.block_until_ready()
    want = q_full[list(survivors)].astype(np.int64).sum(0) % (1 << INT_BITS)
    check(out, want)

    print(f"OK process={args.process_id} mesh={dict(mesh.shape)} "
          f"lanes={n} first_round_s={dt0:.3f}")


if __name__ == "__main__":
    main()
