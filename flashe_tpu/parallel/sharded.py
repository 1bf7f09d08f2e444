"""Sharded encrypted aggregation over a device mesh.

The accelerator replacement for the reference's transport-level
aggregation (jzf_aggregator.py:404-435: arbiter big-int adds over
gRPC/LMDB): on a multi-GPU host, clients map to a mesh axis and the
flattened lane vector shards across the other axis.  Each (client,
lane-shard) worker generates exactly its slice of the PRP mask stream
(counter-mode AES is embarrassingly parallel: `begin_block` offsets
reproduce bit-identical lanes, see flashe_tpu/ops/masks.py), encrypts on
its own card, and the aggregate is one `psum`, which XLA hands to NCCL
over NVLink — no host round trips, no serialization.  Every card reaches
every other at the same rate, so the mesh shape follows the algorithm
alone.

Mask-index convention matches the protocol: client c on the mesh uses
stream idx c (iter, idx, counter structure unchanged), so a mesh-aggregated
round is bit-compatible with the federated protocol path.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from flashe_tpu.jaxenv import mask_kernel
from flashe_tpu.ops.lanes import lane_add, lane_sub
from flashe_tpu.ops.masks import merge_size, prp_lane_stream

__all__ = ["make_mesh", "padded_lane_count", "encrypted_aggregate",
           "encrypt_shard", "decrypt_shard", "decrypt_shard_runs"]


def make_mesh(n_clients_axis: int, n_lane_shards: int,
              devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    need = n_clients_axis * n_lane_shards
    if devices.size < need:
        raise ValueError(f"need {need} devices, have {devices.size}")
    grid = devices[:need].reshape(n_clients_axis, n_lane_shards)
    return Mesh(grid, ("clients", "lanes"))


def padded_lane_count(n: int, int_bits: int, n_shards: int) -> int:
    """Round lanes up so every shard starts on a 32-aligned AES block
    (the bitsliced stream generator's group granularity)."""
    quantum = merge_size(int_bits) * 32 * n_shards
    return -(-n // quantum) * quantum


def encrypt_shard(rk, q_shard, iter_index, stream_idx, shard_id, int_bits,
                  use_circuit=True, kernel="xla"):
    """Encrypt one lane shard; counters offset by the shard's first block.

    kernel: jaxenv.mask_kernel of the mesh the shard runs on.  "cuda"
    runs the fused kernel (its base_block counter offset keeps shards
    bit-identical to the single-device stream), "xla" the stream path.
    """
    n = q_shard.shape[0]
    merge = merge_size(int_bits)
    begin = shard_id * (n // merge)
    if kernel == "cuda":
        from flashe_tpu.ops.fused_mask import fused_mask_apply

        return fused_mask_apply(q_shard, rk, iter_index, stream_idx,
                                 stream_idx + 1, int_bits, base_block=begin)
    add = prp_lane_stream(rk, iter_index, stream_idx, n, int_bits,
                          begin_block=begin, use_circuit=use_circuit)
    minus = prp_lane_stream(rk, iter_index, stream_idx + 1, n, int_bits,
                            begin_block=begin, use_circuit=use_circuit)
    return lane_sub(lane_add(q_shard, add, int_bits), minus, int_bits)


def decrypt_shard(rk, agg_shard, iter_index, num_clients, shard_id, int_bits,
                  use_circuit=True, kernel="xla"):
    """Boundary-mask decrypt of an aggregated lane shard."""
    n = agg_shard.shape[0]
    merge = merge_size(int_bits)
    begin = shard_id * (n // merge)
    if kernel == "cuda":
        from flashe_tpu.ops.fused_mask import fused_mask_apply

        return fused_mask_apply(agg_shard, rk, iter_index, num_clients, 0,
                                 int_bits, base_block=begin)
    add = prp_lane_stream(rk, iter_index, num_clients, n, int_bits,
                          begin_block=begin, use_circuit=use_circuit)
    minus = prp_lane_stream(rk, iter_index, 0, n, int_bits,
                            begin_block=begin, use_circuit=use_circuit)
    return lane_sub(lane_add(agg_shard, add, int_bits), minus, int_bits)


def decrypt_shard_runs(rk, agg_shard, iter_index, adds, minuses, shard_id,
                       int_bits, use_circuit=True, kernel="xla"):
    """Decrypt an aggregated lane shard given run-merged telescope
    boundaries (dropout path: `adds`/`minuses` from
    crypto.flashe.merge_idx_runs over the survivor idx list,
    reference jzf_flashe.py:354-386).  adds/minuses are static tuples."""
    n = agg_shard.shape[0]
    merge = merge_size(int_bits)
    begin = shard_id * (n // merge)
    out = agg_shard
    adds, minuses = list(adds), list(minuses)
    if kernel == "cuda":
        from flashe_tpu.ops.fused_mask import fused_mask_apply

        npairs = min(len(adds), len(minuses))
        for a, b in zip(adds[:npairs], minuses[:npairs]):
            out = fused_mask_apply(out, rk, iter_index, a, b, int_bits,
                                    base_block=begin)
        adds, minuses = adds[npairs:], minuses[npairs:]
    for a in adds:
        stream = prp_lane_stream(rk, iter_index, a, n, int_bits,
                                 begin_block=begin, use_circuit=use_circuit)
        out = lane_add(out, stream, int_bits)
    for b in minuses:
        stream = prp_lane_stream(rk, iter_index, b, n, int_bits,
                                 begin_block=begin, use_circuit=use_circuit)
        out = lane_sub(out, stream, int_bits)
    return out


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "int_bits", "num_clients", "use_circuit",
                     "survivors"),
)
def encrypted_aggregate(mesh: Mesh, rk, q, iter_index, int_bits: int,
                        num_clients: int, use_circuit: bool = True,
                        survivors: tuple | None = None):
    """One encrypted-aggregation round on a mesh.

    q: (num_clients, N) uint32 quantized lanes, N divisible by
    merge_size * mesh lane shards (use padded_lane_count).  Returns the
    decrypted mod-2^m sum, (N,), sharded over the lane axis.

    survivors: optional static tuple of client indices that completed the
    round (dropout); non-survivors' ciphertexts are zeroed before the
    psum (removing both their value and their masks — the mesh analogue
    of the arbiter never receiving the upload) and decryption uses the
    run-merged survivor boundaries instead of (num_clients, 0).

    int_bits <= 32 only (single-limb lanes psum exactly when
    num_clients * 2^int_bits <= 2^32; asserted).
    """
    if num_clients << int_bits > (1 << 32):
        raise ValueError("num_clients * 2^int_bits must fit in uint32 psum")
    kernel = mask_kernel(mesh)

    if survivors is not None:
        from flashe_tpu.crypto.flashe import merge_idx_runs

        adds, minuses = merge_idx_runs(list(survivors))
        adds, minuses = tuple(adds), tuple(minuses)

    def worker(rk, q_block):
        c = jax.lax.axis_index("clients")
        s = jax.lax.axis_index("lanes")
        qb = q_block[0]  # (shard_lanes,)
        ct = encrypt_shard(rk, qb, iter_index, c, s, int_bits, use_circuit,
                           kernel)
        if survivors is not None:
            alive = functools.reduce(
                jnp.logical_or, [c == i for i in survivors])
            ct = jnp.where(alive, ct, jnp.zeros_like(ct))
        agg = jax.lax.psum(ct, "clients")
        m = np.uint32((1 << int_bits) - 1) if int_bits < 32 else np.uint32(
            0xFFFFFFFF)
        agg = agg & m
        if survivors is None:
            out = decrypt_shard(rk, agg, iter_index, num_clients, s,
                                int_bits, use_circuit, kernel)
        else:
            out = decrypt_shard_runs(rk, agg, iter_index, adds, minuses, s,
                                     int_bits, use_circuit, kernel)
        return out[None, :]

    fn = shard_map(
        worker, mesh=mesh,
        in_specs=(P(), P("clients", "lanes")),
        out_specs=P("clients", "lanes"),
    )
    # every client row holds the same decrypted aggregate; take row 0
    out = fn(rk, q)
    return out[0]
