"""A federated party that owns a multi-device slice.

The reference scales one silo's crypto across all its CPU cores with a
`multiprocessing.Pool` over contiguous index chunks
(federatedml/secureprotol/jzf_flashe.py:436-447).  The accelerator
composition is: the *protocol* path (flashe_tpu/protocol, TCP or in-mem
federation between WAN silos) stays unchanged, while each party's
encrypt/decrypt shards its flattened lane vector over a local 1-D
device mesh via `shard_map` — counter-offset mask generation
(ops/masks.py `begin_block`) makes every shard produce exactly its
slice of the PRP stream, so the sharded ciphertext is bit-identical to
the single-device one (asserted in tests/test_party_mesh.py).

This is the BASELINE north-star scaling story (1 card -> 1 host -> N
hosts *per party*): a silo with 4 GPUs shards its crypto over all four
yet speaks the exact same wire protocol.
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
from flashe_tpu.parallel.sharded import (
    decrypt_shard_runs, encrypt_shard, padded_lane_count)

__all__ = ["LocalLaneMesh", "sparse_decrypt_fanout"]


@functools.partial(jax.jit, static_argnames=("mesh", "int_bits"))
def _party_encrypt(mesh, rk, q, iter_index, stream_idx, int_bits):
    """Double-mask encrypt of a (N_pad,) lane vector sharded over the
    local `lanes` axis; N_pad from padded_lane_count."""

    def worker(rk, it, sidx, qb):
        s = jax.lax.axis_index("lanes")
        return encrypt_shard(rk, qb, it, sidx, s, int_bits,
                             kernel=mask_kernel(mesh))

    return shard_map(
        worker, mesh=mesh,
        in_specs=(P(), P(), P(), P("lanes")),
        out_specs=P("lanes"),
    )(rk, iter_index, stream_idx, q)


@functools.partial(
    jax.jit, static_argnames=("mesh", "int_bits", "adds", "minuses"))
def _party_decrypt(mesh, rk, agg, iter_index, int_bits, adds, minuses):
    """Run-boundary decrypt of an aggregated (N_pad,) lane vector sharded
    over the local `lanes` axis (adds/minuses: static tuples from
    crypto.flashe.merge_idx_runs)."""

    def worker(rk, it, aggb):
        s = jax.lax.axis_index("lanes")
        return decrypt_shard_runs(rk, aggb, it, adds, minuses, s, int_bits,
                                  kernel=mask_kernel(mesh))

    return shard_map(
        worker, mesh=mesh,
        in_specs=(P(), P(), P("lanes")),
        out_specs=P("lanes"),
    )(rk, iter_index, agg)


@functools.partial(jax.jit, static_argnames=("mesh", "int_bits"))
def _party_encrypt_single(mesh, rk, q, iter_index, stream_idx, int_bits):
    """Single-mask encrypt (c = q + a_idx) of a (N_pad,) lane vector
    sharded over the local `lanes` axis (reference single-mask scheme,
    jzf_flashe.py:306-343)."""

    def worker(rk, it, sidx, qb):
        s = jax.lax.axis_index("lanes")
        n = qb.shape[0]
        begin = s * (n // merge_size(int_bits))
        add = prp_lane_stream(rk, it, sidx, n, int_bits,
                              begin_block=begin)
        return lane_add(qb, add, int_bits)

    return shard_map(
        worker, mesh=mesh,
        in_specs=(P(), P(), P(), P("lanes")),
        out_specs=P("lanes"),
    )(rk, iter_index, stream_idx, q)


@functools.partial(
    jax.jit, static_argnames=("mesh", "int_bits", "idx_list"))
def _party_decrypt_single(mesh, rk, agg, iter_index, int_bits, idx_list):
    """Single-mask aggregate decrypt: subtract every survivor's stream
    (no telescoping; idx_list static)."""

    def worker(rk, it, aggb):
        s = jax.lax.axis_index("lanes")
        return decrypt_shard_runs(rk, aggb, it, (), idx_list, s, int_bits)

    return shard_map(
        worker, mesh=mesh,
        in_specs=(P(), P(), P("lanes")),
        out_specs=P("lanes"),
    )(rk, iter_index, agg)


@functools.partial(
    jax.jit,
    static_argnames=("cnt", "n_dense", "int_bits", "double"))
def _sparse_partial(rk, iter_index, idxs, locs, cnt, n_dense, int_bits,
                    double):
    """Scattered mask accumulators for a subset of clients (sparse path).

    idxs: (C,) int32 stream indices; locs: (C, cnt) int32 dense
    positions (rows padded with n_dense, dropped by the scatter).
    Returns (acc_minus, acc_add): the sum of the clients' add-streams /
    minus-streams scattered to dense positions, uint32 mod 2^32 (the
    caller masks to int_bits — exact because 2^int_bits divides 2^32).
    """

    def streams(idx):
        return prp_lane_stream(rk, iter_index, idx, cnt, int_bits)

    a = jax.vmap(streams)(idxs)  # (C, cnt)
    acc_minus = jnp.zeros(n_dense, jnp.uint32).at[locs].add(
        a, mode="drop")
    if double:
        b = jax.vmap(streams)(idxs + 1)
        acc_add = jnp.zeros(n_dense, jnp.uint32).at[locs].add(
            b, mode="drop")
    else:
        acc_add = jnp.zeros(n_dense, jnp.uint32)
    return acc_minus, acc_add


def sparse_decrypt_fanout(devices, rk, value, iter_index, locs_list,
                          idx_list, int_bits, double):
    """Sparse-aggregate decrypt fanned out over local devices by CLIENT
    (the reference regenerates per-client masks across pool workers,
    jzf_flashe.py:431-454): device d handles a round-robin subset of the
    surviving clients, generates their compact-counter streams and
    scatters them into a dense partial on-device; the partials combine
    with wrapping uint32 adds (exact mod 2^int_bits) on the default
    device.  Bit-identical to the single-device path."""
    n_dense = int(value.shape[0])
    cnt = max(int(np.asarray(m).shape[0]) for m in locs_list)
    n_dev = min(len(devices), len(idx_list))
    partials = []
    for d in range(n_dev):
        rows = list(range(d, len(idx_list), n_dev))
        locs = np.full((len(rows), cnt), n_dense, np.int32)
        idxs = np.empty(len(rows), np.int32)
        for r, row in enumerate(rows):
            m = np.asarray(locs_list[row], np.int32)
            locs[r, : m.shape[0]] = m
            idxs[r] = idx_list[row]
        dev = devices[d]
        partials.append(_sparse_partial(
            rk, jnp.asarray(iter_index, jnp.int32),
            jax.device_put(idxs, dev), jax.device_put(locs, dev),
            cnt, n_dense, int_bits, double))
    acc_minus = np.zeros(n_dense, np.uint32)
    acc_add = np.zeros(n_dense, np.uint32)
    for pm, pa in partials:
        acc_minus += np.asarray(pm)  # wrapping uint32 adds
        acc_add += np.asarray(pa)
    out = lane_sub(jnp.asarray(value), jnp.asarray(acc_minus), int_bits)
    if double:
        out = lane_add(out, jnp.asarray(acc_add), int_bits)
    return out


class LocalLaneMesh:
    """1-D `lanes` mesh over a party's local devices.

    Install on a FlasheCipher with `cipher.set_local_devices(...)`; the
    cipher then routes dense double-mask AND single-mask
    encrypt/decrypt through shard_map (and its sparse decrypt through
    sparse_decrypt_fanout over the same devices), leaving the protocol
    and limb (>32-bit) paths untouched.
    """

    def __init__(self, n_shards=None, devices=None):
        devices = list(devices if devices is not None else
                       jax.local_devices())
        if n_shards in (None, "all"):
            n_shards = len(devices)
        n_shards = int(n_shards)
        if n_shards > len(devices):
            raise ValueError(
                f"local_lane_shards={n_shards} > {len(devices)} local "
                f"devices")
        self.n_shards = n_shards
        self.devices = devices[:n_shards]
        self.mesh = Mesh(np.asarray(devices[:n_shards]), ("lanes",))
        self._sharding = NamedSharding(self.mesh, P("lanes"))

    def _pad(self, v, int_bits):
        n = v.shape[0]
        n_pad = padded_lane_count(n, int_bits, self.n_shards)
        if n_pad != n:
            v = jnp.concatenate(
                [jnp.asarray(v), jnp.zeros(n_pad - n, v.dtype)])
        return jax.device_put(jnp.asarray(v), self._sharding)

    def encrypt(self, rk, q, iter_index, stream_idx, int_bits):
        n = q.shape[0]
        qp = self._pad(q, int_bits)
        out = _party_encrypt(self.mesh, rk, qp, jnp.asarray(iter_index,
                             jnp.int32), jnp.asarray(stream_idx, jnp.int32),
                             int_bits)
        return out[:n]

    def decrypt_runs(self, rk, agg, iter_index, adds, minuses, int_bits):
        n = agg.shape[0]
        ap = self._pad(agg, int_bits)
        out = _party_decrypt(self.mesh, rk, ap,
                             jnp.asarray(iter_index, jnp.int32), int_bits,
                             tuple(adds), tuple(minuses))
        return out[:n]

    def encrypt_single(self, rk, q, iter_index, stream_idx, int_bits):
        n = q.shape[0]
        qp = self._pad(q, int_bits)
        out = _party_encrypt_single(
            self.mesh, rk, qp, jnp.asarray(iter_index, jnp.int32),
            jnp.asarray(stream_idx, jnp.int32), int_bits)
        return out[:n]

    def decrypt_single(self, rk, agg, iter_index, idx_list, int_bits):
        n = agg.shape[0]
        ap = self._pad(agg, int_bits)
        out = _party_decrypt_single(
            self.mesh, rk, ap, jnp.asarray(iter_index, jnp.int32),
            int_bits, tuple(idx_list))
        return out[:n]
