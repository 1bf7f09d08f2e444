"""FLASHE PRP mask streams as fused device programs.

The reference generates one-time masks by AES-256-ECB over structured
16-byte indices and chops each 128-bit output into `128 // int_bits` lanes,
least-significant-bits first (jzf_flashe.py:48-82, jzf_aes_prp.py:24-30):

    index  = iter_index(4B, BE) || stream_idx(4B, BE) || counter(8B, BE)
    block  = AES256_ECB(seed, index)            # 128 bits, big-endian
    lane_j = (block >> (j * int_bits)) & (2^int_bits - 1),  j < 128//int_bits

Bit-exactness contract: identical to the reference evaluated with a single
worker (N_JOBS=1).  The reference's multiprocessing fan-out makes `counter`
depend on the chunk boundaries — i.e. on the *machine's* cpu_count
(jzf_flashe.py:59-65 uses `i + begin` with `begin` in element units) — so
the only machine-independent canonicalization is the global block index,
which is what a single worker produces and what this module computes.
Golden tests pin this contract against a pure-python replica of the
reference semantics (tests/test_masks_golden.py).

Lanes wider than 32 bits (the reference's `batch=True` mode packs several
quantized elements into one `int_bits`-bit integer, e.g. 120-bit lanes in
the *_b6 configs) are represented as little-endian uint32 limb vectors.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from flashe_tpu.ops import aes
from flashe_tpu.ops.lanes import nlimbs_for

__all__ = [
    "merge_size",
    "num_blocks",
    "index_blocks",
    "lanes_from_blocks",
    "prp_lane_stream",
    "flashe_mask_pair",
]


def merge_size(int_bits: int) -> int:
    """Lanes extracted per AES block (reference jzf_flashe.py:54)."""
    return 128 // int_bits


def num_blocks(count: int, int_bits: int) -> int:
    """Blocks needed for `count` lanes (reference jzf_flashe.py:55)."""
    return (count - 1) // merge_size(int_bits) + 1


def index_blocks(iter_index, stream_idx, begin_block, nblocks: int):
    """Build the (nblocks, 16) int32 byte matrix of PRP indices.

    iter_index / stream_idx may be traced int32 scalars; begin_block is a
    traced or static int32 (global block offset for sharded generation).
    Counter values must stay below 2^31 (100M-param models need ~2^24).
    """
    iter_index = jnp.asarray(iter_index, jnp.int32)
    stream_idx = jnp.asarray(stream_idx, jnp.int32)
    counter = jnp.asarray(begin_block, jnp.int32) + jnp.arange(
        nblocks, dtype=jnp.int32
    )

    def be4(v):
        return [(v >> 24) & 0xFF, (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF]

    ones = jnp.ones((nblocks,), jnp.int32)
    cols = (
        [b * ones for b in be4(iter_index)]
        + [b * ones for b in be4(stream_idx)]
        + [jnp.zeros((nblocks,), jnp.int32)] * 4  # counter high 4 bytes
        + be4(counter)
    )
    return jnp.stack(cols, axis=-1)


def lanes_from_blocks(out_bytes: jnp.ndarray, int_bits: int) -> jnp.ndarray:
    """Extract LSB-first lanes from AES output bytes.

    out_bytes: (N, 16) int32 byte values.  Returns (N * merge, L) uint32
    limb vectors (L == 1 for int_bits <= 32; callers squeeze).  Lane j of
    block i is element i * merge + j (reference jzf_flashe.py:72-80).
    """
    n = out_bytes.shape[0]
    merge = merge_size(int_bits)
    nl = nlimbs_for(int_bits)

    b = out_bytes.astype(jnp.uint32)
    # 32-bit words, w[0] least significant (bytes 12..15 big-endian)
    words = [
        (b[:, 12 - 4 * w] << 24)
        | (b[:, 13 - 4 * w] << 16)
        | (b[:, 14 - 4 * w] << 8)
        | b[:, 15 - 4 * w]
        for w in range(4)
    ]
    words.append(jnp.zeros((n,), jnp.uint32))  # overflow word for shifts

    def extract32(bitpos: int) -> jnp.ndarray:
        wi, off = bitpos >> 5, bitpos & 31
        if off == 0:
            return words[wi]
        return (words[wi] >> off) | (words[wi + 1] << (32 - off))

    top_bits = int_bits - 32 * (nl - 1)
    top_mask = np.uint32((1 << top_bits) - 1) if top_bits < 32 else np.uint32(
        0xFFFFFFFF
    )

    lanes = []
    for j in range(merge):
        limbs = []
        for l in range(nl):
            v = extract32(j * int_bits + 32 * l)
            limbs.append(v & top_mask if l == nl - 1 else v)
        lanes.append(jnp.stack(limbs, axis=-1))  # (N, L)
    return jnp.stack(lanes, axis=1).reshape(n * merge, nl)


def prp_lane_stream(
    round_keys,
    iter_index,
    stream_idx,
    count: int,
    int_bits: int,
    begin_block=0,
    use_circuit: bool = True,
    impl: str = "bitsliced",
) -> jnp.ndarray:
    """Mask lanes for elements [0, count) of stream (iter_index, stream_idx).

    Returns (count,) uint32 for int_bits <= 32, else (count, L) uint32 limbs.
    `begin_block` offsets the counter for sharded generation: a shard owning
    elements [s*merge*k, ...) passes begin_block = s*k and gets bit-identical
    lanes to the corresponding slice of the full stream.

    impl='bitsliced' (default) packs 32 counter blocks per uint32 bit —
    ~30x less VPU arithmetic (flashe_tpu/ops/aes_bitsliced.py); it requires
    begin_block to be a multiple of 32 (callers align shard boundaries via
    flashe_tpu/parallel/sharded.padded_lane_count).  impl='byteplane' is
    the reference-shaped fallback for unaligned offsets.
    """
    if impl == "bitsliced":
        from flashe_tpu.ops.aes_bitsliced import bitsliced_prp_lane_stream

        return bitsliced_prp_lane_stream(round_keys, iter_index, stream_idx,
                                         count, int_bits, begin_block)
    nb = num_blocks(count, int_bits)
    blocks = index_blocks(iter_index, stream_idx, begin_block, nb)
    out = aes.aes_encrypt_blocks(blocks, jnp.asarray(round_keys, jnp.int32),
                                 use_circuit=use_circuit)
    lanes = lanes_from_blocks(out, int_bits)[:count]
    if nlimbs_for(int_bits) == 1:
        return lanes[:, 0]
    return lanes


def flashe_mask_pair(
    round_keys, iter_index, add_idx, minus_idx, count: int, int_bits: int,
    begin_block=0, use_circuit: bool = True,
):
    """The (add, minus) mask streams used by double masking.

    Encrypt uses (idx, idx+1); decrypt-after-aggregate uses (num_clients, 0)
    — the non-cancelling telescope ends (jzf_flashe.py:599-666).
    """
    add = prp_lane_stream(round_keys, iter_index, add_idx, count, int_bits,
                          begin_block, use_circuit)
    minus = prp_lane_stream(round_keys, iter_index, minus_idx, count, int_bits,
                            begin_block, use_circuit)
    return add, minus


def reference_mask_stream_host(
    seed: bytes, iter_index: int, stream_idx: int, count: int, int_bits: int,
    begin_block: int = 0,
) -> np.ndarray:
    """Host-side oracle of the same stream via the numpy AES
    (crypto/aes_host.ecb_encrypt), independent of the device programs.

    Used for cross-checks and for golden-vector generation; mirrors
    jzf_flashe.py:48-82 with N_JOBS=1 (the canonical chunking).
    begin_block starts at that global block (lane begin_block * merge).
    Returns object-dtype ints (arbitrary int_bits).
    """
    from flashe_tpu.crypto.aes_host import ecb_encrypt

    merge = merge_size(int_bits)
    nb = num_blocks(count, int_bits)
    blocks = np.zeros((nb, 16), np.uint8)
    blocks[:, 0:4] = np.frombuffer(iter_index.to_bytes(4, "big"), np.uint8)
    blocks[:, 4:8] = np.frombuffer(stream_idx.to_bytes(4, "big"), np.uint8)
    ctr = np.arange(begin_block, begin_block + nb, dtype=np.uint64)
    blocks[:, 8:] = ctr.astype(">u8").view(np.uint8).reshape(nb, 8)
    out = ecb_encrypt(seed, blocks)
    mask = (1 << int_bits) - 1
    lanes = []
    for row in out:
        val = int.from_bytes(row.tobytes(), "big")
        for _ in range(merge):
            lanes.append(val & mask)
            val >>= int_bits
    return np.array(lanes[:count], dtype=object)
