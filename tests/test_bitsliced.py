"""Bitsliced AES mask stream: bit-exact with the reference PRP stream."""

import numpy as np
import jax
import pytest

from flashe_tpu.ops import aes, masks
from flashe_tpu.ops.aes_bitsliced import bitsliced_prp_lane_stream
from flashe_tpu.ops.lanes import lanes_to_ints

SEED = bytes(range(7, 39))


@pytest.mark.parametrize("int_bits,count", [(20, 5), (20, 400), (16, 77),
                                            (32, 100)])
def test_bitsliced_matches_reference(int_bits, count):
    rk = aes.key_schedule(SEED)
    got = np.asarray(
        bitsliced_prp_lane_stream(rk, 3, 2, count, int_bits))
    want = masks.reference_mask_stream_host(SEED, 3, 2, count, int_bits)
    np.testing.assert_array_equal(got.astype(object), want)


def test_bitsliced_wide_lanes():
    rk = aes.key_schedule(SEED)
    int_bits, count = 120, 40
    got = lanes_to_ints(
        np.asarray(bitsliced_prp_lane_stream(rk, 1, 4, count, int_bits)),
        int_bits)
    want = masks.reference_mask_stream_host(SEED, 1, 4, count, int_bits)
    np.testing.assert_array_equal(got, want)


def test_bitsliced_sharded_offset():
    # begin_block must reproduce the same lanes at a 32-aligned offset
    int_bits = 20
    merge = masks.merge_size(int_bits)
    rk = aes.key_schedule(SEED)
    full = np.asarray(
        bitsliced_prp_lane_stream(rk, 0, 1, 64 * merge, int_bits))
    shard = np.asarray(
        bitsliced_prp_lane_stream(rk, 0, 1, 32 * merge, int_bits,
                                  begin_block=32))
    np.testing.assert_array_equal(shard, full[32 * merge: 64 * merge])
