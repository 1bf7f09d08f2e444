"""On-card regression gate (`FLASHE_TESTS_GPU=1 pytest tests/test_gpu_gate.py
-m gpu`).

The correctness contracts that need the card itself: golden mask vectors
against the host PRP oracle, the FLASHE telescoping identity through the
fused CUDA kernel the backend rule picks, that kernel against the host
oracle, party-mesh bit-exactness (multi-card hosts only) and a Paillier
CRT roundtrip.  Whether a GPU is
present is decided by the `gpu` fixture at run time; without one every
test skips with a reason, so the CPU suite is unaffected.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.gpu

SEED = bytes(range(11, 43))


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a CUDA GPU backend "
                    "(FLASHE_TESTS_GPU=1 on a GPU host)")
    return dev


def _cipher(idx, num_clients, int_bits=20, n_shards=None):
    from flashe_tpu.crypto.flashe import FlasheCipher

    c = FlasheCipher(int_bits)
    c.idx = idx
    c.set_num_clients(num_clients)
    c.set_iter_index(3)
    c.generate_prp_seed(assigned_seed=SEED)
    if n_shards:
        c.set_local_devices(n_shards)
    return c


@pytest.mark.parametrize("int_bits", [20])
def test_golden_masks_on_card(gpu, int_bits):
    """Device mask stream == host AES-PRP oracle (jzf_flashe.py:48-82)."""
    from flashe_tpu.ops import aes, lanes, masks

    rk = aes.key_schedule(SEED)
    count = 129
    got = np.asarray(masks.prp_lane_stream(rk, 3, 2, count, int_bits))
    want = masks.reference_mask_stream_host(SEED, 3, 2, count, int_bits)
    if got.ndim == 2:  # wide lanes arrive as limb arrays
        np.testing.assert_array_equal(
            lanes.lanes_to_ints(got, int_bits), want)
    else:
        np.testing.assert_array_equal(got.astype(object), want)


def test_backend_rule_picks_fused_kernel_on_card(gpu):
    from flashe_tpu.jaxenv import mask_kernel

    assert mask_kernel(jnp.zeros(4, jnp.uint32)) == "cuda"
    assert _cipher(0, 2)._fused(jnp.zeros(4, jnp.uint32))


def test_telescoping_identity_on_card(gpu):
    """enc -> lane-add -> boundary decrypt == mod-sum, through the fused
    kernel the backend rule picks on the card."""
    from flashe_tpu.ops.lanes import lane_add

    int_bits, nc, n = 20, 4, 8192
    rng = np.random.RandomState(7)
    q = rng.randint(0, 1 << 16, (nc, n)).astype(np.uint32)
    ciphers = [_cipher(i, nc, int_bits) for i in range(nc)]
    agg = None
    for i, c in enumerate(ciphers):
        ct = c.encrypt(jnp.asarray(q[i]))
        agg = ct if agg is None else lane_add(agg, ct, int_bits)
    dec = np.asarray(ciphers[0].decrypt(agg)).astype(np.int64)
    want = q.astype(np.int64).sum(0) % (1 << int_bits)
    np.testing.assert_array_equal(dec, want)


@pytest.mark.parametrize("base_block", [0, 96])
def test_fused_kernel_matches_oracle_on_card(gpu, base_block):
    """The CUDA kernel == the host AES oracle, bit for bit, over several
    CUDA blocks and a partial last one."""
    from flashe_tpu.ops import aes, masks
    from flashe_tpu.ops.fused_mask import fused_encrypt

    int_bits = 20
    count = 3 * 32 * 32 * masks.merge_size(int_bits) + 123
    rk = aes.key_schedule(SEED).astype(np.int32)
    rng = np.random.RandomState(1)
    q = rng.randint(0, 1 << 16, count).astype(np.uint32)

    got = np.asarray(fused_encrypt(jnp.asarray(q), rk, 4, 2, int_bits,
                                   base_block=base_block))
    add = masks.reference_mask_stream_host(SEED, 4, 2, count, int_bits,
                                           base_block)
    minus = masks.reference_mask_stream_host(SEED, 4, 3, count, int_bits,
                                             base_block)
    want = (q.astype(object) + add - minus) % (1 << int_bits)
    np.testing.assert_array_equal(got.astype(object), want)


def test_party_mesh_bit_exact_on_card(gpu):
    """Sharded party encrypt == single-device encrypt on real cards
    (skips on a 1-card host: there is no local mesh to shard over)."""
    n_dev = len(jax.devices())
    if n_dev < 2:
        pytest.skip(f"party mesh needs >=2 local devices, have {n_dev}")
    rng = np.random.RandomState(0)
    q = jnp.asarray(rng.randint(0, 1 << 16, 4000).astype(np.uint32))
    single = _cipher(idx=1, num_clients=3)
    party = _cipher(idx=1, num_clients=3, n_shards=n_dev)
    np.testing.assert_array_equal(
        np.asarray(single.encrypt(q)), np.asarray(party.encrypt(q)))


def test_paillier_crt_roundtrip_on_card(gpu):
    """Device-kernel Paillier encrypt -> homomorphic add -> CRT decrypt."""
    from flashe_tpu.crypto import paillier

    c = paillier.PaillierCipher()
    c.generate_key(n_length=512)
    rng = np.random.RandomState(2)
    batches = [np.array([int(v) for v in rng.randint(0, 1 << 30, 4)],
                        dtype=object) for _ in range(3)]
    cts = [c.encrypt(b) for b in batches]
    agg = c.add_ciphertexts(cts)
    dec = c.decrypt(agg)
    want = [int(sum(b[i] for b in batches)) for i in range(4)]
    assert list(dec) == want
