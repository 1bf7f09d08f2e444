"""The fused CUDA mask kernel (native/flashe_mask.cu, ops/fused_mask.py) on
the CPU.

The kernel's arithmetic lives in native/flashe_mask.h; its host build
(native/flashe_mask_host.cpp) runs the same counter_words / block_lane code
group by group in the kernel's lane order, and is checked here against the
XLA stream path and the host AES oracle.  The JAX wrapper is lowered for
CUDA (alone and inside shard_map) to check the call it emits.  Running the
CUDA build needs the card: tests/test_gpu_gate.py.
"""

import ctypes
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from flashe_tpu import native
from flashe_tpu.ops import aes, masks
from flashe_tpu.ops import fused_mask as fm
from flashe_tpu.ops.aes_bitsliced import round_key_planes

SEED = bytes(range(32))


@pytest.fixture(scope="module")
def host_kernel():
    lib = native.build_lib("flashe_mask_host.cpp", "libflashemask_host.so")
    if lib is None:
        pytest.fail("g++ could not build native/flashe_mask_host.cpp")
    fn = lib.flashe_mask_apply_host
    P = ctypes.c_void_p
    fn.argtypes = [P, P, P, P, ctypes.c_int64, ctypes.c_int32]

    def apply(q, it, add_idx, minus_idx, int_bits, base_block=0):
        q = np.ascontiguousarray(q, np.uint32)
        out = np.zeros_like(q)
        kp = np.asarray(round_key_planes(aes.key_schedule(SEED)), np.uint32)
        sc = np.array([it, add_idx, minus_idx, base_block], np.int32)
        fn(q.ctypes.data, out.ctypes.data, kp.ctypes.data, sc.ctypes.data,
           q.shape[0], int_bits)
        return out

    return apply


def _xla(q, it, add_idx, minus_idx, int_bits, base_block=0):
    rk = aes.key_schedule(SEED)
    n = q.shape[0]
    add = np.asarray(masks.prp_lane_stream(rk, it, add_idx, n, int_bits,
                                           begin_block=base_block), np.int64)
    minus = np.asarray(masks.prp_lane_stream(rk, it, minus_idx, n, int_bits,
                                             begin_block=base_block),
                       np.int64)
    return (q.astype(np.int64) + add - minus) % (1 << int_bits)


@pytest.mark.parametrize("int_bits,count,base_block", [
    (20, 32 * 32 * 6 * 2 + 123, 0),   # two CUDA blocks and a partial third
    (20, 5000, 64),                   # counter offset of a shard
    (16, 777, 32),
    (24, 3001, 96),
    (32, 100, 0),
])
def test_kernel_arithmetic_matches_xla_stream(host_kernel, int_bits, count,
                                              base_block):
    q = np.random.RandomState(count).randint(0, 1 << 16, count)
    got = host_kernel(q, 3, 2, 3, int_bits, base_block)
    np.testing.assert_array_equal(
        got.astype(np.int64), _xla(q, 3, 2, 3, int_bits, base_block))


def test_kernel_arithmetic_matches_host_oracle(host_kernel):
    """Boundary decrypt (add idx = num_clients, minus idx = 0) against the
    numpy AES oracle, independent of every device program."""
    count, int_bits = 4099, 20
    q = np.random.RandomState(1).randint(0, 1 << 20, count)
    got = host_kernel(q, 7, 10, 0, int_bits)
    add = masks.reference_mask_stream_host(SEED, 7, 10, count, int_bits)
    minus = masks.reference_mask_stream_host(SEED, 7, 0, count, int_bits)
    want = (q.astype(object) + add - minus) % (1 << int_bits)
    np.testing.assert_array_equal(got.astype(object), want)


def test_kernel_arithmetic_roundtrip(host_kernel):
    """Three clients encrypt (idx, idx+1), the lane sum decrypts with the
    boundary streams to the plain mod-2^m sum."""
    int_bits, count = 20, 2500
    rng = np.random.RandomState(2)
    qs = [rng.randint(0, 1 << 16, count) for _ in range(3)]
    agg = sum(host_kernel(q, 0, i, i + 1, int_bits).astype(np.int64)
              for i, q in enumerate(qs)) % (1 << int_bits)
    dec = host_kernel(agg, 0, 3, 0, int_bits)
    np.testing.assert_array_equal(
        dec.astype(np.int64), sum(q.astype(np.int64) for q in qs)
        % (1 << int_bits))


@pytest.mark.parametrize("int_bits,ok", [(8, False), (15, False), (16, True),
                                         (20, True), (32, True), (64, False)])
def test_supported_lane_widths(int_bits, ok):
    assert fm.supports(int_bits) is ok
    if not ok:
        with pytest.raises(ValueError, match="int_bits"):
            fm.fused_mask_apply(jnp.zeros(8, jnp.uint32),
                                aes.key_schedule(SEED), 0, 1, 2, int_bits)


def test_nvcc_command_targets_hopper(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("")
    monkeypatch.setenv("NVCC", str(fake))
    cmd = fm.nvcc_command("out.so")
    assert cmd[0] == str(fake)
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert jax.ffi.include_dir() in cmd
    assert cmd[-1].endswith(os.path.join("native", "flashe_mask.cu"))
    # the library name carries a digest of the kernel sources
    path = fm.library_path()
    assert os.path.basename(path).startswith("libflashe_mask-")
    assert os.path.dirname(path).endswith("build")


def test_build_without_nvcc_says_so(monkeypatch):
    monkeypatch.setenv("NVCC", "/nonexistent/nvcc")
    monkeypatch.setattr(fm.shutil, "which", lambda name: None)
    monkeypatch.setattr(fm.os.path, "exists",
                        lambda p, _e=os.path.exists: (
                            False if "cuda" in p or "nvcc" in p or
                            "libflashe_mask-" in p else _e(p)))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fm.build_library()


def _lower_for_cuda(fn, *shapes):
    return jax.jit(fn).trace(*shapes).lower(
        lowering_platforms=("cuda",)).as_text()


def test_wrapper_lowers_to_one_ffi_call(monkeypatch):
    """At FemnistCNN width the wrapper emits exactly one custom call to the
    registered target, with the lane vector, the key planes and the four
    scalars as operands and int_bits as an attribute."""
    monkeypatch.setattr(fm, "_register", lambda: None)
    rk = jnp.asarray(aes.key_schedule(SEED).astype(np.int32))
    text = _lower_for_cuda(lambda q: fm.fused_encrypt(q, rk, 1, 2, 20),
                           jax.ShapeDtypeStruct((1_206_590,), jnp.uint32))
    calls = [l for l in text.splitlines() if "custom_call" in l]
    assert len(calls) == 1
    assert "@flashe_mask_apply" in calls[0]
    assert "int_bits = 20" in calls[0]
    assert "tensor<1206590xui32>" in text


def test_wrapper_lowers_inside_shard_map(monkeypatch):
    """The sharded paths call the kernel per shard with a traced counter
    offset: it lowers under shard_map over a 4-device mesh."""
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    monkeypatch.setattr(fm, "_register", lambda: None)
    rk = jnp.asarray(aes.key_schedule(SEED).astype(np.int32))
    mesh = Mesh(np.array(jax.devices()[:4]), ("lanes",))

    def worker(q):
        s = jax.lax.axis_index("lanes")
        return fm.fused_mask_apply(q, rk, 1, 2, 3, 20,
                                   base_block=s * (q.shape[0] // 6))

    fn = shard_map(worker, mesh=mesh, in_specs=P("lanes"),
                   out_specs=P("lanes"))
    text = _lower_for_cuda(fn, jax.ShapeDtypeStruct((4 * 6 * 32 * 10,),
                                                    jnp.uint32))
    assert sum("@flashe_mask_apply" in l for l in text.splitlines()) == 1
