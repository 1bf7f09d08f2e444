"""Fused FLASHE mask kernel for NVIDIA Hopper (CUDA, called through jax.ffi).

The XLA path (ops/masks.prp_lane_stream) writes each uint32 mask stream
to device memory in full and reads it back before it is applied.  This
kernel (native/flashe_mask.cu) generates the bitsliced AES-256 counter
blocks of both streams in registers and writes only the result

    out = (q + stream(add_idx) - stream(minus_idx)) mod 2^int_bits

which is double-mask encrypt (add=idx, minus=idx+1) and boundary decrypt
(add=num_clients, minus=0) alike.  Its arithmetic lives in
native/flashe_mask.h, which also builds for the host
(native/flashe_mask_host.cpp) so the CPU tests check the very code the
card runs; the CUDA part adds only the thread layout.

The library is built from the repository's sources on first use:
`nvcc -gencode arch=compute_90a,code=sm_90a` into `build/` (git-ignored),
under a name that carries a digest of the sources, so an edited kernel is
rebuilt and concurrent processes never load a half-written file.  The
build counts as set-up time.  jaxenv.mask_kernel decides where it runs.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np
import jax
import jax.numpy as jnp

from flashe_tpu.ops.aes_bitsliced import round_key_planes

__all__ = ["supports", "fused_mask_apply", "fused_encrypt", "fused_decrypt",
           "build_library", "nvcc_command"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE = os.path.join(_REPO, "native")
_SOURCES = ("flashe_mask.cu", "flashe_mask.h")
_TARGET = "flashe_mask_apply"


def supports(int_bits: int) -> bool:
    """Lane widths the kernel handles: single-limb lanes of 16-32 bits
    (the production FLASHE configs use 20).  Narrower lanes pack more
    lanes per block than its shared-memory staging holds."""
    return 16 <= int_bits <= 32


def _digest() -> str:
    h = hashlib.sha1()
    for name in _SOURCES:
        with open(os.path.join(_NATIVE, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def library_path() -> str:
    return os.path.join(_REPO, "build", f"libflashe_mask-{_digest()}.so")


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc",
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the fused mask kernel is built "
                       "with the CUDA toolkit (set NVCC to its path)")


def nvcc_command(out: str) -> list:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-I", jax.ffi.include_dir(), "-I", _NATIVE, "-o", out,
            os.path.join(_NATIVE, "flashe_mask.cu")]


def build_library() -> str:
    """Path of the built library, compiling it if this source has not
    been built yet."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    try:
        res = subprocess.run(nvcc_command(tmp), capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{res.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def _register() -> None:
    lib = ctypes.CDLL(build_library())
    jax.ffi.register_ffi_target(
        _TARGET, jax.ffi.pycapsule(lib.FlasheMaskApply), platform="CUDA")


@functools.partial(jax.jit, static_argnames=("int_bits",))
def _apply(q, rk, scalars, int_bits):
    out = jax.ShapeDtypeStruct(q.shape, jnp.uint32)
    return jax.ffi.ffi_call(_TARGET, out)(
        q, round_key_planes(rk), scalars, int_bits=np.int32(int_bits))


def fused_mask_apply(q, rk, iter_index, add_idx, minus_idx, int_bits: int,
                     base_block=0):
    """(q + stream(add_idx) - stream(minus_idx)) mod 2^int_bits, fused.

    q: (n,) uint32 lanes on a CUDA device.  rk: (15, 16) round keys.
    iter_index, add_idx, minus_idx and base_block may be python ints or
    int32 scalars (traced ones too).  base_block offsets the AES counters
    and must be a multiple of 32: the counter-offset contract of
    prp_lane_stream's begin_block.
    """
    if not supports(int_bits):
        raise ValueError(f"the fused mask kernel handles int_bits in "
                         f"[16, 32], not {int_bits}")
    _register()
    vals = (iter_index, add_idx, minus_idx, base_block)
    if all(isinstance(v, (int, np.integer)) for v in vals):
        # host integers travel with the call: no eager device op per value
        scalars = np.asarray(vals, np.int32)
    else:
        scalars = jnp.stack([jnp.asarray(v, jnp.int32) for v in vals])
    return _apply(q, jnp.asarray(rk, jnp.int32), scalars, int_bits)


def fused_encrypt(q, rk, iter_index, client_idx, int_bits: int,
                  base_block=0):
    """FLASHE double-mask encrypt (jzf_flashe.py:480-481), fused."""
    return fused_mask_apply(q, rk, iter_index, client_idx, client_idx + 1,
                            int_bits, base_block)


def fused_decrypt(agg, rk, iter_index, num_clients, int_bits: int,
                  base_block=0):
    """Boundary-mask decrypt of an aggregate (add idx=n, minus idx=0)."""
    return fused_mask_apply(agg, rk, iter_index, num_clients, 0, int_bits,
                            base_block)
