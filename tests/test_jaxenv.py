"""Process set-up rules: the compile-cache directory, the single mask-kernel
choice, and the launchers' card placement."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from flashe_tpu import jaxenv
from flashe_tpu.jaxenv import mask_kernel
from flashe_tpu.runtime.placement import child_envs, visible_cards

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Dev:
    def __init__(self, platform):
        self.platform = platform


# -- compile cache -----------------------------------------------------------

_PRINT_CACHE = "import jax; print(jax.config.jax_compilation_cache_dir)"


@pytest.mark.parametrize("entry", [
    "from flashe_tpu import jaxenv; jaxenv.setup()",
    "from flashe_tpu.__main__ import main; main(['keygen'])",
    "import bench; bench.setup_jax(force_cpu=True)",
])
@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_cache_dir_rule(tmp_path, entry, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise <repo>/.jax_cache."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        want = env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    out = subprocess.run(
        [sys.executable, "-c", f"{entry}\n{_PRINT_CACHE}"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == want


def test_cache_dir_function(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jaxenv.cache_dir() == os.path.join(REPO, ".jax_cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxenv.cache_dir() == str(tmp_path)


# -- the single backend rule ---------------------------------------------------

def test_mask_kernel_on_cpu_arrays_and_meshes():
    x = jnp.zeros(8, jnp.uint32)
    assert mask_kernel(x) == "xla"
    assert mask_kernel(np.zeros(8, np.uint32)) == "xla"
    assert mask_kernel(jax.devices()[0]) == "xla"
    from flashe_tpu.parallel.sharded import make_mesh

    assert mask_kernel(make_mesh(2, 2)) == "xla"


def test_mask_kernel_picks_cuda_for_gpu_devices():
    assert mask_kernel(_Dev("gpu")) == "cuda"
    assert mask_kernel(_Dev("cpu")) == "xla"


def test_mask_kernel_refuses_traced_values():
    def f(x):
        mask_kernel(x)
        return x

    with pytest.raises(TypeError, match="traced"):
        jax.jit(f)(jnp.zeros(4))


def _cipher():
    from flashe_tpu.crypto.flashe import FlasheCipher

    c = FlasheCipher(20)
    c.idx = 1
    c.set_num_clients(3)
    c.set_num_params(64)
    c.set_iter_index(0)
    c.generate_prp_seed(assigned_seed=7)
    return c


def test_cipher_follows_the_rule(monkeypatch):
    """Where the rule says "cuda", encrypt and decrypt take the fused
    kernel and precompute turns itself off; elsewhere the stream path."""
    import flashe_tpu.crypto.flashe as fl
    from flashe_tpu.ops import fused_mask as fm

    q = jnp.arange(64, dtype=jnp.uint32)
    c = _cipher()
    want_ct = np.asarray(c.encrypt(q))
    want_dec = np.asarray(c.decrypt(c.encrypt(q), idx_list=[1]))
    c.prepare_encrypt()
    assert c._prepared  # XLA path on the CPU precomputes
    c._prepared.clear()

    calls = []

    def fused(q, rk, it, a, b, int_bits, base_block=0, **kw):
        calls.append((a, b))
        n = q.shape[0]
        return fl._mask_apply(q, fl._stream(rk, it, a, n, int_bits),
                              fl._stream(rk, it, b, n, int_bits), int_bits)

    monkeypatch.setattr(fm, "fused_mask_apply", fused)
    monkeypatch.setattr(
        fm, "fused_encrypt",
        lambda q, rk, it, i, ib, **kw: fused(q, rk, it, i, i + 1, ib))
    monkeypatch.setattr(fl, "mask_kernel", lambda x: "cuda")

    c2 = _cipher()
    c2.prepare_encrypt()
    assert not c2._prepared  # fused: nothing to precompute
    np.testing.assert_array_equal(np.asarray(c2.encrypt(q)), want_ct)
    np.testing.assert_array_equal(
        np.asarray(c2.decrypt(c2.encrypt(q), idx_list=[1])), want_dec)
    assert calls == [(1, 2), (1, 2), (2, 1)]


# -- launcher placement --------------------------------------------------------

def test_child_envs_one_card_each():
    envs, rule = child_envs({"PATH": "/bin"}, 3, cards=["0", "1", "2", "3"])
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["0", "1", "2"]
    assert all("XLA_PYTHON_CLIENT_MEM_FRACTION" not in e for e in envs)
    assert all(e["PATH"] == "/bin" for e in envs)
    assert "one card per process" in rule


def test_child_envs_share_cards_with_memory_fractions():
    envs, rule = child_envs({}, 11, cards=["0"])
    assert {e["CUDA_VISIBLE_DEVICES"] for e in envs} == {"0"}
    fracs = {float(e["XLA_PYTHON_CLIENT_MEM_FRACTION"]) for e in envs}
    assert len(fracs) == 1 and 11 * fracs.pop() <= 0.81
    envs, rule = child_envs({}, 5, cards=["2", "3"])
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == [
        "2", "3", "2", "3", "2"]
    assert float(envs[0]["XLA_PYTHON_CLIENT_MEM_FRACTION"]) <= 0.8 / 3
    assert "XLA_PYTHON_CLIENT_MEM_FRACTION" in rule


def test_child_envs_without_cards_keep_the_environment():
    base = {"JAX_PLATFORMS": "cpu", "X": "1"}
    envs, rule = child_envs(base, 4)
    assert envs == [base] * 4
    assert "CPU" in rule


def test_visible_cards_rules():
    assert visible_cards({"FLASHE_FORCE_CPU": "1"}) == []
    assert visible_cards({"JAX_PLATFORMS": "cpu"}) == []
    assert visible_cards({"CUDA_VISIBLE_DEVICES": "1, 3"}) == ["1", "3"]
    assert visible_cards({"CUDA_VISIBLE_DEVICES": ""}) == []
