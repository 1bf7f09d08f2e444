"""The pure-JAX layer set (nn/layers.py) behind the model zoo: shapes,
parameter counts, flax-compatible parameter-tree names, finite gradients,
dropout, and a main path free of flax, cryptography and msgpack."""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from flashe_tpu.nn import layers as L
from flashe_tpu.nn.models import build_model, init_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _paths(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{pre}{k}/"))
        else:
            out[pre + k] = tuple(v.shape)
    return out


def test_femnist_cnn_tree_and_count():
    """1,206,590 parameters (the reference pins num_params=1206590) under
    the names flax gave them, so checkpoints and codecs carry over."""
    p = init_params(build_model("femnist_cnn"), jnp.zeros((2, 28, 28, 1)))
    assert _paths(p) == {
        "Conv_0/kernel": (3, 3, 1, 32), "Conv_0/bias": (32,),
        "Conv_1/kernel": (3, 3, 32, 64), "Conv_1/bias": (64,),
        "Dense_0/kernel": (9216, 128), "Dense_0/bias": (128,),
        "Dense_1/kernel": (128, 62), "Dense_1/bias": (62,)}
    assert sum(x.size for x in jax.tree_util.tree_leaves(p)) == 1_206_590


def test_char_lstm_tree_names():
    p = init_params(build_model("char_lstm", hidden=16),
                    jnp.zeros((2, 5), jnp.int32))
    paths = _paths(p)
    assert paths["Embed_0/embedding"] == (80, 8)
    assert paths["OptimizedLSTMCell_0/ii/kernel"] == (8, 16)
    assert paths["OptimizedLSTMCell_1/hf/kernel"] == (16, 16)
    assert paths["OptimizedLSTMCell_1/hf/bias"] == (16,)
    assert "OptimizedLSTMCell_0/ii/bias" not in paths
    assert paths["Dense_0/kernel"] == (16, 80)


def test_resnet_tree_names_and_shapes():
    m = build_model("cifar_resnet")
    p = init_params(m, jnp.zeros((2, 32, 32, 3)))
    paths = _paths(p)
    assert paths["_ResBlock_2/Conv_2/kernel"] == (1, 1, 16, 32)
    assert paths["_ResBlock_0/GroupNorm_1/scale"] == (16,)
    assert sum(x.size for x in jax.tree_util.tree_leaves(p)) == 175_066
    assert m.apply({"params": p}, jnp.ones((2, 32, 32, 3))).shape == (2, 10)


@pytest.mark.parametrize("name,x", [
    ("mlp", np.ones((4, 8), np.float32)),
    ("femnist_cnn", np.ones((4, 28, 28, 1), np.float32)),
    ("char_lstm", np.ones((4, 6), np.int32)),
])
def test_finite_gradient(name, x):
    kw = {"hidden": 16} if name == "char_lstm" else {}
    m = build_model(name, **kw)
    p = init_params(m, jnp.asarray(x[:1]))
    y = jnp.zeros((4,), jnp.int32)

    def loss(p):
        logits = m.apply({"params": p}, jnp.asarray(x), train=True,
                         rngs={"dropout": jax.random.PRNGKey(3)})
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(4), y])

    g = jax.grad(loss)(p)
    leaves = jax.tree_util.tree_leaves(g)
    assert all(bool(jnp.all(jnp.isfinite(v))) for v in leaves)
    assert any(float(jnp.abs(v).sum()) > 0 for v in leaves)


def test_dropout_only_in_training():
    m = build_model("femnist_cnn")
    x = jnp.ones((2, 28, 28, 1))
    p = init_params(m, x)
    a = m.apply({"params": p}, x)
    b = m.apply({"params": p}, x, train=False)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    c = m.apply({"params": p}, x, train=True,
                rngs={"dropout": jax.random.PRNGKey(0)})
    assert not np.allclose(np.asarray(a), np.asarray(c))
    with pytest.raises(ValueError, match="dropout"):
        m.apply({"params": p}, x, train=True)


def test_layer_primitives():
    s = L.Scope({}, key=jax.random.PRNGKey(0))
    x = jnp.ones((2, 6, 6, 4))
    assert L.conv(s, x, 8, (3, 3), strides=(2, 2)).shape == (2, 3, 3, 8)
    assert L.max_pool(x, (2, 2)).shape == (2, 3, 3, 4)
    np.testing.assert_allclose(np.asarray(L.avg_pool(x, (2, 2))), 1.0)
    y = L.group_norm(s, jnp.arange(2 * 4 * 8, dtype=jnp.float32)
                     .reshape(2, 4, 8), 4)
    np.testing.assert_allclose(
        np.asarray(y).reshape(2, 4, 4, 2).mean(axis=(1, 3)), 0.0, atol=1e-5)
    seq = jnp.ones((2, 5, 3))
    assert L.gru(s, seq, 7).shape == (2, 5, 7)
    assert L.lstm(s, seq, 7).shape == (2, 5, 7)
    assert set(s.params["GRUCell_0"]) == {"ir", "iz", "in", "hr", "hz", "hn"}
    assert "bias" not in s.params["GRUCell_0"]["hr"]
    assert "bias" in s.params["GRUCell_0"]["hn"]
    assert L.activation("tanh")(jnp.zeros(2)).shape == (2,)


def test_keras_define_gru_and_sequential():
    from flashe_tpu.nn.keras_define import count_params_define, \
        from_nn_define

    define = {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "Embedding",
         "config": {"name": "emb", "input_dim": 20, "output_dim": 4}},
        {"class_name": "GRU", "config": {"name": "gru", "units": 6,
                                         "activation": "tanh"}},
        {"class_name": "Dense", "config": {"name": "out", "units": 3,
                                           "activation": "softmax"}}]}}
    m = from_nn_define(define)
    x = jnp.zeros((2, 7), jnp.int32)
    p = m.init(jax.random.PRNGKey(0), x)["params"]
    assert set(p) == {"emb", "gru", "out"}
    # GRU: 3 input kernels + biases, 3 recurrent kernels, 1 recurrent bias
    assert count_params_define(m, x) == 20 * 4 + 3 * (4 * 6 + 6) \
        + 3 * 36 + 6 + 6 * 3 + 3
    assert m.apply({"params": p}, x).shape == (2, 3)


def test_flashe_job_runs_without_flax_cryptography_msgpack():
    """The main path imports only what the GPU machine is sure to have:
    an in-process FLASHE job with those packages (and the off-path yaml
    and cloudpickle) blocked in sys.modules."""
    code = (
        "import sys\n"
        "for m in ('flax', 'cryptography', 'msgpack', 'yaml', "
        "'cloudpickle'):\n"
        "    sys.modules[m] = None\n"
        "from flashe_tpu.__main__ import main\n"
        "sys.exit(main(['submit', '-c', 'examples/configs/mlp_flashe.json',"
        " '--json', '--cpu']))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    losses = json.loads(out.stdout.strip().splitlines()[-1])["loss_per_round"]
    assert len(losses) == 3 and all(np.isfinite(losses))
