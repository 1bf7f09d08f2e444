"""Keras `nn_define` JSON -> JAX model interpreter.

The reference builds its training model from the Keras-serialized JSON
embedded in every job conf (`build_keras` from nn_define,
federatedml/nn/backend/tf_keras/jzf_nn_model.py:99-109; the configs live
at examples/configs/*/train_job_conf.json `algorithm_parameters.
homo_nn_0.nn_define`).  This module interprets the same JSON directly as
a model over nn/layers.py so a reference user's job confs work unchanged:

- Sequential layer stacks (the CNN and LSTM/GRU workloads),
- nested functional `Model` graphs (the ResNet workload: inbound_nodes
  wiring with Add merges),
- layers: InputLayer, Reshape, Conv2D, MaxPooling2D, AveragePooling2D,
  Dropout, Flatten, Dense, Activation, Add, Embedding, GRU, LSTM,
  BatchNormalization.

Documented divergences (by design, not defects):
- BatchNormalization maps to GroupNorm: running batch statistics are
  non-trainable state that does not aggregate meaningfully under FedAvg
  (the aggregator only federates trainable weights), and GroupNorm keeps
  the forward pass purely functional (same decision as
  flashe_tpu/nn/models.py::CifarResNet).
- A trailing `softmax` activation is folded into the loss: the trainer
  consumes logits and applies softmax-cross-entropy (numerically stabler
  and XLA-fusible); predict() re-applies softmax.
- Keras regularizers/initializer seeds are ignored (the reference's L2
  regularizers only shape gradients slightly; initializers are re-drawn
  from the JAX PRNG with the shared cross-client seed).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, Sequence

import jax.numpy as jnp

from flashe_tpu.nn import layers as L

__all__ = ["KerasDefineModel", "from_nn_define", "count_params_define"]


def _act(x, name: str | None):
    if not name or name in ("linear", "softmax"):
        # softmax folds into the loss (see module docstring)
        return x
    return L.activation(name)(x)


def _pair(v) -> tuple:
    if isinstance(v, (list, tuple)):
        return tuple(int(i) for i in v)
    return (int(v), int(v))


def _graph(s, layers: Sequence[dict], x, train: bool):
    """Functional Keras `Model` graph (the ResNet nn_define)."""
    values: Dict[str, Any] = {}
    for spec in layers:
        name = spec["name"]
        cls = spec["class_name"]
        if cls == "InputLayer":
            values[name] = x
            continue
        inbound = spec["inbound_nodes"][0]
        ins = [values[ref[0]] for ref in inbound]
        if cls == "Add":
            out = ins[0]
            for extra in ins[1:]:
                out = out + extra
        else:
            out = _apply_layer(s, cls, spec["config"], ins[0], train)
        values[name] = out
    return values[layers[-1]["name"]]


def _apply_layer(s, cls: str, cfg: dict, x, train: bool):
    """One Keras layer -> JAX ops in scope `s`; layer names from the
    define keep the param tree stable across rebuilds."""
    name = cfg.get("name")
    if cls == "Reshape":
        return x.reshape((x.shape[0],) + tuple(cfg["target_shape"]))
    if cls == "Flatten":
        return x.reshape((x.shape[0], -1))
    if cls == "Dropout":
        return L.dropout(s, x, float(cfg["rate"]), train)
    if cls == "Activation":
        return _act(x, cfg.get("activation"))
    if cls == "Dense":
        y = L.dense(s, x, int(cfg["units"]),
                    use_bias=cfg.get("use_bias", True), name=name)
        return _act(y, cfg.get("activation"))
    if cls == "Conv2D":
        y = L.conv(s, x, int(cfg["filters"]), _pair(cfg["kernel_size"]),
                   strides=_pair(cfg.get("strides", 1)),
                   padding=cfg.get("padding", "valid").upper(),
                   use_bias=cfg.get("use_bias", True), name=name)
        return _act(y, cfg.get("activation"))
    if cls in ("MaxPooling2D", "AveragePooling2D"):
        pool = _pair(cfg.get("pool_size", 2))
        strides = _pair(cfg.get("strides") or cfg.get("pool_size", 2))
        fn = L.max_pool if cls == "MaxPooling2D" else L.avg_pool
        return fn(x, pool, strides=strides,
                  padding=cfg.get("padding", "valid").upper())
    if cls == "BatchNormalization":
        # -> GroupNorm (documented divergence, module docstring)
        ch = x.shape[-1]
        groups = 8
        while ch % groups:
            groups //= 2
        return L.group_norm(s, x, max(groups, 1),
                            epsilon=float(cfg.get("epsilon", 1e-3)),
                            name=name)
    if cls == "Embedding":
        return L.embed(s, x.astype(jnp.int32), int(cfg["input_dim"]),
                       int(cfg["output_dim"]), name=name)
    if cls in ("GRU", "LSTM"):
        units = int(cfg["units"])
        if cls == "GRU":
            y = _act(L.gru(s, x, units, name=name), cfg.get("activation"))
        else:
            y = L.lstm(s, x, units, name=name)
        if cfg.get("return_sequences", False):
            return y
        return y[:, -1, :]
    if cls == "Model":
        return _graph(s.child("_Graph", name), cfg["layers"], x, train)
    raise ValueError(f"unsupported Keras layer {cls!r} in nn_define")


@dataclass(frozen=True)
class KerasDefineModel(L.Module):
    """Model interpreting a Keras Sequential/functional nn_define.

    Construct with the JSON *string* (hashable); `from_nn_define` wraps a
    dict.
    """

    define_json: str

    def __call__(self, s, x, train: bool = False):
        define = json.loads(self.define_json)
        if define.get("class_name") == "Model":
            return _graph(s.child("_Graph"), define["config"]["layers"], x,
                          train)
        if define.get("class_name") != "Sequential":
            raise ValueError(
                f"unsupported nn_define class {define.get('class_name')!r}")
        for spec in define["config"]["layers"]:
            if spec["class_name"] == "InputLayer":
                continue
            x = _apply_layer(s, spec["class_name"], spec["config"], x,
                             train)
        return x


def from_nn_define(nn_define: dict) -> KerasDefineModel:
    return KerasDefineModel(json.dumps(nn_define))


def count_params_define(model: KerasDefineModel, input_example,
                        seed: int = 0) -> int:
    """Total trainable parameter count (to cross-check the reference's
    precompute.num_params, e.g. 1,206,590 for the FEMNIST CNN)."""
    import jax

    params = model.init(jax.random.PRNGKey(seed), input_example)["params"]
    return sum(p.size for p in jax.tree_util.tree_leaves(params))
