"""Model zoo mirroring the reference workloads (pure JAX, nn/layers.py).

Reference (examples/configs/*/train_job_conf.json nn_define, Keras/TF1):
- FEMNIST CNN: Conv32-3x3/relu -> Conv64-3x3/relu -> maxpool2 -> dropout
  -> dense128/relu -> dropout -> dense62/softmax (1,206,590 params),
- CIFAR-10 ResNet (CIFAR-style residual stacks),
- Shakespeare char-LSTM: embed -> 2x LSTM(256) -> dense(vocab).

`build_model(name, **kw)` is the registry entry point the HomoNN component
resolves through, standing in for the reference's nn_define JSON -> Keras
builder (federatedml/nn/backend/tf_keras/jzf_nn_model.py:99-109).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Sequence

import jax
import jax.numpy as jnp

from flashe_tpu.nn import layers as L

__all__ = ["build_model", "FemnistCNN", "CifarResNet", "CharLSTM", "MLP"]


@dataclass(frozen=True)
class MLP(L.Module):
    features: Sequence[int] = (64, 10)

    def __call__(self, s, x, train: bool = False):
        x = x.reshape((x.shape[0], -1))
        for f in self.features[:-1]:
            x = jax.nn.relu(L.dense(s, x, f))
        return L.dense(s, x, self.features[-1])


@dataclass(frozen=True)
class FemnistCNN(L.Module):
    """The FEMNIST CNN (cnn_* configs)."""

    num_classes: int = 62

    def __call__(self, s, x, train: bool = False):
        x = x.reshape((x.shape[0], 28, 28, 1))
        x = jax.nn.relu(L.conv(s, x, 32, (3, 3), padding="VALID"))
        x = jax.nn.relu(L.conv(s, x, 64, (3, 3), padding="VALID"))
        x = L.max_pool(x, (2, 2), strides=(2, 2))
        x = L.dropout(s, x, 0.25, train)
        x = x.reshape((x.shape[0], -1))
        x = jax.nn.relu(L.dense(s, x, 128))
        x = L.dropout(s, x, 0.5, train)
        return L.dense(s, x, self.num_classes)


def _res_block(s, x, filters: int, strides: int):
    s = s.child("_ResBlock")
    y = L.conv(s, x, filters, (3, 3), strides=(strides,) * 2,
               use_bias=False)
    y = jax.nn.relu(L.group_norm(s, y, 8))
    y = L.conv(s, y, filters, (3, 3), use_bias=False)
    y = L.group_norm(s, y, 8)
    if x.shape[-1] != filters or strides != 1:
        x = L.conv(s, x, filters, (1, 1), strides=(strides,) * 2,
                   use_bias=False)
    return jax.nn.relu(x + y)


@dataclass(frozen=True)
class CifarResNet(L.Module):
    """CIFAR-style ResNet (resnet_* configs).  GroupNorm instead of
    BatchNorm: running batch statistics do not aggregate meaningfully
    under FedAvg, and GN keeps the forward pass purely functional."""

    num_classes: int = 10
    stage_sizes: Sequence[int] = (2, 2, 2)
    width: int = 16

    def __call__(self, s, x, train: bool = False):
        x = L.conv(s, x, self.width, (3, 3), use_bias=False)
        x = jax.nn.relu(L.group_norm(s, x, 8))
        for stage, blocks in enumerate(self.stage_sizes):
            filters = self.width * (2 ** stage)
            for b in range(blocks):
                strides = 2 if (b == 0 and stage > 0) else 1
                x = _res_block(s, x, filters, strides)
        x = jnp.mean(x, axis=(1, 2))
        return L.dense(s, x, self.num_classes)


@dataclass(frozen=True)
class CharLSTM(L.Module):
    """Shakespeare next-char model (lstm_* configs): embed -> stacked LSTM
    -> dense(vocab), predicting the next token from the last position
    (the reference's create_label construction, enter_point.py:158-166)."""

    vocab: int = 80
    embed: int = 8
    hidden: int = 256
    layers: int = 2

    def __call__(self, s, x, train: bool = False):
        h = L.embed(s, x, self.vocab, self.embed)
        for _ in range(self.layers):
            h = L.lstm(s, h, self.hidden)
        return L.dense(s, h[:, -1, :], self.vocab)


_REGISTRY: Dict[str, Callable[..., L.Module]] = {
    "mlp": MLP,
    "cnn": FemnistCNN,
    "femnist_cnn": FemnistCNN,
    "resnet": CifarResNet,
    "cifar_resnet": CifarResNet,
    "lstm": CharLSTM,
    "char_lstm": CharLSTM,
}


def build_model(name: str, **kwargs: Any) -> L.Module:
    if name in ("keras", "nn_define"):
        # a Keras-JSON nn_define from a reference-style job conf
        # (federatedml/nn/backend/tf_keras/jzf_nn_model.py:99-109)
        import json

        from flashe_tpu.nn.keras_define import KerasDefineModel

        define = kwargs["nn_define"]
        if not isinstance(define, str):
            define = json.dumps(define)
        return KerasDefineModel(define)
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def init_params(model: L.Module, input_example, seed: int = 0):
    return model.init(jax.random.PRNGKey(seed), input_example)["params"]
