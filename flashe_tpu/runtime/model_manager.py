"""Versioned model storage: the fate_flow model manager analogue.

Reference scope (fate_flow/manager/model_manager.py, arch/api/
model_manager/): trained models are saved under a versioned key
(model_id = role#party#job namespace, model_version = job_id), can be
re-loaded for prediction jobs, and a "bind" marks which version serves a
party (fate_flow_client -f load / bind).  Here a model is a checkpoint
file plus JSON meta in a (namespace, version)-addressed directory; `bind`
writes a LATEST pointer that `load_latest` follows.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import List, Optional

from flashe_tpu.runtime.checkpoint import (
    checkpoint_aggregate_iter, load_checkpoint, save_checkpoint)

__all__ = ["ModelManager", "default_model_manager"]


def _safe(part: str) -> str:
    if (not part or part in (".", "..", "LATEST")
            or any(c in part for c in ("/", "\\", "\0"))):
        raise ValueError(f"invalid model identifier {part!r}")
    return part


class ModelManager:
    def __init__(self, root: Optional[str] = None):
        self.root = root or os.environ.get(
            "FLASHE_MODELS_DIR",
            os.path.join(os.path.expanduser("~"), ".flashe_tpu", "models"))

    def _dir(self, namespace: str, version: str) -> str:
        return os.path.join(self.root, _safe(namespace), _safe(version))

    def save(self, namespace: str, version: str, params,
             aggregate_iter: int, param_dict: Optional[dict] = None,
             opt_state=None, quantizer_stats=None) -> dict:
        d = self._dir(namespace, version)
        os.makedirs(d, exist_ok=True)
        save_checkpoint(os.path.join(d, "model.ckpt"), params,
                        aggregate_iter, opt_state=opt_state,
                        quantizer_stats=quantizer_stats)
        meta = {
            "namespace": namespace,
            "version": version,
            "aggregate_iter": int(aggregate_iter),
            "param": param_dict or {},
            "created": time.time(),
        }
        with open(os.path.join(d, "meta.json"), "w") as f:
            json.dump(meta, f)
        return meta

    def publish_checkpoint(self, namespace: str, version: str,
                           ckpt_path: str,
                           param_dict: Optional[dict] = None) -> dict:
        """Register an existing checkpoint file (e.g. a job's
        <role>_<party>.ckpt) as a model version."""
        aggregate_iter = checkpoint_aggregate_iter(ckpt_path)
        d = self._dir(namespace, version)
        os.makedirs(d, exist_ok=True)
        shutil.copyfile(ckpt_path, os.path.join(d, "model.ckpt"))
        meta = {
            "namespace": namespace,
            "version": version,
            "aggregate_iter": aggregate_iter,
            "param": param_dict or {},
            "created": time.time(),
        }
        with open(os.path.join(d, "meta.json"), "w") as f:
            json.dump(meta, f)
        return meta

    def load(self, namespace: str, version: str, params_template,
             opt_state_template=None) -> dict:
        d = self._dir(namespace, version)
        if not os.path.exists(os.path.join(d, "model.ckpt")):
            raise KeyError(f"no model {namespace}/{version} "
                           f"under {self.root}")
        state = load_checkpoint(os.path.join(d, "model.ckpt"),
                                params_template, opt_state_template)
        with open(os.path.join(d, "meta.json")) as f:
            state["meta"] = json.load(f)
        return state

    def checkpoint_path(self, namespace: str, version: str) -> str:
        return os.path.join(self._dir(namespace, version), "model.ckpt")

    # -- bind / latest (fate_flow_client -f bind analogue) -------------------

    def bind(self, namespace: str, version: str) -> dict:
        d = self._dir(namespace, version)
        if not os.path.isdir(d):
            raise KeyError(f"no model {namespace}/{version}")
        ptr = os.path.join(self.root, _safe(namespace), "LATEST")
        tmp = ptr + ".tmp"
        with open(tmp, "w") as f:
            f.write(version)
        os.replace(tmp, ptr)
        return {"namespace": namespace, "bound": version}

    def bound_version(self, namespace: str) -> Optional[str]:
        ptr = os.path.join(self.root, _safe(namespace), "LATEST")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            return f.read().strip()

    def load_latest(self, namespace: str, params_template,
                    opt_state_template=None) -> dict:
        version = self.bound_version(namespace)
        if version is None:
            versions = self.list_versions(namespace)
            if not versions:
                raise KeyError(f"no models in namespace {namespace}")
            version = versions[-1]["version"]
        return self.load(namespace, version, params_template,
                         opt_state_template)

    # -- catalogue ------------------------------------------------------------

    def list_versions(self, namespace: str) -> List[dict]:
        nsd = os.path.join(self.root, _safe(namespace))
        out = []
        if not os.path.isdir(nsd):
            return out
        for v in sorted(os.listdir(nsd)):
            mp = os.path.join(nsd, v, "meta.json")
            if os.path.exists(mp):
                with open(mp) as f:
                    out.append(json.load(f))
        return sorted(out, key=lambda m: m["created"])

    def delete(self, namespace: str, version: str) -> bool:
        d = self._dir(namespace, version)
        if not os.path.isdir(d):
            return False
        shutil.rmtree(d)
        if self.bound_version(namespace) == version:
            os.remove(os.path.join(self.root, _safe(namespace), "LATEST"))
        return True


def default_model_manager() -> ModelManager:
    return ModelManager()
