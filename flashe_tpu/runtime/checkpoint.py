"""Model checkpoint/resume.

Reference scope (enter_point.py:202-216, 262-269): export the model weights
plus meta including `aggregate_iter`; restore resumes the federation loop
from that iteration.  Cipher state (PRP seed) is per-job and deliberately
NOT checkpointed, as in the reference.  Improvement over the reference: the
optimizer state and the quantizer's running layer statistics are saved too,
so a resumed job quantizes identically to an uninterrupted one.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import jax

__all__ = ["save_checkpoint", "load_checkpoint", "checkpoint_aggregate_iter"]


def _leaves(prefix: str, tree) -> Dict[str, np.ndarray]:
    return {f"{prefix}/{i:05d}": np.asarray(x)
            for i, x in enumerate(jax.tree_util.tree_leaves(tree))}


def _restore(blob, prefix: str, template):
    treedef = jax.tree_util.tree_structure(template)
    keys = sorted(k for k in blob.files if k.startswith(prefix + "/"))
    if len(keys) != treedef.num_leaves:
        raise ValueError(f"checkpoint holds {len(keys)} {prefix} leaves, "
                         f"the template {treedef.num_leaves}")
    return jax.tree_util.tree_unflatten(treedef, [blob[k] for k in keys])


def save_checkpoint(path: str, params, aggregate_iter: int,
                    opt_state=None, quantizer_stats: Dict[str, Any] | None = None):
    """One .npz archive of numpy leaves (params and optimizer state in
    tree-leaf order) plus aggregate_iter and the quantizer statistics."""
    arrays = {"aggregate_iter": np.asarray(aggregate_iter, np.int64)}
    arrays.update(_leaves("params", params))
    if opt_state is not None:
        arrays.update(_leaves("opt_state", opt_state))
    for k, v in (quantizer_stats or {}).items():
        arrays[f"quantizer_stats/{k}"] = np.asarray(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, params_template, opt_state_template=None):
    """Restore into the templates' tree structures."""
    with np.load(path) as blob:
        has_opt = any(k.startswith("opt_state/") for k in blob.files)
        return {
            "params": _restore(blob, "params", params_template),
            "aggregate_iter": int(blob["aggregate_iter"]),
            "opt_state": (_restore(blob, "opt_state", opt_state_template)
                          if has_opt and opt_state_template is not None
                          else None),
            "quantizer_stats": {
                k.split("/", 1)[1]: blob[k] for k in blob.files
                if k.startswith("quantizer_stats/")},
        }


def checkpoint_aggregate_iter(path: str) -> int:
    """The federation round a checkpoint was saved at, without templates."""
    with np.load(path) as blob:
        return int(blob["aggregate_iter"])
