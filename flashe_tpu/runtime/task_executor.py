"""Per-(job, role, party) task executor process.

The analogue of fate_flow/driver/task_executor.py:39-160: the job runner
spawns `python -m flashe_tpu.runtime.task_executor -c task.json` per role;
the executor joins the federation, runs its HomoNN component, and saves
outputs (history / loss curve / model checkpoint) for the runner to
collect.
"""

from __future__ import annotations

import argparse
import json
import pickle


def run_task(cfg: dict):
    import os

    from flashe_tpu import jaxenv

    jaxenv.setup(force_cpu=bool(os.environ.get("FLASHE_FORCE_CPU")))

    import numpy as np

    from flashe_tpu.fed.tcp import TcpFederation
    from flashe_tpu.fed.transport import Party, default_parties
    from flashe_tpu.fed.variables import HomoTransferVariables
    from flashe_tpu.nn.homo_nn import HomoNNArbiter, HomoNNGuest, HomoNNHost
    from flashe_tpu.runtime.checkpoint import save_checkpoint
    from flashe_tpu.runtime.config import HomoNNParam
    from flashe_tpu.runtime.tracking import tracker

    role = cfg["role"]
    party_id = cfg["party_id"]
    parties = default_parties(cfg["n_hosts"])
    local = Party(role, party_id)

    from flashe_tpu.runtime.permission import effective_authorization

    fed = TcpFederation(tuple(cfg["broker"]), cfg["job_id"], local, parties,
                        effective_authorization())
    trv = HomoTransferVariables(fed)

    out = {"role": role, "party_id": party_id}
    if cfg.get("kind") == "dsl":
        # FATE-style component-DAG task (see runtime/dsl.py)
        from flashe_tpu.runtime.dsl import (
            JobConf, arbiter_pipeline, client_pipeline, parse_dsl,
        )

        components = parse_dsl(cfg["dsl"])
        jc = JobConf.parse(cfg["conf"])
        store = None
        if cfg.get("data_root"):
            from flashe_tpu.data.store import DataStore

            store = DataStore(cfg["data_root"])
        if role == "arbiter":
            out.update(arbiter_pipeline(trv, components, jc))
        else:
            res = client_pipeline(trv, components, jc, role,
                                  cfg.get("ordinal", party_id), store,
                                  seed=cfg.get("seed", 0))
            res.pop("_client", None)
            out.update(res)
    elif role == "arbiter":
        param = HomoNNParam.from_dict(cfg["param"])
        if param.cv.need_cv:
            from flashe_tpu.nn.cross_validation import cv_fit_arbiter

            out["cv"] = cv_fit_arbiter(HomoNNArbiter, param, trv)
        else:
            comp = HomoNNArbiter(param)
            out["loss_history"] = comp.fit(trv)
    else:
        param = HomoNNParam.from_dict(cfg["param"])
        data = np.load(cfg["data"])
        cls = HomoNNGuest if role == "guest" else HomoNNHost
        if param.cv.need_cv:
            from flashe_tpu.nn.cross_validation import cv_fit_client

            out["cv"] = cv_fit_client(cls, param, trv, data["x"],
                                      data["y"], seed=cfg.get("seed", 0))
        else:
            comp = cls(param, seed=cfg.get("seed", 0))
            comp.fit(trv, data["x"], data["y"])
            out["history"] = comp.history
            if cfg.get("checkpoint"):
                save_checkpoint(cfg["checkpoint"], comp.trainer.params,
                                comp.aggregate_iter,
                                quantizer_stats={})
    out["phases"] = tracker().summary()
    out["transfer_stats"] = fed.stats.summary()
    with open(cfg["out"], "wb") as f:
        pickle.dump(out, f)
    fed.close()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", required=True)
    args = ap.parse_args()
    with open(args.config) as f:
        cfg = json.load(f)
    run_task(cfg)


if __name__ == "__main__":
    main()
