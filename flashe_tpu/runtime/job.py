"""Job runner: submit a federated training job across OS processes.

The library-sized replacement for fate_flow's JobController/TaskScheduler
(fate_flow/driver/job_controller.py:42, task_scheduler.py:286-315): start
the federation broker, write per-party task configs and data shards, spawn
one task-executor subprocess per (role, party), watch liveness, collect
outputs.  Children get GPUs by runtime/placement.py's rule: a card each
while there are enough, else an explicit memory share of a shared card.  Kill-job semantics: any dead child aborts the rest
(the reference's job_detector / kill-file watch).
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Dict, List, Sequence, Tuple

import numpy as np

from flashe_tpu.fed.tcp import FedBroker
from flashe_tpu.runtime.config import HomoNNParam
from flashe_tpu.runtime.job_manager import JobRegistry, default_registry
from flashe_tpu.runtime.placement import child_envs

__all__ = ["submit_job", "submit_dsl_job", "JobCanceled"]


class JobCanceled(RuntimeError):
    """The job was stopped via the registry (stop_job analogue)."""


def _run_party_processes(job_id: str, reg: JobRegistry, workdir: str,
                         task_cfgs: List[dict], timeout: float,
                         env_overrides: Dict[str, str] | None) -> None:
    """Spawn one task-executor process per config and watch liveness.

    Each cfg must carry "role"/"party_id"/"out"; broker address is added
    by the caller.  Raises on timeout, cancellation or task failure
    (TaskScheduler.check_task_status / kill_job semantics)."""
    procs: List[subprocess.Popen] = []
    names: Dict[int, str] = {}
    status, err = "success", ""
    envs, rule = child_envs({**os.environ, **(env_overrides or {})},
                            len(task_cfgs))
    print(f"job {job_id}: {rule}", file=sys.stderr, flush=True)
    try:
        for cfg, env in zip(task_cfgs, envs):
            task = f"{cfg['role']}_{cfg['party_id']}"
            cfg_path = os.path.join(workdir, task + ".json")
            with open(cfg_path, "w") as f:
                json.dump(cfg, f)
            log_path = os.path.join(reg.log_dir(job_id), task + ".log")
            with open(log_path, "ab") as logf:
                proc = subprocess.Popen(
                    [sys.executable, "-m",
                     "flashe_tpu.runtime.task_executor", "-c", cfg_path],
                    env=env, stdout=logf, stderr=subprocess.STDOUT,
                    cwd=os.path.dirname(os.path.dirname(
                        os.path.dirname(os.path.abspath(__file__)))),
                )
            procs.append(proc)
            names[proc.pid] = task
            reg.set_task(job_id, task, proc.pid)

        deadline = time.time() + timeout
        pending = list(procs)
        while pending:
            if time.time() > deadline:
                raise TimeoutError(f"job {job_id} timed out")
            if reg.is_canceled(job_id):
                raise JobCanceled(f"job {job_id} was stopped")
            for p in list(pending):
                rc = p.poll()
                if rc is None:
                    continue
                pending.remove(p)
                reg.set_task_status(job_id, names[p.pid],
                                    "success" if rc == 0 else "failed")
                if rc != 0:
                    raise RuntimeError(
                        f"job {job_id}: task {names[p.pid]} failed rc={rc} "
                        f"(log: {os.path.join(reg.log_dir(job_id), names[p.pid] + '.log')})")
            time.sleep(0.2)
    except BaseException as e:
        status = ("canceled" if isinstance(e, JobCanceled)
                  else "timeout" if isinstance(e, TimeoutError)
                  else "failed")
        err = str(e)
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        reg.finish(job_id, status, err)


def submit_job(param: HomoNNParam,
               shards: Sequence[Tuple[np.ndarray, np.ndarray]],
               workdir: str | None = None,
               timeout: float = 900.0,
               env_overrides: Dict[str, str] | None = None,
               checkpoint_dir: str | None = None,
               registry: JobRegistry | None = None,
               job_id: str | None = None) -> Dict[str, dict]:
    """Run guest + hosts + arbiter as subprocesses; return per-role outputs.

    shards[0] is the guest's data; shards[1:] go to hosts.
    checkpoint_dir: each client saves its final model + aggregate_iter
    there as <role>_<party>.ckpt (reference save_output_model analogue).
    Job state + per-task logs persist under the registry
    (query_job/stop_job via `python -m flashe_tpu jobs/query/stop/logs`).
    """
    param.check()
    job_id = job_id or uuid.uuid4().hex[:12]
    n_hosts = len(shards) - 1
    workdir = workdir or tempfile.mkdtemp(prefix=f"flashe_job_{job_id}_")
    os.makedirs(workdir, exist_ok=True)
    reg = registry or default_registry()
    reg.create(job_id, {
        "param": param.to_dict(),
        "n_hosts": n_hosts,
        "workdir": workdir,
    })

    broker = FedBroker()
    outs = {}
    try:
        roles = [("guest", 0, shards[0])]
        roles += [("host", h, shards[1 + h]) for h in range(n_hosts)]
        roles += [("arbiter", 0, None)]
        cfgs = []
        for i, (role, pid, shard) in enumerate(roles):
            cfg = {
                "job_id": job_id,
                "role": role,
                "party_id": pid,
                "n_hosts": n_hosts,
                "broker": list(broker.address),
                "param": param.to_dict(),
                "seed": i,
                "out": os.path.join(workdir, f"{role}_{pid}.out"),
            }
            if shard is not None:
                data_path = os.path.join(workdir, f"{role}_{pid}.npz")
                np.savez(data_path, x=shard[0], y=shard[1])
                cfg["data"] = data_path
                if checkpoint_dir:
                    os.makedirs(checkpoint_dir, exist_ok=True)
                    cfg["checkpoint"] = os.path.join(
                        checkpoint_dir, f"{role}_{pid}.ckpt")
            cfgs.append(cfg)
            outs[f"{role}_{pid}"] = cfg["out"]
        _run_party_processes(job_id, reg, workdir, cfgs, timeout,
                             env_overrides)
    finally:
        broker.close()

    results = {"__job__": {"job_id": job_id, "workdir": workdir,
                           "logs": reg.log_dir(job_id)}}
    for key, path in outs.items():
        with open(path, "rb") as f:
            results[key] = pickle.load(f)
    return results


def submit_dsl_job(dsl: dict, conf: dict,
                   workdir: str | None = None,
                   timeout: float = 900.0,
                   env_overrides: Dict[str, str] | None = None,
                   registry: JobRegistry | None = None,
                   data_root: str | None = None,
                   job_id: str | None = None) -> Dict[str, dict]:
    """Run a FATE-style DSL job with one OS process per (role, party).

    The process-mode counterpart of runtime/dsl.py::run_dsl_job — the
    full fate_flow shape: submit(dsl, conf) -> per-party task executors
    over the native federation broker, each walking the component DAG
    (task_scheduler.py:133-315).  data_root overrides the dataset-store
    location the executors read DataIO tables from.
    """
    from flashe_tpu.runtime.dsl import JobConf, parse_dsl

    parse_dsl(dsl)  # validate before spawning anything
    jc = JobConf.parse(conf)
    job_id = job_id or uuid.uuid4().hex[:12]
    workdir = workdir or tempfile.mkdtemp(prefix=f"flashe_job_{job_id}_")
    os.makedirs(workdir, exist_ok=True)
    reg = registry or default_registry()
    reg.create(job_id, {"dsl": dsl, "conf": conf, "n_hosts": jc.n_hosts,
                        "workdir": workdir})
    if reg.is_canceled(job_id):
        # stopped while queued (create() preserved the cancel): never
        # spawn any executor
        raise JobCanceled(f"job {job_id} was stopped before it started")

    broker = FedBroker()
    outs = {}
    try:
        roles = [("guest", 0, 0)]
        roles += [("host", h, h) for h in range(jc.n_hosts)]
        roles += [("arbiter", 0, 0)]
        cfgs = []
        for i, (role, pid, ordinal) in enumerate(roles):
            cfg = {
                "job_id": job_id,
                "kind": "dsl",
                "role": role,
                "party_id": pid,
                "ordinal": ordinal,
                "n_hosts": jc.n_hosts,
                "broker": list(broker.address),
                "dsl": dsl,
                "conf": conf,
                "seed": i,
                "out": os.path.join(workdir, f"{role}_{pid}.out"),
            }
            if data_root:
                cfg["data_root"] = data_root
            cfgs.append(cfg)
            outs[f"{role}_{pid}"] = cfg["out"]
        _run_party_processes(job_id, reg, workdir, cfgs, timeout,
                             env_overrides)
    finally:
        broker.close()

    results = {"__job__": {"job_id": job_id, "workdir": workdir,
                           "logs": reg.log_dir(job_id)}}
    for key, path in outs.items():
        with open(path, "rb") as f:
            results[key] = pickle.load(f)
    return results
