"""Multi-host cluster deployment: one party per machine over one broker.

The library-scale analogue of the reference's deployment harness
(deployment/cluster_conf.yml + server_deploy.sh/client_deploy.sh, which
provision EC2 machines, install FATE per role, and write the proxy's
route_table.json; deployment/modify_fate_configs.py:21-57).  Here a
deployment is three commands instead of a provisioning pipeline:

- ``python -m flashe_tpu broker`` on one machine — the exchange every
  party dials (the route-table/proxy analogue; native C++ when the
  toolchain is present),
- ``python -m flashe_tpu party --broker HOST:PORT --role ... --party-id
  N --job-id JOB -d dsl.json -c conf.json`` on each silo — joins the
  federation and runs that party's task executor against its **local**
  dataset store (data never leaves the machine),
- ``python -m flashe_tpu cluster -c cluster_conf.yml --plan`` on the
  operator's box — expands a cluster conf into the exact per-machine
  command lines (or runs them, through an optional ``runner`` template
  such as ``ssh {host} {cmd}``).

A conf can also be executed entirely locally (``--run-local``) to
validate it before touching real machines; that path doubles as the CI
test for this module.
"""

from __future__ import annotations

import json
import os
import shlex
import subprocess
import sys
import time
import uuid
from typing import Dict, List, Tuple

from flashe_tpu.runtime.placement import child_envs

__all__ = [
    "load_cluster_conf",
    "party_roles",
    "plan_commands",
    "run_broker",
    "run_party",
    "run_local",
]


# --------------------------------------------------------------------------
# party execution (the `party` CLI)
# --------------------------------------------------------------------------


def _party_seed(role: str, party_id: int, n_hosts: int) -> int:
    """The deterministic per-party seed used by runtime/job.py (roles are
    enumerated guest, host 0..n-1, arbiter; seed = position)."""
    if role == "guest":
        return 0
    if role == "host":
        return 1 + party_id
    return 1 + n_hosts


def build_party_cfg(role: str, party_id: int, broker: Tuple[str, int],
                    job_id: str, *, dsl: dict | None = None,
                    conf: dict | None = None, param: dict | None = None,
                    n_hosts: int | None = None, data: str | None = None,
                    data_root: str | None = None, out: str | None = None,
                    checkpoint: str | None = None) -> dict:
    """Assemble a task-executor config for one party of a cluster job.

    DSL jobs pass (dsl, conf); param jobs pass (param, n_hosts) plus an
    optional local ``data`` npz for client roles.  The result is exactly
    the dict runtime/job.py writes for its local subprocesses, so
    cluster parties and single-box parties run identical code.
    """
    if (dsl is None) == (param is None):
        raise ValueError("exactly one of dsl / param is required")
    if role not in ("guest", "host", "arbiter"):
        raise ValueError(f"unknown role {role!r}")
    if dsl is not None:
        from flashe_tpu.runtime.dsl import JobConf, parse_dsl

        parse_dsl(dsl)
        n_hosts = JobConf.parse(conf).n_hosts
    if n_hosts is None:
        raise ValueError("param jobs need n_hosts")
    if role == "host" and not 0 <= party_id < n_hosts:
        raise ValueError(f"host party_id {party_id} out of range "
                         f"(conf declares {n_hosts} hosts)")
    cfg = {
        "job_id": job_id,
        "role": role,
        "party_id": party_id if role == "host" else 0,
        "n_hosts": n_hosts,
        "broker": [broker[0], int(broker[1])],
        "seed": _party_seed(role, party_id, n_hosts),
        "out": out or os.path.join(
            os.getcwd(), f"{job_id}_{role}_{party_id}.out"),
    }
    if dsl is not None:
        cfg.update({"kind": "dsl", "dsl": dsl, "conf": conf,
                    "ordinal": party_id if role == "host" else 0})
        if data_root:
            cfg["data_root"] = data_root
    else:
        cfg["param"] = param
        if role != "arbiter":
            if not data:
                raise ValueError("client parties of param jobs need --data")
            cfg["data"] = data
            if checkpoint:
                cfg["checkpoint"] = checkpoint
    return cfg


def run_party(cfg: dict) -> dict:
    """Run one party to completion in this process; returns its output."""
    import pickle

    from flashe_tpu.runtime.task_executor import run_task

    run_task(cfg)
    with open(cfg["out"], "rb") as f:
        return pickle.load(f)


def run_broker(host: str, port: int, native: bool | str = "auto") -> None:
    """Start the exchange and block until interrupted (broker CLI body).

    Prints ``PORT <n>`` on stdout once listening so wrappers (tests, the
    cluster launcher) can discover an ephemeral port.
    """
    from flashe_tpu.fed.tcp import FedBroker

    broker = FedBroker(host=host, port=port, native=native)
    print(f"PORT {broker.address[1]}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        broker.close()


# --------------------------------------------------------------------------
# cluster conf -> per-machine command plan (the `cluster` CLI)
# --------------------------------------------------------------------------


def load_cluster_conf(path: str) -> dict:
    """Read a cluster conf (YAML or JSON) and validate its shape."""
    with open(path) as f:
        if path.endswith((".yml", ".yaml")):
            import yaml

            conf = yaml.safe_load(f)
        else:
            conf = json.load(f)
    if "mesh" in conf:
        # SPMD mesh federation (parallel/mesh_party.py): one client
        # process per host over jax.distributed; no broker, no roles
        mesh = conf["mesh"]
        if not mesh.get("hosts"):
            raise ValueError("mesh conf needs a non-empty hosts list")
        return conf
    for key in ("broker", "job", "parties"):
        if key not in conf:
            raise ValueError(f"cluster conf missing section {key!r}")
    job = conf["job"]
    if not (("dsl" in job and "conf" in job) or "config" in job):
        raise ValueError("job section needs dsl+conf (DSL job) or "
                         "config (param job)")
    parties = conf["parties"]
    if "guest" not in parties or "arbiter" not in parties:
        raise ValueError("parties must include guest and arbiter")
    if len(parties.get("guest", [])) != 1 or len(parties["arbiter"]) != 1:
        raise ValueError("exactly one guest and one arbiter")
    return conf


def party_roles(conf: dict) -> List[Tuple[str, int, dict]]:
    """Enumerate (role, party_id, entry) in canonical order."""
    parties = conf["parties"]
    out = [("guest", 0, parties["guest"][0])]
    out += [("host", h, e) for h, e in enumerate(parties.get("host", []))]
    out.append(("arbiter", 0, parties["arbiter"][0]))
    return out


def plan_commands(conf: dict, conf_dir: str = ".") -> Dict[str, dict]:
    """Expand a cluster conf into the command every machine runs.

    Returns {party_key: {host, cmd}} plus a "broker" entry.  Paths in
    the job section are resolved relative to the conf file's directory
    and must exist at the same location on the party machines (the
    reference ships job configs to every node the same way —
    deployment/server_deploy.sh copies the repo tree verbatim).
    """
    if "mesh" in conf:
        return _plan_mesh_commands(conf)
    broker = conf["broker"]
    job = conf["job"]
    job_id = str(job.get("id") or uuid.uuid4().hex[:12])
    baddr = f"{broker['host']}:{broker.get('port', 9370)}"
    py = conf.get("python", "python")

    plan = {"broker": {
        "host": broker["host"],
        "cmd": (f"{py} -m flashe_tpu broker --host 0.0.0.0 "
                f"--port {broker.get('port', 9370)}"),
    }}
    for role, pid, entry in party_roles(conf):
        parts = [py, "-m", "flashe_tpu", "party",
                 "--broker", baddr, "--role", role,
                 "--party-id", str(pid), "--job-id", job_id]
        if "dsl" in job:
            parts += ["-d", os.path.normpath(os.path.join(conf_dir,
                                                          job["dsl"])),
                      "-c", os.path.normpath(os.path.join(conf_dir,
                                                          job["conf"]))]
        else:
            parts += ["-c", os.path.normpath(os.path.join(conf_dir,
                                                          job["config"]))]
            if role != "arbiter" and entry.get("data"):
                parts += ["--data", entry["data"]]
        if entry.get("data_root"):
            parts += ["--data-root", entry["data_root"]]
        if entry.get("out"):
            parts += ["--out", entry["out"]]
        if conf.get("cpu"):
            parts += ["--cpu"]
        plan[f"{role}_{pid}"] = {
            "host": entry.get("host", "localhost"),
            "cmd": " ".join(shlex.quote(p) for p in parts),
        }
    return plan


def _plan_mesh_commands(conf: dict) -> Dict[str, dict]:
    """Mesh-federation plan: one `mesh-party` process per host of the
    slice (multi-controller JAX over DCN; parallel/mesh_party.py).
    Process 0's machine doubles as the coordinator."""
    mesh = conf["mesh"]
    hosts = [h if isinstance(h, dict) else {"host": h}
             for h in mesh["hosts"]]
    coordinator = mesh.get("coordinator") or f"{hosts[0]['host']}:9401"
    py = conf.get("python", "python")
    plan: Dict[str, dict] = {}
    for i, entry in enumerate(hosts):
        parts = [py, "-m", "flashe_tpu", "mesh-party",
                 "--coordinator", coordinator,
                 "--num-processes", str(len(hosts)),
                 "--process-id", str(i),
                 "--rounds", str(mesh.get("rounds", 5)),
                 "--model", mesh.get("model", "mlp")]
        if mesh.get("model_kwargs"):
            parts += ["--model-kwargs", json.dumps(mesh["model_kwargs"])]
        if mesh.get("learning_rate"):
            parts += ["--learning-rate", str(mesh["learning_rate"])]
        if entry.get("data"):
            parts += ["--data", entry["data"]]
        plan[f"mesh_{i}"] = {
            "host": entry["host"],
            "cmd": " ".join(shlex.quote(p) for p in parts),
        }
    return plan


def run_local(conf: dict, conf_dir: str = ".",
              timeout: float = 900.0) -> Dict[str, int]:
    """Validate a cluster conf by executing the whole plan on this box.

    Spawns the broker CLI plus every party CLI as subprocesses (exactly
    the commands --plan prints, with the broker address rewritten to the
    locally bound port) and waits for completion.  Returns per-party
    return codes.
    """
    if "mesh" in conf:
        return _run_local_mesh(conf, timeout)
    plan = plan_commands(conf, conf_dir)
    broker_cmd = shlex.split(plan.pop("broker")["cmd"])
    # ephemeral local port instead of the conf's fleet-facing one
    broker_cmd[broker_cmd.index("--port") + 1] = "0"
    broker_cmd[broker_cmd.index("--host") + 1] = "127.0.0.1"
    broker = subprocess.Popen(broker_cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL, text=True)
    rcs: Dict[str, int] = {}
    procs: List[Tuple[str, subprocess.Popen]] = []
    try:
        line = broker.stdout.readline()
        if not line.startswith("PORT "):
            raise RuntimeError(f"broker failed to start: {line!r}")
        port = int(line.split()[1])
        envs, rule = child_envs(os.environ, len(plan))
        print(f"cluster --run-local: {rule}", file=sys.stderr, flush=True)
        for (key, entry), env in zip(plan.items(), envs):
            argv = shlex.split(entry["cmd"])
            argv[argv.index("--broker") + 1] = f"127.0.0.1:{port}"
            if "--cpu" in argv:
                env = dict(os.environ)
            procs.append((key, subprocess.Popen(argv, env=env)))
        deadline = time.time() + timeout
        for key, proc in procs:
            rcs[key] = proc.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.terminate()
        broker.terminate()
        broker.wait()
    return rcs


def _run_local_mesh(conf: dict, timeout: float) -> Dict[str, int]:
    """Validate a mesh conf on this box: every mesh-party process runs
    locally over virtual CPU devices through a localhost coordinator."""
    import re

    from flashe_tpu.parallel.multihost import free_port

    plan = plan_commands(conf)
    port = free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (re.sub(
        r"--xla_force_host_platform_device_count=\d+", "",
        env.get("XLA_FLAGS", "")).strip()
        + " --xla_force_host_platform_device_count=2").strip()
    procs: List[Tuple[str, subprocess.Popen]] = []
    rcs: Dict[str, int] = {}
    try:
        for key, entry in plan.items():
            argv = shlex.split(entry["cmd"])
            argv[argv.index("--coordinator") + 1] = f"127.0.0.1:{port}"
            procs.append((key, subprocess.Popen(argv, env=env)))
        deadline = time.time() + timeout
        for key, proc in procs:
            rcs[key] = proc.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.terminate()
    return rcs


def main(argv=None) -> int:
    """`python -m flashe_tpu.runtime.cluster` == `python -m flashe_tpu
    cluster` (kept runnable standalone for parity with runtime/job.py)."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", required=True,
                    help="cluster conf (YAML or JSON)")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--plan", action="store_true",
                      help="print the per-machine command lines")
    mode.add_argument("--run", action="store_true",
                      help="execute the plan through the conf's runner "
                           "template (e.g. 'ssh {host} {cmd}')")
    mode.add_argument("--run-local", action="store_true",
                      help="execute every command on this machine "
                           "(conf validation)")
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)

    conf = load_cluster_conf(args.config)
    conf_dir = os.path.dirname(os.path.abspath(args.config))
    if args.plan:
        plan = plan_commands(conf, conf_dir)
        for key, entry in plan.items():
            print(f"# on {entry['host']} ({key})")
            print(entry["cmd"])
        return 0
    if args.run_local:
        rcs = run_local(conf, conf_dir, timeout=args.timeout)
        print(json.dumps(rcs))
        return 0 if all(rc == 0 for rc in rcs.values()) else 1
    runner = conf.get("runner")
    if not runner:
        print("cluster --run needs a 'runner' template in the conf "
              "(e.g. \"ssh {host} {cmd}\"); use --plan to run by hand",
              file=sys.stderr)
        return 2
    plan = plan_commands(conf, conf_dir)
    procs = {}
    broker = None
    broker_entry = plan.pop("broker", None)
    if broker_entry is not None:
        broker = subprocess.Popen(
            runner.format(host=broker_entry["host"],
                          cmd=broker_entry["cmd"]), shell=True)
        time.sleep(2.0)  # let the exchange bind before parties dial it
    try:
        for key, entry in plan.items():
            procs[key] = subprocess.Popen(
                runner.format(host=entry["host"], cmd=entry["cmd"]),
                shell=True)
        rcs = {key: p.wait(timeout=args.timeout)
               for key, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
        if broker is not None:
            broker.terminate()
    print(json.dumps(rcs))
    return 0 if all(rc == 0 for rc in rcs.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
