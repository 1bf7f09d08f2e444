"""Package CLI — job submission and utilities.

The analogue of the reference's CLI layer
(fate_flow/fate_flow_client.py:196-225: `python fate_flow_client.py -f
submit_job -d train_job_dsl.json -c train_job_conf.json`); here the DSL
is the model/scheme registry, so one JSON config selects the workload:

    python -m flashe_tpu submit -c examples/configs/mlp_flashe.json
    python -m flashe_tpu submit -c cfg.json --processes   # one OS process
                                                          # per party over
                                                          # the native broker
    python -m flashe_tpu keygen                           # print a PRP seed
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _force_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")


def cmd_submit(args) -> int:
    if args.cpu:
        _force_cpu()
    with open(args.config) as f:
        cfg = json.load(f)

    from flashe_tpu.data import federated_dataset, partition_iid
    from flashe_tpu.runtime.config import HomoNNParam

    param = HomoNNParam.from_dict(cfg["param"])
    n_clients = cfg.get("n_clients", 3)
    dataset = cfg.get("dataset", param.model)
    if isinstance(dataset, dict):
        # an uploaded table: {"namespace": ..., "name": ...}
        from flashe_tpu.data.store import default_store

        x, y, _meta = default_store().load(dataset["namespace"],
                                           dataset["name"])
        shards = partition_iid(x, y, n_clients, seed=cfg.get("seed", 0))
    else:
        shards = federated_dataset(dataset, n_clients,
                                   cfg.get("samples_per_client", 128),
                                   seed=cfg.get("seed", 0))

    if args.processes:
        import tempfile

        from flashe_tpu.runtime.job import submit_job

        env = {"FLASHE_FORCE_CPU": "1"} if args.cpu else {}
        ckpt_dir = args.checkpoint_dir
        if args.publish and not ckpt_dir:
            ckpt_dir = tempfile.mkdtemp(prefix="flashe_publish_")
        results = submit_job(param, shards, env_overrides=env,
                             checkpoint_dir=ckpt_dir)
        losses = results["arbiter_0"]["loss_history"]
        phases = results["guest_0"]["phases"]
        transfer = results["guest_0"].get("transfer_stats")
        if args.publish:
            from flashe_tpu.runtime.model_manager import (
                default_model_manager,
            )

            meta = default_model_manager().publish_checkpoint(
                args.publish, results["__job__"]["job_id"],
                os.path.join(ckpt_dir, "guest_0.ckpt"),
                param_dict=param.to_dict())
            print(json.dumps({"published": meta}), file=sys.stderr)
    else:
        from flashe_tpu.nn.homo_nn import (
            HomoNNArbiter, HomoNNGuest, HomoNNHost,
        )
        from flashe_tpu.runtime.simulate import run_roles
        from flashe_tpu.runtime.tracking import tracker

        def guest(trv):
            c = HomoNNGuest(param, seed=0)
            c.fit(trv, *shards[0])
            return {"history": c.history, "phases": tracker().summary()}

        def host(trv, hid):
            c = HomoNNHost(param, seed=1 + hid)
            c.fit(trv, *shards[1 + hid])
            return c.history

        def arbiter(trv):
            return HomoNNArbiter(param).fit(trv)

        results = run_roles(n_clients - 1, guest, host, arbiter)
        losses = results["arbiter"]
        phases = results["guest"]["phases"]
        transfer = None

    out = {
        "loss_per_round": [round(float(v), 6) for v in losses],
        "phases": {k: {"total_s": round(v["total_s"], 4),
                       "count": v["count"]}
                   for k, v in phases.items()},
    }
    if transfer is not None:
        out["guest_transfer"] = transfer
    if args.json:
        print(json.dumps(out))
    else:
        print("mean loss per round:",
              [round(v, 4) for v in out["loss_per_round"]])
        print("guest phase profile:")
        for name, stat in out["phases"].items():
            print(f"  {name:<18} {stat['total_s']:8.3f}s x{stat['count']}")
    return 0


def cmd_submit_dsl(args) -> int:
    """FATE-style submission: -d train_job_dsl.json -c train_job_conf.json
    (fate_flow_client.py:196-225).  Reference job confs work unchanged —
    nn_define JSON is interpreted directly."""
    if args.cpu:
        _force_cpu()
    with open(args.dsl) as f:
        dsl = json.load(f)
    with open(args.config) as f:
        conf = json.load(f)

    if args.server:
        from flashe_tpu.runtime.client import FlasheClient

        client = FlasheClient(args.server)
        sub = client.submit_job(dsl, conf)
        job_id = sub["job_id"]
        if args.no_wait:
            print(json.dumps(sub))
            return 0
        rec = client.wait_job(job_id)
        res = client.job_result(job_id)
        print(json.dumps({"job_id": job_id, "status": rec["status"],
                          "result": res.get("result")},
                         indent=None if args.json else 1))
        return 0 if rec["status"] == "success" else 1

    if args.processes:
        from flashe_tpu.runtime.job import submit_dsl_job

        env = {"FLASHE_FORCE_CPU": "1"} if args.cpu else {}
        results = submit_dsl_job(dsl, conf, env_overrides=env)
    else:
        from flashe_tpu.runtime.dsl import run_dsl_job

        results = run_dsl_job(dsl, conf)

    out = {}
    for role_key, res in results.items():
        if role_key == "__job__":
            out["job"] = res
            continue
        if not isinstance(res, dict):
            continue
        role_out = {}
        for comp, val in res.items():
            if isinstance(val, dict) and "loss_history" in val:
                role_out[comp] = {"loss_per_round": [
                    round(float(v), 6) for v in val["loss_history"]]}
            elif isinstance(val, dict) and "history" in val:
                role_out[comp] = {"final": val["history"][-1]
                                  if val["history"] else None}
            elif isinstance(val, dict) and "accuracy" in val:
                role_out[comp] = {k: (round(v, 6)
                                      if isinstance(v, float) else v)
                                  for k, v in val.items()}
        if role_out:
            out[role_key] = role_out
    print(json.dumps(out) if args.json else json.dumps(out, indent=1))
    return 0


def cmd_predict(args) -> int:
    if args.cpu:
        _force_cpu()
    import numpy as np

    with open(args.config) as f:
        cfg = json.load(f)

    from flashe_tpu.nn.homo_nn import HomoNNGuest
    from flashe_tpu.runtime.config import HomoNNParam

    param = HomoNNParam.from_dict(cfg["param"])
    if args.csv:
        from flashe_tpu.data.io import read_dense_csv

        x, y = read_dense_csv(args.csv,
                              label_index=None if args.unlabeled else 0)
    else:
        from flashe_tpu.data import synthetic_dataset

        x, y = synthetic_dataset(cfg.get("dataset", param.model),
                                 cfg.get("samples_per_client", 128),
                                 seed=cfg.get("seed", 0))

    ckpt = args.checkpoint
    if ckpt is None:
        if not args.model:
            print("predict: one of --checkpoint / --model is required",
                  file=sys.stderr)
            return 2
        from flashe_tpu.runtime.model_manager import default_model_manager

        mm = default_model_manager()
        ns, _, ver = args.model.partition(":")
        if not ver:
            ver = mm.bound_version(ns)
            if ver is None:
                versions = mm.list_versions(ns)
                if not versions:
                    print(f"predict: no models in namespace {ns}",
                          file=sys.stderr)
                    return 2
                ver = versions[-1]["version"]
        ckpt = mm.checkpoint_path(ns, ver)
    client = HomoNNGuest(param)
    client.load_model(ckpt, x[:1])
    preds = np.asarray(client.predict(x))
    labels = preds.argmax(axis=-1)
    if args.out:
        np.save(args.out, preds)
    result = {"n": int(len(x)), "aggregate_iter": client.aggregate_iter}
    if y is not None:
        result["accuracy"] = round(float((labels == y).mean()), 4)
    if args.out:
        result["out"] = args.out
    print(json.dumps(result))
    return 0


def cmd_keygen(args) -> int:
    seed = os.urandom(32)
    print(seed.hex())
    return 0


# -- multi-host cluster deployment (deployment/ analogue) --------------------


def cmd_broker(args) -> int:
    """Run the federation exchange standalone (proxy/route-table analogue)."""
    from flashe_tpu.runtime.cluster import run_broker

    run_broker(args.host, args.port,
               native=False if args.python else "auto")
    return 0


def cmd_storage_node(args) -> int:
    """Run a persistent storage node (eggroll storage-service analogue);
    sessions bind with data.table.init(storage_addr=...)."""
    import time

    from flashe_tpu.data.remote_kv import StorageNode

    node = StorageNode(args.dir, port=args.port,
                       native=not args.python)
    kind = "native" if node.native else "python"
    print(f"storage node ({kind}) serving {args.dir} at {node.address}",
          flush=True)
    try:
        while True:
            if node._proc is not None and node._proc.poll() is not None:
                return node._proc.returncode or 0
            time.sleep(1.0)
    except KeyboardInterrupt:
        node.shutdown()
    return 0


def cmd_party(args) -> int:
    """Join a cluster job as one party from this machine."""
    if args.cpu:
        os.environ["FLASHE_FORCE_CPU"] = "1"
    host, _, port = args.broker.rpartition(":")
    if not host:
        print("party: --broker must be host:port", file=sys.stderr)
        return 2

    from flashe_tpu.runtime.cluster import build_party_cfg, run_party

    dsl = conf = param = None
    n_hosts = None
    data = args.data
    if args.dsl:
        with open(args.dsl) as f:
            dsl = json.load(f)
        with open(args.config) as f:
            conf = json.load(f)
    else:
        with open(args.config) as f:
            job_cfg = json.load(f)
        param = job_cfg["param"]
        n_hosts = int(job_cfg.get("n_clients", 3)) - 1
        if data and data.endswith(".csv") and args.role != "arbiter":
            import tempfile

            import numpy as np

            from flashe_tpu.data.io import read_dense_csv

            x, y = read_dense_csv(data)
            data = os.path.join(tempfile.mkdtemp(prefix="flashe_party_"),
                                "data.npz")
            np.savez(data, x=x, y=y)

    cfg = build_party_cfg(
        args.role, args.party_id, (host, int(port)), args.job_id,
        dsl=dsl, conf=conf, param=param, n_hosts=n_hosts, data=data,
        data_root=args.data_root, out=args.out,
        checkpoint=args.checkpoint)
    out = run_party(cfg)
    brief = {k: v for k, v in out.items()
             if k in ("role", "party_id", "loss_history")}
    brief["out"] = cfg["out"]
    print(json.dumps(brief, default=str))
    return 0


def cmd_cluster(args) -> int:
    from flashe_tpu.runtime.cluster import main as cluster_main

    argv = ["-c", args.config, "--timeout", str(args.timeout)]
    argv.append("--plan" if args.plan
                else "--run-local" if args.run_local else "--run")
    return cluster_main(argv)


def cmd_mesh_party(args) -> int:
    """One client process of an SPMD mesh federation (multi-controller
    JAX over the network — parallel/mesh_party.py; run one per host).

    NOTE: must run before anything initialises the XLA backend, so this
    command performs jax.distributed.initialize first thing."""
    from flashe_tpu.parallel.mesh_party import run_mesh_training

    out = run_mesh_training(
        args.coordinator, args.num_processes, args.process_id,
        model=args.model, model_kwargs=json.loads(args.model_kwargs),
        rounds=args.rounds, samples=args.samples, data=args.data,
        learning_rate=args.learning_rate, int_bits=args.int_bits,
        verbose=args.verbose)
    print(json.dumps(out))
    return 0


# -- job management (fate_flow_client -f query_job/stop_job analogues) ------


def cmd_jobs(args) -> int:
    if getattr(args, "server", None):
        from flashe_tpu.runtime.client import FlasheClient

        rows = FlasheClient(args.server).list_jobs()
    else:
        from flashe_tpu.runtime.job_manager import default_registry

        rows = default_registry().list_jobs()
    if args.json:
        print(json.dumps(rows))
        return 0
    for rec in rows:
        print(f"{rec['job_id']}  {rec['status']:<9} "
              f"tasks={len(rec.get('tasks', {}))}")
    return 0


def cmd_query(args) -> int:
    if getattr(args, "server", None):
        from flashe_tpu.runtime.client import FlasheClient

        rec = FlasheClient(args.server).query_job(args.job_id)
    else:
        from flashe_tpu.runtime.job_manager import default_registry

        rec = default_registry().query(args.job_id)
    print(json.dumps(rec, indent=1))
    return 0


def cmd_stop(args) -> int:
    if getattr(args, "server", None):
        from flashe_tpu.runtime.client import FlasheClient

        rec = FlasheClient(args.server).stop_job(args.job_id)
    else:
        from flashe_tpu.runtime.job_manager import default_registry

        rec = default_registry().stop(args.job_id)
    print(json.dumps({"job_id": rec["job_id"], "status": rec["status"]}))
    return 0


def cmd_serve(args) -> int:
    from flashe_tpu.runtime.server import serve

    serve(args.host, args.port, force_cpu=args.cpu)
    return 0


def cmd_board(args) -> int:
    """Terminal dashboard for one job (FATEBoard analogue)."""
    from flashe_tpu.runtime.board import render_job

    if getattr(args, "server", None):
        from flashe_tpu.runtime.client import FlasheClient

        client = FlasheClient(args.server)
        rec = client.query_job(args.job_id)
        result = client.job_result(args.job_id)
    else:
        import os as _os

        from flashe_tpu.runtime.job_manager import default_registry

        reg = default_registry()
        rec = reg.query(args.job_id)
        result = None
        path = _os.path.join(reg.root, args.job_id, "result.json")
        if _os.path.exists(path):
            with open(path) as f:
                result = {"result": json.load(f)}
    print(render_job(rec, result))
    return 0


def cmd_logs(args) -> int:
    from flashe_tpu.runtime.job_manager import default_registry

    logs = default_registry().read_log(args.job_id, task=args.task,
                                       tail=args.tail)
    for task, text in logs.items():
        print(f"===== {task} =====")
        print(text)
    return 0


# -- tracking / pipeline / permission apps (fate_flow app analogues) --------


def cmd_tracking(args) -> int:
    """Tracking queries (fate_flow tracking_app analogue)."""
    if getattr(args, "server", None):
        from flashe_tpu.runtime.client import FlasheClient

        c = FlasheClient(args.server)
        if args.what == "data-view":
            out = c._call("POST", "/v1/tracking/job/data_view",
                          {"job_id": args.job_id})
        elif args.what == "metrics":
            out = c._call("POST", "/v1/tracking/component/metric/all",
                          {"job_id": args.job_id})
        else:  # metric-data
            out = c._call("POST", "/v1/tracking/component/metric_data",
                          {"job_id": args.job_id,
                           "component_name": args.component,
                           "role": args.role,
                           "metric_name": args.metric})
    else:
        from flashe_tpu.runtime import apps
        from flashe_tpu.runtime.job_manager import default_registry

        reg = default_registry()
        if args.what == "data-view":
            out = apps.job_data_view(reg, args.job_id)
        elif args.what == "metrics":
            out = apps.metric_all(reg, args.job_id)
        else:
            if not args.component:
                raise SystemExit("metric-data needs --component")
            out = apps.metric_data(reg, args.job_id, args.component,
                                   role=args.role,
                                   metric_name=args.metric)
    print(json.dumps(out, indent=1))
    return 0


def cmd_dag(args) -> int:
    """Pipeline DAG of a submitted DSL job (pipeline_app analogue)."""
    if getattr(args, "server", None):
        from flashe_tpu.runtime.client import FlasheClient

        out = FlasheClient(args.server)._call(
            "POST", "/v1/pipeline/dag/dependency", {"job_id": args.job_id})
    else:
        from flashe_tpu.runtime import apps
        from flashe_tpu.runtime.job_manager import default_registry

        out = apps.dag_dependency(default_registry(), args.job_id)
    print(json.dumps(out, indent=1))
    return 0


def cmd_permission(args) -> int:
    """Privilege grant/revoke/query (permission_app analogue)."""
    if args.action in ("grant", "revoke") and not (
            args.variable and args.src_role and args.dst_role):
        raise SystemExit(
            "grant/revoke need --variable --src-role --dst-role")
    if getattr(args, "server", None):
        from flashe_tpu.runtime.client import FlasheClient

        c = FlasheClient(args.server)
        if args.action == "query":
            out = c._call("POST", "/v1/permission/query/privilege",
                          {"src_role": args.src_role})
        else:
            route = ("/v1/permission/grant/privilege"
                     if args.action == "grant"
                     else "/v1/permission/delete/privilege")
            out = c._call("POST", route,
                          {"variable": args.variable,
                           "src_role": args.src_role,
                           "dst_role": args.dst_role})
    else:
        from flashe_tpu.runtime.permission import default_privilege_store

        store = default_privilege_store()
        if args.action == "query":
            out = {"privileges": store.query(args.src_role)}
        elif args.action == "grant":
            out = store.grant(args.variable, args.src_role, args.dst_role)
        else:
            out = store.revoke(args.variable, args.src_role,
                               args.dst_role)
    print(json.dumps(out, indent=1))
    return 0


def cmd_queue(args) -> int:
    """Job queue status of a running server (schedule_app analogue)."""
    from flashe_tpu.runtime.client import FlasheClient

    out = FlasheClient(args.server)._call("GET", "/v1/schedule/queue")
    print(json.dumps(out, indent=1))
    return 0


# -- model manager (fate_flow_client -f load/bind analogues) ----------------


def cmd_models(args) -> int:
    from flashe_tpu.runtime.model_manager import default_model_manager

    mm = default_model_manager()
    rows = mm.list_versions(args.namespace)
    bound = mm.bound_version(args.namespace)
    if args.json:
        print(json.dumps({"versions": rows, "bound": bound}))
        return 0
    for meta in rows:
        star = "*" if meta["version"] == bound else " "
        print(f"{star} {meta['namespace']}/{meta['version']}  "
              f"iter={meta['aggregate_iter']}")
    return 0


def cmd_bind(args) -> int:
    from flashe_tpu.runtime.model_manager import default_model_manager

    print(json.dumps(default_model_manager().bind(args.namespace,
                                                  args.version)))
    return 0


# -- data store (fate_flow_client -f upload/download analogues) -------------


def cmd_upload(args) -> int:
    from flashe_tpu.data.store import default_store

    meta = default_store().upload_csv(
        args.file, args.namespace, args.name,
        label_index=None if args.unlabeled else args.label_index,
        has_header=not args.no_header, partition=args.partition)
    print(json.dumps(meta))
    return 0


def cmd_download(args) -> int:
    from flashe_tpu.data.store import default_store

    meta = default_store().download_csv(args.namespace, args.name, args.out)
    print(json.dumps({"namespace": meta["namespace"], "name": meta["name"],
                      "count": meta["count"], "out": args.out}))
    return 0


def cmd_tables(args) -> int:
    from flashe_tpu.data.store import default_store

    rows = default_store().list_tables()
    if args.json:
        print(json.dumps(rows))
        return 0
    for meta in rows:
        print(f"{meta['namespace']}.{meta['name']}  n={meta['count']} "
              f"features={meta['feature_shape']} labeled={meta['labeled']}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flashe_tpu",
        description="FLASHE secure-aggregation framework on JAX")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_submit = sub.add_parser(
        "submit", help="run a federated training job from a JSON config")
    p_submit.add_argument("-c", "--config", required=True,
                          help="job config JSON (see examples/configs/)")
    p_submit.add_argument("--processes", action="store_true",
                          help="one OS process per party over the native "
                               "federation broker")
    p_submit.add_argument("--cpu", action="store_true",
                          help="force the CPU backend")
    p_submit.add_argument("--json", action="store_true",
                          help="machine-readable result on stdout")
    p_submit.add_argument("--checkpoint-dir",
                          help="with --processes: each client saves its "
                               "final model there (<role>_<id>.ckpt)")
    p_submit.add_argument("--publish",
                          help="with --processes: register the guest's "
                               "final model in the model store under this "
                               "namespace (version = job id)")
    p_submit.set_defaults(fn=cmd_submit)

    p_dsl = sub.add_parser(
        "submit-dsl",
        help="run a FATE-style DSL job (-d dsl.json -c conf.json)")
    p_dsl.add_argument("-d", "--dsl", required=True,
                       help="component-DAG DSL JSON (train_job_dsl.json)")
    p_dsl.add_argument("-c", "--config", required=True,
                       help="job conf JSON (train_job_conf.json)")
    p_dsl.add_argument("--processes", action="store_true",
                       help="one OS process per party over the native "
                            "federation broker")
    p_dsl.add_argument("--cpu", action="store_true")
    p_dsl.add_argument("--json", action="store_true")
    p_dsl.add_argument("--server",
                       help="submit to a running job server "
                            "(http://host:port) instead of locally")
    p_dsl.add_argument("--no-wait", action="store_true",
                       help="with --server: return the job id immediately")
    p_dsl.set_defaults(fn=cmd_submit_dsl)

    p_pred = sub.add_parser(
        "predict", help="run predictions with a checkpointed model")
    p_pred.add_argument("-c", "--config", required=True)
    p_pred.add_argument("--checkpoint",
                        help="checkpoint written by a submit run "
                             "(param.checkpoint) or save_checkpoint")
    p_pred.add_argument("--model",
                        help="stored model 'namespace[:version]' "
                             "(default version: the bound / newest one)")
    p_pred.add_argument("--csv", help="dense CSV to predict on "
                                      "(default: the config's dataset)")
    p_pred.add_argument("--unlabeled", action="store_true",
                        help="the CSV has no label column")
    p_pred.add_argument("--out", help="write raw prediction scores (.npy)")
    p_pred.add_argument("--cpu", action="store_true")
    p_pred.set_defaults(fn=cmd_predict)

    p_key = sub.add_parser("keygen",
                           help="generate a fresh 256-bit PRP seed (hex)")
    p_key.set_defaults(fn=cmd_keygen)

    p_broker = sub.add_parser(
        "broker", help="run the federation exchange standalone "
                       "(one per cluster; parties dial it)")
    p_broker.add_argument("--host", default="0.0.0.0")
    p_broker.add_argument("--port", type=int, default=9370,
                          help="0 = ephemeral (the bound port is printed)")
    p_broker.add_argument("--python", action="store_true",
                          help="force the pure-Python broker instead of "
                               "the native C++ one")
    p_broker.set_defaults(fn=cmd_broker)

    p_store = sub.add_parser(
        "storage-node", help="run a persistent KV storage node "
                             "(tables bind via storage_addr)")
    p_store.add_argument("--dir", required=True,
                         help="storage root directory")
    p_store.add_argument("--port", type=int, default=0,
                         help="0 = ephemeral (the bound port is printed)")
    p_store.add_argument("--python", action="store_true",
                         help="force the pure-Python server instead of "
                              "the native C++ one")
    p_store.set_defaults(fn=cmd_storage_node)

    p_party = sub.add_parser(
        "party", help="join a multi-host job as one party "
                      "(run on each silo's machine)")
    p_party.add_argument("--broker", required=True, help="host:port of the "
                                                         "running broker")
    p_party.add_argument("--role", required=True,
                         choices=["guest", "host", "arbiter"])
    p_party.add_argument("--party-id", type=int, default=0,
                         help="host ordinal 0..n_hosts-1 (guest/arbiter: 0)")
    p_party.add_argument("--job-id", required=True,
                         help="shared across all parties of one job")
    p_party.add_argument("-d", "--dsl",
                         help="DSL JSON (DSL job; omit for a param job)")
    p_party.add_argument("-c", "--config", required=True,
                         help="job conf JSON (DSL) or job config with "
                              "'param' (param job)")
    p_party.add_argument("--data", help="param jobs: this party's local "
                                        "training data (.npz x/y or .csv)")
    p_party.add_argument("--data-root",
                         help="DSL jobs: local dataset-store root the "
                              "DataIO component reads from")
    p_party.add_argument("--out", help="output pickle path")
    p_party.add_argument("--checkpoint", help="param jobs: save the final "
                                              "local model here")
    p_party.add_argument("--cpu", action="store_true")
    p_party.set_defaults(fn=cmd_party)

    p_mesh = sub.add_parser(
        "mesh-party", help="join an SPMD mesh federation as one client "
                           "process (multi-controller JAX; run one per "
                           "host of the slice)")
    p_mesh.add_argument("--coordinator", required=True,
                        help="host:port of process 0's coordinator")
    p_mesh.add_argument("--num-processes", type=int, required=True)
    p_mesh.add_argument("--process-id", type=int, required=True)
    p_mesh.add_argument("--rounds", type=int, default=5)
    p_mesh.add_argument("--model", default="mlp")
    p_mesh.add_argument("--model-kwargs", default="{}")
    p_mesh.add_argument("--samples", type=int, default=256,
                        help="synthetic samples when --data is omitted")
    p_mesh.add_argument("--data", help="this process's private shard "
                                       "(.npz with x, y)")
    p_mesh.add_argument("--learning-rate", type=float, default=0.05)
    p_mesh.add_argument("--int-bits", type=int, default=20)
    p_mesh.add_argument("--verbose", action="store_true")
    p_mesh.set_defaults(fn=cmd_mesh_party)

    p_cluster = sub.add_parser(
        "cluster", help="expand/run a multi-host cluster conf "
                        "(deploy/cluster_conf.yml)")
    p_cluster.add_argument("-c", "--config", required=True)
    cl_mode = p_cluster.add_mutually_exclusive_group(required=True)
    cl_mode.add_argument("--plan", action="store_true",
                         help="print per-machine commands")
    cl_mode.add_argument("--run", action="store_true",
                         help="execute through the conf's runner template")
    cl_mode.add_argument("--run-local", action="store_true",
                         help="validate the conf on this machine")
    p_cluster.add_argument("--timeout", type=float, default=900.0)
    p_cluster.set_defaults(fn=cmd_cluster)

    p_jobs = sub.add_parser("jobs", help="list submitted jobs")
    p_jobs.add_argument("--json", action="store_true")
    p_jobs.add_argument("--server", help="query a job server instead of "
                                         "the local registry")
    p_jobs.set_defaults(fn=cmd_jobs)

    p_query = sub.add_parser("query", help="query a job's status")
    p_query.add_argument("-j", "--job-id", required=True)
    p_query.add_argument("--server")
    p_query.set_defaults(fn=cmd_query)

    p_stop = sub.add_parser("stop", help="stop a running job")
    p_stop.add_argument("-j", "--job-id", required=True)
    p_stop.add_argument("--server")
    p_stop.set_defaults(fn=cmd_stop)

    p_serve = sub.add_parser(
        "serve", help="run the HTTP job server (fate_flow server analogue)")
    p_serve.add_argument("--host", default="127.0.0.1")
    p_serve.add_argument("--port", type=int, default=9380)
    p_serve.add_argument("--cpu", action="store_true",
                         help="job executors force the CPU backend")
    p_serve.set_defaults(fn=cmd_serve)

    p_board = sub.add_parser(
        "board", help="terminal job dashboard (FATEBoard analogue)")
    p_board.add_argument("-j", "--job-id", required=True)
    p_board.add_argument("--server")
    p_board.set_defaults(fn=cmd_board)

    p_logs = sub.add_parser("logs", help="print a job's task logs")
    p_logs.add_argument("-j", "--job-id", required=True)
    p_logs.add_argument("--task", help="one task, e.g. guest_0")
    p_logs.add_argument("--tail", type=int, default=0,
                        help="only the last N lines")
    p_logs.set_defaults(fn=cmd_logs)

    p_trk = sub.add_parser(
        "tracking", help="tracking queries (metrics/data-view)")
    p_trk.add_argument("-j", "--job-id", required=True)
    p_trk.add_argument("--what", default="metrics",
                       choices=["data-view", "metrics", "metric-data"])
    p_trk.add_argument("--component")
    p_trk.add_argument("--role")
    p_trk.add_argument("--metric")
    p_trk.add_argument("--server")
    p_trk.set_defaults(fn=cmd_tracking)

    p_dag = sub.add_parser(
        "dag", help="pipeline DAG of a submitted DSL job")
    p_dag.add_argument("-j", "--job-id", required=True)
    p_dag.add_argument("--server")
    p_dag.set_defaults(fn=cmd_dag)

    p_perm = sub.add_parser(
        "permission", help="grant/revoke/query transfer privileges")
    p_perm.add_argument("action", choices=["grant", "revoke", "query"])
    p_perm.add_argument("--variable")
    p_perm.add_argument("--src-role")
    p_perm.add_argument("--dst-role")
    p_perm.add_argument("--server")
    p_perm.set_defaults(fn=cmd_permission)

    p_queue = sub.add_parser(
        "queue", help="job-queue status of a running server")
    p_queue.add_argument("--server", required=True)
    p_queue.set_defaults(fn=cmd_queue)

    p_up = sub.add_parser(
        "upload", help="ingest a dense CSV into the dataset store")
    p_up.add_argument("-f", "--file", required=True)
    p_up.add_argument("-n", "--namespace", required=True)
    p_up.add_argument("-t", "--name", required=True)
    p_up.add_argument("--label-index", type=int, default=0)
    p_up.add_argument("--unlabeled", action="store_true")
    p_up.add_argument("--no-header", action="store_true")
    p_up.add_argument("--partition", type=int, default=1)
    p_up.set_defaults(fn=cmd_upload)

    p_down = sub.add_parser(
        "download", help="export a stored table back to CSV")
    p_down.add_argument("-n", "--namespace", required=True)
    p_down.add_argument("-t", "--name", required=True)
    p_down.add_argument("-o", "--out", required=True)
    p_down.set_defaults(fn=cmd_download)

    p_tab = sub.add_parser("tables", help="list stored tables")
    p_tab.add_argument("--json", action="store_true")
    p_tab.set_defaults(fn=cmd_tables)

    p_models = sub.add_parser("models",
                              help="list stored model versions")
    p_models.add_argument("-n", "--namespace", required=True)
    p_models.add_argument("--json", action="store_true")
    p_models.set_defaults(fn=cmd_models)

    p_bind = sub.add_parser(
        "bind", help="mark a model version as the serving default")
    p_bind.add_argument("-n", "--namespace", required=True)
    p_bind.add_argument("-v", "--version", required=True)
    p_bind.set_defaults(fn=cmd_bind)

    args = ap.parse_args(argv)
    from flashe_tpu import jaxenv

    jaxenv.setup()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
