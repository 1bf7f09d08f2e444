"""HTTP job server + client + board (fate_flow server / client /
FATEBoard analogues, runtime/server.py + client.py + board.py)."""

import json
import os

import numpy as np
import pytest

from flashe_tpu.runtime.board import render_job, sparkline
from flashe_tpu.runtime.client import FlasheClient, ServerError
from flashe_tpu.runtime.job_manager import JobRegistry
from flashe_tpu.runtime.server import JobServer, summarize_result


@pytest.fixture()
def server(tmp_path):
    reg = JobRegistry(str(tmp_path / "jobs"))
    srv = JobServer("127.0.0.1", 0, registry=reg, force_cpu=True).start()
    host, port = srv.address
    yield FlasheClient(f"http://{host}:{port}"), srv, reg
    srv.close()


def test_version_and_errors(server):
    client, _, _ = server
    v = client.version()
    assert v["name"] == "flashe_tpu"
    with pytest.raises(ServerError, match="404"):
        client._call("GET", "/v1/nosuch")
    with pytest.raises(ServerError):
        client.query_job("missing-job")


def test_upload_and_list_tables(server):
    client, _, _ = server
    csv_text = "y,f0,f1\n0,1.0,2.0\n1,3.0,4.0\n1,0.5,0.1\n"
    meta = client.upload("srvns", "t1", csv_text)
    assert meta["count"] == 3 and meta["labeled"]
    tables = client.list_tables()
    assert any(t["namespace"] == "srvns" and t["name"] == "t1"
               for t in tables)

    from flashe_tpu.data.store import default_store

    x, y, _ = default_store().load("srvns", "t1")
    assert x.shape == (3, 2)
    np.testing.assert_array_equal(y, [0, 1, 1])


def test_submit_bad_dsl_is_rejected(server):
    client, _, _ = server
    with pytest.raises(ServerError, match="400"):
        client.submit_job({"components": {
            "a": {"module": "Bogus"}}}, {"role": {"guest": [1]}})


@pytest.mark.slow
def test_submit_job_roundtrip_and_board(server, tmp_path):
    client, srv, reg = server
    # seed two party tables through the upload endpoint
    rng = np.random.RandomState(3)
    for name in ("g", "h"):
        rows = ["y," + ",".join(f"f{i}" for i in range(6))]
        x = rng.randn(40, 6)
        y = (x.sum(1) > 0).astype(int)
        for i in range(40):
            rows.append(f"{y[i]}," + ",".join(f"{v:.5f}" for v in x[i]))
        client.upload("jobns", name, "\n".join(rows) + "\n")

    dsl = {"components": {
        "dataio_0": {"module": "DataIO",
                     "input": {"data": {"data": ["args.train_data"]}},
                     "output": {"data": ["train"]}},
        "homo_nn_0": {"module": "JZFHomoNN",
                      "input": {"data": {"train_data": ["dataio_0.train"]}},
                      "output": {"data": ["train"]}},
        "evaluation_0": {"module": "Evaluation",
                         "input": {"data": {"data": ["homo_nn_0.train"]}},
                         "output": {"data": ["evaluate"]}},
    }}
    conf = {
        "initiator": {"role": "guest", "party_id": 9999},
        "role": {"guest": [9999], "host": [10000], "arbiter": [99999]},
        "role_parameters": {
            "guest": {"args": {"data": {"train_data": [
                {"namespace": "jobns", "name": "g"}]}}},
            "host": {"args": {"data": {"train_data": [
                {"namespace": "jobns", "name": "h"}]}}},
        },
        "algorithm_parameters": {"homo_nn_0": {
            "model": "mlp", "model_kwargs": {"features": [8, 2]},
            "batch_size": 16, "max_iter": 1,
            "optimizer": {"optimizer": "Adam", "learning_rate": 0.01},
            "secure_aggregate": "plain",
        }},
    }
    sub = client.submit_job(dsl, conf, timeout=600)
    job_id = sub["job_id"]
    rec = client.wait_job(job_id, timeout=600)
    assert rec["status"] == "success", rec
    res = client.job_result(job_id)
    assert res["result"]["arbiter_0"]["homo_nn_0"]["loss_history"]
    ev = res["result"]["guest_0"]["evaluation_0"]
    assert "auc" in ev and 0.0 <= ev["accuracy"] <= 1.0

    # jobs listing includes it; board renders without error
    assert any(r["job_id"] == job_id for r in client.list_jobs())
    text = render_job(rec, res)
    assert job_id in text and "loss" in text and "evaluation:" in text


def test_web_board_routes(server):
    """HTML board (webboard.py) served from `/` and `/board/<id>`."""
    import urllib.error
    import urllib.request

    client, srv, reg = server
    base = f"http://{srv.address[0]}:{srv.address[1]}"
    page = urllib.request.urlopen(f"{base}/", timeout=10)
    assert page.headers["Content-Type"].startswith("text/html")
    text = page.read().decode()
    assert "FLASHE jobs" in text and "no jobs yet" in text
    # the index surfaces the scheduler queue state
    assert "queue: 0 running / 0 waiting" in text

    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{base}/board/nope", timeout=10)
    assert e.value.code == 404

    reg.create("boardjob", {})
    reg.set_task("boardjob", "guest_0", pid=11, status="running")
    text = urllib.request.urlopen(
        f"{base}/board/boardjob", timeout=10).read().decode()
    assert "job boardjob" in text and "guest_0" in text
    # job list links to the job page and auto-refreshes while running
    idx = urllib.request.urlopen(f"{base}/board", timeout=10).read().decode()
    assert "/board/boardjob" in idx


def test_web_board_rendering():
    """Chart/eval/transfer cards render from a full result summary."""
    from flashe_tpu.runtime import webboard

    rec = {"job_id": "j1", "status": "success", "created": None,
           "updated": None,
           "tasks": {"guest_0": {"status": "success", "pid": 1}}}
    result = {"result": {
        "guest_0": {"loss_history": [2.0, 1.5, 1.0],
                    "phases": {"encryption": {"total_s": 1.0, "count": 3}},
                    "transfer_stats": {"upload_model": {
                        "sent_msgs": 3, "sent_bytes": 999,
                        "recv_msgs": 0, "recv_bytes": 0}},
                    "evaluation_0": {"accuracy": 0.9, "auc": 0.95}},
        "host_0": {"loss_history": [2.1, 1.6]},
    }}
    page = webboard.render_job_html(rec, result)
    for expected in ("<svg", "loss per round", "phase profile",
                     "evaluation", "upload_model", "table view"):
        assert expected in page, expected
    # ragged series must not break the table fallback
    assert "<td>-</td>" in page


def test_board_sparkline_and_summary():
    assert sparkline([]) == ""
    s = sparkline([3.0, 2.0, 1.0])
    assert len(s) == 3 and s[0] == "█" and s[-1] == "▁"
    summary = summarize_result({
        "__job__": {"job_id": "x"},
        "arbiter_0": {"role": "arbiter",
                      "homo_nn_0": {"loss_history": [1.0, 0.5]},
                      "phases": {}},
        "guest_0": {"role": "guest",
                    "evaluation_0": {"accuracy": 0.9, "auc": 0.95},
                    "phases": {"encryption": {"total_s": 1.5, "count": 2}}},
    })
    assert summary["arbiter_0"]["homo_nn_0"]["loss_history"] == [1.0, 0.5]
    assert summary["guest_0"]["phases"]["encryption"]["count"] == 2
    rec = {"job_id": "x", "status": "success", "created": None,
           "updated": None, "tasks": {"guest_0": {"pid": 1,
                                                  "status": "success"}}}
    text = render_job(rec, {"result": summary})
    assert "x" in text and "1.0000 -> 0.5000" in text
