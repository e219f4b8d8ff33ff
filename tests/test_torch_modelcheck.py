"""The flight-recorder replay (``tools/modelcheck.py`` ``replay_paths``)
over the port's dumps.

A two-party port ``InProcessHiPS`` on the CPU, its recorders given a
directory (``Config.flightrec_dir``, the ``GEOMX_FLIGHTREC_DIR`` knob),
runs three dense rounds; ``geomx_tpu_torch/ps/flightrec.py`` ``dump_all``
writes every van's ring, and the replay reads each dump and finds it
clean. A planted epoch regression in one dump is flagged.
"""

import json

import numpy as np
import pytest

from geomx_tpu_torch.ps import flightrec
from geomx_tpu_torch.simulate import InProcessHiPS
from tools.modelcheck import replay_paths

KEY, N, ROUNDS = 3, 8, 3


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    out = tmp_path_factory.mktemp("flightrec")
    topo = InProcessHiPS(num_parties=2, workers_per_party=1, device="cpu",
                         extra_cfg={"flightrec_dir": str(out)}).start()
    pulled = []
    try:
        def master(kv):
            kv.init(KEY, np.zeros(N, np.float32))
            kv.wait()

        def worker(kv):
            kv.init(KEY, np.zeros(N, np.float32))
            kv.wait()
            for _ in range(ROUNDS):
                kv.push(KEY, np.ones(N, np.float32))
                got = np.zeros(N, np.float32)
                kv.pull(KEY, out=got)
                kv.wait()
                pulled.append(got)

        topo.run_workers(lambda kv: None, include_master=master, timeout=60)
        topo.run_workers(worker, timeout=60)
        # the shutdown class: the dump at interpreter exit adds none
        paths = [p for p in flightrec.dump_all("shutdown:test")
                 if p.startswith(str(out))]
    finally:
        topo.stop()
    # the rounds aggregated both parties' pushes
    assert len(pulled) == 2 * ROUNDS and all((p == 2).all() for p in pulled)
    return out, sorted(paths)


def test_port_dumps_replay_clean(dumps):
    out, paths = dumps
    # every van of the topology: 3 schedulers, 3 servers, 3 workers
    assert len(paths) == 9
    report = replay_paths([out])
    assert report["violations"] == 0
    assert sorted(f["path"] for f in report["files"]) == paths
    for f in report["files"]:
        doc = json.loads(open(f["path"]).read())
        assert f["node"] == doc["node"] and f["problems"] == []
        assert f["events"] == len(doc["events"]) > 0
        kinds = {e["kind"] for e in doc["events"]}
        assert {"sent", "recv"} <= kinds
        assert all("peer" in e and "epoch" in e for e in doc["events"]
                   if e["kind"] in ("sent", "recv"))


def test_planted_epoch_regression_is_flagged(dumps, tmp_path):
    _out, paths = dumps
    doc = json.loads(open(paths[0]).read())
    recvs = [e for e in doc["events"] if e["kind"] == "recv"]
    peer = max({e["peer"] for e in recvs},
               key=lambda p: sum(e["peer"] == p for e in recvs))
    same = [e for e in recvs if e["peer"] == peer]
    assert len(same) >= 2
    # the peer's first frame at epoch 2, a later one back at epoch 1
    same[0]["epoch"], same[-1]["epoch"] = 2, 1
    planted = tmp_path / "flightrec_planted.json"
    planted.write_text(json.dumps(doc))
    report = replay_paths([planted])
    assert report["violations"] == 1
    (problem,) = report["files"][0]["problems"]
    assert f"recv from peer {peer} at epoch 1 after seeing 2" in problem
