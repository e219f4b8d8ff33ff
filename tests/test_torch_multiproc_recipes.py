"""The launch recipes of a party over several processes, on the CPU.

``geomx_tpu_torch/scripts/run_mesh_multihost.sh --cpu`` with 2 and 4
processes under every mesh codec: the group forms, every process agrees
on its size, process 0 alone is the global worker, and each process's
ring output equals every other's and the one-process
``QuantRingReducer`` on a ``PartyMesh`` of the same P fed the same
seeded rows (int8, 2-bit, fp16 bit for bit; ``none`` within 1e-6).

``slow``: ``run_mesh_hips.sh`` with ``MESH_PROCS=2`` (LeNet, 2 parties x
2 rank processes, the 2-bit ring; 12 processes) must print the same
per-round accuracies on all four ranks, and the same as the recipe with
each party one process (``MESH_PROCS`` 1), whose ring sees the same
local gradients. Every launch runs in a session of its own under a wall
deadline; on a timeout the whole group is killed.
"""

import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from geomx_tpu_torch.parallel import mesh as pmesh
from geomx_tpu_torch.parallel import quant_collectives as qc
from torch_multiproc_kit import ROOT, free_port

SCRIPTS = ROOT / "geomx_tpu_torch" / "scripts"
CODECS = ("int8", "2bit", "fp16", "none")
N = 4096
ACC = re.compile(r"\[Iteration (\d+)\] Test Acc (\d+\.\d+)")


def _run(argv, env, deadline):
    full = {k: v for k, v in os.environ.items()
            if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    full.update(env, PYTHON=sys.executable)
    proc = subprocess.Popen(argv, cwd=str(ROOT), env=full, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=deadline)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{argv}: not done in {deadline} s\n{out[-4000:]}")
    assert proc.returncode == 0, f"{argv}: exit {proc.returncode}\n" \
        f"{out[-4000:]}"
    return out


@pytest.mark.parametrize("P", [2, 4])
def test_run_mesh_multihost_script(tmp_path, P):
    out = _run(["bash", str(SCRIPTS / "run_mesh_multihost.sh"), str(P),
                "--cpu"],
               {"COORD": f"127.0.0.1:{free_port()}", "CODECS": " ".join(CODECS),
                "N": str(N), "OUT_DIR": str(tmp_path)}, deadline=90)
    assert f"=== mesh multihost: OK (nproc={P} " in out
    assert len(re.findall(r"global_worker=True", out)) == 1
    assert re.search(r"proc 0: rank=0 global_worker=True", out)
    rows = np.stack([np.random.RandomState(r).randn(1, N).astype(
        np.float32)[0] for r in range(P)])
    mesh = pmesh.make_party_mesh(P, device="cpu")
    for codec in CODECS:
        want = qc.QuantRingReducer(mesh, codec, N, mean=True).reduce(
            torch.from_numpy(rows))[0].numpy()
        got = [np.load(tmp_path / f"proc{r}_{codec}.npy") for r in range(P)]
        digests = set(re.findall(rf"codec={codec} .* sha256=(\w+)", out))
        assert len(digests) == 1, (codec, digests)
        for g in got:
            np.testing.assert_array_equal(g, got[0])
            if codec == "none":
                np.testing.assert_allclose(g, want, atol=1e-6, rtol=1e-6)
            else:
                np.testing.assert_array_equal(g, want)
        bpr = re.findall(rf"codec={codec} n={N} bytes/round=(\d+)", out)
        assert bpr == [str(qc.ring_wire_bytes(codec, N, P, 256))] * P


def _mesh_recipe(log_dir, procs):
    ports = [str(free_port()) for _ in range(6)]
    env = dict(zip(("GPORT", "CPORT", "APORT", "BPORT", "MPORT_A", "MPORT_B"),
                   ports))
    env.update(LOG_DIR=str(log_dir), MESH_PROCS=str(procs),
               GEOMX_MESH_CODEC="2bit", GEOMX_WIRE_2BIT_THRESHOLD="2e-4")
    fg = _run(["bash", str(SCRIPTS / "run_mesh_hips.sh"), "--cpu",
               "--max-iters", "8", "-bs", "64"], env, deadline=180)
    logs = [fg] + [Path(p).read_text() for p in
                   sorted(Path(log_dir).glob("mesh_w*.log"))]
    return [[float(a) for _i, a in ACC.findall(t)] for t in logs]


@pytest.mark.slow
def test_mesh_hips_recipe_with_process_ranks(tmp_path):
    ranks = _mesh_recipe(tmp_path / "procs", 2)
    one = _mesh_recipe(tmp_path / "one", 1)
    assert len(ranks) == 4 and len(one) == 2
    assert len(ranks[0]) == 8
    for accs in ranks + one:
        assert accs == ranks[0]
