"""The port's launch recipes as real multi-process topologies.

Counterpart of ``tests/test_launch_integration.py``: each recipe of
``geomx_tpu_torch/scripts`` boots its topology (12 processes in 3
parties, 13 with MultiGPS, 9 for the mesh party) through ``hips_env.sh``
with ``python -m geomx_tpu_torch.kvstore_server`` for the infrastructure
roles and ``python -m geomx_tpu_torch.examples.<name> --cpu`` for the
workers, with the JAX file's iteration counts, time limits and accuracy
bars. Every process of the group must be gone when the recipe returns.
One more launch runs the JAX package's infrastructure roles with the
port's workers. All slow: the default tier runs ``-m 'not slow'``.
"""

import os
import re
import signal
import subprocess
import sys
import time

import pytest

from geomx_tpu_torch.simulate import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "geomx_tpu_torch", "scripts")


def _run_launch(script, extra_args, n_iters, timeout, expect_lines=0,
                env_extra=None, pattern=r"Test Acc (\d+\.\d+)",
                pass_max_iters=True, tmp_path=None):
    env = dict(os.environ)
    env.update(env_extra or {})
    env.update({
        "GPORT": str(free_port()), "CPORT": str(free_port()),
        "APORT": str(free_port()), "BPORT": str(free_port()),
        "PYTHON": sys.executable, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "",
        "LOG_DIR": str(tmp_path)})
    argv = ["bash", os.path.join(SCRIPTS, script), "--cpu"]
    if pass_max_iters:
        argv += ["--max-iters", str(n_iters)]
    t = time.monotonic()
    proc = subprocess.Popen([*argv, *extra_args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"launch timed out; output:\n{out[-4000:]}")
    # the recipe reaps its roles before it returns: nothing may be left
    try:
        os.killpg(proc.pid, 0)
        os.killpg(proc.pid, signal.SIGKILL)
        pytest.fail("background topology processes did not exit cleanly")
    except ProcessLookupError:
        pass
    assert proc.returncode == 0, f"launch failed:\n{out[-4000:]}"
    accs = [float(m) for m in re.findall(pattern, out)]
    expect = expect_lines or n_iters
    assert len(accs) == expect, \
        f"expected {expect} iteration lines, got:\n{out[-4000:]}"
    print(f"{script}: {time.monotonic() - t:.1f} s, {accs}")
    return accs


@pytest.mark.slow
def test_vanilla_hips_subprocess_topology(tmp_path):
    accs = _run_launch("run_vanilla_hips.sh", [], n_iters=15, timeout=240,
                       tmp_path=tmp_path)
    assert max(accs[-5:]) > 0.4, f"accuracy did not climb: {accs}"
    assert max(accs[-5:]) > accs[0], f"accuracy did not improve: {accs}"


@pytest.mark.slow
def test_bsc_subprocess_topology(tmp_path):
    accs = _run_launch("run_bsc.sh", ["-cr", "0.2"], n_iters=40,
                       timeout=360, tmp_path=tmp_path)
    assert max(accs[-10:]) > 0.15, f"BSC training frozen at chance: {accs}"
    assert len(set(accs[-20:])) > 3, f"accuracy never moved: {accs}"


@pytest.mark.slow
def test_mixed_sync_subprocess_topology(tmp_path):
    accs = _run_launch("run_mixed_sync.sh", [], n_iters=15, timeout=240,
                       tmp_path=tmp_path)
    assert max(accs[-5:]) > 0.3, f"MixedSync did not learn: {accs}"
    assert max(accs[-5:]) > accs[0], f"no improvement: {accs}"


@pytest.mark.slow
def test_hfa_subprocess_topology(tmp_path):
    accs = _run_launch("run_hfa.sh", [], n_iters=20, timeout=240,
                       expect_lines=10, tmp_path=tmp_path)
    assert max(accs[-4:]) > 0.5, f"HFA did not learn: {accs}"


@pytest.mark.slow
def test_fp16_subprocess_topology(tmp_path):
    accs = _run_launch("run_fp16.sh", [], n_iters=15, timeout=240,
                       tmp_path=tmp_path)
    assert max(accs[-5:]) > 0.5, f"FP16 did not learn: {accs}"


@pytest.mark.slow
def test_mpq_subprocess_topology(tmp_path):
    accs = _run_launch("run_mpq.sh", [], n_iters=25, timeout=300,
                       tmp_path=tmp_path)
    assert max(accs[-8:]) > 0.5, f"MPQ did not learn: {accs}"


@pytest.mark.slow
def test_p3_subprocess_topology(tmp_path):
    accs = _run_launch("run_p3.sh", [], n_iters=15, timeout=300,
                       tmp_path=tmp_path)
    assert max(accs[-5:]) > 0.4, f"P3 did not learn: {accs}"
    assert max(accs[-5:]) > accs[0], f"no improvement: {accs}"


@pytest.mark.slow
def test_multi_gps_subprocess_topology(tmp_path):
    accs = _run_launch("run_multi_gps.sh", [], n_iters=15, timeout=300,
                       tmp_path=tmp_path)
    assert max(accs[-5:]) > 0.4, f"MultiGPS did not learn: {accs}"
    assert max(accs[-5:]) > accs[0], f"no improvement: {accs}"


@pytest.mark.slow
def test_dcasgd_subprocess_topology(tmp_path):
    accs = _run_launch("run_dcasgd.sh", ["-lr", "0.05"], n_iters=60,
                       timeout=420, tmp_path=tmp_path)
    assert max(accs) > 0.3, f"DCASGD did not learn: {accs}"
    assert len(set(accs[-20:])) > 3, f"accuracy never moved: {accs}"


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["1", "3"])
def test_dgt_subprocess_topology(mode, tmp_path):
    """DGT mode 1 (unimportant blocks over lossy UDP channels) and mode
    3 (4-bit quantized over TCP) on the inter-DC tier."""
    accs = _run_launch("run_dgt.sh", [], n_iters=20, timeout=300,
                       env_extra={"ENABLE_DGT": mode}, tmp_path=tmp_path)
    assert max(accs[-5:]) > 0.3, f"DGT mode {mode} did not learn: {accs}"


@pytest.mark.slow
def test_intra_ts_subprocess_topology(tmp_path):
    accs = _run_launch("run_intra_ts.sh", [], n_iters=15, timeout=300,
                       tmp_path=tmp_path)
    assert max(accs[-5:]) > 0.3, f"intra-TS did not learn: {accs}"


@pytest.mark.slow
def test_inter_ts_subprocess_topology(tmp_path):
    accs = _run_launch("run_inter_ts.sh", [], n_iters=15, timeout=300,
                       tmp_path=tmp_path)
    assert max(accs[-5:]) > 0.3, f"inter-TS did not learn: {accs}"


@pytest.mark.slow
def test_transformer_bsc_subprocess_topology(tmp_path):
    losses = _run_launch(
        "run_transformer_bsc.sh",
        ["--dim", "64", "--depth", "2", "--heads", "4", "--vocab", "256",
         "--seq-len", "64", "-bs", "4"],
        n_iters=12, timeout=360, pattern=r"Loss (\d+\.\d+)",
        tmp_path=tmp_path)
    assert min(losses[-6:]) < losses[0], f"no learning: {losses}"


@pytest.mark.slow
def test_esync_subprocess_topology(tmp_path):
    accs = _run_launch("run_esync.sh", ["-r", "25", "-lr", "0.01"],
                       n_iters=0, timeout=240, expect_lines=1,
                       pattern=r"final acc=(\d+\.\d+)",
                       pass_max_iters=False, tmp_path=tmp_path)
    assert accs[0] > 0.5, f"ESync did not learn: {accs}"


@pytest.mark.slow
@pytest.mark.parametrize("codec", ["none", "2bit"])
def test_mesh_hips_subprocess_topology(codec, tmp_path):
    """The mesh-party recipe: 9 processes, each party ONE worker whose 2
    ranks share its device, the party's gradients through the plain mean
    or the 2-bit ring."""
    accs = _run_launch("run_mesh_hips.sh", [], n_iters=15, timeout=240,
                       env_extra={"GEOMX_MESH_CODEC": codec,
                                  # the 2-bit ring's step at LeNet's
                                  # gradient scale (chip_smoke.py phase 6a)
                                  "GEOMX_WIRE_2BIT_THRESHOLD": "2e-4"},
                       tmp_path=tmp_path)
    assert max(accs[-5:]) > accs[0], f"no improvement: {accs}"


@pytest.mark.slow
def test_jax_infrastructure_with_port_workers(tmp_path):
    """The JAX package's schedulers and servers (``geomx_tpu`` enters its
    server loop at import) with the port's workers: one wire."""
    accs = _run_launch("run_vanilla_hips.sh", [], n_iters=15, timeout=240,
                       env_extra={"INFRA": "-m geomx_tpu.kvstore_server"},
                       tmp_path=tmp_path)
    assert max(accs[-5:]) > 0.4, f"accuracy did not climb: {accs}"
