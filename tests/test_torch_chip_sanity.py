"""The port's on-card self-check (``geomx_tpu_torch/tools/chip_sanity.py``)
on the CPU: the five probes green, the BSC probe on the same bits as its
numpy oracle, a planted index flush turns it red, a probe that raises
fails the run, and the verdict names its probes after the JAX tool's.
On the card the same verdict is ``chip_smoke.py`` phase 12.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from geomx_tpu_torch import trainer_device
from geomx_tpu_torch.tools import chip_sanity

ROOT = Path(__file__).resolve().parents[1]
# the port's probe -> the JAX tool's (tools/chip_sanity.py); the port
# has no jit, so its bitcast probe makes the patterns on the device
JAX_NAMES = {"transfer_bitexact": "transfer_bitexact",
             "bitcast_on_device": "bitcast_in_jit",
             "matmul_precision": "matmul_precision",
             "blocking_honest": "blocking_honest",
             "bsc_oracle": "bsc_oracle"}


@pytest.fixture(scope="module")
def verdict():
    return chip_sanity.run_chip_sanity(device="cpu")


def test_green_on_the_cpu(verdict):
    assert verdict["ok"] is True, verdict
    assert (verdict["platform"], verdict["device"]) == ("cpu", "cpu")
    for name in chip_sanity.PROBES:
        assert verdict[name]["ok"] is True, (name, verdict[name])
    assert verdict["transfer_bitexact"]["modes"] == [
        "pageable/blocking", "pageable/non_blocking"]
    assert verdict["bitcast_on_device"]["checked"] == [
        "cat", "device_to_host", "host_to_device", "index_select", "pack",
        "where"]
    mm = verdict["matmul_precision"]
    assert mm["matmul_err_exact"] < 1e-5 and mm["conv_err_exact"] < 1e-5
    # CUDA events time only the card
    assert verdict["blocking_honest"]["t_events_s"] is None


def test_bsc_probe_lands_on_the_oracle(verdict):
    bsc = verdict["bsc_oracle"]
    assert bsc["rounds"] == 25 and bsc["device_finite"]
    assert bsc["max_param_drift"] < 1e-6


def test_planted_index_flush_turns_the_probe_red(monkeypatch):
    """The r04 fault: the packed wire's indices flushed to zero (here to
    each leaf's first coordinate, where the local store can take them)."""
    real = trainer_device.DeviceResidentTrainer._fwd_compress

    def flushed(self, *args):
        packed, u, v = real(self, *args)
        base = 1 + self.k
        for i, off in enumerate(self._offsets[:-1]):
            packed[base + int(self._kofs[i]):
                   base + int(self._kofs[i + 1])] = int(off)
        return packed, u, v

    monkeypatch.setattr(trainer_device.DeviceResidentTrainer,
                        "_fwd_compress", flushed)
    out = chip_sanity.run_chip_sanity(device="cpu", rounds=5)
    assert out["bsc_oracle"]["ok"] is False
    assert out["bsc_oracle"]["max_param_drift"] > 1e-2
    assert out["ok"] is False


def test_a_probe_that_raises_fails_the_run(monkeypatch):
    def broken(dev):
        raise RuntimeError("copy engine fault")

    monkeypatch.setattr(chip_sanity, "_probe_transfer_bitexact", broken)
    with pytest.raises(RuntimeError, match="copy engine fault"):
        chip_sanity.run_chip_sanity(device="cpu", rounds=1)


def test_the_card_unless_the_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chip_sanity.run_chip_sanity()


def test_probe_names_mirror_the_jax_tool():
    tree = ast.parse((ROOT / "tools" / "chip_sanity.py").read_text())
    jax = {n.name[len("_probe_"):] for n in tree.body
           if isinstance(n, ast.FunctionDef) and n.name.startswith("_probe_")}
    assert set(JAX_NAMES) == set(chip_sanity.PROBES)
    assert set(JAX_NAMES.values()) == jax


def test_matmul_probe_restores_the_process_settings():
    backends = torch.backends
    held = (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32)
    try:
        backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = \
            True, False
        out = chip_sanity._probe_matmul_precision(torch.device("cpu"))
        assert out["process_settings"] == {"cublas_allow_tf32": True,
                                           "cudnn_allow_tf32": False}
        assert (backends.cuda.matmul.allow_tf32,
                backends.cudnn.allow_tf32) == (True, False)
    finally:
        backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = held


def test_import_leaves_jax_out():
    code = ("import sys, geomx_tpu_torch.tools.chip_sanity\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'flax', 'geomx_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]"


@pytest.mark.cuda
def test_green_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = chip_sanity.run_chip_sanity()
    assert out["platform"] == "gpu" and out["ok"] is True, out
    assert len(out["transfer_bitexact"]["modes"]) == 4
