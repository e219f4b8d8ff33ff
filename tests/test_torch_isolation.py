"""geomx_tpu_torch stands alone and runs on the card unless told otherwise.

The port imports torch and never jax, flax or geomx_tpu (checked both at
run time in a fresh interpreter and statically over every source file,
``chip_smoke.py`` included); its entry points raise without a CUDA card
unless the caller asks for the CPU; and the kv store names it has not
ported raise instead of quietly becoming another store.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import geomx_tpu_torch as gx
from geomx_tpu_torch.examples import transformer_bsc_device as example
from geomx_tpu_torch.kvstore.local import KVStoreLocal
from geomx_tpu_torch.trainer_device import DeviceResidentTrainer

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "geomx_tpu"}


def test_import_leaves_jax_out_of_the_process():
    code = (
        "import sys\n"
        "import geomx_tpu_torch\n"
        "import geomx_tpu_torch.examples.transformer_bsc_device\n"
        "import geomx_tpu_torch.ops.flash_attention\n"
        "import geomx_tpu_torch.ops.two_bit\n"
        "import geomx_tpu_torch.compression\n"
        "import geomx_tpu_torch.compression.device\n"
        "import geomx_tpu_torch.parallel\n"
        "import geomx_tpu_torch.parallel.quant_collectives\n"
        "import geomx_tpu_torch.parallel.train_step\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]"


def _sources():
    files = sorted((ROOT / "geomx_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_no_source_imports_jax_flax_or_geomx_tpu():
    files = _sources()
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
            assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_trainer_without_cuda_raises(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceResidentTrainer([np.zeros(4, np.float32)], KVStoreLocal(),
                              lambda lv, X, y: (None, lv), device=None)


def test_example_without_cpu_flag_raises(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        example.main(["--local", "--max-iters", "1", "--dim", "8",
                      "--depth", "1", "--heads", "1", "--vocab", "8",
                      "--seq-len", "4"])


def test_example_runs_on_the_cpu_when_asked(capsys):
    example.main(["--local", "--cpu", "--max-iters", "2", "--dim", "16",
                  "--depth", "1", "--heads", "2", "--vocab", "32",
                  "--seq-len", "8", "-bs", "2"])
    out = capsys.readouterr().out
    assert "on cpu" in out and "[Iteration 2] Loss" in out


@pytest.mark.parametrize("name", ["dist_sync", "dist_async", "dist",
                                  "dist_sync_mesh", "nccl"])
def test_unported_kvstores_raise(name, monkeypatch):
    """The mesh-party and nccl stores still raise; the HiPS names map to
    ``KVStoreDist`` with the JAX factory's ``sync_global`` (checked with
    the class stubbed out, so no node starts)."""
    import geomx_tpu_torch.kvstore.dist as dist

    made = []
    monkeypatch.setattr(dist, "KVStoreDist",
                        lambda sync_global: made.append(sync_global) or "kv")
    want = {"dist_sync": True, "dist_async": False, "dist": True}
    if name in want:
        assert gx.kv.create(name) == "kv"
        assert made == [want[name]]
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gx.kv.create(name)
    assert made == []


def test_local_store_matches_the_jax_package():
    from geomx_tpu.kvstore.local import KVStoreLocal as JaxLocal

    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    results = []
    for kv in (gx.kv.create("local"), JaxLocal()):
        kv.init(3, a)
        kv.push(3, [a, 2 * a])              # no updater: push overwrites
        out = np.zeros_like(a)
        kv.pull(3, out=out)
        kv.set_updater(lambda k, g, w: w - 0.5 * g)
        kv.push(3, a)
        results.append((out, kv.pull(3)))
    for x, y in zip(*results):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="duplicate"):
        gx.kv.create("device").init([1, 1], [a, a])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gx.kv.create("local").save_optimizer_states("x")
