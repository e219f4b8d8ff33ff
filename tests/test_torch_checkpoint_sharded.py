"""geomx_tpu_torch sharded mesh checkpointing: the four cases of the JAX
package's ``tests/test_checkpoint_sharded.py``, port only (the two
packages' checkpoint formats differ, ROADMAP queue C).

Rank-stacked state (``parallel.mesh.Sharded``) round-trips, including a
restore onto a mesh of another rank count (the re-layout a resize hits);
a torn step fails loudly and never counts as a checkpoint.
"""

import os

import numpy as np
import pytest
import torch

from geomx_tpu_torch.checkpoint_sharded import (latest_step,
                                                restore_sharded,
                                                save_sharded)
from geomx_tpu_torch.parallel.mesh import make_mesh, shard


def _sharded_tree(mesh, seed=0):
    rng = np.random.RandomState(seed)
    w = torch.tensor(rng.normal(size=(16, 8)), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(16,)), dtype=torch.float32)
    return {
        "w": shard(w, mesh, ("tp", None)),
        "b": shard(b, mesh, ()),
        "step_count": torch.tensor(7, dtype=torch.int32),
    }


def _zeros_like(tree):
    return {"w": shard(torch.zeros(16, 8), tree["w"].mesh, tree["w"].spec),
            "b": shard(torch.zeros(16), tree["b"].mesh, tree["b"].spec),
            "step_count": torch.zeros((), dtype=torch.int32)}


def test_save_restore_same_mesh(tmp_path):
    mesh = make_mesh(8, tp=2, device="cpu")
    tree = _sharded_tree(mesh)
    save_sharded(str(tmp_path / "ck"), 3, tree)
    assert latest_step(str(tmp_path / "ck")) == 3
    out = restore_sharded(str(tmp_path / "ck"), None, _zeros_like(tree))
    assert torch.equal(out["w"].full(), tree["w"].full())
    assert torch.equal(out["w"].shards, tree["w"].shards)
    assert torch.equal(out["b"].full(), tree["b"].full())
    assert int(out["step_count"]) == 7
    assert out["step_count"].dtype == torch.int32
    assert "tp" in out["w"].spec
    assert not [d for d in os.listdir(tmp_path / "ck") if d != "3"]


def test_restore_onto_different_mesh_shape(tmp_path):
    mesh_a = make_mesh(8, tp=2, device="cpu")       # dp=4 x tp=2
    tree = _sharded_tree(mesh_a, seed=1)
    save_sharded(str(tmp_path / "ck"), 0, tree)
    mesh_b = make_mesh(8, tp=4, device="cpu")       # dp=2 x tp=4
    template = {
        "w": shard(torch.zeros(16, 8), mesh_b, ("tp", None)),
        "b": shard(torch.zeros(16), mesh_b, ()),
        "step_count": torch.tensor(0, dtype=torch.int32),
    }
    out = restore_sharded(str(tmp_path / "ck"), 0, template)
    assert torch.equal(out["w"].full(), tree["w"].full())
    # the restored value really lives in the NEW layout
    assert out["w"].mesh.shape["tp"] == 4
    assert out["w"].shards.shape == (4, 4, 8)


def test_latest_step_empty_and_missing(tmp_path):
    assert latest_step(str(tmp_path / "nope")) is None
    (tmp_path / "empty").mkdir()
    assert latest_step(str(tmp_path / "empty")) is None


def test_corrupt_step_fails_loudly_valid_step_survives(tmp_path):
    """Restoring a torn/corrupt step raises (never silent garbage); the
    intact checkpoint next to it still restores, and a torn step is not
    the latest."""
    mesh = make_mesh(8, tp=2, device="cpu")
    tree = _sharded_tree(mesh)
    path = tmp_path / "ck"
    save_sharded(str(path), 1, tree)
    (path / "5").mkdir()
    (path / "5" / "junk").write_text("partial")
    with pytest.raises(Exception):
        restore_sharded(str(path), 5, _zeros_like(tree))
    assert latest_step(str(path)) == 1
    save_sharded(str(path), 2, tree)
    with open(path / "2" / "checkpoint.gxck", "r+b") as f:   # truncated
        f.truncate(40)
    with pytest.raises(Exception):
        restore_sharded(str(path), 2, _zeros_like(tree))
    out = restore_sharded(str(path), 1, _zeros_like(tree))
    assert torch.equal(out["w"].full(), tree["w"].full())
    with pytest.raises(FileExistsError):
        save_sharded(str(path), 1, tree)


def test_optimizer_state_and_bf16_round_trip(tmp_path):
    """An AdamW state dict and a bf16 tensor restore exactly onto their
    templates (bf16 is stored widened to fp32, an exact widening)."""
    p = torch.nn.Parameter(torch.randn(5, 3))
    opt = torch.optim.AdamW([p], lr=1e-3, weight_decay=1e-4)
    p.grad = torch.randn(5, 3)
    opt.step()
    h = torch.randn(4, dtype=torch.float32).to(torch.bfloat16)
    save_sharded(str(tmp_path), 1, {"opt": opt.state_dict(), "h": h})
    fresh = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(5, 3))],
                              lr=1e-3, weight_decay=1e-4)
    fresh.load_state_dict(opt.state_dict())
    out = restore_sharded(str(tmp_path), 1, {
        "opt": fresh.state_dict(), "h": torch.zeros(4, dtype=torch.bfloat16)})
    assert out["h"].dtype == torch.bfloat16 and torch.equal(out["h"], h)
    want = opt.state_dict()
    assert out["opt"]["param_groups"] == want["param_groups"]
    for key in ("step", "exp_avg", "exp_avg_sq"):
        assert torch.equal(out["opt"]["state"][0][key],
                           want["state"][0][key])
