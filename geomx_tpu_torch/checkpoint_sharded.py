"""Sharded (mesh) checkpointing.

Counterpart of ``geomx_tpu/checkpoint_sharded.py`` (``save_sharded``
``:41``, ``restore_sharded`` ``:55``, ``latest_step`` ``:86``), with the
same surface and guarantees:

- ``save_sharded(path, step, tree)``: a synchronous, atomic write of a
  tree of tensors (plain or :class:`~geomx_tpu_torch.parallel.mesh.Sharded`)
  as ``path/<step>``. The step is written into a temporary directory
  beside it and renamed into place when complete, so a crashed write
  never looks like a checkpoint;
- ``restore_sharded(path, step, template)``: restore onto the layouts
  and dtypes of ``template`` — a rank-stacked leaf is re-split over its
  template's mesh, whose rank count may differ from the saved one's;
- ``latest_step(path)``: resume discovery.

The JAX package writes orbax's format; the port has no orbax, and writes
each step as one file of :mod:`geomx_tpu_torch.checkpoint`'s codec (a
JSON header and the raw bytes of numpy arrays) holding every leaf's
whole value. So checkpoints do not cross packages (ROADMAP queue C).
bf16 tensors are stored widened to fp32 (numpy has no bf16; the
widening is exact) and narrowed back onto the template's dtype.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch

from geomx_tpu_torch.checkpoint import _dumps, _loads
from geomx_tpu_torch.parallel.mesh import Sharded, shard

__all__ = ["save_sharded", "restore_sharded", "latest_step"]

_FILE = "checkpoint.gxck"


def _to_host(x: Any) -> Any:
    if isinstance(x, Sharded):
        x = x.full()
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _onto(template: Any, saved: Any, where: str) -> Any:
    """``saved`` (host values) laid out as ``template``."""
    if isinstance(template, Sharded):
        full = torch.as_tensor(np.asarray(saved)).to(template.dtype)
        if tuple(full.shape) != template.shape:
            raise ValueError(f"{where}: saved shape {tuple(full.shape)} "
                             f"!= template shape {template.shape}")
        return shard(full, template.mesh, template.spec)
    if isinstance(template, torch.Tensor):
        arr = np.asarray(saved)
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"{where}: saved shape {arr.shape} != "
                             f"template shape {tuple(template.shape)}")
        return torch.as_tensor(arr).to(device=template.device,
                                       dtype=template.dtype)
    if isinstance(template, np.ndarray):
        return np.asarray(saved, dtype=template.dtype).reshape(
            template.shape)
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            raise ValueError(f"{where}: saved keys do not match the "
                             "template's")
        return {k: _onto(v, saved[k], f"{where}/{k}")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(saved, (list, tuple)) \
                or len(saved) != len(template):
            raise ValueError(f"{where}: saved length does not match the "
                             "template's")
        return type(template)(_onto(t, s, f"{where}/{i}")
                              for i, (t, s) in enumerate(zip(template,
                                                             saved)))
    return saved


def save_sharded(path: str, step: int, tree: Any) -> None:
    """Write ``tree`` as checkpoint ``step`` under ``path``. Blocks until
    durable (atomic finalize — a crashed write never looks like a
    checkpoint). An existing step is not overwritten."""
    path = os.path.abspath(path)
    final = os.path.join(path, str(int(step)))
    if os.path.exists(final):
        raise FileExistsError(f"checkpoint step {step} exists under {path}")
    os.makedirs(path, exist_ok=True)
    data = _dumps({"step": int(step), "tree": _to_host(tree)})
    tmp = tempfile.mkdtemp(
        prefix=f".{int(step)}.{os.getpid()}.{threading.get_ident()}.",
        dir=path)
    try:
        with open(os.path.join(tmp, _FILE), "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)


def restore_sharded(path: str, step: Optional[int], template: Any) -> Any:
    """Restore checkpoint ``step`` (or the latest when None) onto the
    layouts and dtypes of ``template`` (values are ignored, structure,
    devices and meshes used)."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    fname = os.path.join(os.path.abspath(path), str(int(step)), _FILE)
    with open(fname, "rb") as f:
        payload = _loads(f.read())
    if payload.get("step") != int(step):
        raise ValueError(f"{fname} holds step {payload.get('step')}, "
                         f"not {step}")
    return _onto(template, payload["tree"], str(step))


def latest_step(path: str) -> Optional[int]:
    """Newest step number under ``path`` (None when empty/missing)."""
    if not os.path.isdir(path):
        return None
    steps = [int(d) for d in os.listdir(path) if d.isdigit()
             and os.path.isfile(os.path.join(path, d, _FILE))]
    return max(steps) if steps else None
