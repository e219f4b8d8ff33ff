"""geomx_tpu_torch.kvstore — the KVStore factory (mirrors mx.kv).

Counterpart of ``geomx_tpu/kvstore/__init__.py``. Accepted type strings:

- "local" / "device" — single-process host store.

The distributed stores ("dist", "dist_sync", "dist_async",
"dist_sync_mesh", ...) and "nccl" need the HiPS host layers and the
intra-party tier, which are not ported yet (ROADMAP queue A items 4 and
9): their names raise instead of falling back to the local store.
"""

from __future__ import annotations

from geomx_tpu_torch.kvstore.base import Command, KVStore  # noqa: F401
from geomx_tpu_torch.kvstore.local import KVStoreLocal  # noqa: F401


def create(name: str = "local") -> KVStore:
    tname = name.lower()
    if tname in ("local", "device"):
        return KVStoreLocal()
    if "dist" in tname:
        raise NotImplementedError(
            f"kvstore {name!r} needs the HiPS host layers (ps/, "
            "kvstore/dist.py, kvstore/server.py), not ported yet "
            "(ROADMAP queue A item 4)")
    if tname == "nccl":
        raise NotImplementedError(
            "kvstore 'nccl' needs the intra-party tier, not ported yet "
            "(ROADMAP queue A item 9)")
    raise ValueError(f"unknown kvstore type {name!r}")
