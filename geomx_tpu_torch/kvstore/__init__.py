"""geomx_tpu_torch.kvstore — the KVStore factory (mirrors mx.kv).

Counterpart of ``geomx_tpu/kvstore/__init__.py``. Accepted type strings:

- "local" / "device"            — single-process host store
- "dist" / "dist_sync" / "dist_sync_device" / "dist_sync_tpu"
                                — distributed HiPS store, FSA (both tiers
                                  synchronous)
- "dist_async"                  — distributed, MixedSync (async global
                                  tier)

The mesh-party tier ("dist_sync_mesh", or the plain dist names under
GEOMX_PARTY_MESH) and "nccl" need the rest of the intra-party tier, not
ported yet (ROADMAP queue A item 9): their names raise instead of
falling back to another store.
"""

from __future__ import annotations

from geomx_tpu_torch import config as cfg_mod
from geomx_tpu_torch.kvstore.base import Command, KVStore  # noqa: F401
from geomx_tpu_torch.kvstore.local import KVStoreLocal  # noqa: F401


def create(name: str = "local") -> KVStore:
    tname = name.lower()
    if "dist" in tname:
        sync_global = "_sync" in tname or tname == "dist"
        if "_async" in tname:
            sync_global = False
        if "_mesh" in tname or (sync_global
                                and cfg_mod.load().party_mesh):
            raise NotImplementedError(
                f"kvstore {name!r} needs the mesh-party tier "
                "(kvstore/mesh_party.py), not ported yet (ROADMAP queue A "
                "item 9)")
        from geomx_tpu_torch.kvstore.dist import KVStoreDist

        return KVStoreDist(sync_global=sync_global)
    if tname == "nccl":
        raise NotImplementedError(
            "kvstore 'nccl' needs the intra-party tier, not ported yet "
            "(ROADMAP queue A item 9)")
    if tname in ("local", "device"):
        return KVStoreLocal()
    raise ValueError(f"unknown kvstore type {name!r}")
