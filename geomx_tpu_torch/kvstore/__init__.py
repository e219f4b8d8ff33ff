"""geomx_tpu_torch.kvstore — the KVStore factory (mirrors mx.kv).

Counterpart of ``geomx_tpu/kvstore/__init__.py``. Accepted type strings:

- "local" / "device"            — single-process host store
- "nccl"                        — single-process multi-device allreduce
                                  store (reference: kvstore_nccl.h:62):
                                  the per-device values are summed on the
                                  store's device (kvstore.device)
- "dist" / "dist_sync" / "dist_sync_device" / "dist_sync_tpu"
                                — distributed HiPS store, FSA (both tiers
                                  synchronous)
- "dist_async"                  — distributed, MixedSync (async global
                                  tier)
- "dist_sync_mesh"              — mesh-party tier: the party's ranks share
                                  one device and aggregate there (or, with
                                  the GEOMX_MESH_* settings, are processes
                                  of a torch.distributed group); one
                                  global worker per party speaks the van
                                  (kvstore.mesh_party). GEOMX_PARTY_MESH
                                  makes the plain synchronous dist names
                                  resolve here, on every rank.

``device`` places the party mesh of the mesh-party store and the
single device of the "nccl" store (None: the CUDA card, and raises
without one); the other stores ignore it.
"""

from __future__ import annotations

from geomx_tpu_torch import config as cfg_mod
from geomx_tpu_torch.kvstore.base import Command, KVStore  # noqa: F401
from geomx_tpu_torch.kvstore.local import KVStoreLocal  # noqa: F401


def create(name: str = "local", device=None) -> KVStore:
    tname = name.lower()
    if "dist" in tname:
        sync_global = "_sync" in tname or tname == "dist"
        if "_async" in tname:
            sync_global = False
        if "_mesh" in tname or (sync_global
                                and cfg_mod.load().party_mesh):
            from geomx_tpu_torch.kvstore.mesh_party import KVStorePartyMesh

            return KVStorePartyMesh(sync_global=sync_global, device=device)
        from geomx_tpu_torch.kvstore.dist import KVStoreDist

        return KVStoreDist(sync_global=sync_global)
    if tname == "nccl":
        from geomx_tpu_torch.kvstore.device import KVStoreDeviceAllreduce

        return KVStoreDeviceAllreduce(
            None if device is None else [device])
    if tname in ("local", "device"):
        return KVStoreLocal()
    raise ValueError(f"unknown kvstore type {name!r}")
