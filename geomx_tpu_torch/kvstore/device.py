"""KVStoreDeviceAllreduce — the KVStoreNCCL equivalent ("nccl").

Counterpart of ``geomx_tpu/kvstore/device.py`` (reference:
src/kvstore/kvstore_nccl.h:62 KVStoreNCCL): ``push`` takes one gradient
PER LOCAL DEVICE, sums them on the store's device, applies the updater,
and ``pull`` serves the fresh value. The JAX package lays the per-device
values out over a "dev" mesh axis and sums them with one jitted
reduction; here the values are stacked on a leading device axis on the
store's device (``devices[0]``) and summed there. One H100 is one
device, so the store takes a list of devices only so that several ranks
can be named (the CPU tests give it several).

The stored values stay on the device; ``pull`` copies to the host,
``pull_device`` does not. The updater path keeps a host mirror of the
values it writes, so the host-side optimizer reads the weight without a
download; a push without an updater only drops the key's mirror.
Row-sparse pushes and pulls scatter and gather rows on the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from geomx_tpu_torch._device import resolve_device
from geomx_tpu_torch.kvstore.base import KVStore, _to_numpy
from geomx_tpu_torch.kvstore.local import gather_rows, scatter_rows

__all__ = ["KVStoreDeviceAllreduce", "StoreArgumentError"]


class StoreArgumentError(ValueError, AssertionError):
    """A push or init whose keys, values or per-device list do not match.
    The JAX package checks these with ``assert`` (``AssertionError``);
    the port raises this, which is both a ``ValueError`` and an
    ``AssertionError``, and is not stripped by ``python -O``."""


class KVStoreDeviceAllreduce(KVStore):
    def __init__(self, devices: Optional[list] = None):
        """``devices``: the local devices whose gradients one push sums
        (None: every visible CUDA card, and raises without one)."""
        super().__init__()
        if devices is None:
            resolve_device(None)
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.device = self.devices[0]
        self._store: Dict[int, torch.Tensor] = {}
        # host mirror of the values the updater path wrote; a key
        # without one is downloaded once when an updater next needs it
        self._host: Dict[int, np.ndarray] = {}
        self._shapes: Dict[int, tuple] = {}
        self._updater = None

    @property
    def type(self) -> str:
        return "nccl"

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    def init(self, key, value) -> None:
        keys = self._as_key_list(key)
        values = value if isinstance(value, (list, tuple)) and len(keys) > 1 \
            else [value]
        if len(keys) != len(values):
            raise StoreArgumentError(
                f"{len(keys)} keys but {len(values)} values")
        for k, v in zip(keys, values):
            if k in self._store:
                raise StoreArgumentError(f"duplicate init of key {k}")
            host = np.array(_to_numpy(v), dtype=np.float32)
            self._shapes[k] = host.shape
            self._store[k] = torch.from_numpy(host.copy()).to(self.device)
            self._host[k] = host

    def push(self, key, value, priority: int = 0) -> None:
        """``value``: ONE array per local device (list), or a single array
        (taken as already reduced)."""
        keys = self._as_key_list(key)
        # a per-device gradient LIST for a single key is not split across
        # keys — ``value`` is per key only when there are several keys
        values = value if isinstance(value, (list, tuple)) \
            and len(keys) > 1 else [value]
        if len(keys) != len(values):
            raise StoreArgumentError(
                f"{len(keys)} keys but {len(values)} values")
        for k, v in zip(keys, values):
            if isinstance(v, (list, tuple)):
                if len(v) != len(self.devices):
                    raise StoreArgumentError(
                        f"push of key {k} expects {len(self.devices)} "
                        f"per-device gradients, got {len(v)}")
                stacked = torch.stack([
                    torch.as_tensor(x, dtype=torch.float32).to(self.device)
                    for x in v])
                merged = stacked.sum(dim=0)
            elif torch.is_tensor(v):        # no host round trip
                merged = v.detach().to(self.device, torch.float32,
                                       copy=True)
            else:
                merged = torch.tensor(_to_numpy(v), dtype=torch.float32,
                                      device=self.device)
            if self._updater is not None:
                # host-side optimizer: the gradient comes to the host, the
                # weight is read from the mirror (downloaded only when a
                # push without an updater replaced it on the device)
                host = self._host.get(k)
                if host is None:
                    host = self._store[k].cpu().numpy()
                new_w = np.asarray(self._updater(
                    k, merged.cpu().numpy(), host)).reshape(
                        self._shapes[k]).astype(np.float32)
                self._host[k] = new_w
                self._store[k] = torch.from_numpy(new_w.copy()).to(
                    self.device)
            else:
                self._store[k] = merged.reshape(self._shapes[k])
                self._host.pop(k, None)         # the mirror is stale

    def pull(self, key, out=None, priority: int = 0):
        keys = self._as_key_list(key)
        results = [self._store[k].cpu().numpy() for k in keys]
        if out is not None:
            outs = out if isinstance(out, (list, tuple)) else [out]
            for o, r in zip(outs, results):
                np.copyto(np.asarray(o), r)
        return results[0] if len(results) == 1 else results

    def pull_device(self, key) -> torch.Tensor:
        """Device-resident pull (no host copy) — the NCCL store's fast
        path."""
        return self._store[key]

    def push_row_sparse(self, key, row_ids, values, priority: int = 0) -> None:
        """Push only the touched rows of a 2-D key: they sum into a dense
        gradient on the store's device (``index_add_``), which then
        takes the path of a reduced ``push``."""
        self.push(key, scatter_rows(self._shapes[key], self.device,
                                    row_ids, values), priority)

    def pull_row_sparse(self, key, row_ids, priority: int = 0) -> torch.Tensor:
        """The requested rows of a 2-D key, gathered on the store's
        device (``index_select``) and left there."""
        return gather_rows(self._store[key], row_ids)

    def set_updater(self, updater) -> None:
        self._updater = updater

    def set_optimizer(self, optimizer) -> None:
        self._updater = optimizer
        self._optimizer = optimizer

