"""Single-process KVStore ("local" / "device").

Counterpart of ``geomx_tpu/kvstore/local.py`` (the reference's
KVStoreLocal): an in-process host store with aggregate-on-push and an
optional updater. The row-sparse push/pull of the JAX store is not
ported yet (no caller in the port).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from geomx_tpu_torch.kvstore.base import KVStore, _sum_values, _to_numpy


class KVStoreLocal(KVStore):
    def __init__(self):
        super().__init__()
        self._store: Dict[int, np.ndarray] = {}
        self._updater = None

    @property
    def type(self) -> str:
        return "local"

    def init(self, key, value) -> None:
        keys = self._as_key_list(key)
        values = value if isinstance(value, (list, tuple)) and len(keys) > 1 else [value]
        if len(keys) != len(values):
            raise ValueError(f"{len(keys)} keys but {len(values)} values")
        for k, v in zip(keys, values):
            if k in self._store:
                raise ValueError(f"duplicate init of key {k}")
            self._store[k] = np.array(_to_numpy(v), copy=True)

    def push(self, key, value, priority: int = 0) -> None:
        keys = self._as_key_list(key)
        values = value if isinstance(value, (list, tuple)) and len(keys) > 1 else [value]
        for k, v in zip(keys, values):
            merged = _sum_values(v)
            if self._updater is not None:
                self._store[k] = np.asarray(self._updater(k, merged, self._store[k]))
            else:
                # no updater: the push overwrites the stored value with
                # the reduction (reference local-store semantics)
                self._store[k] = merged

    def pull(self, key, out=None, priority: int = 0):
        keys = self._as_key_list(key)
        results = [self._store[k] for k in keys]
        if out is not None:
            outs = out if isinstance(out, (list, tuple)) else [out]
            for o, r in zip(outs, results):
                np.copyto(np.asarray(o), r)
        return results[0] if len(results) == 1 else results

    def set_updater(self, updater) -> None:
        self._updater = updater

    def set_optimizer(self, optimizer) -> None:
        self._updater = optimizer
        self._optimizer = optimizer  # for save/load_optimizer_states
