"""Single-process KVStore ("local" / "device").

Counterpart of ``geomx_tpu/kvstore/local.py`` (the reference's
KVStoreLocal): an in-process host store with aggregate-on-push and an
optional updater, and row-sparse push/pull of 2-D keys. The row
scatter and gather (``scatter_rows``/``gather_rows``, shared with the
device store) are ``index_add_`` and ``index_select`` on the device
the stored value lives on.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from geomx_tpu_torch.kvstore.base import KVStore, _sum_values, _to_numpy


def _row_ids(row_ids, device) -> torch.Tensor:
    if not torch.is_tensor(row_ids):
        row_ids = np.asarray(row_ids, np.int64)
    return torch.as_tensor(row_ids, dtype=torch.int64,
                           device=device).reshape(-1)


def scatter_rows(shape, device, row_ids, values) -> torch.Tensor:
    """A dense fp32 tensor of ``shape`` (rows x row_len) on ``device``
    holding the sum of ``values``' rows at ``row_ids`` (a row pushed
    twice sums) and zeros elsewhere."""
    ids = _row_ids(row_ids, device)
    rows = torch.as_tensor(values, dtype=torch.float32,
                           device=device).reshape(ids.numel(), -1)
    dense = torch.zeros(int(np.prod(shape)) // rows.shape[1], rows.shape[1],
                        dtype=torch.float32, device=device)
    return dense.index_add_(0, ids, rows).reshape(shape)


def gather_rows(value: torch.Tensor, row_ids) -> torch.Tensor:
    """The rows ``row_ids`` of a (rows x row_len) ``value``, on its
    device."""
    return value.reshape(-1, value.shape[-1]).index_select(
        0, _row_ids(row_ids, value.device))


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

    # -- row-sparse (reference: kvstore.h:59 PullRowSparse; row_sparse
    # storage type of kvstore_local.h) ----------------------------------

    def push_row_sparse(self, key, row_ids, values, priority: int = 0) -> None:
        """Push only the touched rows of a 2-D key; rows aggregate by sum
        (then the updater applies, when set)."""
        dense = scatter_rows(self._store[key].shape, "cpu", row_ids, values)
        self.push(key, dense.numpy(), priority)

    def pull_row_sparse(self, key, row_ids, priority: int = 0) -> np.ndarray:
        """Gather the requested rows (reference: PullRowSparse). The key
        must hold a 2-D (rows x row_len) value."""
        w = np.require(self._store[key], requirements=["C", "W"])
        return gather_rows(torch.from_numpy(w), row_ids).numpy()

    def set_updater(self, updater) -> None:
        self._updater = updater

    def set_optimizer(self, optimizer) -> None:
        self._updater = optimizer
        self._optimizer = optimizer  # for save/load_optimizer_states
