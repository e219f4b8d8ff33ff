"""Abstract KVStore interface + server command constants.

Counterpart of ``geomx_tpu/kvstore/base.py``: the user-facing KVStore
surface of GeoMX's ``mx.kv`` (``init``, ``push(..., priority=)``,
``pull``, ``set_optimizer``, ``set_gradient_compression``, ``barrier``,
``rank`` / ``num_workers`` / ``num_all_workers`` / ``is_master_worker``).

Values are array-likes (numpy, or torch tensors on any device); push
accepts a single array or a list of per-device arrays which are summed
on the host (the reference's Comm reduce).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np


# Server command channel (same numbering as the JAX package's wire).
class Command:
    CONTROLLER = 1                # body = pickled optimizer
    STOP_SERVER = 2
    SYNC_MODE = 3
    SYNC_GLOBAL_MODE = 4
    SET_GRADIENT_COMPRESSION = 5
    SET_PROFILER_PARAMS = 6
    SET_MULTI_PRECISION = 7
    GLOBAL_BARRIER = 8            # cross-party worker barrier (via servers)
    GET_OPTIMIZER_STATES = 9      # fetch the server-side updater's states
    SET_OPTIMIZER_STATES = 10     # restore the server-side updater's states
    ESYNC_STATE = 11              # ESync state-server report -> step count
    REPLICA_UPDATE = 12           # server -> peer server: snapshot delta
    REPLICA_FETCH = 13            # recovering server <- peer: full replica
    METRICS = 14                  # worker <- server: telemetry snapshot JSON
    HEALTH = 15                   # worker <- scheduler: cluster health board



ArrayLike = Any  # numpy arrays / torch tensors


def _to_numpy(value: ArrayLike) -> np.ndarray:
    """Host copy of a numpy array or a torch tensor on any device."""
    if hasattr(value, "detach"):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _sum_values(value: Union[ArrayLike, Sequence[ArrayLike]]) -> np.ndarray:
    """Reduce a per-device value list to one host array (Comm::Reduce)."""
    if isinstance(value, (list, tuple)):
        out = _to_numpy(value[0])
        for v in value[1:]:
            out = out + _to_numpy(v)
        return out
    return _to_numpy(value)


class KVStore:
    """Abstract key-value store."""

    def __init__(self):
        self._compression_params: Optional[Dict] = None

    # -- identity --------------------------------------------------------

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    @property
    def num_all_workers(self) -> int:
        """Total trainers across every party."""
        return self.num_workers

    @property
    def is_master_worker(self) -> bool:
        """True on the central party's master worker."""
        return False

    @property
    def type(self) -> str:
        return "base"

    # -- data plane ------------------------------------------------------

    def init(self, key: Union[int, Sequence[int]], value) -> None:
        raise NotImplementedError

    def push(self, key, value, priority: int = 0) -> None:
        raise NotImplementedError

    def pull(self, key, out=None, priority: int = 0):
        raise NotImplementedError

    def push_pull(self, key, value, out, priority: int = 0) -> None:
        """Combined push+pull; the base behavior is the two-op sequence."""
        self.push(key, value, priority=priority)
        self.pull(key, out=out, priority=priority)

    def wait(self, keys=None) -> None:
        """Block until outstanding ops on ``keys`` (or all) complete."""

    # -- control plane ---------------------------------------------------

    def set_optimizer(self, optimizer) -> None:
        raise NotImplementedError

    def set_updater(self, updater) -> None:
        raise NotImplementedError

    def set_gradient_compression(self, compression_params: Dict) -> None:
        self._compression_params = dict(compression_params)

    # -- optimizer state persistence -------------------------------------

    def save_optimizer_states(self, fname: str) -> None:
        raise NotImplementedError(
            "optimizer-state checkpoints need geomx_tpu_torch.checkpoint, "
            "which is not ported yet (ROADMAP queue A item 4)")

    def load_optimizer_states(self, fname: str) -> None:
        raise NotImplementedError(
            "optimizer-state checkpoints need geomx_tpu_torch.checkpoint, "
            "which is not ported yet (ROADMAP queue A item 4)")

    def barrier(self, is_global: bool = False) -> None:
        pass

    def close(self) -> None:
        pass

    # -- iteration helpers ----------------------------------------------

    @staticmethod
    def _as_key_list(key) -> List[int]:
        if isinstance(key, (list, tuple)):
            return [int(k) for k in key]
        return [int(key)]
