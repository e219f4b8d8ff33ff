"""Abstract KVStore interface + server command constants.

Counterpart of ``geomx_tpu/kvstore/base.py``: the user-facing KVStore
surface of GeoMX's ``mx.kv`` (``init``, ``push(..., priority=)``,
``pull``, ``set_optimizer``, ``set_gradient_compression``, ``barrier``,
``rank`` / ``num_workers`` / ``num_all_workers`` / ``is_master_worker``),
and the server command numbers of the shared wire.

Values are array-likes (numpy, or torch tensors on any device); push
accepts a single array or a list of per-device arrays which are summed
on the host (the reference's Comm reduce).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from geomx_tpu_torch import checkpoint


# Server command channel (reference: src/kvstore/kvstore_dist_server.h:46-52).
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
    #                               (beyond parity: reference README.md:45
    #                               documents ESync but ships no code)
    REPLICA_UPDATE = 12           # server -> peer server: snapshot delta
    #                               (durable recovery; docs/robustness.md)
    REPLICA_FETCH = 13            # recovering server <- peer: full replica
    METRICS = 14                  # worker <- server: telemetry snapshot JSON
    HEALTH = 15                   # worker <- scheduler: cluster health board
    #                               JSON (ps/linkstate.py; the value mirrors
    #                               linkstate.HEALTH_CMD — answered at the
    #                               VAN level because scheduler Postoffices
    #                               have no customers)


# Data-plane cmd values carried in push meta.head.
DATA_DEFAULT = 0
DATA_INIT = 1                     # initialization push (kv.init), never a gradient


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
    """Abstract key-value store (reference: include/mxnet/kvstore.h:59)."""

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
        """Total trainers across every party (kvstore.py:541)."""
        return self.num_workers

    @property
    def is_master_worker(self) -> bool:
        """True on the central party's master worker (kvstore.py:554)."""
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
        """Combined push+pull (reference: ZPushPull, kv_app.h:140).
        The base behavior is the two-op sequence; KVStoreDist overrides
        it with the one-message-per-server combined wire."""
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
        """Dump the updater's states (reference: kvstore.py:566). This base
        implementation serves stores whose updater runs in-process
        (KVStoreLocal); KVStoreDist overrides it with a server round-trip
        because the live states sit on the aggregation server."""
        checkpoint.save_optimizer_states(fname, self._local_optimizer())

    def load_optimizer_states(self, fname: str) -> None:
        checkpoint.load_optimizer_states(fname, self._local_optimizer())

    def _local_optimizer(self):
        opt = getattr(self, "_optimizer", None)
        if opt is None:
            raise RuntimeError("no optimizer set on this node; optimizer "
                               "states are saved and loaded where "
                               "set_optimizer was called")
        return opt

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
