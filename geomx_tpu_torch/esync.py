"""ESync: straggler-saving synchronous training for heterogeneous nodes.

Counterpart of ``geomx_tpu/esync.py``, numpy as there: the state server's
assignments and the trainer's rounds are the same numbers.

The reference DOCUMENTS this algorithm but ships no code ("to be
integrated", reference README.md:45; the cited paper is Li et al.,
"ESync: Accelerating Intra-domain Federated Learning in Heterogeneous
Data Centers", IEEE TSC 2020, reference README.md:111). Implemented here
from the paper's design as a beyond-parity feature:

- A **state server** tracks each worker's smoothed per-iteration compute
  time tau_i and sync round-trip time c_i, and assigns a LOCAL STEP
  COUNT M_i that balances every worker's reach-server time against the
  slowest worker: fast nodes run more local SGD steps instead of idling
  at the barrier, so synchronous aggregation stops wasting heterogeneous
  capacity without admitting stale gradients (the asynchronous
  alternative the paper measures against).
- Aggregation is synchronous MODEL AVERAGING each sync round (workers
  push w_i / n; the aggregator tier sums), so replicas leave every sync
  bit-identical regardless of how many local steps each ran.

The state server is hosted on the party's rank-0 parameter server behind
the existing command channel (Command.ESYNC_STATE) — matching the
paper's deployment, where the state server co-locates with the PS. The
assignment rule, per the paper's reach-time balancing:

    T      = max_j(tau_j + c_j)          # slowest single-step reach time
    M_i    = clamp(floor((T - c_i) / tau_i), 1, cap)

First-round reports default to M=1 (everyone synchronous) until real
measurements arrive; reports are EMA-smoothed (alpha 0.5) so transient
scheduling noise doesn't whipsaw the step counts.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Sequence

import numpy as np

__all__ = ["ESyncStateServer", "ESyncTrainer"]

EMA_ALPHA = 0.5
DEFAULT_CAP = 32
# reports older than this many sync rounds (times the slowest reach
# time) are a departed/crashed worker: its stale entry must not keep
# inflating `reach` — which would pin every surviving worker's step
# count to a ghost forever
STALE_ROUNDS = 4


class ESyncStateServer:
    """Per-worker reach-time table + step-count assignment (state server
    role from the paper, hosted inside the rank-0 PS)."""

    def __init__(self, cap: int = DEFAULT_CAP,
                 stale_rounds: float = STALE_ROUNDS,
                 time_fn=time.monotonic, live_fn=None):
        self.cap = cap
        self.stale_rounds = float(stale_rounds)
        self._time_fn = time_fn          # injectable for tests
        # membership hook: () -> iterable of LIVE worker ids. When the
        # hosting PS wires it (kvstore/server.py), a worker the scheduler
        # declared dead leaves the reach table on its NEXT report instead
        # of lingering for stale_rounds * T — the epoch view and the
        # time-based ageing agree on who counts
        self.live_fn = live_fn
        self._lock = threading.Lock()
        # sender id -> (tau_ema, c_ema, last_report_time)
        self._times: Dict[int, tuple] = {}

    def report(self, sender: int, tau_s: float, c_s: float) -> int:
        """Record worker ``sender``'s measured times; return its next
        local step count."""
        tau_s = max(float(tau_s), 1e-6)
        c_s = max(float(c_s), 0.0)
        now = self._time_fn()
        with self._lock:
            prev = self._times.get(sender)
            if prev is not None:
                tau_s = EMA_ALPHA * tau_s + (1 - EMA_ALPHA) * prev[0]
                c_s = EMA_ALPHA * c_s + (1 - EMA_ALPHA) * prev[1]
            self._times[sender] = (tau_s, c_s, now)
            # age out the dead: a worker reports once per sync round and
            # a round lasts about the balanced reach time T, so anything
            # silent for stale_rounds * T rounds has left the job
            reach_all = max(t + c for t, c, _ in self._times.values())
            window = max(self.stale_rounds * reach_all, 1e-3)
            self._times = {s: e for s, e in self._times.items()
                           if now - e[2] <= window}
            if self.live_fn is not None:
                # membership epoch view: declared-dead reporters leave
                # immediately (the reporting sender always counts — its
                # report IS evidence of life)
                live = set(self.live_fn()) | {sender}
                self._times = {s: e for s, e in self._times.items()
                               if s in live}
            reach = max(t + c for t, c, _ in self._times.values())
            m = int((reach - c_s) / tau_s)
        return max(1, min(m, self.cap))

    def live_workers(self) -> int:
        """Number of workers that count toward reach-time balancing:
        the membership epoch's live view when wired (``live_fn``), the
        non-stale report table otherwise (observability)."""
        if self.live_fn is not None:
            return len(set(self.live_fn()))
        with self._lock:
            return len(self._times)

    def handle(self, body: str, sender: int) -> str:
        """Command-channel entry: body = JSON {"tau": s, "c": s};
        response body = the assigned step count."""
        d = json.loads(body)
        return str(self.report(sender, d.get("tau", 1e-3),
                               d.get("c", 0.0)))


class ESyncTrainer:
    """Worker-side ESync loop: M_i local optimizer steps per sync round,
    synchronous model averaging through the kvstore, step count from the
    state server each round.

    ``opt_update(i, leaf, grad) -> new_leaf`` is the local optimizer
    (geomx_tpu_torch.optimizer instances fit directly); ``grad_fn(leaves,
    X, y) -> (loss, grads)``. The kvstore's PS tier must run WITHOUT a
    server-side optimizer (aggregator mode), like cnn_bsc."""

    def __init__(self, leaves: Sequence[np.ndarray], kvstore, grad_fn,
                 opt, begin_key: int = 0):
        self.kv = kvstore
        self.grad_fn = grad_fn
        self.opt = opt
        self.begin_key = begin_key
        self.leaves: List[np.ndarray] = [np.array(l, np.float32)
                                         for l in leaves]
        self.keys = [begin_key + i for i in range(len(self.leaves))]
        self.steps = 1                    # M_i, assigned by the state server
        self.local_steps_run = 0
        self.sync_rounds = 0
        # transmission-time estimate: the paper's c_i is pure
        # transmission, but a synchronous round's wall time also contains
        # the wait for stragglers — reporting that conflation suppresses
        # fast workers' step counts forever (at M=1 a fast worker ALWAYS
        # waits, so it never observes a clean sample and never ramps).
        # Instead c_i is measured from the state-server command's own
        # round-trip: same network path, answered immediately, never
        # includes barrier wait. It underestimates large-tensor transfer
        # (compute heterogeneity dominates the paper's setting); the min
        # of the two keeps an occasional clean sync sample in play.
        self._c_est = 0.0
        for k, leaf in zip(self.keys, self.leaves):
            self.kv.init(k, leaf)
        if not getattr(self.kv, "is_master_worker", False):
            for i, k in enumerate(self.keys):
                self.kv.pull(k, out=self.leaves[i])
        self.kv.wait()
        self._nw = max(int(getattr(self.kv, "num_all_workers", 0)
                           or getattr(self.kv, "num_workers", 1)), 1)

    def round(self, batches) -> float:
        """One ESync round: M_i local steps over ``batches`` (cycled),
        one synchronous model-average, one state-server report. Returns
        the last local loss."""
        t0 = time.perf_counter()
        loss = 0.0
        for m in range(self.steps):
            X, y = batches[m % len(batches)]
            loss, grads = self.grad_fn(self.leaves, X, y)
            for i, g in enumerate(grads):
                self.leaves[i] = np.asarray(
                    self.opt.update(i, self.leaves[i], np.asarray(g)),
                    dtype=np.float32).reshape(self.leaves[i].shape)
            self.local_steps_run += 1
        tau = (time.perf_counter() - t0) / max(self.steps, 1)
        t1 = time.perf_counter()
        scaled = [l / self._nw for l in self.leaves]
        if hasattr(self.kv, "push_pull"):
            self.kv.push_pull(self.keys, scaled, out=self.leaves)
        else:
            self.kv.push(self.keys, scaled)
            self.kv.pull(self.keys, out=self.leaves)
        self.kv.wait()
        c_sync = time.perf_counter() - t1
        self.sync_rounds += 1
        if hasattr(self.kv, "esync_state"):
            t2 = time.perf_counter()
            self.steps = self.kv.esync_state(
                tau, min(self._c_est, c_sync) if self._c_est else 0.0)
            self._c_est = time.perf_counter() - t2
        return float(loss)
